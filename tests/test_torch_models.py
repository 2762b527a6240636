"""The port's models against the JAX package's at tiny widths: tokenizers
id for id, the encoder (learned and rotary positions, both RoPE pairings,
GELU and SwiGLU, every pooling), Nemotron (the materialized path below 512
tokens, the block path at 512 and at a ragged 528), causality, GGUF files
read by both loaders, and the cross-encoder's scores and rerank order.

Parameters are made once by the JAX package and carried across
(``convert.py``), so both sides compute with the same weights; inputs come
from numpy seeds.

Tolerance for embeddings and scores: 1e-2 absolute on L2-normalized
vectors. Both sides round every product's output and activations to bf16
(2^-8 relative each) in framework-specific orders and fusions; through two
layers that stays within ~1e-2 of a unit vector (measured ~3e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from trueno_rag_tpu.models import cross_encoder as jce
from trueno_rag_tpu.models import encoder as je
from trueno_rag_tpu.models import gguf as jg
from trueno_rag_tpu.models import nemotron as jn
from trueno_rag_tpu.models.tokenization import WordPieceTokenizer as JaxWordPiece

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch.convert import (
    cross_encoder_params_from_jax,
    encoder_params_from_jax,
    nemotron_params_from_jax,
)
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.models import cross_encoder as tce
from trueno_rag_tpu_torch.models import encoder as te
from trueno_rag_tpu_torch.models import gguf as tg
from trueno_rag_tpu_torch.models import nemotron as tn
from trueno_rag_tpu_torch.models.tokenization import WordPieceTokenizer

TOL = 1e-2


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _texts(n, words, vocab=300, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{i}" for i in rng.integers(0, vocab, size=int(ln)))
            for ln in rng.integers(1, words + 1, size=n)]


TEXTS = ["The quick brown fox", "naïve café — ünïcode 🦊 tokens", "x", "",
         "A much longer sentence with many words, punctuation; and numbers 12345."]


def test_hash_tokenizer_matches_jax_id_for_id():
    for vocab, max_len in ((512, 64), (30522, 8), (32000, 8192)):
        t, j = te.HashTokenizer(vocab, max_len), je.HashTokenizer(vocab, max_len)
        texts = TEXTS + _texts(20, 40, seed=vocab)
        assert [t.encode(x) for x in texts] == [j.encode(x) for x in texts]
        for mult in (16, 8):
            assert np.array_equal(t.encode_batch(texts, mult), j.encode_batch(texts, mult))


def test_wordpiece_tokenizer_matches_jax_id_for_id():
    vocab = {w: i for i, w in enumerate(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "quick", "brown", "fox", "un", "##able",
         "##s", "a", ",", ".", "café", "jump", "##ed", "##ing"])}
    texts = TEXTS + ["unable jumped jumping foxs", "the,the. " * 30]
    for max_len in (8, 64):
        t, j = WordPieceTokenizer(vocab, max_len=max_len), JaxWordPiece(vocab, max_len=max_len)
        assert [t.encode(x) for x in texts] == [j.encode(x) for x in texts]
        assert np.array_equal(t.encode_batch(texts), j.encode_batch(texts))


def _encoder_pair(seed=0, **changes):
    cj = dataclasses.replace(je.EncoderConfig.tiny(), **changes)
    ct = dataclasses.replace(te.EncoderConfig.tiny(), **changes)
    pj = je.init_encoder_params(jax.random.PRNGKey(seed), cj)
    return cj, ct, pj, encoder_params_from_jax(_np(pj), "cpu")


@pytest.mark.parametrize("changes", [
    {},
    {"pooling": "cls"},
    {"pooling": "weighted_mean"},
    {"pooling": "last_token"},
    {"position": "rotary", "mlp": "swiglu"},
    {"position": "rotary", "rope_interleaved": True},
    {"normalize": False, "pooling": "cls", "mlp": "swiglu"},
], ids=["learned-gelu-mean", "cls", "weighted_mean", "last_token", "rotary-swiglu",
        "rotary-interleaved", "unnormalized"])
def test_encoder_forward_matches_jax(changes):
    cj, ct, pj, pt = _encoder_pair(**changes)
    ids = te.HashTokenizer(ct.vocab_size, ct.max_len).encode_batch(_texts(6, 50, seed=1))
    want = np.asarray(je.encoder_forward(pj, jnp.asarray(ids), cj))
    got = te.encoder_forward(pt, torch.from_numpy(ids), ct).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL * (1 if ct.normalize else 10))
    if ct.normalize:
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_encoder_token_states_match_jax():
    cj, ct, pj, pt = _encoder_pair(seed=3)
    ids = te.HashTokenizer(ct.vocab_size, ct.max_len).encode_batch(_texts(4, 30, seed=2))
    xj, mj = je.encoder_token_states(pj, jnp.asarray(ids), cj)
    xt, mt = te.encoder_token_states(pt, torch.from_numpy(ids), ct)
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    # token states are layer-normed (unit variance per token), so bf16
    # rounding of their ~O(1) entries is the scale: 2^-8 relative, through
    # two layers
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=0.1)


def test_encoder_embedder_matches_jax_and_defaults_to_the_card(monkeypatch):
    cfg = te.EncoderConfig.tiny()
    jemb = je.JaxEncoderEmbedder(config=dataclasses.replace(je.EncoderConfig.tiny()), seed=5)
    temb = te.EncoderEmbedder(config=cfg, params=encoder_params_from_jax(_np(jemb.params), "cpu"),
                              device="cpu")
    texts = _texts(11, 40, seed=4)
    np.testing.assert_allclose(temb.embed_batch(texts), jemb.embed_batch(texts), atol=TOL)
    np.testing.assert_allclose(temb.embed_queries(texts[:3]), jemb.embed_queries(texts[:3]), atol=TOL)
    q = temb.embed_queries_device(texts[:3])
    assert isinstance(q, torch.Tensor) and q.device.type == "cpu"
    assert temb.embed_batch([]).shape == (0, cfg.hidden_dim)
    # slicing a batch into several forwards changes no row
    monkeypatch.setattr(te, "_EMBED_ROWS", 4)
    np.testing.assert_allclose(temb.embed_batch(texts), jemb.embed_batch(texts), atol=TOL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(InvalidConfigError, match="CUDA"):
        te.EncoderEmbedder(config=cfg)
    with pytest.raises(trag.SerializationError, match="no checkpoint"):
        te.EncoderEmbedder.load_checkpoint("no/such/model.safetensors", device="cpu")


def test_embedding_config_overrides_like_jax():
    ec = trag.EmbeddingConfig(pooling=trag.PoolingStrategy.CLS, max_length=32)
    temb = te.EncoderEmbedder(config=te.EncoderConfig.tiny(), embedding_config=ec, device="cpu")
    assert temb.encoder_config.pooling == "cls" and temb.encoder_config.max_len == 32


def _nemotron_pair(max_len=128, seed=0):
    cj = dataclasses.replace(jn.NemotronConfig.tiny(), max_len=max_len)
    ct = dataclasses.replace(tn.NemotronConfig.tiny(), max_len=max_len)
    pj = jn.init_nemotron_params(jax.random.PRNGKey(seed), cj)
    return cj, ct, pj, nemotron_params_from_jax(_np(pj), "cpu")


def _ids(texts, vocab, max_len, rows=8):
    ids = te.HashTokenizer(vocab, max_len).encode_batch(texts)
    return np.pad(ids, ((0, rows - ids.shape[0]), (0, 0)))  # all-PAD rows, as the embedder's bucket


@pytest.mark.parametrize("words,impl", [(40, "naive"), (510, "block"), (526, "block")],
                         ids=["T48-naive", "T512-block", "T528-block"])
def test_nemotron_forward_matches_jax(words, impl):
    """Below 512 tokens both take the materialized path; at T = 512 both
    take the block kernel (JAX's in interpret mode, the port's plain
    version); at T = 528 the JAX block path asserts (T % 128), so the port's
    block path is held to the JAX naive path."""
    cj, ct, pj, pt = _nemotron_pair(max_len=1024)
    texts = [" ".join(f"w{i}" for i in range(words))] + _texts(2, words // 2, seed=words)
    ids = _ids(texts, ct.vocab_size, ct.max_len)
    t = ids.shape[1]
    got = tn.nemotron_forward(pt, torch.from_numpy(ids), ct).numpy()
    jcfg = cj if t % 128 == 0 else dataclasses.replace(cj, attention_impl="naive")
    want = np.asarray(jn.nemotron_forward(pj, jnp.asarray(ids), jcfg))
    assert (t >= tn.BLOCK_FROM_T) == (impl == "block")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:3], want[:3], atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_nemotron_block_and_naive_agree():
    _, ct, _, pt = _nemotron_pair(max_len=1024, seed=2)
    ids = torch.from_numpy(_ids(_texts(3, 600, seed=3), ct.vocab_size, ct.max_len))
    block = tn.nemotron_forward(pt, ids, dataclasses.replace(ct, attention_impl="block"))
    naive = tn.nemotron_forward(pt, ids, dataclasses.replace(ct, attention_impl="naive"))
    np.testing.assert_allclose(block.numpy(), naive.numpy(), atol=TOL)


def test_nemotron_causality_prefix_invariance():
    """The hidden state at position t depends on no later token: a prefix
    pooled alone equals the same prefix followed by padding, and a text
    embedded beside a longer one (padded to its length, block path)
    equals itself alone."""
    _, ct, _, pt = _nemotron_pair(max_len=1024, seed=1)
    base = [1, 10, 20, 30]
    a = tn.nemotron_forward(pt, torch.tensor([base + [0, 0]]), ct).numpy()
    b = tn.nemotron_forward(pt, torch.tensor([base]), ct).numpy()
    np.testing.assert_allclose(a, b, atol=2e-3)
    emb = tn.NemotronEmbedder(config=ct, params=pt, device="cpu")
    short = " ".join(f"w{i}" for i in range(100))
    long = " ".join(f"v{i}" for i in range(700))  # T = 704: the block path
    together = emb.embed_batch([short, long])
    alone = emb.embed_batch([short])
    cos = float(together[0] @ alone[0])
    assert cos >= 0.999, cos


def test_nemotron_embedder_matches_jax():
    cj, ct, pj, pt = _nemotron_pair()
    jemb = jn.NemotronEmbedder(config=cj, params=pj, batch_size=3)
    temb = tn.NemotronEmbedder(config=ct, params=pt, batch_size=3, device="cpu")
    texts = _texts(7, 30, seed=6)
    np.testing.assert_allclose(temb.embed_batch(texts), jemb.embed_batch(texts), atol=TOL)
    np.testing.assert_allclose(temb.embed_query("what is a fox"), jemb.embed_query("what is a fox"), atol=TOL)
    assert temb.config.query_prefix == tn.NEMOTRON_QUERY_PREFIX and temb.model_id == "nvidia/NV-Embed-v2"
    full = tn.NemotronConfig.full()
    assert (full.hidden_dim, full.num_layers, full.num_heads, full.mlp_dim, full.max_len) == (
        4096, 32, 32, 14336, 8192)


def _tiny_llama(path, seed=0, h=16, m=32, layers=2, heads=2, vocab=64):
    rng = np.random.default_rng(seed)
    t = {"token_embd.weight": rng.standard_normal((vocab, h)).astype(np.float32),
         "output_norm.weight": rng.uniform(0.5, 1.5, h).astype(np.float32)}
    for i in range(layers):
        for name, shape in (("attn_q", (h, h)), ("attn_k", (h, h)), ("attn_v", (h, h)),
                            ("attn_output", (h, h)), ("ffn_gate", (m, h)), ("ffn_up", (m, h)),
                            ("ffn_down", (h, m))):
            t[f"blk.{i}.{name}.weight"] = (0.2 * rng.standard_normal(shape)).astype(np.float32)
        t[f"blk.{i}.attn_norm.weight"] = rng.uniform(0.5, 1.5, h).astype(np.float32)
        t[f"blk.{i}.ffn_norm.weight"] = rng.uniform(0.5, 1.5, h).astype(np.float32)
    meta = {"general.architecture": "llama", "llama.block_count": layers,
            "llama.embedding_length": h, "llama.feed_forward_length": m,
            "llama.attention.head_count": heads, "llama.context_length": 128,
            "llama.rope.freq_base": 10000.0}
    jg.write_gguf(path, meta, t)
    return t


def test_gguf_file_loads_equal_params_in_both_packages(tmp_path):
    path = str(tmp_path / "tiny.gguf")
    _tiny_llama(path)
    pj, cj = jg.load_nemotron_gguf(path)
    pt, ct = tg.load_nemotron_gguf(path)
    assert dataclasses.asdict(ct) == {**dataclasses.asdict(cj), "compute_dtype": torch.bfloat16}
    want = nemotron_params_from_jax(_np(pj), "cpu")
    for key in ("tok_emb", "final_rms_scale"):
        assert torch.equal(pt[key], want[key]), key
    for lt, lw in zip(pt["layers"], want["layers"]):
        for key in tn.LAYER_KEYS:
            assert lt[key].dtype == lw[key].dtype and torch.equal(lt[key], lw[key]), key
    temb = tn.NemotronEmbedder.from_gguf(path, device="cpu")
    jemb = jn.NemotronEmbedder.from_gguf(path)
    texts = ["hello world", "gguf import", "w1 w2 w3 w4"]
    np.testing.assert_allclose(temb.embed_batch(texts), jemb.embed_batch(texts), atol=TOL)
    # the same files, the same error taxonomy
    with pytest.raises(trag.IndexNotFoundError):
        tg.read_gguf(str(tmp_path / "missing.gguf"))
    bad = tmp_path / "bad.gguf"
    bad.write_bytes(b"NOPE" + b"\0" * 64)
    with pytest.raises(trag.SerializationError, match="magic"):
        tg.read_gguf(str(bad))


@pytest.mark.parametrize("ggml_type,block_bytes,per_block", [
    (1, 2, 1), (8, 34, 32), (2, 18, 32), (3, 20, 32), (12, 144, 256), (13, 176, 256),
    (14, 210, 256), (15, 292, 256),
], ids=["F16", "Q8_0", "Q4_0", "Q4_1", "Q4_K", "Q5_K", "Q6_K", "Q8_K"])
def test_dequantize_matches_jax_bit_for_bit(ggml_type, block_bytes, per_block):
    rng = np.random.default_rng(ggml_type)
    nb = 4
    raw = rng.integers(0, 256, size=nb * block_bytes, dtype=np.uint8)
    if ggml_type == 1:
        raw = np.frombuffer(rng.standard_normal(nb).astype(np.float16).tobytes(), np.uint8).copy()
    else:  # finite scales: no inf/nan bit patterns in the f16/f32 headers
        for b in range(nb):
            o = b * block_bytes
            if ggml_type == 15:
                raw[o:o + 4] = np.frombuffer(np.float32(0.01 * (b + 1)).tobytes(), np.uint8)
            else:
                at = o + (208 if ggml_type == 14 else 0)
                raw[at:at + 2] = np.frombuffer(np.float16(0.02 * (b + 1)).tobytes(), np.uint8)
                if ggml_type in (3, 12, 13):
                    raw[o + 2:o + 4] = np.frombuffer(np.float16(0.003 * (b + 1)).tobytes(), np.uint8)
    n = nb * per_block
    got = tg._dequantize(raw, ggml_type, n)
    want = jg._dequantize(raw, ggml_type, n)
    assert got.dtype == np.float32 and np.array_equal(got, want)


def _cross_pair(seed=0, pooler=False):
    cfg_j, cfg_t = je.EncoderConfig.tiny(), te.EncoderConfig.tiny()
    pj = jce.init_cross_encoder_params(jax.random.PRNGKey(seed), cfg_j)
    # sharper attention and a larger head than the 0.02 init, so the CLS
    # state varies by pair and the scores spread over (0, 1)
    for key, scale in (("tok_emb", 20.0), ("qkv_w", 10.0), ("score_w", 5.0)):
        pj[key] = pj[key] * scale
    if pooler:
        rng = np.random.default_rng(seed)
        pj["pooler_w"] = jnp.asarray(0.1 * rng.standard_normal((64, 64)), jnp.float32)
        pj["pooler_b"] = jnp.asarray(0.1 * rng.standard_normal(64), jnp.float32)
    return cfg_j, cfg_t, pj, cross_encoder_params_from_jax(_np(pj), "cpu")


@pytest.mark.parametrize("pooler", [False, True])
def test_cross_encoder_scores_and_rerank_order_match_jax(pooler):
    """Scores within the tolerance; the rerank order equal on data whose
    scores are tie-free (every gap above twice the largest difference
    between the two packages' scores — the first such seed)."""
    from trueno_rag_tpu.chunking import Chunk as JaxChunk
    from trueno_rag_tpu.retrieve import RetrievalResult as JaxResult

    query = "w1 w7 w42"
    for seed in range(40):
        cfg_j, cfg_t, pj, pt = _cross_pair(seed=seed, pooler=pooler)
        jr = jce.CrossEncoderReranker(config=cfg_j, params=pj)
        tr = tce.CrossEncoderReranker(config=cfg_t, params=pt, device="cpu")
        contents = _texts(6, 40, seed=seed)
        assert np.array_equal(tr._encode_pairs(query, contents), jr._encode_pairs(query, contents))
        ts, js = tr.score_batch(query, contents), jr.score_batch(query, contents)
        np.testing.assert_allclose(ts, js, atol=TOL)
        if np.diff(np.sort(js)).min() > 2 * np.abs(ts - js).max():
            break
    else:
        raise AssertionError("no tie-free seed")
    tc = [trag.RetrievalResult(chunk=trag.Chunk(f"d{i}", c, 0, len(c), id=f"c{i}"), fused_score=0.1)
          for i, c in enumerate(contents)]
    jc = [JaxResult(chunk=JaxChunk(f"d{i}", c, 0, len(c), id=f"c{i}"), fused_score=0.1)
          for i, c in enumerate(contents)]
    tout, jout = tr.rerank(query, tc, 4), jr.rerank(query, jc, 4)
    assert [r.chunk.id for r in tout] == [r.chunk.id for r in jout]
    assert all(r.rerank_score is not None for r in tout)
    assert tr.score_batch(query, []).shape == (0,)
