"""The port's Hugging Face import (``models/hf_import.py``) against the JAX
package's and against ``transformers`` itself, on random-weight models
built in-process (no download):

- ``BertModel``, ``BertForSequenceClassification`` and ``RoFormerModel``
  exported as ``model.safetensors`` (and one as ``pytorch_model.bin``),
  loaded by both packages: the converted arrays identical; at
  ``compute_dtype=float32`` mean-pooled states and cross-encoder scores
  within 2e-4 (rel and abs) of ``transformers`` and of the JAX package;
  at the default bf16 the unit embeddings within 1e-2 of the JAX
  package's (the two frameworks round the bf16 trunk differently);
- a synthetic nomic-bert checkpoint converted array for array as the JAX
  package converts it, and its embeddings within 2e-4;
- the CLI's ``--embedder semantic --model DIR`` indexes and answers as the
  JAX CLI does over the same directory; errors as the JAX loader raises
  them.
"""

import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
from safetensors.numpy import save_file  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from trueno_rag_tpu.models import hf_import as jh  # noqa: E402
from trueno_rag_tpu.models.cross_encoder import cross_encoder_scores as j_ce_scores  # noqa: E402
from trueno_rag_tpu.models.encoder import encoder_forward as j_forward  # noqa: E402
from trueno_rag_tpu_torch.errors import SerializationError  # noqa: E402
from trueno_rag_tpu_torch.models import hf_import as ph  # noqa: E402
from trueno_rag_tpu_torch.models.cross_encoder import cross_encoder_scores as p_ce_scores  # noqa: E402
from trueno_rag_tpu_torch.models.encoder import encoder_forward as p_forward  # noqa: E402
from trueno_rag_tpu_torch.models.tokenization import WordPieceTokenizer  # noqa: E402

TINY = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, pad_token_id=0, type_vocab_size=2)
ROFORMER = dict(TINY, model_type="roformer", embedding_size=32, rotary_value=False)
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
    "the", "fox", "jump", "##s", "##ing", "over", "dog", "lazy", "quick",
    "retrieval", "tpu", "matrix", "a", "b", "c", ".", ",",
] + [f"w{i}" for i in range(178)]
IDS = np.array([[2, 5, 6, 8, 3, 0, 0, 0], [2, 9, 10, 11, 14, 15, 16, 3]], dtype=np.int32)


def write_dir(d, model, cfg, fmt="safetensors"):
    d.mkdir()
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    if fmt == "safetensors":
        save_file(state, str(d / "model.safetensors"))
    else:
        torch.save(model.state_dict(), str(d / "pytorch_model.bin"))
    (d / "config.json").write_text(json.dumps(cfg))
    (d / "vocab.txt").write_text("\n".join(VOCAB))
    return str(d)


@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    torch.manual_seed(0)
    model = transformers.BertModel(transformers.BertConfig(**TINY)).eval()
    return write_dir(tmp_path_factory.mktemp("b") / "bert", model, TINY), model


@pytest.fixture(scope="module")
def roformer(tmp_path_factory):
    torch.manual_seed(1)
    cfg = {k: v for k, v in ROFORMER.items() if k != "model_type"}
    model = transformers.RoFormerModel(transformers.RoFormerConfig(**cfg)).eval()
    return write_dir(tmp_path_factory.mktemp("r") / "roformer", model, ROFORMER), model


def hf_mean(model, ids):
    mask = (ids != 0).astype(np.int64)
    with torch.no_grad():
        out = model(input_ids=torch.tensor(ids, dtype=torch.long),
                    attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
    m = mask[..., None].astype(np.float32)
    return (out * m).sum(1) / m.sum(1)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_bert_matches_transformers_and_jax(bert, tmp_path, fmt):
    model_dir, model = bert
    if fmt == "bin":
        model_dir = write_dir(tmp_path / "bin", model, TINY, fmt="bin")
    pe = ph.load_hf_bert_encoder(model_dir, pooling="mean", normalize=False, compute_dtype=torch.float32,
                                 device="cpu")
    je = jh.load_hf_bert_encoder(model_dir, pooling="mean", normalize=False, compute_dtype=jnp.float32)
    assert isinstance(pe.tokenizer, WordPieceTokenizer)
    assert pe.tokenizer.encode("the quick fox jumps") == je.tokenizer.encode("the quick fox jumps")
    got = p_forward(pe.params, torch.from_numpy(IDS), pe.encoder_config).numpy()
    want = np.asarray(j_forward(je.params, jnp.asarray(IDS), je.encoder_config))
    np.testing.assert_allclose(got, hf_mean(model, IDS), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_bert_state_converted_as_jax_converts_it(bert):
    from trueno_rag_tpu_torch.persist import load_params

    state = load_params(bert[0] + "/model.safetensors")[0]
    got, want = ph.convert_bert_state(state, 2), jh.convert_bert_state(state, 2)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rot = ph.convert_bert_state(state, 2, position="rotary")
    assert "pos_emb" not in rot and sorted(rot) == sorted(jh.convert_bert_state(state, 2, position="rotary"))


def test_bert_embedder_bf16_against_jax(bert):
    pe = ph.load_hf_bert_encoder(bert[0], device="cpu")
    je = jh.load_hf_bert_encoder(bert[0])
    assert pe.encoder_config.compute_dtype == torch.bfloat16
    assert pe.params["layers"][0]["qkv_w"].dtype == torch.bfloat16
    texts = ["the quick fox jumps", "tpu matrix retrieval", "a lazy dog"]
    got, want = pe.embed_batch(texts), je.embed_batch(texts)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-2)
    assert pe.model_id == je.model_id


def test_cross_encoder_matches_transformers_and_jax(tmp_path):
    torch.manual_seed(1)
    model = transformers.BertForSequenceClassification(transformers.BertConfig(**TINY, num_labels=1)).eval()
    d = write_dir(tmp_path / "ce", model, TINY)
    pr = ph.load_hf_cross_encoder(d, compute_dtype=torch.float32, device="cpu")
    jr = jh.load_hf_cross_encoder(d, compute_dtype=jnp.float32)
    assert pr.has_pooler and isinstance(pr.tokenizer, WordPieceTokenizer)
    ids = np.array([[2, 5, 6, 3, 8, 3, 0, 0], [2, 9, 10, 3, 11, 14, 15, 3]], dtype=np.int32)
    with torch.no_grad():
        logits = model(input_ids=torch.tensor(ids, dtype=torch.long),
                       attention_mask=torch.tensor((ids != 0).astype(np.int64))).logits.numpy()[:, 0]
    got = p_ce_scores(pr.params, torch.from_numpy(ids), pr.config).numpy()
    np.testing.assert_allclose(got, 1.0 / (1.0 + np.exp(-logits)), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got, np.asarray(j_ce_scores(jr.params, jnp.asarray(ids), jr.config)),
                               rtol=2e-4, atol=2e-4)
    cands = ["the fox jumps", "tpu matrix", "a lazy dog over the fox"]
    np.testing.assert_allclose(pr.score_batch("the fox", cands), jr.score_batch("the fox", cands),
                               rtol=2e-4, atol=2e-4)


def test_cross_encoder_rejects_multi_label(tmp_path):
    torch.manual_seed(2)
    model = transformers.BertForSequenceClassification(transformers.BertConfig(**TINY, num_labels=2)).eval()
    d = write_dir(tmp_path / "ce2", model, TINY)
    with pytest.raises(SerializationError, match="single-logit"):
        ph.load_hf_cross_encoder(d, device="cpu")


def test_roformer_matches_transformers_and_jax(roformer):
    model_dir, model = roformer
    pe = ph.load_hf_rotary_encoder(model_dir, pooling="mean", normalize=False, compute_dtype=torch.float32,
                                   device="cpu")
    je = jh.load_hf_rotary_encoder(model_dir, pooling="mean", normalize=False, compute_dtype=jnp.float32)
    cfg = pe.encoder_config
    assert (cfg.position, cfg.rope_interleaved, cfg.mlp) == ("rotary", True, "gelu")
    assert "pos_emb" not in pe.params
    got = p_forward(pe.params, torch.from_numpy(IDS), cfg).numpy()
    np.testing.assert_allclose(got, hf_mean(model, IDS), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(j_forward(je.params, jnp.asarray(IDS), je.encoder_config)),
                               rtol=2e-4, atol=2e-4)


def nomic_state(h=32, L=2, m=48, v=128, with_biases=False):
    rng = np.random.default_rng(0)
    state = {"embeddings.word_embeddings.weight": rng.standard_normal((v, h)),
             "embeddings.token_type_embeddings.weight": rng.standard_normal((2, h)),
             "emb_ln.weight": np.ones(h), "emb_ln.bias": np.zeros(h)}
    for i in range(L):
        p = f"encoder.layers.{i}."
        state.update({
            p + "attn.Wqkv.weight": rng.standard_normal((3 * h, h)), p + "attn.Wqkv.bias": rng.standard_normal(3 * h),
            p + "attn.out_proj.weight": rng.standard_normal((h, h)), p + "attn.out_proj.bias": rng.standard_normal(h),
            p + "norm1.weight": np.ones(h), p + "norm1.bias": np.zeros(h),
            p + "norm2.weight": np.ones(h), p + "norm2.bias": np.zeros(h),
            p + "mlp.fc11.weight": rng.standard_normal((m, h)), p + "mlp.fc12.weight": rng.standard_normal((m, h)),
            p + "mlp.fc2.weight": rng.standard_normal((h, m)),
        })
        if with_biases:
            state.update({p + "mlp.fc11.bias": rng.standard_normal(m), p + "mlp.fc12.bias": rng.standard_normal(m),
                          p + "mlp.fc2.bias": rng.standard_normal(h)})
    return {k: np.asarray(val, np.float32) * 0.05 for k, val in state.items()}


@pytest.mark.parametrize("with_biases", [False, True])
def test_nomic_conversion_and_forward_match_jax(tmp_path, with_biases):
    state = nomic_state(with_biases=with_biases)
    got, want = ph.convert_nomic_state(state, 2), jh.convert_nomic_state(state, 2)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    d = tmp_path / "nomic"
    d.mkdir()
    save_file(state, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(dict(
        model_type="nomic_bert", vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=48, max_position_embeddings=64, pad_token_id=0, rotary_emb_base=1000.0)))
    pe = ph.load_hf_rotary_encoder(str(d), compute_dtype=torch.float32, device="cpu")
    je = jh.load_hf_rotary_encoder(str(d), compute_dtype=jnp.float32)
    cfg = pe.encoder_config
    assert (cfg.position, cfg.mlp, cfg.rope_interleaved, cfg.rope_base) == ("rotary", "swiglu", False, 1000.0)
    ids = np.array([[2, 5, 6, 3, 0, 0], [2, 7, 9, 11, 12, 3]], np.int32)
    np.testing.assert_allclose(p_forward(pe.params, torch.from_numpy(ids), cfg).numpy(),
                               np.asarray(j_forward(je.params, jnp.asarray(ids), je.encoder_config)),
                               rtol=2e-4, atol=2e-4)


def test_loader_errors(tmp_path, bert):
    with pytest.raises(SerializationError):
        ph.convert_bert_state({"embeddings.word_embeddings.weight": np.zeros((4, 4))}, 1)
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "config.json").write_text(json.dumps(TINY))
    with pytest.raises(SerializationError, match="no model.safetensors"):
        ph.load_hf_bert_encoder(str(empty), device="cpu")
    (empty / "config.json").write_text(json.dumps(dict(TINY, pad_token_id=1)))
    with pytest.raises(SerializationError, match="pad_token_id"):
        ph.load_hf_bert_encoder(str(empty), device="cpu")
    (empty / "config.json").write_text(json.dumps(dict(TINY, model_type="bert")))
    with pytest.raises(SerializationError, match="roformer/nomic_bert"):
        ph.load_hf_rotary_encoder(str(empty), device="cpu")


def test_models_package_exports_the_loaders():
    from trueno_rag_tpu_torch import models

    assert models.load_hf_bert_encoder is ph.load_hf_bert_encoder
    assert models.load_hf_rotary_encoder is ph.load_hf_rotary_encoder
    assert models.load_hf_cross_encoder is ph.load_hf_cross_encoder
