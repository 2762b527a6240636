"""DeepSeek-V2-Lite as the port's embedder (``models/deepseek_v2.py``)
against the benchmark's plain reference (``benchmark/reference/
deepseek_v2.py``) and against its equations written out here: at
``tiny()`` on the CPU, and at ``lite()``, the published widths, on the
card (marker ``cuda``). No JAX here: the card's machine runs the card
tests with ``--noconftest -m cuda``."""

import math

import numpy as np
import pytest
import torch

from benchmark.harness import inputs
from benchmark.reference import deepseek_v2 as ref
from benchmark.reference import scores as ref_scores
from trueno_rag_tpu_torch.models.deepseek_v2 import (
    DEEPSEEK_V2_QUERY_PREFIX, DeepseekV2Config, DeepseekV2Embedder, deepseek_v2_forward, init_deepseek_v2_params,
    mla_qkv, moe_mlp, real_token_index, softmax_scale, yarn_correction_range, yarn_inv_freq,
)
from trueno_rag_tpu_torch.models.encoder import HashTokenizer, pad_batch_pow2

TINY = DeepseekV2Config.tiny()
QUERIES = ["w00012 w00400 w07001", "w00002 w00003 w00004 w00005 w00006 w00007 w00008 w00009 w00010",
           "w00077", "w12345 w00001 w00002 w00003 w00004"]


def hf_config(c: DeepseekV2Config) -> dict:
    """``c`` under the keys of DeepSeek-V2's ``config.json``, as the
    reference reads them."""
    return {
        "vocab_size": c.vocab_size, "hidden_size": c.hidden_dim, "num_hidden_layers": c.num_layers,
        "first_k_dense_replace": c.first_k_dense, "num_attention_heads": c.num_heads,
        "kv_lora_rank": c.kv_lora_rank, "qk_nope_head_dim": c.qk_nope_head_dim,
        "qk_rope_head_dim": c.qk_rope_head_dim, "v_head_dim": c.v_head_dim, "intermediate_size": c.mlp_dim,
        "moe_intermediate_size": c.expert_dim, "n_routed_experts": c.n_routed_experts,
        "num_experts_per_tok": c.experts_per_token, "n_shared_experts": c.n_shared_experts,
        "routed_scaling_factor": 1, "rms_norm_eps": c.rms_norm_eps, "rope_theta": c.rope_theta,
        "rope_scaling": {"beta_fast": c.rope_beta_fast, "beta_slow": c.rope_beta_slow, "factor": c.rope_factor,
                         "mscale": c.rope_mscale, "mscale_all_dim": c.rope_mscale_all_dim,
                         "original_max_position_embeddings": c.rope_original_max, "type": "yarn"},
        "query_prefix": DEEPSEEK_V2_QUERY_PREFIX, "tokenizer_max_len": c.max_len,
    }


def seeded_params(c: DeepseekV2Config, seed: int, device="cpu") -> dict:
    """Seeded weights with norm scales ``1 + N(0, 0.02²)``, so the scales
    count."""
    g = torch.Generator(device=device).manual_seed(seed)
    p = init_deepseek_v2_params(c, g, device)
    for scale in [p["final_norm"]] + [lp[k] for lp in p["layers"] for k in ("attn_norm", "kv_a_norm", "mlp_norm")]:
        scale.add_(0.02 * torch.randn(scale.shape, generator=g, device=device))
    return p


def token_ids(c: DeepseekV2Config, texts, prefix: bool = True) -> np.ndarray:
    tok = HashTokenizer(c.vocab_size, c.max_len)
    return pad_batch_pow2(tok.encode_batch([(DEEPSEEK_V2_QUERY_PREFIX if prefix else "") + t for t in texts]))


unit = ref_scores.unit


@pytest.fixture(scope="module")
def tiny_params():
    return seeded_params(TINY, 7)


# -- CPU, tiny() -----------------------------------------------------------------


def test_tiny_keeps_every_kind_of_layer():
    c = TINY
    assert c.first_k_dense == 1 and c.num_layers - c.first_k_dense >= 3
    assert c.n_routed_experts >= 8 and c.experts_per_token >= 2 and c.n_shared_experts == 2
    assert len({c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim}) == 3


def test_embeddings_equal_the_bf16_reference_bit_for_bit_with_the_same_experts(tiny_params):
    ids = torch.from_numpy(token_ids(TINY, QUERIES))
    routes_port, routes_ref = [], []
    got = deepseek_v2_forward(tiny_params, ids, TINY, routes=routes_port)
    want = ref.pooled(tiny_params, ids, hf_config(TINY), "bf16", routes_ref)
    assert torch.equal(got, unit(want))
    assert len(routes_port) == len(routes_ref) == TINY.num_layers - TINY.first_k_dense
    for a, b in zip(routes_port, routes_ref):
        assert torch.equal(a, b)


def test_embeddings_are_within_bf16_rounding_of_the_f32_reference(tiny_params):
    """bf16 keeps 8 significant bits, so each product's result is rounded by
    up to 2^-9 of itself; over 4 layers of residual adds the unit
    embeddings of a seeded network drift by a few hundredths of a unit at
    most, where a wrong equation moves them by order one. The cosine of the
    two embeddings must be above 0.995 and no lane off by more than 0.03."""
    ids = torch.from_numpy(token_ids(TINY, QUERIES))
    got = deepseek_v2_forward(tiny_params, ids, TINY)[: len(QUERIES)].double()
    want = unit(ref.pooled(tiny_params, ids, hf_config(TINY), "f32")[: len(QUERIES)].double())
    assert (got * want).sum(dim=-1).min().item() > 0.995
    assert (got - want).abs().max().item() < 0.03


def test_yarn_frequencies_and_softmax_scale_at_the_published_widths():
    c = DeepseekV2Config.lite()
    assert yarn_correction_range(c) == (10, 23)
    i = np.arange(32, dtype=np.float64)
    extra = 1.0 / 10000.0 ** (2 * i / 64)
    keep = 1.0 - np.clip((i - 10) / (23 - 10), 0, 1)
    want = extra / 40.0 * (1 - keep) + extra * keep
    got = yarn_inv_freq(c).double().numpy()
    # f32's pow is within a few ulps of float64's: rtol 1e-6 is ~8 ulps
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[:10], extra[:10], rtol=1e-6)  # lanes below 10: unscaled
    np.testing.assert_allclose(got[24:], extra[24:] / 40, rtol=1e-6)  # above 23: interpolated by 40
    m = 0.1 * 0.707 * math.log(40) + 1
    assert softmax_scale(c) == pytest.approx(m * m / math.sqrt(192), rel=1e-12)
    assert round(softmax_scale(c), 5) == 0.11472
    ref_freq, ref_scale = ref.yarn(hf_config(c), "cpu")
    assert torch.equal(ref_freq, yarn_inv_freq(c)) and ref_scale == softmax_scale(c)


def _rms64(x, scale, eps):
    x = x.double()
    return x / torch.sqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale.double()


def _rope64(x, inv_freq):
    """RoPE as a complex rotation: (x[2j] + i·x[2j+1]) · e^{i·pos·θ_j}."""
    t = x.shape[-2]
    z = torch.view_as_complex(x.double().reshape(*x.shape[:-1], -1, 2).contiguous())
    ang = torch.arange(t, dtype=torch.float64)[:, None] * inv_freq.double()[None, :]
    return torch.view_as_real(z * torch.polar(torch.ones_like(ang), ang)).reshape(x.shape)


def test_mla_heads_follow_the_paper_equations(tiny_params):
    """Eqs. 9-19 without query compression, per head, in float64 from the
    same weights; the port's products round to bf16 (8 significant bits),
    so each value is held within 2% of its head's largest."""
    c, lp = TINY, tiny_params["layers"][1]
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(2, 11, c.hidden_dim, generator=g)).to(torch.bfloat16)
    inv_freq = yarn_inv_freq(c)
    q, k, v = mla_qkv(x, lp, c, inv_freq)
    h = _rms64(x, lp["attn_norm"], c.rms_norm_eps)
    latent = h @ lp["kv_a_w"].double()
    c_kv = _rms64(latent[..., :c.kv_lora_rank], lp["kv_a_norm"], c.rms_norm_eps)
    k_rope = _rope64(latent[..., c.kv_lora_rank:], inv_freq)
    dq, dkv = c.qk_head_dim, c.qk_nope_head_dim + c.v_head_dim
    for i in range(c.num_heads):
        w_q = lp["q_w"].double()[:, i * dq:(i + 1) * dq]
        w_kv = lp["kv_b_w"].double()[:, i * dkv:(i + 1) * dkv]
        q_i = torch.cat([h @ w_q[:, :c.qk_nope_head_dim], _rope64(h @ w_q[:, c.qk_nope_head_dim:], inv_freq)], -1)
        k_i = torch.cat([c_kv @ w_kv[:, :c.qk_nope_head_dim], k_rope], -1)
        v_i = c_kv @ w_kv[:, c.qk_nope_head_dim:]
        for got, want in ((q[:, i], q_i), (k[:, i], k_i), (v[:, i], v_i)):
            assert got.shape == want.shape
            assert (got.double() - want).abs().max() <= 0.02 * want.abs().max()


def _swiglu64(x, gate, up, down):
    a = x @ gate.double()
    return (a * torch.sigmoid(a) * (x @ up.double())) @ down.double()


def test_expert_layer_is_the_sum_over_each_tokens_chosen_experts(tiny_params):
    """Per real token: Σ over its top-k experts of gate · expert(u) plus the
    shared experts once, in float64; padding positions get the shared
    experts alone. The port's products round to bf16, so each token is
    held within 3% of its largest lane. The residual stream is small, so
    its bf16 add hides nothing of the layer's output (RMSNorm does not see
    the scale)."""
    c, lp = TINY, tiny_params["layers"][2]
    g = torch.Generator().manual_seed(5)
    x = (1e-3 * torch.randn(3, 8, c.hidden_dim, generator=g)).to(torch.bfloat16)
    mask = torch.zeros(3, 8, dtype=torch.bool)
    mask[0, :8], mask[1, :3], mask[2, :5] = True, True, True
    n_real = int(mask.sum())
    counts = torch.zeros(c.n_routed_experts, dtype=torch.int64)
    routes = []
    got = (moe_mlp(x, lp, c, real_token_index(mask, n_real), counts, routes) - x).double()
    u = _rms64(x, lp["mlp_norm"], c.rms_norm_eps)
    s = torch.softmax(u @ lp["router_w"].double(), dim=-1)
    m = c.expert_dim
    real = mask.reshape(-1).nonzero().squeeze(1).tolist()
    assert int(counts.sum()) == c.experts_per_token * n_real
    for j, pos in enumerate(real):
        b, t = divmod(pos, 8)
        top = torch.topk(s[b, t], c.experts_per_token).indices
        assert torch.equal(top, routes[0][j])
        want = _swiglu64(u[b, t], lp["gate_w"], lp["up_w"], lp["down_w"])
        for e in top.tolist():
            w13 = lp["experts_w13"][e]
            want = want + s[b, t, e] * _swiglu64(u[b, t], w13[:, :m], w13[:, m:], lp["experts_w2"][e])
        assert (got[b, t] - want).abs().max() <= 0.03 * want.abs().max()
    pad = (~mask).nonzero().tolist()
    for b, t in pad:
        want = _swiglu64(u[b, t], lp["gate_w"], lp["up_w"], lp["down_w"])
        assert (got[b, t] - want).abs().max() <= 0.03 * want.abs().max()


def test_a_query_alone_equals_itself_in_a_padded_batch(tiny_params):
    """One query alone and the same query among longer ones (a longer T,
    more rows): equal bits, and the expert counter holds top-k × MoE
    layers × real tokens."""
    emb = DeepseekV2Embedder(TINY, params=tiny_params, device="cpu")
    alone = emb.embed_queries([QUERIES[2]])
    assert int(emb.routed_tokens) == np.count_nonzero(token_ids(TINY, QUERIES[2:3]))
    batch = [QUERIES[1], QUERIES[2], "w00005 " * 30, QUERIES[0]]
    assert token_ids(TINY, batch).shape[1] > token_ids(TINY, QUERIES[2:3]).shape[1]
    together = emb.embed_queries(batch)
    assert np.array_equal(alone[0], together[1])
    n_moe = TINY.num_layers - TINY.first_k_dense
    assert int(emb.expert_tokens.sum()) == TINY.experts_per_token * n_moe * int(emb.routed_tokens)
    assert int(emb.routed_tokens) == (np.count_nonzero(token_ids(TINY, QUERIES[2:3]))
                                      + np.count_nonzero(token_ids(TINY, batch)))


def test_hybrid_retriever_serves_it_with_the_references_top_k(tiny_params):
    import trueno_rag_tpu_torch as rag
    from benchmark.systems.common import chunks_of, row_of

    n, k, seed = 512, 5, 2**31 + 11
    cfg = dict(hf_config(TINY), corpus={"chunks": n, "row_slab": 128})
    emb = DeepseekV2Embedder(TINY, params=tiny_params, device="cpu")
    retr = rag.HybridRetriever(emb, rag.HybridRetrieverConfig(use_sparse=False, candidates_per_source=20),
                               vector_config=rag.VectorStoreConfig(dimension=TINY.hidden_dim), device="cpu")
    rows = torch.cat([x for _, x in inputs.unit_rows(n, (TINY.hidden_dim,), seed, "cpu", 128)]).numpy()
    retr.vector_store.load_rows(chunks_of([f"t{i}" for i in range(n)]), rows)
    got = retr.retrieve_batch(QUERIES, k)
    s = ref.scores(cfg, tiny_params, QUERIES, seed, "cpu", "bf16")
    want_scores, want_rows = ref_scores.top_k(s, k)
    for res, wr, ws in zip(got, want_rows.tolist(), want_scores.tolist()):
        assert [row_of(r.chunk.id) for r in res] == wr
        np.testing.assert_allclose([r.dense_score for r in res], ws, rtol=0, atol=1e-6)


# -- the card, lite() ---------------------------------------------------------------


@pytest.fixture(scope="module")
def lite_params():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (DeepSeek-V2-Lite's 31 GB of weights)")
    p = seeded_params(DeepseekV2Config.lite(), 11, "cuda")
    yield p
    del p
    torch.cuda.empty_cache()


def _card_queries(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{w:05d}" for w in rng.integers(100, 100_000, rng.integers(4, 13))) for _ in range(n)]


@pytest.mark.cuda
def test_cuda_lite_forward_of_256_queries_never_synchronizes(lite_params):
    c = DeepseekV2Config.lite()
    ids_np = token_ids(c, _card_queries(256, 1))
    assert ids_np.shape == (256, 32)
    n_real = int(np.count_nonzero(ids_np))
    ids = torch.from_numpy(ids_np).cuda()
    counts = torch.zeros(c.num_layers - c.first_k_dense, c.n_routed_experts, dtype=torch.int64, device="cuda")
    deepseek_v2_forward(lite_params, ids, c, n_real, counts)  # warm-up: cuBLAS handles, workspaces
    counts.zero_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = deepseek_v2_forward(lite_params, ids, c, n_real, counts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert out.shape == (256, 2048) and bool(torch.isfinite(out).all())
    assert torch.allclose(out.norm(dim=-1), torch.ones(256, device="cuda"), atol=1e-5)
    assert int(counts.sum()) == 6 * 26 * n_real
    assert int((counts.sum(dim=0) > 0).sum()) == 64  # every expert busy


@pytest.mark.cuda
def test_cuda_lite_embeddings_equal_the_bf16_reference_with_the_same_experts(lite_params):
    c = DeepseekV2Config.lite()
    ids = torch.from_numpy(token_ids(c, _card_queries(16, 2))).cuda()
    routes_port, routes_ref = [], []
    got = deepseek_v2_forward(lite_params, ids, c, routes=routes_port)
    want = ref.pooled(lite_params, ids, hf_config(c), "bf16", routes_ref)
    assert len(routes_port) == len(routes_ref) == 26
    for layer, (a, b) in enumerate(zip(routes_port, routes_ref)):
        assert torch.equal(a, b), f"MoE layer {layer + 1}: experts differ"
    assert torch.equal(got, unit(want)), (got - unit(want)).abs().max().item()
