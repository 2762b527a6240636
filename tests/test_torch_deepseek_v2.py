"""DeepSeek-V2-Lite as the port's embedder (``models/deepseek_v2.py``)
against the benchmark's plain reference (``benchmark/reference/
deepseek_v2.py``) and against its equations written out here: at
``tiny()`` on the CPU, and at ``lite()``, the published widths, on the
card (marker ``cuda``). No JAX here: the card's machine runs the card
tests with ``--noconftest -m cuda``."""

import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import inputs
from benchmark.reference import deepseek_v2 as ref
from benchmark.reference import scores as ref_scores
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.models import deepseek_v2 as dsv2
from trueno_rag_tpu_torch.models.deepseek_v2 import (
    DEEPSEEK_V2_QUERY_PREFIX, DeepseekV2Config, DeepseekV2Embedder, deepseek_v2_forward, init_deepseek_v2_params,
    mla_qkv, moe_mlp, real_token_index, softmax_scale, yarn_correction_range, yarn_inv_freq,
)
from trueno_rag_tpu_torch.models.encoder import HashTokenizer, pad_batch_pow2
from trueno_rag_tpu_torch.ops.kernels.moe_combine import (
    moe_combine, moe_combine_reference, pair_rows, position_slots,
)
from trueno_rag_tpu_torch.utils import profiling

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


# -- the combine (ops/kernels/moe_combine.py) ------------------------------------------


def combine_inputs(p: int, n: int, k: int, h: int, seed: int, experts: int = 64):
    """A layer's combine inputs on the CPU: ``n`` real tokens among ``p``
    positions, each routed to ``k`` distinct experts sorted stably by
    expert as ``moe_mlp`` sorts them, expert outputs whose magnitudes span
    a few binades, descending gates → ``(out, order, weight, real, x,
    shared)``."""
    g = torch.Generator().manual_seed(seed)
    real = torch.sort(torch.randperm(p, generator=g)[:n]).values
    expert = torch.stack([torch.randperm(experts, generator=g)[:k] for _ in range(n)]) if n else \
        torch.zeros(0, k, dtype=torch.int64)
    order = torch.argsort(expert.reshape(-1), stable=True)
    out = (torch.randn(n * k, h, generator=g) * torch.exp(torch.randn(n * k, 1, generator=g))).to(torch.bfloat16)
    weight = torch.sort(torch.rand(n, k, generator=g) / k, dim=-1, descending=True).values
    x = torch.randn(p, h, generator=g).to(torch.bfloat16)
    shared = (0.3 * torch.randn(p, h, generator=g)).to(torch.bfloat16)
    return out, order, weight, real, x, shared


def parent_combine(out, order, weight, real, x, shared):
    """The combine as ``moe_mlp`` wrote it before the kernel: scatter the
    sorted rows back to pair order, weight in f32, sum rank by rank, round,
    scatter to the real positions, add the shared output and the residual."""
    (n, k), h = weight.shape, out.shape[1]
    per_pair = torch.empty_like(out).index_copy_(0, order, out).view(-1, k, h).float() * weight[..., None]
    acc = per_pair[:, 0]
    for r in range(1, k):
        acc = acc + per_pair[:, r]
    routed = x.new_zeros(x.shape[0], h).index_copy_(0, real, acc.to(x.dtype))
    return x + (routed + shared)


# (positions, real tokens, k, H): tiny()'s widths, the published k = 6 with
# padding, one real token, k = 1, a width that is not a multiple of 8
COMBINE_CASES = [(24, 16, TINY.experts_per_token, TINY.hidden_dim), (512, 300, 6, 64), (32, 1, 6, 64),
                 (16, 16, 1, 36), (40, 29, 6, 100)]


@pytest.mark.parametrize("p,n,k,h", COMBINE_CASES)
def test_combine_on_the_cpu_gives_the_parent_expressions_bits(p, n, k, h):
    out, order, weight, real, x, shared = combine_inputs(p, n, k, h, seed=p + n + k + h)
    launches = moe_combine.launches
    got = moe_combine(out, pair_rows(order), weight, position_slots(real, p), x, shared)
    assert moe_combine.launches == launches  # the CPU takes the plain version
    want = parent_combine(out, order, weight, real, x, shared)
    assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("p,n,k,h", COMBINE_CASES)
def test_combine_maps_place_what_index_copy_places(p, n, k, h):
    """``pair_rows(order)`` gathers what ``index_copy_(0, order, …)``
    scatters; ``position_slots`` puts each real token where
    ``index_copy_(0, real, …)`` does and -1 elsewhere."""
    out, order, _, real, _, _ = combine_inputs(p, n, k, h, seed=7 * p + n)
    src = pair_rows(order)
    assert src.dtype == torch.int32
    assert torch.equal(out.index_select(0, src), torch.empty_like(out).index_copy_(0, order, out))
    slot = position_slots(real, p)
    assert slot.dtype == torch.int32
    placed = torch.zeros(p, dtype=torch.int64).index_copy_(0, real, torch.arange(1, n + 1))
    assert torch.equal(torch.where(slot < 0, 0, slot + 1), placed)


def _stand_in(fn):
    """``fn`` in ``moe_combine``'s place, keeping the ``launches`` count that
    ``moe_mlp`` reads: the kernel launches made inside ``fn``."""
    def call(*args):
        before = moe_combine.launches
        got = fn(*args)
        call.launches += moe_combine.launches - before
        return got

    call.launches = 0
    return call


def _tiny_layer_inputs(tiny_params):
    ids = torch.from_numpy(token_ids(TINY, QUERIES))
    mask = ids != 0
    return dsv2.embed(tiny_params, ids), real_token_index(mask, int(mask.sum())), mask.numel()


def test_expert_layer_hands_the_combine_its_maps(tiny_params, monkeypatch):
    """``moe_mlp`` hands the combine the sorted rows' inverse and the
    position slots of ``real``; on the CPU nothing launches, so the span
    recorder counts no ``rag.encode.moe_combine``."""
    c, lp = TINY, tiny_params["layers"][1]
    x, real, positions = _tiny_layer_inputs(tiny_params)
    seen = []
    monkeypatch.setattr(dsv2, "moe_combine", _stand_in(lambda *a: seen.append(a) or moe_combine(*a)))
    with profiling.spans() as rec:
        moe_mlp(x, lp, c, real)
    assert len(seen) == 1 and "rag.encode.moe_combine" not in rec.counters
    out, src, weight, slot, _, _ = seen[0]
    assert torch.equal(slot, position_slots(real, positions))
    assert torch.equal(slot[real], torch.arange(real.numel(), dtype=torch.int32))
    assert sorted(src.tolist()) == list(range(out.shape[0])) and weight.shape == (real.numel(), c.experts_per_token)


def test_expert_layer_counts_the_kernels_launches_on_the_recorder(tiny_params, monkeypatch):
    """``rag.encode.moe_combine`` gains what ``moe_combine.launches``
    gained across the layer's call, and nothing while no recorder is on."""
    c, lp = TINY, tiny_params["layers"][1]
    x, real, _ = _tiny_layer_inputs(tiny_params)

    def launching(*args):  # a combine that reports one launch a call
        launching.launches += 1
        return moe_combine_reference(*args)

    launching.launches = 0
    monkeypatch.setattr(dsv2, "moe_combine", launching)
    moe_mlp(x, lp, c, real)  # no recorder on
    with profiling.spans() as rec:
        moe_mlp(moe_mlp(x, lp, c, real), lp, c, real)
    assert rec.counters["rag.encode.moe_combine"] == 2 and launching.launches == 3


@pytest.mark.parametrize("bad", ["weight_f16", "out_shape", "src_int64", "slot_shape", "shared_f32", "k0"])
def test_combine_refuses_what_the_kernel_does_not_take(bad):
    out, order, weight, real, x, shared = combine_inputs(16, 8, 2, 64, seed=1)
    src, slot = pair_rows(order), position_slots(real, 16)
    args = {"out": out, "src": src, "weight": weight, "slot": slot, "x": x, "shared": shared}
    args.update({"weight_f16": {"weight": weight.half()}, "out_shape": {"out": out[1:]},
                 "src_int64": {"src": src.long()}, "slot_shape": {"slot": slot[1:]},
                 "shared_f32": {"shared": shared.float()}, "k0": {"weight": weight[:, :0]}}[bad])
    with pytest.raises(InvalidConfigError):
        moe_combine(**args)


def test_combine_module_imports_without_a_card_or_a_build():
    root = pathlib.Path(__file__).resolve().parents[1]
    code = ("import torch\n"
            "import trueno_rag_tpu_torch.models.deepseek_v2, trueno_rag_tpu_torch.ops.kernels.moe_combine\n"
            "from trueno_rag_tpu_torch.ops.kernels import build\n"
            "assert build._fns is None and build.build_log == '' and not torch.cuda.is_initialized()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(root), env=dict(os.environ, PYTHONPATH=str(root)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


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


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16).cpu()


# (positions, real tokens, k, H, misalign): the cell's shape (8,192 positions,
# 6,134 real tokens, k 6, H 2,048), one real token in a padded batch, k = 1,
# tiny()'s widths, k past the kernel's 8 loads in flight, widths that are not
# a multiple of 8, and rows 8 bytes off 16-byte alignment (both one lane a
# thread)
CUDA_COMBINE_CASES = [(8192, 6134, 6, 2048, 0), (512, 1, 6, 2048, 0), (1024, 1024, 1, 2048, 0),
                      (1024, 700, 2, 64, 0), (256, 200, 9, 256, 0), (1024, 700, 6, 100, 0),
                      (512, 300, 6, 2047, 0), (1024, 700, 6, 2048, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,k,h,misalign", CUDA_COMBINE_CASES)
def test_cuda_combine_kernel_equals_its_plain_version_bit_for_bit(p, n, k, h, misalign):
    _need_card()
    out, order, weight, real, x, shared = combine_inputs(p, n, k, h, seed=p + n + k + h)
    want = moe_combine(out, pair_rows(order), weight, position_slots(real, p), x, shared)  # CPU: the plain version
    assert torch.equal(want.view(torch.int16), parent_combine(out, order, weight, real, x, shared).view(torch.int16))
    dev = [t.cuda() for t in (out, order, weight, real)]
    xs = []
    for t in (x, shared):  # `misalign` bf16 values into a buffer: the row starts lose 16-byte alignment
        buf = torch.empty(p * h + misalign, dtype=torch.bfloat16, device="cuda")
        xs.append(buf[misalign:].view(p, h).copy_(t))
    launches = moe_combine.launches
    got = moe_combine(dev[0], pair_rows(dev[1]), dev[2], position_slots(dev[3], p), *xs)
    torch.cuda.synchronize()
    assert moe_combine.launches == launches + 1
    assert torch.equal(_bits(got), want.view(torch.int16))


@pytest.mark.cuda
def test_cuda_lite_moe_layers_run_the_kernel_with_the_plain_versions_bits(lite_params, monkeypatch):
    """A forward of 256 queries, every expert busy: each of the 26 MoE
    layers launches the kernel once (``moe_combine.launches`` and the span
    recorder's ``rag.encode.moe_combine``), each launch equals the plain
    version on the same inputs bit for bit, and the embeddings equal the
    ``"bf16"`` reference with the same experts."""
    c = DeepseekV2Config.lite()
    ids = torch.from_numpy(token_ids(c, _card_queries(256, 3))).cuda()
    same = []

    def checked(*args):
        got = moe_combine(*args)
        same.append(torch.equal(got, moe_combine_reference(*args)))
        return got

    monkeypatch.setattr(dsv2, "moe_combine", _stand_in(checked))
    counts = torch.zeros(c.num_layers - c.first_k_dense, c.n_routed_experts, dtype=torch.int64, device="cuda")
    routes_port, routes_ref = [], []
    launches = moe_combine.launches
    with profiling.spans() as rec:
        got = deepseek_v2_forward(lite_params, ids, c, expert_counts=counts, routes=routes_port)
    torch.cuda.synchronize()
    assert moe_combine.launches - launches == 26 and rec.counters["rag.encode.moe_combine"] == 26
    assert same == [True] * 26
    assert int((counts > 0).sum(dim=1).min()) == 64  # every expert busy in every layer
    want = ref.pooled(lite_params, ids, hf_config(c), "bf16", routes_ref)
    for layer, (a, b) in enumerate(zip(routes_port, routes_ref)):
        assert torch.equal(a, b), f"MoE layer {layer + 1}: experts differ"
    assert torch.equal(got, unit(want)), (got - unit(want)).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [(1, 0, 0, 0), (5, 0, 3, 2)])
def test_cuda_lite_moe_layer_with_idle_experts_equals_its_plain_version(lite_params, monkeypatch, lengths):
    """One MoE layer at the published widths with experts that get no
    token: one real token in a padded batch of 4 x 32, and 10 real tokens
    in rows of 0-5 (60 pairs over 64 experts leave at least 4 idle). The
    kernel's layer equals the layer with the plain combine bit for bit."""
    c, lp = DeepseekV2Config.lite(), lite_params["layers"][1]
    t = 32
    mask = torch.arange(t, device="cuda")[None, :] < torch.tensor(lengths, device="cuda")[:, None]
    g = torch.Generator(device="cuda").manual_seed(len(lengths))
    x = (0.5 * torch.randn(len(lengths), t, c.hidden_dim, generator=g, device="cuda")).to(torch.bfloat16)
    real = real_token_index(mask, sum(lengths))
    counts = torch.zeros(c.n_routed_experts, dtype=torch.int64, device="cuda")
    got = moe_mlp(x, lp, c, real, counts)
    monkeypatch.setattr(dsv2, "moe_combine", _stand_in(moe_combine_reference))
    want = moe_mlp(x, lp, c, real)
    assert int((counts == 0).sum()) > 0 and int(counts.sum()) == c.experts_per_token * sum(lengths)
    assert torch.equal(_bits(got), _bits(want))
