"""Plain DeepSeek-V2-Lite embedder, written from the DeepSeek-V2 paper's
equations (arXiv:2405.04434, §2.1 eqs. 9-19 without query compression,
§2.2 DeepSeekMoE) and the published ``config.json``, in plain PyTorch:
materialized attention, and the expert layer as a loop over the experts,
each applied to the tokens that chose it.

Per layer, on the residual stream ``h`` of one batch ``[B, T, H]``:

- MLA: ``q = RMS(h) W_Q`` split per head into ``q_nope`` (128) and
  ``q_rope`` (64); ``[c_kv | k_rope] = RMS(h) W_DKV`` (512 + 64, ``k_rope``
  shared by the heads); ``[k_nope | v] = RMS(c_kv) W_UKV`` per head (128 +
  128); RoPE on interleaved pairs of ``q_rope`` and ``k_rope`` at YaRN's
  frequencies; ``softmax(q·k · m²/sqrt(192))`` over the causal, unmasked
  keys; ``h += concat_heads(p·v) W_O``;
- layer 0: ``h += SwiGLU(RMS(h))`` of width 10,944;
- later layers: ``s = softmax(RMS(h) W_gate)``, the 6 largest (no
  renormalisation), ``h += Σ_i s_i · FFN_i(RMS(h)) + SwiGLU_shared(RMS(h))``,
  the sum over a token's experts in descending gate order, its routed
  experts computed for real tokens only (padding keys are masked and never
  pooled);
- the embedding: the last real token's state, the final RMSNorm, unit
  length.

Precisions:

- ``"bf16"``, what the configuration states: every product of a weight
  matrix, and the probabilities times the values, takes bf16 inputs with
  f32 accumulation and a bf16 result; RMSNorm, the attention logits, the
  router's product and both softmaxes are f32 (TF32 off); the weighted
  expert sum is f32, rounded to bf16 once;
- ``"fp8"``, the control one precision below: each of those bf16 products
  fed e4m3 inputs (one scale per tensor, f32 accumulation), the f32 logits
  and the router's product in TF32;
- ``"f32"``: float32 throughout, TF32 off (the CPU tests' sanity bound).

The weights are a dict in the layout the benchmark draws
(``benchmark/systems/deepseek_v2.py``): matrices ``[in, out]``, the routed
experts stacked ``[E, …]`` with each expert's ``[gate | up]`` packed.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from benchmark.reference import scores as ref_scores
from benchmark.reference import tokenizer as ref_tokenizer
from benchmark.reference.encoder import _fp8

MASKED = -1e9


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class _Arith:
    """The products and the activation dtype of one precision."""

    def __init__(self, precision: str):
        if precision not in ("bf16", "fp8", "f32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.dtype = torch.float32 if precision == "f32" else torch.bfloat16

    def product(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """A product of activations and a weight matrix (or of the
        probabilities and the values)."""
        if self.precision == "bf16":
            return a @ w
        if self.precision == "f32":
            with _tf32(False):
                return a.float() @ w.float()
        (qa, sa), (qw, sw) = _fp8(a), _fp8(w)
        with _tf32(False):
            return ((qa @ qw) * (sa * sw)).to(torch.bfloat16)

    def f32_product(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The attention logits and the router: f32, TF32 in the control."""
        with _tf32(self.precision == "fp8"):
            return a.float() @ b.float()


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float, dtype) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps) * scale).to(dtype)


def yarn(cfg: dict, device):
    """YaRN's rotary inverse frequencies ``[d/2]`` (f32) and the softmax scale."""
    rs, d, base = cfg["rope_scaling"], cfg["qk_rope_head_dim"], cfg["rope_theta"]

    def correction_dim(rotations):
        return d * math.log(rs["original_max_position_embeddings"] / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rs["beta_slow"])), d - 1)
    pos = base ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)
    extra, inter = 1.0 / pos, 1.0 / (rs["factor"] * pos)
    keep = 1.0 - torch.clamp((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
                             / (high - low if high != low else 0.001), 0, 1)
    m = 0.1 * rs["mscale_all_dim"] * math.log(rs["factor"]) + 1.0
    qk = cfg["qk_nope_head_dim"] + d
    return inter * (1 - keep) + extra * keep, qk ** -0.5 * m * m


def rope(x: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved pairs (x[2i], x[2i+1]) of ``[..., T, d]`` by
    ``pos · inv_freq[i]``, in f32."""
    t = x.shape[-2]
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv_freq[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    even, odd = x[..., 0::2].float(), x[..., 1::2].float()
    return torch.stack([even * cos - odd * sin, odd * cos + even * sin], dim=-1).reshape(x.shape).to(x.dtype)


def attention(h, mask, lp, cfg, ar: _Arith, inv_freq, scale):
    b, t, _ = h.shape
    nh, dn, dr, dv = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    x = rms(h, lp["attn_norm"], cfg["rms_norm_eps"], ar.dtype)
    q = ar.product(x, lp["q_w"]).view(b, t, nh, dn + dr).transpose(1, 2)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    latent = ar.product(x, lp["kv_a_w"])
    c_kv, k_rope = latent[..., :cfg["kv_lora_rank"]], latent[..., cfg["kv_lora_rank"]:]
    kv = ar.product(rms(c_kv, lp["kv_a_norm"], cfg["rms_norm_eps"], ar.dtype), lp["kv_b_w"])
    kv = kv.view(b, t, nh, dn + dv).transpose(1, 2)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, rope(q_rope, inv_freq)], dim=-1)
    k = torch.cat([k_nope, rope(k_rope.view(b, 1, t, dr), inv_freq).expand(b, nh, t, dr)], dim=-1)
    logits = ar.f32_product(q, k.transpose(-1, -2)) * scale
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    logits = logits.masked_fill(~(causal[None, None] & mask[:, None, None, :]), MASKED)
    p = torch.softmax(logits, dim=-1).to(ar.dtype)
    out = ar.product(p, v).transpose(1, 2).reshape(b, t, nh * dv)
    return h + ar.product(out, lp["o_w"])


def swiglu(x, gate_w, up_w, down_w, ar: _Arith):
    return ar.product(F.silu(ar.product(x, gate_w)) * ar.product(x, up_w), down_w)


def experts(h, mask, lp, cfg, ar: _Arith, routes=None):
    """The DeepSeekMoE sublayer, one expert at a time."""
    b, t, hid = h.shape
    k, m, n_exp = cfg["num_experts_per_tok"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    x = rms(h, lp["mlp_norm"], cfg["rms_norm_eps"], ar.dtype)
    s = torch.softmax(ar.f32_product(x, lp["router_w"]), dim=-1).view(b * t, n_exp)
    gate, chosen = torch.topk(s, k, dim=-1)
    real = mask.reshape(-1).nonzero().squeeze(1)
    gate, chosen = gate[real] * cfg["routed_scaling_factor"], chosen[real]
    if routes is not None:
        routes.append(chosen)
    flat = x.reshape(b * t, hid)
    y = torch.zeros(real.numel(), k, hid, dtype=ar.dtype, device=h.device)
    for e in range(n_exp):
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        if tok.numel():
            gu = ar.product(flat[real[tok]], lp["experts_w13"][e])
            y[tok, slot] = ar.product(F.silu(gu[:, :m]) * gu[:, m:], lp["experts_w2"][e])
    acc = y[:, 0].float() * gate[:, 0:1]
    for i in range(1, k):
        acc = acc + y[:, i].float() * gate[:, i:i + 1]
    routed = torch.zeros(b * t, hid, dtype=ar.dtype, device=h.device)
    routed[real] = acc.to(ar.dtype)
    shared = swiglu(x, lp["gate_w"], lp["up_w"], lp["down_w"], ar)
    return h + (routed.view(b, t, hid) + shared)


@torch.no_grad()
def pooled(weights: dict, ids: torch.Tensor, cfg: dict, precision: str = "bf16", routes=None) -> torch.Tensor:
    """ids ``[B, T]`` (0 = padding, real tokens first) → the last real
    token's final-normed state ``[B, H]`` in f32; ``routes`` gains each MoE
    layer's experts of the real tokens ``[n, k]``."""
    ar = _Arith(precision)
    mask = ids != 0
    inv_freq, scale = yarn(cfg, ids.device)
    h = weights["tok_emb"][ids.long()].to(ar.dtype)
    for i, lp in enumerate(weights["layers"]):
        h = attention(h, mask, lp, cfg, ar, inv_freq, scale)
        if i < cfg["first_k_dense_replace"]:
            x = rms(h, lp["mlp_norm"], cfg["rms_norm_eps"], ar.dtype)
            h = h + swiglu(x, lp["gate_w"], lp["up_w"], lp["down_w"], ar)
        else:
            h = experts(h, mask, lp, cfg, ar, routes)
    last = (mask.sum(dim=1) - 1).clamp(min=0)
    return rms(h[torch.arange(h.shape[0], device=h.device), last], weights["final_norm"], cfg["rms_norm_eps"],
               ar.dtype).float()


def encode(cfg: dict, queries) -> torch.Tensor:
    """The configuration's prefixed queries as the reference tokenizer's ids."""
    return torch.from_numpy(ref_tokenizer.encode([cfg["query_prefix"] + q for q in queries], cfg["vocab_size"],
                                                 cfg["tokenizer_max_len"]))


def scores(cfg: dict, weights: dict, queries, seed: int, device, precision: str) -> torch.Tensor:
    """The reference's (``"bf16"`` or ``"f32"``, scores in float64) or the
    control's (``"fp8"``, float32) cosine of ``queries`` with the whole
    corpus → ``[B, N]``."""
    q = pooled(weights, encode(cfg, queries).to(device), cfg, precision)[: len(queries)]
    dtype = torch.float32 if precision == "fp8" else torch.float64
    return ref_scores.cosine_all(q, cfg["corpus"]["chunks"], cfg["hidden_size"], seed, cfg["corpus"]["row_slab"],
                                 dtype)
