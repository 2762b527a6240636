"""Plain BERT encoder (sentence-transformers/all-MiniLM-L6-v2's architecture:
post-LN blocks, learned positions, exact erf GELU, mean pooling), written
from the published equations in plain PyTorch.

``precision="bf16"`` is the arithmetic the configuration states: every
product of a weight matrix, and the attention-weighted sum of values,
takes bf16 inputs with f32 accumulation and a bf16 result; biases are
added in bf16; the embedding sum, layer norms, attention logits and
softmax are f32 (TF32 off). ``precision="fp8"`` is the control: the same
network with each of those bf16 products fed e4m3 inputs (one scale per
tensor, f32 accumulation) and the f32 logits taken in TF32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
MASKED = -1e9


@contextlib.contextmanager
def tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _fp8(x: torch.Tensor):
    """``x`` rounded to e4m3 under one scale → (values as f32, scale)."""
    scale = x.abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    return (x.float() / scale).to(torch.float8_e4m3fn).float(), scale


def _product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` of bf16 operands → bf16, in the given precision."""
    if precision == "bf16":
        return a @ b
    (qa, sa), (qb, sb) = _fp8(a), _fp8(b)
    with tf32(False):
        return ((qa @ qb) * (sa * sb)).to(torch.bfloat16)


def _norm(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mean) * torch.rsqrt(var + eps) * scale + bias).to(torch.bfloat16)


def _dense(x, w, b, precision):
    return _product(x, w.to(torch.bfloat16), precision) + b.to(torch.bfloat16)


@torch.no_grad()
def token_states(weights: dict, ids: torch.Tensor, cfg: dict, precision: str = "bf16"):
    """ids ``[B, T]`` (0 = padding) → (final token states ``[B, T, H]`` f32,
    mask ``[B, T]``)."""
    h, nh, eps = cfg["hidden_size"], cfg["num_attention_heads"], cfg["layer_norm_eps"]
    hd = h // nh
    b, t = ids.shape
    mask = ids != 0
    x = weights["tok_emb"][ids.long()] + weights["pos_emb"][:t][None]
    x = _norm(x.to(torch.bfloat16), weights["emb_ln_scale"], weights["emb_ln_bias"], eps)
    for lp in weights["layers"]:
        q, k, v = _dense(x, lp["qkv_w"], lp["qkv_b"], precision).split(h, dim=-1)
        q, k, v = (z.reshape(b, t, nh, hd).permute(0, 2, 1, 3) for z in (q, k, v))
        with tf32(precision != "bf16"):
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits / torch.tensor(math.sqrt(hd), dtype=torch.float32, device=logits.device)
        logits = logits.masked_fill(~mask[:, None, None, :], MASKED)
        probs = torch.softmax(logits, dim=-1).to(torch.bfloat16)
        ctx = _product(probs, v, precision).permute(0, 2, 1, 3).reshape(b, t, h)
        x = _norm(x + _dense(ctx, lp["attn_out_w"], lp["attn_out_b"], precision), lp["ln1_scale"],
                  lp["ln1_bias"], eps)
        mid = F.gelu(_dense(x, lp["mlp_w1"], lp["mlp_b1"], precision), approximate="none")
        x = _norm(x + _dense(mid, lp["mlp_w2"], lp["mlp_b2"], precision), lp["ln2_scale"], lp["ln2_bias"], eps)
    return x.float(), mask


def mean_pooled(states: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of the unmasked token states, unit length, in float64."""
    m = mask.double()[..., None]
    pooled = (states.double() * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp(min=1e-300)
