"""Masked causal attention for long contexts: the CUDA kernel
``block_attention`` (``csrc/block_attention.cu``) and its plain PyTorch
versions.

Counterpart of ``trueno_rag_tpu/ops/pallas/attention.py``. Shapes keep the
JAX layout: ``q, k, v [BH, T, hd]`` bf16 (heads folded into the leading
dim) and a boolean key mask. ``heads=h`` lets the mask be ``[BH / h, T]``
(one row per batch row, shared by its ``h`` heads) instead of the JAX
package's repeated ``[BH, T]`` (``heads=1``). The kernel never
materializes the ``[T, T]`` logits, so an 8192-token context fits.

A masked or causal-future key gets the logit -1e9 (not -inf), so a query
row with no kept key averages V over all T keys, as in JAX. Unlike the
Pallas kernel, any T is taken (the JAX wrapper asserts T % 128 == 0 past
T = 128).

Dispatch: a CPU tensor goes to :func:`block_attention_reference`; a CUDA
tensor launches the kernel (counted in ``block_attention.launches``) or
the call raises.
"""

from __future__ import annotations

import numpy as np
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.kernels.build import entry

MASKED = -1e9  # the JAX package's logit for a masked key
_PLAIN_ELEMS = 1 << 28  # logits per chunk of the plain version (1 GiB of f32)


def _check(q, k, v, key_mask, heads: int) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise InvalidConfigError(f"need q, k, v [BH, T, hd] alike, got {tuple(q.shape)}, "
                                 f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, t, hd = q.shape
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise InvalidConfigError(f"q, k, v must be bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd % 16 or not 16 <= hd <= 128:
        raise InvalidConfigError(f"hd must be a multiple of 16 in [16, 128], got {hd}")
    if heads < 1 or bh % heads:
        raise InvalidConfigError(f"heads={heads} must divide BH={bh}")
    if key_mask.dtype != torch.bool or tuple(key_mask.shape) != (bh // heads, t):
        raise InvalidConfigError(f"key_mask must be bool [{bh // heads}, {t}], got "
                                 f"{key_mask.dtype} {tuple(key_mask.shape)}")
    if t < 1 or -(-t // 64) > 65535:
        raise InvalidConfigError(f"T must be in [1, {65535 * 64}], got {t}")
    if len({x.device for x in (q, k, v, key_mask)}) != 1:
        raise InvalidConfigError("q, k, v and key_mask must be on one device")


def block_attention(
    q: torch.Tensor,  # [BH, T, hd] bf16
    k: torch.Tensor,  # [BH, T, hd] bf16
    v: torch.Tensor,  # [BH, T, hd] bf16
    key_mask: torch.Tensor,  # [BH / heads, T] bool — False for padding keys
    causal: bool = True,
    heads: int = 1,
) -> torch.Tensor:
    """→ ``[BH, T, hd]`` bf16: softmax(q·kᵀ·scale, masked) · v with the
    JAX recipe (``scale = f32(1/sqrt(hd))`` multiplied, fp32 softmax,
    probabilities rounded to bf16, f32-accumulated product)."""
    _check(q, k, v, key_mask, heads)
    if q.device.type == "cpu":
        return block_attention_reference(q, k, v, key_mask, causal, heads)
    if q.device.type != "cuda":
        raise InvalidConfigError(f"block_attention runs on cpu or cuda tensors, got {q.device}")
    q, k, v, key_mask = (x.contiguous() for x in (q, k, v, key_mask))
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise InvalidConfigError("block_attention: q, k and v must be 16-byte aligned")
    bh, t, hd = q.shape
    out = torch.empty_like(q)
    fn = entry("block_attention_launch")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), out.data_ptr(),
                 bh, t, hd, heads, int(causal), float(1.0 / np.sqrt(hd)), stream)
    if err != 0:
        raise RuntimeError(f"block_attention kernel launch failed: cudaError {err}")
    block_attention.launches += 1
    return out


block_attention.launches = 0


def _attention_plain(q, k, v, key_mask, causal: bool, heads: int, divide: bool) -> torch.Tensor:
    """Materialized attention in chunks of heads, on any device: f32 logits
    of the bf16 values, scaled (``divide``: by f32 sqrt(hd), else times
    f32(1/sqrt(hd))), masked to -1e9, softmax in f32, rounded to bf16, then
    an f32 product with v rounded to bf16."""
    bh, t, hd = q.shape
    out = torch.empty_like(q)
    step = max(1, _PLAIN_ELEMS // (t * t))
    pos = torch.arange(t, device=q.device)
    future = pos[None, :] > pos[:, None]  # [T, T]: key after query
    for lo in range(0, bh, step):
        hi = min(bh, lo + step)
        logits = torch.matmul(q[lo:hi].float(), k[lo:hi].float().transpose(1, 2))
        if divide:
            logits = logits / torch.tensor(np.sqrt(hd).astype(np.float32), device=q.device)
        else:
            logits = logits * torch.tensor(np.float32(1.0 / np.sqrt(hd)), device=q.device)
        drop = ~key_mask[torch.arange(lo, hi, device=q.device) // heads][:, None, :]
        if causal:
            drop = drop | future[None]
        logits = logits.masked_fill_(drop, MASKED)
        probs = torch.softmax(logits, dim=-1).to(torch.bfloat16)
        del logits, drop
        out[lo:hi] = torch.matmul(probs.float(), v[lo:hi].float()).to(torch.bfloat16)
    return out


def block_attention_reference(q, k, v, key_mask, causal: bool = True, heads: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the scale multiplied, as in
    ``attention.py::_attn_kernel``), on any device."""
    _check(q, k, v, key_mask, heads)
    return _attention_plain(q, k, v, key_mask, causal, heads, divide=False)


def attention_oracle(q, k, v, key_mask, causal: bool = True, heads: int = 1) -> torch.Tensor:
    """Counterpart of ``attention.py::attention_oracle``: the same recipe
    with the logits divided by ``sqrt(hd)``, as the models' materialized
    attention does."""
    _check(q, k, v, key_mask, heads)
    return _attention_plain(q, k, v, key_mask, causal, heads, divide=True)
