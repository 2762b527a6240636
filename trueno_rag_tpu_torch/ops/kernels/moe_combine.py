"""The expert layer's combine: the CUDA kernel ``moe_combine``
(``csrc/moe_combine.cu``) and its plain PyTorch version.

It replaces no TPU kernel (the JAX package has no expert layer). In a
DeepSeekMoE layer (``models/deepseek_v2.py::moe_mlp``) it takes the second
grouped product's rows in expert-sorted order and writes the new residual:
each real token's k expert outputs times their gates, summed in f32 in gate
order and rounded to bf16, plus the shared experts' output, plus the
residual. The kernel is bound by bytes; it reads each expert row, the
residual and the shared output once and writes the residual once, where the
plain version passes the pairs through device memory about ten times
(``csrc/moe_combine.cu`` has the numbers).

Dispatch: a CPU tensor goes to :func:`moe_combine_reference`; a CUDA tensor
launches the kernel (counted in ``moe_combine.launches``) or the call
raises.
"""

from __future__ import annotations

import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.kernels.build import entry


def pair_rows(order: torch.Tensor) -> torch.Tensor:
    """The inverse of the expert sort ``order [n·k]`` (sorted row → pair):
    for each pair ``token·k + rank``, the sorted row that holds it, int32."""
    n = order.numel()
    return torch.empty(n, dtype=torch.int32, device=order.device).index_copy_(
        0, order, torch.arange(n, dtype=torch.int32, device=order.device))


def position_slots(real: torch.Tensor, positions: int) -> torch.Tensor:
    """For each of ``positions`` flat positions, its index in ``real`` (the
    real tokens' positions), or -1 for padding; int32."""
    return torch.full((positions,), -1, dtype=torch.int32, device=real.device).index_copy_(
        0, real, torch.arange(real.numel(), dtype=torch.int32, device=real.device))


def _check(out, src, weight, slot, x, shared) -> None:
    if weight.dim() != 2 or weight.dtype != torch.float32:
        raise InvalidConfigError(f"weight must be f32 [n, k], got {weight.dtype} {tuple(weight.shape)}")
    n, k = weight.shape
    if x.dim() != 2 or x.shape != shared.shape or x.dtype != torch.bfloat16 or shared.dtype != torch.bfloat16:
        raise InvalidConfigError(f"x and shared must be bf16 [P, H] alike, got {x.dtype} {tuple(x.shape)}, "
                                 f"{shared.dtype} {tuple(shared.shape)}")
    p, h = x.shape
    if out.dtype != torch.bfloat16 or tuple(out.shape) != (n * k, h):
        raise InvalidConfigError(f"out must be bf16 [{n * k}, {h}], got {out.dtype} {tuple(out.shape)}")
    if src.dtype != torch.int32 or tuple(src.shape) != (n * k,):
        raise InvalidConfigError(f"src must be int32 [{n * k}], got {src.dtype} {tuple(src.shape)}")
    if slot.dtype != torch.int32 or tuple(slot.shape) != (p,):
        raise InvalidConfigError(f"slot must be int32 [{p}], got {slot.dtype} {tuple(slot.shape)}")
    if k < 1 or h < 1 or p >= 1 << 31:
        raise InvalidConfigError(f"need k >= 1, H >= 1 and fewer than 2**31 positions, got k={k}, H={h}, P={p}")
    if len({t.device for t in (out, src, weight, slot, x, shared)}) != 1:
        raise InvalidConfigError("out, src, weight, slot, x and shared must be on one device")


def moe_combine(
    out: torch.Tensor,  # [n·k, H] bf16: the expert outputs in expert-sorted order
    src: torch.Tensor,  # [n·k] int32: pair token·k + rank → its row of out (pair_rows)
    weight: torch.Tensor,  # [n, k] f32: each real token's gates, in gate order
    slot: torch.Tensor,  # [P] int32: position → real-token index, or -1 (position_slots)
    x: torch.Tensor,  # [P, H] bf16: the residual stream
    shared: torch.Tensor,  # [P, H] bf16: the shared experts' output
) -> torch.Tensor:
    """→ the new residual ``[P, H]`` bf16: ``x + (routed + shared)`` with
    ``routed`` each real token's ``Σ_r out[src[t·k + r]] · weight[t, r]``
    (f32, in rank order, rounded to bf16) and 0 at padding."""
    if x.device.type == "cpu":
        return moe_combine_reference(out, src, weight, slot, x, shared)
    _check(out, src, weight, slot, x, shared)
    if x.device.type != "cuda":
        raise InvalidConfigError(f"moe_combine runs on cpu or cuda tensors, got {x.device}")
    out, src, weight, slot, x, shared = (t.contiguous() for t in (out, src, weight, slot, x, shared))
    p, h = x.shape
    y = torch.empty_like(x)
    fn = entry("moe_combine_launch")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(out.data_ptr(), src.data_ptr(), weight.data_ptr(), slot.data_ptr(), x.data_ptr(),
                 shared.data_ptr(), y.data_ptr(), p, weight.shape[1], h, stream)
    if err != 0:
        raise RuntimeError(f"moe_combine kernel launch failed: cudaError {err}")
    moe_combine.launches += 1
    return y


moe_combine.launches = 0


def moe_combine_reference(out, src, weight, slot, x, shared) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the pairs
    gathered into token order, widened to f32 and weighted, summed rank by
    rank, rounded to bf16 and placed at the real positions (zero
    elsewhere), then the two bf16 adds."""
    _check(out, src, weight, slot, x, shared)
    n, k = weight.shape
    h = x.shape[1]
    per_pair = out.index_select(0, src).view(n, k, h).float() * weight[..., None]
    acc = per_pair[:, 0]
    for r in range(1, k):
        acc = acc + per_pair[:, r]
    routed = torch.cat([acc.to(x.dtype), x.new_zeros(1, h)]).index_select(0, torch.where(slot < 0, n, slot))
    return x + (routed + shared)
