"""The block-kernel scans of the bf16 and int8 tiers (``scan_kernel="block"``)
as CUDA kernels for Hopper, plus their plain PyTorch versions
(``csrc/scan_select_v1.cu``):

- ``scan_select``: the bf16 scan, counterpart of the Pallas TPU kernel
  ``trueno_rag_tpu/ops/pallas/scan_select.py::scan_select``. It scores
  ``f32(bf16 q · bf16 m)`` with f32 accumulation.
- ``scan_select_int8``: the int8 scan, counterpart of
  ``trueno_rag_tpu/ops/pallas/scan_select_int8.py::scan_select_int8``. It
  scores ``(f32(Σ q_i8·m_i8)·s_row)·t_q`` with an exact integer dot.

Both add the PER-ROW bound ``e_l2·u_q + a_l2·v_q`` (left to right), mask
invalid rows to -inf, and emit per 128-row block the top ``top+1`` upper
values and the top ``top`` lanes → ``(v1..v_{top+1} [B, N/128] f32,
i1..i_top [B, N/128] int32)``, lanes within the block. Each pass takes
the block max and the LARGEST lane holding it, whose entry then becomes
-inf (the Pallas kernels' ``max(where(x == v, lane, -1))``).

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to
the kernel, or the call raises. The kernels are built at first use by
:mod:`~trueno_rag_tpu_torch.ops.kernels.build`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.dense import require_fp32
from trueno_rag_tpu_torch.ops.kernels.build import entry

BLOCK = 128  # selection granularity (rows per block lane)
TOP = 4  # default candidate slots per block (+1 threshold value)
MAX_TOP = 8


def _check(q, m, dtype, vectors, tile_n: int, top: int) -> None:
    """Shapes, types and devices common to both scans."""
    if q.dim() != 2 or m.dim() != 2 or q.shape[1] != m.shape[1]:
        raise InvalidConfigError(f"need q [B, d] and m [N, d], got {tuple(q.shape)}, {tuple(m.shape)}")
    if q.dtype != dtype or m.dtype != dtype:
        raise InvalidConfigError(f"q and m must be {dtype} (got {q.dtype}, {m.dtype})")
    b, n = q.shape[0], m.shape[0]
    if b < 1 or q.shape[1] < 1:
        raise InvalidConfigError(f"need B >= 1 and d >= 1, got {tuple(q.shape)}")
    if tile_n < BLOCK or tile_n % BLOCK or n < tile_n or n % tile_n:
        raise InvalidConfigError(f"need tile_n a multiple of {BLOCK} and N a positive multiple of tile_n, "
                                 f"got tile_n={tile_n}, N={n}")
    if not 1 <= top <= MAX_TOP:
        raise InvalidConfigError(f"top must be in [1, {MAX_TOP}], got {top}")
    for name, t, dt, per_row in vectors:
        ln = n if per_row else b
        if t.dtype != dt or tuple(t.shape) != (ln,):
            raise InvalidConfigError(f"{name} must be {dt} [{ln}], got {t.dtype} {tuple(t.shape)}")
    devices = {t.device for t in [q, m] + [t for _, t, _, _ in vectors]}
    if len(devices) != 1:
        raise InvalidConfigError(f"all inputs must be on one device, got {sorted(map(str, devices))}")


def _launch(name: str, inputs, top: int) -> Tuple[torch.Tensor, ...]:
    """Allocate the outputs and launch entry point ``name`` on the current
    stream of the inputs' device; raises if the launch is refused."""
    dev = inputs[0].device
    if dev.type != "cuda":
        raise InvalidConfigError(f"{name[:-7]} runs on cpu or cuda tensors, got {dev}")
    if not all(t.is_contiguous() for t in inputs):
        raise InvalidConfigError(f"{name[:-7]} needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in inputs):
        raise InvalidConfigError(f"{name[:-7]}: every input must be 16-byte aligned")
    (b, d), n = inputs[0].shape, inputs[1].shape[0]
    v = torch.empty((top + 1, b, n // BLOCK), dtype=torch.float32, device=dev)
    lanes = torch.empty((top, b, n // BLOCK), dtype=torch.int32, device=dev)
    fn = entry(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in inputs), v.data_ptr(), lanes.data_ptr(), b, d, n, top, stream)
    if err != 0:
        raise RuntimeError(f"{name[:-7]} kernel launch failed: cudaError {err}")
    return tuple(v.unbind(0)) + tuple(lanes.unbind(0))


def _check_bf16(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_n, top) -> None:
    f32 = torch.float32
    _check(q_bf16, m_bf16, torch.bfloat16, [
        ("e_l2", e_l2, f32, True), ("a_l2", a_l2, f32, True),
        ("valid", valid_i32, torch.int32, True), ("u_q", u_q, f32, False), ("v_q", v_q, f32, False),
    ], tile_n, top)


def scan_select(
    q_bf16: torch.Tensor,  # [B, d] bf16 (pre-normalized for cosine)
    m_bf16: torch.Tensor,  # [N, d] bf16, N % tile_n == 0
    e_l2: torch.Tensor,  # [N] f32
    a_l2: torch.Tensor,  # [N] f32
    valid_i32: torch.Tensor,  # [N] int32 (0/1)
    u_q: torch.Tensor,  # [B] f32 — bound coefficient on e_l2
    v_q: torch.Tensor,  # [B] f32 — bound coefficient on a_l2
    tile_n: int = 1024,
    top: int = TOP,
) -> Tuple[torch.Tensor, ...]:
    """→ (v1..v_{top+1} [B, N/128] f32, i1..i_top [B, N/128] int32).

    ``tile_n`` is the JAX kernel's corpus tile, kept for its signature: it
    only has to divide N (the CUDA kernel walks 128-row blocks). CPU
    tensors run :func:`scan_select_reference`; CUDA tensors launch the
    kernel (counted in ``scan_select.launches``) or raise."""
    _check_bf16(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_n, top)
    if q_bf16.device.type == "cpu":
        return scan_select_reference(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_n, top)
    out = _launch("scan_select_v1_launch", (q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q), top)
    scan_select.launches += 1
    return out


scan_select.launches = 0


def _check_int8(q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q, tile_n, top) -> None:
    f32 = torch.float32
    _check(q_i8, m_i8, torch.int8, [
        ("s_row", s_row, f32, True), ("e_l2", e_l2, f32, True), ("a_l2", a_l2, f32, True),
        ("valid", valid_i32, torch.int32, True), ("t_q", t_q, f32, False),
        ("u_q", u_q, f32, False), ("v_q", v_q, f32, False),
    ], tile_n, top)
    if q_i8.shape[1] * 127 * 127 >= 1 << 24:
        raise InvalidConfigError("d*127^2 must stay below 2^24: the integer dot must stay exact in f32")


def scan_select_int8(
    q_i8: torch.Tensor,  # [B, d] int8 (symmetric amax/127 scale t_q)
    m_i8: torch.Tensor,  # [N, d] int8, N % tile_n == 0
    s_row: torch.Tensor,  # [N] f32 — row scales
    e_l2: torch.Tensor,  # [N] f32 — ‖row − s_i·row_i8‖₂
    a_l2: torch.Tensor,  # [N] f32 — ‖s_i·row_i8‖₂
    valid_i32: torch.Tensor,  # [N] int32 (0/1)
    t_q: torch.Tensor,  # [B] f32 — query scales
    u_q: torch.Tensor,  # [B] f32 — bound coefficient on e_l2
    v_q: torch.Tensor,  # [B] f32 — bound coefficient on a_l2
    tile_n: int = 1024,
    use_int8_mxu: bool = True,
    top: int = TOP,
) -> Tuple[torch.Tensor, ...]:
    """→ (v1..v_{top+1} [B, N/128] f32, i1..i_top [B, N/128] int32).

    ``use_int8_mxu`` is accepted for the JAX package's signature and has no
    effect: its two routes give the same exact integer dot (the JAX
    docstring), and the kernel accumulates in int32. CPU tensors run
    :func:`scan_select_int8_reference`; CUDA tensors launch the kernel
    (counted in ``scan_select_int8.launches``) or raise."""
    del use_int8_mxu
    _check_int8(q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q, tile_n, top)
    if q_i8.device.type == "cpu":
        return scan_select_int8_reference(q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q, tile_n, top)
    out = _launch("scan_select_int8_v1_launch", (q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q), top)
    scan_select_int8.launches += 1
    return out


scan_select_int8.launches = 0


def _select_blocks(s, e_l2, a_l2, valid_i32, u_q, v_q, top: int) -> Tuple[torch.Tensor, ...]:
    """The shared tail of both plain versions on raw scores ``s [N, B]``:
    the per-row bound added left to right, the mask, then the top+1
    passes per 128-row block (ties → the largest lane; a taken lane
    becomes -inf)."""
    neg_inf = float("-inf")
    upper = s + e_l2[:, None] * u_q[None, :]
    upper = upper + a_l2[:, None] * v_q[None, :]
    n, b = upper.shape
    x = torch.where(valid_i32[:, None] != 0, upper, neg_inf).view(n // BLOCK, BLOCK, b)
    lane = torch.arange(BLOCK, device=s.device, dtype=torch.int32)[None, :, None]
    vals, lanes = [], []
    for t in range(top + 1):
        v = x.amax(dim=1)  # [G, B]
        vals.append(v.T.contiguous())
        if t < top:
            amax = torch.where(x == v[:, None, :], lane, -1).amax(dim=1)
            lanes.append(amax.T.contiguous())
            x = torch.where(lane == amax[:, None, :], neg_inf, x)
    return tuple(vals) + tuple(lanes)


def scan_select_reference(
    q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_n: int = 1024, top: int = TOP
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the bf16 kernel, on any device: an f32
    matmul of the bf16 values (TF32 off), then :func:`_select_blocks`.
    Its values differ from the kernel's only by the f32 summation order."""
    _check_bf16(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_n, top)
    require_fp32()
    s = m_bf16.float() @ q_bf16.float().T  # [N, B]
    return _select_blocks(s, e_l2, a_l2, valid_i32, u_q, v_q, top)


def scan_select_int8_reference(
    q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q, tile_n: int = 1024, top: int = TOP
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the int8 kernel, on any device: an f32
    matmul of the int8 values, exact in any summation order because every
    partial sum is an integer below 2²⁴, the two scale multiplies in the
    kernel's order, then :func:`_select_blocks`. Its output equals the
    kernel's bit for bit."""
    _check_int8(q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q, tile_n, top)
    require_fp32()
    s = (m_i8.float() @ q_i8.float().T) * s_row[:, None] * t_q[None, :]  # [N, B]
    return _select_blocks(s, e_l2, a_l2, valid_i32, u_q, v_q, top)
