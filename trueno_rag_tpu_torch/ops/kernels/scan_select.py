"""The certified tile scans as CUDA kernels for Hopper, plus their plain
PyTorch versions:

- ``scan_select_v3`` (``csrc/scan_select_v3.cu``): the bf16 scan,
  counterpart of the Pallas TPU kernel
  ``trueno_rag_tpu/ops/pallas/scan_select_v2.py::scan_select_v3``. It
  scores ``bf16(m)·bf16(q)`` in f32.
- ``scan_select_v3_indirect`` (the same source, a second entry point):
  the bf16 scan over only a listed set of corpus tiles, read in place —
  the cluster-pruned tier's selective fetch, counterpart of
  ``scan_select_v2.py::scan_select_v3_indirect``.
- ``scan_select_int8_v3`` (``csrc/scan_select_int8_v3.cu``): the int8
  scan, counterpart of ``scan_select_v2.py::scan_select_int8_v3``. It
  scores ``(f32(Σ q_i8·m_i8)·s_row)·t_q`` with an exact integer dot.
- ``scan_select_v2``, ``scan_select_v2_indirect`` and
  ``scan_select_int8_v2`` (the same two sources, three more entry
  points): the v2 siblings of the three, counterparts of the Pallas
  kernels of the same names in ``scan_select_v2.py``.

The v3 scans keep each 128-row block's top-2 raw scores (with global
rows) and third value, add the block's bound correction
``max_blk(e_l2)·u_q + max_blk(a_l2)·v_q``, and run a tournament over the
tile's 16 block candidates → ``v_pack [B, T+1, N/1024]`` (values, then
the tile threshold) and ``r_pack [B, T, N/1024]`` (global rows). The v2
scans add each row's own bound first, ``upper = (s + e_l2·u_q) +
a_l2·v_q``, and select on those upper bounds with nothing added after:
the same packs, tighter by the spread of the norms within a block. With
``tags=(tag_bits [N], t_all [B], t_any [B], t_none [B])`` (int32), a row
that fails the query's tag predicate (``ops/tags.py::tag_pred``) scores
-inf before selection, like an invalid row.

The bf16-query scans (v3, v3 indirect, v2, v2 indirect) take the corpus
``m`` as bf16 (the replica layout) or as f32 (the inline-cast layout: the
kernel rounds each value to bf16 as it stages it, the same
round-to-nearest-even as ``prepare_tiered``, so the packs are
bit-identical to a run over the replica).

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to
the kernel, or the call raises. The kernels are built at first use by
:mod:`~trueno_rag_tpu_torch.ops.kernels.build`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.kernels.build import entry
from trueno_rag_tpu_torch.ops.tags import tag_pred

BLOCK = 128  # rows per bound block
SEL = 1024  # rows per selection tile (one emitted candidate set)
TILE_T = 8  # default candidates kept per tile
MAX_T_TOP = 2 * (SEL // BLOCK)  # the tournament pool: 16 slots


def block_bound_maxes(e_l2: torch.Tensor, a_l2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-128-row-block maxes of the bound norms ([N] → [N/128]); both
    the kernels and the plain versions take the bound at block
    granularity."""
    return (
        e_l2.view(-1, BLOCK).amax(dim=1).contiguous(),
        a_l2.view(-1, BLOCK).amax(dim=1).contiguous(),
    )


def _check_vectors(named: Sequence[Tuple[str, torch.Tensor, torch.dtype, int]]) -> None:
    for name, t, dt, ln in named:
        if t.dtype != dt or tuple(t.shape) != (ln,):
            raise InvalidConfigError(f"{name} must be {dt} [{ln}], got {t.dtype} {tuple(t.shape)}")


def _check(q, m, dtype, vectors, tags, t_top, m_dtypes=None) -> None:
    """Shapes, types and devices common to the scans (any width d >= 1:
    the kernels read a width that is not a multiple of their 16-byte
    vector through ``csrc/row_load.cuh``). ``m_dtypes``: the corpus types
    taken, ``(dtype,)`` by default."""
    if q.dim() != 2 or m.dim() != 2 or q.shape[1] != m.shape[1]:
        raise InvalidConfigError(f"need q [B, d] and m [N, d], got {tuple(q.shape)}, {tuple(m.shape)}")
    b, d = q.shape
    n = m.shape[0]
    m_dtypes = m_dtypes or (dtype,)
    if q.dtype != dtype or m.dtype not in m_dtypes:
        raise InvalidConfigError(f"q must be {dtype} and m one of {m_dtypes} (got {q.dtype}, {m.dtype})")
    if b < 1 or n < SEL or n % SEL:
        raise InvalidConfigError(f"need B >= 1 and N a positive multiple of {SEL}, got B={b}, N={n}")
    if d < 1:
        raise InvalidConfigError(f"d must be positive, got {d}")
    named = [(name, t, dt, n if per_row else b) for name, t, dt, per_row in vectors]
    if tags is not None:
        if len(tags) != 4:
            raise InvalidConfigError("tags must be (tag_bits, t_all, t_any, t_none)")
        named += [
            (name, t, torch.int32, n if name == "tag_bits" else b)
            for name, t in zip(("tag_bits", "t_all", "t_any", "t_none"), tags)
        ]
    _check_vectors(named)
    if not 1 <= t_top <= MAX_T_TOP:
        raise InvalidConfigError(f"t_top must be in [1, {MAX_T_TOP}], got {t_top}")
    devices = {t.device for t in [q, m] + [t for _, t, _, _ in named]}
    if len(devices) != 1:
        raise InvalidConfigError(f"all inputs must be on one device, got {sorted(map(str, devices))}")


def _launch(name: str, inputs, aligned, tags, g_out: int, t_top: int, ints):
    """Allocate the packs (``g_out`` selection-tile columns) and launch
    entry point ``name`` on the current stream of the inputs' device with
    the trailing int arguments ``ints``; raises if the launch is refused."""
    dev = inputs[0].device
    if dev.type != "cuda":
        raise InvalidConfigError(f"{name[:-7]} runs on cpu or cuda tensors, got {dev}")
    tag_list = list(tags) if tags is not None else []
    if not all(t.is_contiguous() for t in list(inputs) + tag_list):
        raise InvalidConfigError(f"{name[:-7]} needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in list(aligned) + tag_list[:1]):
        raise InvalidConfigError(f"{name[:-7]}: q, m and the per-row arrays must be 16-byte aligned")
    fn = entry(name)
    b = inputs[0].shape[0]
    v_pack = torch.empty((b, t_top + 1, g_out), dtype=torch.float32, device=dev)
    r_pack = torch.empty((b, t_top, g_out), dtype=torch.int32, device=dev)
    tag_ptrs = [t.data_ptr() for t in tag_list] or [None] * 4
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            *(t.data_ptr() for t in inputs), *tag_ptrs,
            v_pack.data_ptr(), r_pack.data_ptr(), *ints, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name[:-7]} kernel launch failed: cudaError {err}")
    return v_pack, r_pack


def _tile_n_ok(n: int, tile_n: int) -> None:
    """The JAX signature's corpus tile: a multiple of 1024 dividing N."""
    if tile_n < SEL or tile_n % SEL or n % tile_n:
        raise InvalidConfigError(f"tile_n must be a multiple of {SEL} dividing N={n}, got {tile_n}")


def _launch_bf16(name, per_row, q_bf16, m, e_l2, a_l2, valid_i32, u_q, v_q, t_top, tags):
    """Launch the direct bf16-query scan ``name`` (v3: block maxes of the
    norms; v2: the per-row norms, read as float4 rows)."""
    b, d = q_bf16.shape
    n = m.shape[0]
    e, a = (e_l2, a_l2) if per_row else block_bound_maxes(e_l2, a_l2)
    aligned = (q_bf16, m, valid_i32) + ((e_l2, a_l2) if per_row else ())
    return _launch(
        name, (q_bf16, m, e, a, valid_i32, u_q, v_q), aligned, tags, n // SEL, t_top,
        (b, d, n, t_top, int(m.dtype == torch.float32)),
    )


def _launch_bf16_indirect(name, per_row, q_bf16, m, e_l2, a_l2, valid_i32, u_q, v_q, tile_ids,
                          tile_n, t_top, tags):
    """Launch the tile-indirect bf16-query scan ``name``."""
    b, d = q_bf16.shape
    n = m.shape[0]
    g = tile_ids.shape[0]
    e, a = (e_l2, a_l2) if per_row else block_bound_maxes(e_l2, a_l2)
    aligned = (q_bf16, m, valid_i32) + ((e_l2, a_l2) if per_row else ())
    return _launch(
        name, (q_bf16, m, e, a, valid_i32, u_q, v_q, tile_ids), aligned, tags,
        g * (tile_n // SEL), t_top, (b, d, n, t_top, tile_n, g, int(m.dtype == torch.float32)),
    )


def scan_select_v3(
    q_bf16: torch.Tensor,  # [B, d] bf16 (pre-normalized for cosine)
    m_bf16: torch.Tensor,  # [N, d] bf16 — or f32 (inline-cast layout); N a multiple of 1024
    e_l2: torch.Tensor,  # [N] f32 — ‖row − bf16(row)‖₂
    a_l2: torch.Tensor,  # [N] f32 — ‖bf16(row)‖₂
    valid_i32: torch.Tensor,  # [N] int32 (0/1)
    u_q: torch.Tensor,  # [B] f32, >= 0 — bound coefficient on e_l2
    v_q: torch.Tensor,  # [B] f32, >= 0 — bound coefficient on a_l2
    t_top: int = TILE_T,
    tags: Optional[Tuple[torch.Tensor, ...]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (v_pack [B, T+1, N/1024] f32, r_pack [B, T, N/1024] int32).

    CPU tensors run :func:`scan_select_v3_reference`; CUDA tensors launch
    the kernel (counted in ``scan_select_v3.launches``) or raise."""
    _check_v3(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, t_top, tags)
    if q_bf16.device.type == "cpu":
        return scan_select_v3_reference(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, t_top, tags)
    out = _launch_bf16("scan_select_v3_launch", False, q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q,
                       t_top, tags)
    scan_select_v3.launches += 1
    return out


scan_select_v3.launches = 0


def scan_select_v2(
    q_bf16: torch.Tensor,  # [B, d] bf16 (pre-normalized for cosine)
    m_bf16: torch.Tensor,  # [N, d] bf16 — or f32 (inline-cast layout); N a multiple of tile_n
    e_l2: torch.Tensor,  # [N] f32
    a_l2: torch.Tensor,  # [N] f32
    valid_i32: torch.Tensor,  # [N] int32 (0/1)
    u_q: torch.Tensor,  # [B] f32 — bound coefficient on e_l2
    v_q: torch.Tensor,  # [B] f32 — bound coefficient on a_l2
    tile_n: int = 2048,
    t_top: int = TILE_T,
    tags: Optional[Tuple[torch.Tensor, ...]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The v2 bf16 scan with the per-row bound → (v_pack [B, T+1, N/1024]
    f32, r_pack [B, T, N/1024] int32); counterpart of
    ``scan_select_v2.py::scan_select_v2``. ``tile_n`` (a multiple of 1024
    dividing N) is the JAX kernel's grid step; it does not change the
    packs.

    CPU tensors run :func:`scan_select_v2_reference`; CUDA tensors launch
    the kernel (counted in ``scan_select_v2.launches``) or raise."""
    _check_v3(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, t_top, tags)
    _tile_n_ok(m_bf16.shape[0], tile_n)
    if q_bf16.device.type == "cpu":
        return scan_select_v2_reference(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, t_top, tags)
    out = _launch_bf16("scan_select_v2_launch", True, q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q,
                       t_top, tags)
    scan_select_v2.launches += 1
    return out


scan_select_v2.launches = 0


def scan_select_v3_indirect(
    q_bf16: torch.Tensor,  # [B, d] bf16 (pre-normalized for cosine)
    m_bf16: torch.Tensor,  # [N, d] bf16 — or f32 (inline-cast layout); N a multiple of tile_n
    e_l2: torch.Tensor,  # [N] f32
    a_l2: torch.Tensor,  # [N] f32
    valid_i32: torch.Tensor,  # [N] int32 (0/1)
    u_q: torch.Tensor,  # [B] f32, >= 0
    v_q: torch.Tensor,  # [B] f32, >= 0
    tile_ids: torch.Tensor,  # [G] int32 — corpus tiles to scan; >= N/tile_n pads
    tile_n: int = 2048,
    t_top: int = TILE_T,
    tags: Optional[Tuple[torch.Tensor, ...]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 scan over only the ``G`` corpus tiles of ``tile_n`` rows
    listed in ``tile_ids``, read in place → (v_pack [B, T+1, G·tile_n/1024]
    f32, r_pack [B, T, G·tile_n/1024] int32 GLOBAL rows). Counterpart of
    ``scan_select_v2.py::scan_select_v3_indirect``: output column j covers
    part j mod (tile_n/1024) of tile ``tile_ids[j // (tile_n/1024)]``; a
    pad slot scores -inf everywhere and emits rows from its unclamped id,
    which the tail's sentinel handling drops. The bound corrections use
    the whole corpus's block maxes.

    CPU tensors run :func:`scan_select_v3_indirect_reference`; CUDA tensors
    launch the kernel (counted in ``scan_select_v3_indirect.launches``) or
    raise."""
    _check_indirect(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_ids, tile_n, t_top, tags)
    if q_bf16.device.type == "cpu":
        return scan_select_v3_indirect_reference(
            q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_ids, tile_n, t_top, tags
        )
    out = _launch_bf16_indirect("scan_select_v3_indirect_launch", False, q_bf16, m_bf16, e_l2, a_l2,
                                valid_i32, u_q, v_q, tile_ids, tile_n, t_top, tags)
    scan_select_v3_indirect.launches += 1
    return out


scan_select_v3_indirect.launches = 0


def scan_select_v2_indirect(
    q_bf16: torch.Tensor,  # [B, d] bf16 (pre-normalized for cosine)
    m_bf16: torch.Tensor,  # [N, d] bf16 — or f32 (inline-cast layout); N a multiple of tile_n
    e_l2: torch.Tensor,  # [N] f32
    a_l2: torch.Tensor,  # [N] f32
    valid_i32: torch.Tensor,  # [N] int32 (0/1)
    u_q: torch.Tensor,  # [B] f32
    v_q: torch.Tensor,  # [B] f32
    tile_ids: torch.Tensor,  # [G] int32 — corpus tiles to scan; >= N/tile_n pads
    tile_n: int = 2048,
    t_top: int = TILE_T,
    tags: Optional[Tuple[torch.Tensor, ...]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`scan_select_v2` over only the listed tiles, read in place —
    the packs and pad rules of :func:`scan_select_v3_indirect` with the
    per-row bound; counterpart of ``scan_select_v2.py::scan_select_v2_indirect``.

    CPU tensors run :func:`scan_select_v2_indirect_reference`; CUDA tensors
    launch the kernel (counted in ``scan_select_v2_indirect.launches``) or
    raise."""
    _check_indirect(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_ids, tile_n, t_top, tags)
    if q_bf16.device.type == "cpu":
        return scan_select_v2_indirect_reference(
            q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_ids, tile_n, t_top, tags
        )
    out = _launch_bf16_indirect("scan_select_v2_indirect_launch", True, q_bf16, m_bf16, e_l2, a_l2,
                                valid_i32, u_q, v_q, tile_ids, tile_n, t_top, tags)
    scan_select_v2_indirect.launches += 1
    return out


scan_select_v2_indirect.launches = 0


def _check_indirect(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_ids, tile_n, t_top, tags):
    _check_v3(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, t_top, tags)
    _tile_n_ok(m_bf16.shape[0], tile_n)
    if tile_ids.dtype != torch.int32 or tile_ids.dim() != 1 or tile_ids.shape[0] < 1:
        raise InvalidConfigError(f"tile_ids must be a non-empty int32 vector, got {tile_ids.dtype} "
                                 f"{tuple(tile_ids.shape)}")
    if tile_ids.shape[0] * (tile_n // SEL) > 65535:
        raise InvalidConfigError("at most 65,535 selection tiles per call")
    if tile_ids.device != q_bf16.device:
        raise InvalidConfigError("tile_ids must be on the inputs' device")


def _check_v3(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, t_top, tags) -> None:
    """The bf16-query scans' checks: the corpus bf16 (replica) or f32
    (inline-cast)."""
    f32 = torch.float32
    _check(q_bf16, m_bf16, torch.bfloat16, [
        ("e_l2", e_l2, f32, True), ("a_l2", a_l2, f32, True),
        ("valid", valid_i32, torch.int32, True), ("u_q", u_q, f32, False),
        ("v_q", v_q, f32, False),
    ], tags, t_top, m_dtypes=(torch.bfloat16, f32))


def scan_select_int8_v3(
    q_i8: torch.Tensor,  # [B, d] int8 (symmetric amax/127 scale t_q)
    m_i8: torch.Tensor,  # [N, d] int8, N a multiple of 1024
    s_row: torch.Tensor,  # [N] f32 — row scales
    e_l2: torch.Tensor,  # [N] f32 — ‖row − s_i·row_i8‖₂
    a_l2: torch.Tensor,  # [N] f32 — ‖s_i·row_i8‖₂
    valid_i32: torch.Tensor,  # [N] int32 (0/1)
    t_q: torch.Tensor,  # [B] f32 — query scales
    u_q: torch.Tensor,  # [B] f32, >= 0 — bound coefficient on e_l2
    v_q: torch.Tensor,  # [B] f32, >= 0 — bound coefficient on a_l2
    t_top: int = TILE_T,
    tags: Optional[Tuple[torch.Tensor, ...]] = None,
    use_int8_mxu: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (v_pack [B, T+1, N/1024] f32, r_pack [B, T, N/1024] int32).

    ``use_int8_mxu`` is accepted for the JAX package's signature and
    ignored: its two branches (an int32 dot, or a bf16 dot with f32
    accumulation) give the same exact integer dot, because int8 values
    are exact in bf16 and every partial sum stays below 2²⁴; the kernel
    always accumulates in int32.

    CPU tensors run :func:`scan_select_int8_v3_reference`; CUDA tensors
    launch the kernel (counted in ``scan_select_int8_v3.launches``) or
    raise."""
    del use_int8_mxu
    _check_int8(q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q, t_top, tags)
    if q_i8.device.type == "cpu":
        return scan_select_int8_v3_reference(
            q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q, t_top, tags
        )
    b, d = q_i8.shape
    n = m_i8.shape[0]
    eb, ab = block_bound_maxes(e_l2, a_l2)
    out = _launch(
        "scan_select_int8_v3_launch", (q_i8, m_i8, s_row, eb, ab, valid_i32, t_q, u_q, v_q),
        (q_i8, m_i8, s_row, valid_i32), tags, n // SEL, t_top, (b, d, n, t_top),
    )
    scan_select_int8_v3.launches += 1
    return out


scan_select_int8_v3.launches = 0


def scan_select_int8_v2(
    q_i8: torch.Tensor,  # [B, d] int8 (symmetric amax/127 scale t_q)
    m_i8: torch.Tensor,  # [N, d] int8, N a multiple of tile_n
    s_row: torch.Tensor,  # [N] f32 — row scales
    e_l2: torch.Tensor,  # [N] f32 — ‖row − s_i·row_i8‖₂
    a_l2: torch.Tensor,  # [N] f32 — ‖s_i·row_i8‖₂
    valid_i32: torch.Tensor,  # [N] int32 (0/1)
    t_q: torch.Tensor,  # [B] f32 — query scales
    u_q: torch.Tensor,  # [B] f32 — bound coefficient on e_l2
    v_q: torch.Tensor,  # [B] f32 — bound coefficient on a_l2
    tile_n: int = 2048,
    t_top: int = TILE_T,
    use_int8_mxu: bool = True,
    tags: Optional[Tuple[torch.Tensor, ...]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The v2 int8 scan with the per-row bound, ``upper = (((dot·s_row)·t_q)
    + e_l2·u_q) + a_l2·v_q`` → the packs of :func:`scan_select_int8_v3`;
    counterpart of ``scan_select_v2.py::scan_select_int8_v2``. ``tile_n`` is
    the JAX kernel's grid step (it does not change the packs) and
    ``use_int8_mxu`` is ignored, as in :func:`scan_select_int8_v3`.

    CPU tensors run :func:`scan_select_int8_v2_reference`; CUDA tensors
    launch the kernel (counted in ``scan_select_int8_v2.launches``) or
    raise. The kernel is bit-identical to the plain version."""
    del use_int8_mxu
    _check_int8(q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q, t_top, tags)
    _tile_n_ok(m_i8.shape[0], tile_n)
    if q_i8.device.type == "cpu":
        return scan_select_int8_v2_reference(
            q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q, t_top, tags
        )
    b, d = q_i8.shape
    n = m_i8.shape[0]
    out = _launch(
        "scan_select_int8_v2_launch", (q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q),
        (q_i8, m_i8, s_row, e_l2, a_l2, valid_i32), tags, n // SEL, t_top, (b, d, n, t_top),
    )
    scan_select_int8_v2.launches += 1
    return out


scan_select_int8_v2.launches = 0


def _check_int8(q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q, t_top, tags) -> None:
    f32 = torch.float32
    _check(q_i8, m_i8, torch.int8, [
        ("s_row", s_row, f32, True), ("e_l2", e_l2, f32, True), ("a_l2", a_l2, f32, True),
        ("valid", valid_i32, torch.int32, True), ("t_q", t_q, f32, False),
        ("u_q", u_q, f32, False), ("v_q", v_q, f32, False),
    ], tags, t_top)
    if q_i8.shape[1] * 127 * 127 >= 1 << 24:
        raise InvalidConfigError("d*127^2 must stay below 2^24: the integer dot must stay exact in f32")


def _mask(s: torch.Tensor, valid_i32: torch.Tensor, tags) -> torch.Tensor:
    """-inf on invalid rows and on (row, query) pairs failing the filter."""
    keep = valid_i32[:, None] != 0
    if tags is not None:
        tag_bits, t_all, t_any, t_none = tags
        keep = keep & tag_pred(tag_bits[:, None], t_all[None, :], t_any[None, :], t_none[None, :])
    return torch.where(keep, s, float("-inf"))


def _block_corr(e_l2, a_l2, u_q, v_q) -> torch.Tensor:
    """The v3 bound correction per 128-row block and query, [N/128, B]."""
    eb, ab = block_bound_maxes(e_l2, a_l2)
    return eb[:, None] * u_q[None, :] + ab[:, None] * v_q[None, :]


def _row_upper(s, e_l2, a_l2, u_q, v_q) -> torch.Tensor:
    """The v2 per-row upper bound ``(s + e_l2·u_q) + a_l2·v_q`` of raw
    scores ``s [N, B]``, each product and sum its own rounded op (the
    kernels' ``_rn`` order)."""
    return (s + e_l2[:, None] * u_q[None, :]) + a_l2[:, None] * v_q[None, :]


def _bf16_rows(m: torch.Tensor) -> torch.Tensor:
    """The corpus as the bf16-query kernels read it: bf16 values in f32
    (an f32 corpus rounded to bf16 first, as the inline-cast kernels do)."""
    return m.to(torch.bfloat16).float()


def _select_reference(x, corr, t_top):
    """The shared selection of the plain versions on masked scores
    ``x [N, B]``: a reshape into [G, 128, B] blocks and the kernels'
    top-2, tournament and tie rules (ties go to the highest lane or slot,
    and a taken entry is replaced by -inf). ``corr [N/128, B]``: the v3
    block correction, added to each block's selected values and third
    value; ``None`` for v2, whose ``x`` already holds per-row upper
    bounds."""
    neg_inf = float("-inf")
    n, b = x.shape
    g, n_sel, bpt = n // BLOCK, n // SEL, SEL // BLOCK
    dev = x.device
    x = x.view(g, BLOCK, b)
    lane = torch.arange(BLOCK, device=dev, dtype=torch.int32)[None, :, None]
    blk_row0 = torch.arange(g, device=dev, dtype=torch.int32)[:, None] * BLOCK
    cand_v, cand_r = [], []
    for _ in range(2):
        v = x.amax(dim=1)  # [G, B]
        amax = torch.where(x == v[:, None, :], lane, -1).amax(dim=1)
        cand_v.append(v if corr is None else v + corr)
        cand_r.append(blk_row0 + amax)
        x = torch.where(lane == amax[:, None, :], neg_inf, x)
    v3 = x.amax(dim=1) if corr is None else x.amax(dim=1) + corr
    del x
    pool_v = torch.cat([cand_v[0].view(n_sel, bpt, b), cand_v[1].view(n_sel, bpt, b)], dim=1)
    pool_r = torch.cat([cand_r[0].view(n_sel, bpt, b), cand_r[1].view(n_sel, bpt, b)], dim=1)
    slot = torch.arange(2 * bpt, device=dev, dtype=torch.int32)[None, :, None]
    v_out, r_out = [], []
    for _ in range(t_top):
        v = pool_v.amax(dim=1)  # [n_sel, B]
        smax = torch.where(pool_v == v[:, None, :], slot, -1).amax(dim=1)
        r = torch.where(slot == smax[:, None, :], pool_r, -1).amax(dim=1)
        v_out.append(v)
        r_out.append(r)
        pool_v = torch.where(slot == smax[:, None, :], neg_inf, pool_v)
    thr = torch.maximum(pool_v.amax(dim=1), v3.view(n_sel, bpt, b).amax(dim=1))
    v_pack = torch.stack(v_out + [thr], dim=0).permute(2, 0, 1).contiguous()
    r_pack = torch.stack(r_out, dim=0).permute(2, 0, 1).contiguous()
    return v_pack, r_pack


def scan_select_v3_reference(
    q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, t_top: int = TILE_T, tags=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the bf16 kernel, on any device: an f32
    matmul of the bf16 values (TF32 off: ops.dense.require_fp32), the
    masks, then :func:`_select_reference` with the block correction."""
    _check_v3(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, t_top, tags)
    s = _mask(_bf16_rows(m_bf16) @ q_bf16.float().T, valid_i32, tags)  # [N, B]
    return _select_reference(s, _block_corr(e_l2, a_l2, u_q, v_q), t_top)


def scan_select_v2_reference(
    q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, t_top: int = TILE_T, tags=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the v2 bf16 kernel, on any device:
    :func:`scan_select_v3_reference`'s scores plus each row's own bound
    (:func:`_row_upper`), then the masks and :func:`_select_reference`
    with nothing added after selection."""
    _check_v3(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, t_top, tags)
    s = _row_upper(_bf16_rows(m_bf16) @ q_bf16.float().T, e_l2, a_l2, u_q, v_q)
    return _select_reference(_mask(s, valid_i32, tags), None, t_top)


def _indirect_reference(direct, q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_ids, tile_n,
                        t_top, tags):
    """A tile-indirect plain version: the listed tiles gathered (ids
    clamped into range, pad slots marked invalid), the direct plain
    version ``direct`` on the copy, then each local row mapped to
    ``tile_ids[slot]·tile_n + offset`` with the unclamped id."""
    n = m_bf16.shape[0]
    n_tiles = n // tile_n
    sel = tile_ids.long()
    ok = (sel >= 0) & (sel < n_tiles)
    ids = sel.clamp(0, n_tiles - 1)

    def gather(x):  # [N, ...] → the listed tiles, [G·tile_n, ...]
        return x.view(n_tiles, tile_n, *x.shape[1:])[ids].reshape(-1, *x.shape[1:])

    valid_sel = (gather(valid_i32).view(-1, tile_n) * ok[:, None]).reshape(-1)
    tags_sel = None if tags is None else (gather(tags[0]),) + tuple(tags[1:])
    v_pack, r_pack = direct(q_bf16, gather(m_bf16), gather(e_l2), gather(a_l2), valid_sel, u_q, v_q,
                            t_top, tags_sel)
    local = r_pack.long()
    rows = sel[local // tile_n] * tile_n + local % tile_n
    return v_pack, rows.to(torch.int32)


def scan_select_v3_indirect_reference(
    q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_ids, tile_n: int = 2048,
    t_top: int = TILE_T, tags=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the tile-indirect kernel, on any device:
    :func:`scan_select_v3_reference` over a copy of the listed tiles
    (:func:`_indirect_reference`). The copy's block maxes are the corpus's
    own, since tiles hold whole 128-row blocks."""
    _check_indirect(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_ids, tile_n, t_top, tags)
    return _indirect_reference(scan_select_v3_reference, q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q,
                               v_q, tile_ids, tile_n, t_top, tags)


def scan_select_v2_indirect_reference(
    q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_ids, tile_n: int = 2048,
    t_top: int = TILE_T, tags=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the v2 tile-indirect kernel, on any device:
    :func:`scan_select_v2_reference` over a copy of the listed tiles
    (:func:`_indirect_reference`)."""
    _check_indirect(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_ids, tile_n, t_top, tags)
    return _indirect_reference(scan_select_v2_reference, q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q,
                               v_q, tile_ids, tile_n, t_top, tags)


def _int8_scores(q_i8, m_i8, s_row, t_q) -> torch.Tensor:
    """The int8 kernels' dequantized scores [N, B]: an f32 matmul of the
    int8 values, exact in any summation order because every partial sum is
    an integer below 2²⁴, then the two scale multiplies in the kernels'
    order."""
    return (m_i8.float() @ q_i8.float().T) * s_row[:, None] * t_q[None, :]


def scan_select_int8_v3_reference(
    q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q, t_top: int = TILE_T, tags=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the int8 kernel, on any device:
    :func:`_int8_scores`, the masks and :func:`_select_reference` with the
    block correction. Its output equals the kernel's bit for bit."""
    _check_int8(q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q, t_top, tags)
    s = _mask(_int8_scores(q_i8, m_i8, s_row, t_q), valid_i32, tags)
    return _select_reference(s, _block_corr(e_l2, a_l2, u_q, v_q), t_top)


def scan_select_int8_v2_reference(
    q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q, t_top: int = TILE_T, tags=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the v2 int8 kernel, on any device:
    :func:`_int8_scores` plus each row's own bound (:func:`_row_upper`),
    the masks and :func:`_select_reference`. Its output equals the
    kernel's bit for bit."""
    _check_int8(q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q, t_top, tags)
    s = _row_upper(_int8_scores(q_i8, m_i8, s_row, t_q), e_l2, a_l2, u_q, v_q)
    return _select_reference(_mask(s, valid_i32, tags), None, t_top)
