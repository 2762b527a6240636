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

Both then keep each 128-row block's top-2 raw scores (with global rows)
and third value, add the block's bound correction
``max_blk(e_l2)·u_q + max_blk(a_l2)·v_q``, and run a tournament over the
tile's 16 block candidates → ``v_pack [B, T+1, N/1024]`` (values, then
the tile threshold) and ``r_pack [B, T, N/1024]`` (global rows). With
``tags=(tag_bits [N], t_all [B], t_any [B], t_none [B])`` (int32), a row
that fails the query's tag predicate (``ops/tags.py::tag_pred``) scores
-inf before selection, like an invalid row.

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


def _check(q, m, dtype, vectors, tags, t_top) -> None:
    """Shapes, types and devices common to both scans (any width d >= 1:
    the kernels read a width that is not a multiple of their 16-byte
    vector through ``csrc/row_load.cuh``)."""
    if q.dim() != 2 or m.dim() != 2 or q.shape[1] != m.shape[1]:
        raise InvalidConfigError(f"need q [B, d] and m [N, d], got {tuple(q.shape)}, {tuple(m.shape)}")
    b, d = q.shape
    n = m.shape[0]
    if q.dtype != dtype or m.dtype != dtype:
        raise InvalidConfigError(f"q and m must be {dtype} (got {q.dtype}, {m.dtype})")
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


def scan_select_v3(
    q_bf16: torch.Tensor,  # [B, d] bf16 (pre-normalized for cosine)
    m_bf16: torch.Tensor,  # [N, d] bf16, N a multiple of 1024
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
    b, d = q_bf16.shape
    n = m_bf16.shape[0]
    eb, ab = block_bound_maxes(e_l2, a_l2)
    out = _launch(
        "scan_select_v3_launch", (q_bf16, m_bf16, eb, ab, valid_i32, u_q, v_q),
        (q_bf16, m_bf16, valid_i32), tags, n // SEL, t_top, (b, d, n, t_top),
    )
    scan_select_v3.launches += 1
    return out


scan_select_v3.launches = 0


def scan_select_v3_indirect(
    q_bf16: torch.Tensor,  # [B, d] bf16 (pre-normalized for cosine)
    m_bf16: torch.Tensor,  # [N, d] bf16, N a multiple of tile_n
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
    b, d = q_bf16.shape
    n = m_bf16.shape[0]
    g = tile_ids.shape[0]
    eb, ab = block_bound_maxes(e_l2, a_l2)
    out = _launch(
        "scan_select_v3_indirect_launch", (q_bf16, m_bf16, eb, ab, valid_i32, u_q, v_q, tile_ids),
        (q_bf16, m_bf16, valid_i32), tags, g * (tile_n // SEL), t_top, (b, d, n, t_top, tile_n, g),
    )
    scan_select_v3_indirect.launches += 1
    return out


scan_select_v3_indirect.launches = 0


def _check_indirect(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_ids, tile_n, t_top, tags):
    _check_v3(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, t_top, tags)
    n = m_bf16.shape[0]
    if tile_n < SEL or tile_n % SEL or n % tile_n:
        raise InvalidConfigError(f"tile_n must be a multiple of {SEL} dividing N={n}, got {tile_n}")
    if tile_ids.dtype != torch.int32 or tile_ids.dim() != 1 or tile_ids.shape[0] < 1:
        raise InvalidConfigError(f"tile_ids must be a non-empty int32 vector, got {tile_ids.dtype} "
                                 f"{tuple(tile_ids.shape)}")
    if tile_ids.shape[0] * (tile_n // SEL) > 65535:
        raise InvalidConfigError("at most 65,535 selection tiles per call")
    if tile_ids.device != q_bf16.device:
        raise InvalidConfigError("tile_ids must be on the inputs' device")


def _check_v3(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, t_top, tags) -> None:
    f32 = torch.float32
    _check(q_bf16, m_bf16, torch.bfloat16, [
        ("e_l2", e_l2, f32, True), ("a_l2", a_l2, f32, True),
        ("valid", valid_i32, torch.int32, True), ("u_q", u_q, f32, False),
        ("v_q", v_q, f32, False),
    ], tags, t_top)


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


def _select_reference(s, e_l2, a_l2, u_q, v_q, t_top):
    """The shared selection of both plain versions on masked raw scores
    ``s [N, B]``: a reshape into [G, 128, B] blocks and the kernels'
    top-2, tournament and tie rules (ties go to the highest lane or slot,
    and a taken entry is replaced by -inf)."""
    neg_inf = float("-inf")
    n, b = s.shape
    g, n_sel, bpt = n // BLOCK, n // SEL, SEL // BLOCK
    dev = s.device
    eb, ab = block_bound_maxes(e_l2, a_l2)
    corr = eb[:, None] * u_q[None, :] + ab[:, None] * v_q[None, :]  # [G, B]
    x = s.view(g, BLOCK, b)
    lane = torch.arange(BLOCK, device=dev, dtype=torch.int32)[None, :, None]
    blk_row0 = torch.arange(g, device=dev, dtype=torch.int32)[:, None] * BLOCK
    cand_v, cand_r = [], []
    for _ in range(2):
        v = x.amax(dim=1)  # [G, B]
        amax = torch.where(x == v[:, None, :], lane, -1).amax(dim=1)
        cand_v.append(v + corr)
        cand_r.append(blk_row0 + amax)
        x = torch.where(lane == amax[:, None, :], neg_inf, x)
    v3 = x.amax(dim=1) + corr
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
    masks, then :func:`_select_reference`."""
    _check_v3(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, t_top, tags)
    s = _mask(m_bf16.float() @ q_bf16.float().T, valid_i32, tags)  # [N, B]
    return _select_reference(s, e_l2, a_l2, u_q, v_q, t_top)


def scan_select_v3_indirect_reference(
    q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_ids, tile_n: int = 2048,
    t_top: int = TILE_T, tags=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the tile-indirect kernel, on any device:
    the listed tiles gathered (ids clamped into range, pad slots marked
    invalid), :func:`scan_select_v3_reference`'s scoring and
    :func:`_select_reference` on the copy, then each local row mapped to
    ``tile_ids[slot]·tile_n + offset`` with the unclamped id."""
    _check_indirect(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, tile_ids, tile_n, t_top, tags)
    n, d = m_bf16.shape
    n_tiles = n // tile_n
    sel = tile_ids.long()
    ok = (sel >= 0) & (sel < n_tiles)
    ids = sel.clamp(0, n_tiles - 1)

    def gather(x):  # [N, ...] → the listed tiles, [G·tile_n, ...]
        return x.view(n_tiles, tile_n, *x.shape[1:])[ids].reshape(-1, *x.shape[1:])

    valid_sel = (gather(valid_i32).view(-1, tile_n) * ok[:, None]).reshape(-1)
    tags_sel = None if tags is None else (gather(tags[0]),) + tuple(tags[1:])
    s = _mask(gather(m_bf16).float() @ q_bf16.float().T, valid_sel, tags_sel)
    v_pack, r_pack = _select_reference(s, gather(e_l2), gather(a_l2), u_q, v_q, t_top)
    local = r_pack.long()
    rows = sel[local // tile_n] * tile_n + local % tile_n
    return v_pack, rows.to(torch.int32)


def scan_select_int8_v3_reference(
    q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q, t_top: int = TILE_T, tags=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the int8 kernel, on any device: an f32
    matmul of the int8 values, exact in any summation order because every
    partial sum is an integer below 2²⁴, then the kernel's two scale
    multiplies in the same order, the masks and :func:`_select_reference`.
    Its output equals the kernel's bit for bit."""
    _check_int8(q_i8, m_i8, s_row, e_l2, a_l2, valid_i32, t_q, u_q, v_q, t_top, tags)
    s = (m_i8.float() @ q_i8.float().T) * s_row[:, None] * t_q[None, :]  # [N, B]
    return _select_reference(_mask(s, valid_i32, tags), e_l2, a_l2, u_q, v_q, t_top)
