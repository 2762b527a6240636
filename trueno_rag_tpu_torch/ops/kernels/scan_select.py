"""``scan_select_v3``: the certified bf16 tile scan, as a CUDA kernel for
Hopper (``csrc/scan_select_v3.cu``) plus its plain PyTorch version.

Counterpart of the Pallas TPU kernel
``trueno_rag_tpu/ops/pallas/scan_select_v2.py::scan_select_v3``. For each
1024-row selection tile and each query it scores ``bf16(m)·bf16(q)`` in
f32, keeps each 128-row block's top-2 raw scores (with global rows) and
third value, adds the block's bound correction
``max_blk(e_l2)·u_q + max_blk(a_l2)·v_q``, and runs a tournament over
the tile's 16 block candidates → ``v_pack [B, T+1, N/1024]`` (values,
then the tile threshold) and ``r_pack [B, T, N/1024]`` (global rows).

Dispatch: a CPU tensor goes to :func:`scan_select_v3_reference`; a CUDA
tensor goes to the kernel, or the call raises. The kernel library is
built from ``csrc/*.cu`` with ``nvcc`` at first use, into ``build/`` at
the repository root.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError

BLOCK = 128  # rows per bound block
SEL = 1024  # rows per selection tile (one emitted candidate set)
TILE_T = 8  # default candidates kept per tile
MAX_T_TOP = 2 * (SEL // BLOCK)  # the tournament pool: 16 slots

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "kernels")
_LIB_PATH = os.path.join(_BUILD, "libtrag_torch_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
build_log = ""  # nvcc's output (register and shared-memory use) of the last build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def _sources():
    return sorted(
        os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith((".cu", ".cuh"))
    )


def build_library(force: bool = False) -> str:
    """Compile ``csrc/*.cu`` into the kernel library unless an up-to-date
    build exists; returns its path. The library is written to a temporary
    name and renamed, so concurrent builders never load a partial file."""
    global build_log
    srcs = _sources()
    fresh = os.path.exists(_LIB_PATH) and all(
        os.path.getmtime(_LIB_PATH) >= os.path.getmtime(s) for s in srcs
    )
    if fresh and not force:
        return _LIB_PATH
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(s for s in srcs if s.endswith(".cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            fn = lib.scan_select_v3_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            _lib = lib
        return _lib


def block_bound_maxes(e_l2: torch.Tensor, a_l2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-128-row-block maxes of the bound norms ([N] → [N/128]); both
    the kernel and the plain version take the bound at block granularity."""
    return (
        e_l2.view(-1, BLOCK).amax(dim=1).contiguous(),
        a_l2.view(-1, BLOCK).amax(dim=1).contiguous(),
    )


def _check(q, m, e_l2, a_l2, valid, u_q, v_q, t_top) -> None:
    if q.dim() != 2 or m.dim() != 2 or q.shape[1] != m.shape[1]:
        raise InvalidConfigError(f"need q [B, d] and m [N, d], got {tuple(q.shape)}, {tuple(m.shape)}")
    b, d = q.shape
    n = m.shape[0]
    if q.dtype != torch.bfloat16 or m.dtype != torch.bfloat16:
        raise InvalidConfigError(
            f"q and m must be bf16 (got {q.dtype}, {m.dtype}); the f32 inline-cast "
            "layout is not ported yet (ROADMAP)"
        )
    if b < 1 or n < SEL or n % SEL:
        raise InvalidConfigError(f"need B >= 1 and N a positive multiple of {SEL}, got B={b}, N={n}")
    if d < 8 or d % 8:
        raise InvalidConfigError(f"d must be a positive multiple of 8, got {d}")
    for name, t, dt, ln in (
        ("e_l2", e_l2, torch.float32, n), ("a_l2", a_l2, torch.float32, n),
        ("valid", valid, torch.int32, n), ("u_q", u_q, torch.float32, b),
        ("v_q", v_q, torch.float32, b),
    ):
        if t.dtype != dt or tuple(t.shape) != (ln,):
            raise InvalidConfigError(f"{name} must be {dt} [{ln}], got {t.dtype} {tuple(t.shape)}")
    if not 1 <= t_top <= MAX_T_TOP:
        raise InvalidConfigError(f"t_top must be in [1, {MAX_T_TOP}], got {t_top}")
    devices = {t.device for t in (q, m, e_l2, a_l2, valid, u_q, v_q)}
    if len(devices) != 1:
        raise InvalidConfigError(f"all inputs must be on one device, got {sorted(map(str, devices))}")


def scan_select_v3(
    q_bf16: torch.Tensor,  # [B, d] bf16 (pre-normalized for cosine)
    m_bf16: torch.Tensor,  # [N, d] bf16, N a multiple of 1024
    e_l2: torch.Tensor,  # [N] f32 — ‖row − bf16(row)‖₂
    a_l2: torch.Tensor,  # [N] f32 — ‖bf16(row)‖₂
    valid_i32: torch.Tensor,  # [N] int32 (0/1)
    u_q: torch.Tensor,  # [B] f32, >= 0 — bound coefficient on e_l2
    v_q: torch.Tensor,  # [B] f32, >= 0 — bound coefficient on a_l2
    t_top: int = TILE_T,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (v_pack [B, T+1, N/1024] f32, r_pack [B, T, N/1024] int32).

    CPU tensors run :func:`scan_select_v3_reference`; CUDA tensors launch
    the kernel (counted in ``scan_select_v3.launches``) or raise."""
    _check(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, t_top)
    dev = q_bf16.device
    if dev.type == "cpu":
        return scan_select_v3_reference(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, t_top)
    if dev.type != "cuda":
        raise InvalidConfigError(f"scan_select_v3 runs on cpu or cuda tensors, got {dev}")
    args = (q_bf16, m_bf16, valid_i32, u_q, v_q)
    if not all(t.is_contiguous() for t in args + (e_l2, a_l2)):
        raise InvalidConfigError("scan_select_v3 needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in (q_bf16, m_bf16, valid_i32)):
        raise InvalidConfigError("q, m and valid must be 16-byte aligned")
    lib = _load()
    b, d = q_bf16.shape
    n = m_bf16.shape[0]
    g = n // SEL
    eb, ab = block_bound_maxes(e_l2, a_l2)
    v_pack = torch.empty((b, t_top + 1, g), dtype=torch.float32, device=dev)
    r_pack = torch.empty((b, t_top, g), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scan_select_v3_launch(
            q_bf16.data_ptr(), m_bf16.data_ptr(), eb.data_ptr(), ab.data_ptr(),
            valid_i32.data_ptr(), u_q.data_ptr(), v_q.data_ptr(),
            v_pack.data_ptr(), r_pack.data_ptr(), b, d, n, t_top, stream,
        )
    if err != 0:
        raise RuntimeError(f"scan_select_v3 kernel launch failed: cudaError {err}")
    scan_select_v3.launches += 1
    return v_pack, r_pack


scan_select_v3.launches = 0


def scan_select_v3_reference(
    q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, t_top: int = TILE_T
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on any device: an f32 matmul
    of the bf16 values, a reshape into [G, 128, B] blocks, and the same
    top-2, tournament and tie rules (ties go to the highest lane or slot,
    and a taken entry is replaced by -inf)."""
    _check(q_bf16, m_bf16, e_l2, a_l2, valid_i32, u_q, v_q, t_top)
    neg_inf = float("-inf")
    b = q_bf16.shape[0]
    n = m_bf16.shape[0]
    g, n_sel, bpt = n // BLOCK, n // SEL, SEL // BLOCK
    dev = q_bf16.device
    eb, ab = block_bound_maxes(e_l2, a_l2)
    s = m_bf16.float() @ q_bf16.float().T  # [N, B]; TF32 off (ops.dense.require_fp32)
    s = torch.where(valid_i32[:, None] != 0, s, neg_inf)
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
    del x, s

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
