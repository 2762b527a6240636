"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``.cu`` source compiles with its own ``nvcc`` (all started together)
into a shared library with a plain C interface under ``build/kernels/`` at
the repository root, at first use; the entry points are bound with
ctypes. A library is rebuilt when it is older than its source or any
``.cuh`` header.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# each kernel's C entry point: name → (source, ctypes argument types)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRY = {
    # q, m, e, a, valid, u_q, v_q, tag_bits, t_all, t_any, t_none, v_pack,
    # r_pack, nq, d, n, t_top, m_f32, stream (e/a: block maxes for v3,
    # per-row norms for v2)
    "scan_select_v3_launch": ("scan_select_v3.cu", [_P] * 13 + [_I] * 5 + [_P]),
    "scan_select_v2_launch": ("scan_select_v3.cu", [_P] * 13 + [_I] * 5 + [_P]),
    # as above with tile_ids after v_q, then nq, d, n, t_top, tile_n, g, m_f32
    "scan_select_v3_indirect_launch": ("scan_select_v3.cu", [_P] * 14 + [_I] * 7 + [_P]),
    "scan_select_v2_indirect_launch": ("scan_select_v3.cu", [_P] * 14 + [_I] * 7 + [_P]),
    # q, m, s_row, e, a, valid, t_q, u_q, v_q, tags (4), v_pack, r_pack,
    # nq, d, n, t_top, stream
    "scan_select_int8_v3_launch": ("scan_select_int8_v3.cu", [_P] * 15 + [_I] * 4 + [_P]),
    "scan_select_int8_v2_launch": ("scan_select_int8_v3.cu", [_P] * 15 + [_I] * 4 + [_P]),
    # q, m, e_l2, a_l2, valid, u_q, v_q, v_out, i_out, nq, d, n, top, stream
    "scan_select_v1_launch": ("scan_select_v1.cu", [_P] * 9 + [_I] * 4 + [_P]),
    # q, m, s_row, e_l2, a_l2, valid, t_q, u_q, v_q, v_out, i_out, nq, d, n, top, stream
    "scan_select_int8_v1_launch": ("scan_select_v1.cu", [_P] * 11 + [_I] * 4 + [_P]),
    # q, m, valid, scores, bmax, nq, d, n, stream
    "score_blockmax_launch": ("dense_score.cu", [_P] * 5 + [_I] * 3 + [_P]),
    # q, m, valid, bmax, nq, d, n, stream
    "blockmax_only_launch": ("dense_score.cu", [_P] * 4 + [_I] * 3 + [_P]),
    # q, k, v, key_mask, out, bh, t, hd, heads, causal, scale, stream
    "block_attention_launch": ("block_attention.cu", [_P] * 5 + [_I] * 5 + [_F, _P]),
    # q16, tok16, t_mask, valid, out, nq, lq, n, lt, h, stream
    "maxsim_scan16_launch": ("maxsim_scan.cu", [_P] * 5 + [_I] * 5 + [_P]),
    "maxsim_scan16_wgmma_launch": ("maxsim_scan.cu", [_P] * 5 + [_I] * 5 + [_P]),
    # q8, t_q, tok8, s_tok, t_mask, valid, out, nq, lq, n, lt, h, stream
    "maxsim_scan_int8_launch": ("maxsim_scan.cu", [_P] * 7 + [_I] * 5 + [_P]),
    # q16, tok_l (or tokens), bias_l, valid, out, nq, lq, n, lt, h, group, stream
    "maxsim_scan16_v2_launch": ("maxsim_scan.cu", [_P] * 5 + [_I] * 6 + [_P]),
    "maxsim_scan16_self_v2_launch": ("maxsim_scan.cu", [_P] * 5 + [_I] * 6 + [_P]),
    # first, lo, hi, packed, rows_out, contrib_out, n_slots, scale,
    # one_minus_b, b, k1, k1p1, av, stream
    "fetch_contribs_launch": ("bm25_fetch.cu", [_P] * 6 + [_I] * 2 + [_F] * 5 + [_P]),
    "fetch_contribs8_launch": ("bm25_fetch.cu", [_P] * 6 + [_I] * 2 + [_F] * 5 + [_P]),
    # out, src, weight, slot, x, shared, y, positions, k, h, stream
    "moe_combine_launch": ("moe_combine.cu", [_P] * 7 + [_I] * 3 + [_P]),
}

_fns: Optional[Dict[str, object]] = None
_lock = threading.Lock()
build_log = ""  # nvcc's output (register and shared-memory use) of the last build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def _lib_path(source: str) -> str:
    return os.path.join(_BUILD, f"libtrag_{os.path.splitext(source)[0]}.so")


def build_library(force: bool = False) -> Dict[str, str]:
    """Compile each kernel source in ``csrc/`` into its own shared library
    unless an up-to-date build exists (newer than the source and every
    ``.cuh``); returns {source: library path}. The ``nvcc`` processes run
    together. Each library is written to a temporary name and renamed, so
    concurrent processes never load a partial file."""
    global build_log
    headers = [os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith(".cuh")]
    sources = sorted({src for src, _ in ENTRY.values()})
    paths = {src: _lib_path(src) for src in sources}
    stale = [
        src for src in sources
        if force or not os.path.exists(paths[src]) or any(
            os.path.getmtime(paths[src]) < os.path.getmtime(f)
            for f in headers + [os.path.join(_CSRC, src)]
        )
    ]
    if not stale:
        return paths
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in stale:
        tmp = f"{paths[src]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs, failed = [], []
    for src, tmp, proc in procs:
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
        else:
            os.replace(tmp, paths[src])
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    return paths


def entry(name: str):
    """The ctypes function of C entry point ``name`` (building the
    libraries on first use); it returns the launch's cudaError (0 = ok)."""
    global _fns
    with _lock:
        if _fns is None:
            paths = build_library()
            libs = {src: ctypes.CDLL(path) for src, path in paths.items()}
            fns = {}
            for fname, (src, argtypes) in ENTRY.items():
                fn = getattr(libs[src], fname)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
                fns[fname] = fn
            _fns = fns
        return _fns[name]
