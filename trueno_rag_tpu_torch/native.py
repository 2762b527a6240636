"""ctypes bindings for the native C++ host runtime (``native/``).

Compiles ``native/trag_native.cpp`` on first use (g++, cached beside the
source) and exposes the bulk BM25 index builder. Pure-Python fallbacks
exist everywhere; :func:`native_available` gates usage.

Why native here: the device owns all scoring math, so the framework's
remaining hot loop is host-side string work during index builds —
exactly where the reference burns its time too (its O(N^2) avgdl
recompute aside, index.rs:157-164). The C++ builder tokenizes and
accumulates postings ~10-30x faster than the Python dict path and
exports the CSR snapshot directly in the device-layout format.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, Optional, Sequence

import numpy as np

from trueno_rag_tpu_torch.text import STOPWORDS

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "native", "trag_native.cpp")
_SO = os.path.join(os.path.dirname(_HERE), "native", "libtrag_native.so")

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        if not os.path.exists(_SRC):
            _build_error = f"source not found: {_SRC}"
            return None
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", _SO, _SRC]
            try:
                subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
            except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError) as e:
                _build_error = f"native build failed: {e}"
                return None
        lib = ctypes.CDLL(_SO)
        lib.trag_bm25_create.restype = ctypes.c_void_p
        lib.trag_bm25_create.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
        lib.trag_bm25_destroy.argtypes = [ctypes.c_void_p]
        lib.trag_bm25_add_doc.restype = ctypes.c_int32
        lib.trag_bm25_add_doc.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32]
        for name in ("trag_bm25_total_postings", "trag_bm25_vocab_size",
                     "trag_bm25_vocab_bytes", "trag_bm25_num_docs", "trag_bm25_total_len"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        lib.trag_bm25_export.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.float32),
            np.ctypeslib.ndpointer(np.int64),
            ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        ]
        lib.trag_tokenize_count.restype = ctypes.c_int32
        lib.trag_tokenize_count.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.trag_bm25_add_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int32),
            ctypes.c_int32, np.ctypeslib.ndpointer(np.int32),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def native_build_error() -> Optional[str]:
    _load()
    return _build_error


class NativeBM25Builder:
    """Bulk BM25 builder: feed (row, text) pairs, export the CSR
    snapshot (vocab, rows, tfs, indptr, doc lengths, totals)."""

    def __init__(self, min_token_len: int = 2, stopwords=STOPWORDS) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_build_error}")
        self._lib = lib
        blob = "\n".join(sorted(stopwords)).encode("utf-8")
        self._handle = ctypes.c_void_p(lib.trag_bm25_create(blob, len(blob), min_token_len))

    def __del__(self) -> None:
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.trag_bm25_destroy(handle)
            self._handle = None

    def add(self, row: int, text: str) -> int:
        data = text.encode("utf-8")
        return self._lib.trag_bm25_add_doc(self._handle, data, len(data), row)

    def add_batch(self, rows: Sequence[int], texts: Sequence[str]) -> np.ndarray:
        """Add many docs in one FFI call; returns token counts per doc."""
        encoded = [t.encode("utf-8") for t in texts]
        offsets = np.zeros(len(encoded) + 1, np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        buf = b"".join(encoded)
        row_arr = np.asarray(list(rows), dtype=np.int32)
        counts = np.zeros(len(encoded), np.int32)
        self._lib.trag_bm25_add_batch(self._handle, buf, offsets, row_arr, len(encoded), counts)
        return counts

    def export(self) -> Dict[str, object]:
        lib, h = self._lib, self._handle
        p = int(lib.trag_bm25_total_postings(h))
        v = int(lib.trag_bm25_vocab_size(h))
        vb = int(lib.trag_bm25_vocab_bytes(h))
        nd = int(lib.trag_bm25_num_docs(h))
        rows = np.zeros(max(p, 1), np.int32)
        tfs = np.zeros(max(p, 1), np.float32)
        indptr = np.zeros(v + 1, np.int64)
        vocab_buf = ctypes.create_string_buffer(max(vb, 1))
        vocab_offsets = np.zeros(v + 1, np.int64)
        dl_rows = np.zeros(max(nd, 1), np.int32)
        dl_vals = np.zeros(max(nd, 1), np.int32)
        lib.trag_bm25_export(h, rows, tfs, indptr, vocab_buf, vocab_offsets, dl_rows, dl_vals)
        raw = vocab_buf.raw[:vb]
        terms = [
            raw[vocab_offsets[i] : vocab_offsets[i + 1]].decode("utf-8")
            for i in range(v)
        ]
        return {
            "terms": terms,
            "rows": rows[:p],
            "tfs": tfs[:p],
            "indptr": indptr,
            "doc_len_rows": dl_rows[:nd],
            "doc_len_vals": dl_vals[:nd],
            "total_len": int(lib.trag_bm25_total_len(h)),
        }

    def tokenize_count(self, text: str) -> int:
        data = text.encode("utf-8")
        return self._lib.trag_tokenize_count(self._handle, data, len(data))
