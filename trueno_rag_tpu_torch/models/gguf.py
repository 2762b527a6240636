"""GGUF checkpoint interop for the Nemotron-class embedder, on the host.

Counterpart of ``trueno_rag_tpu/models/gguf.py``: a dependency-free GGUF
v2/v3 parser (missing file → :class:`IndexNotFoundError`; bad magic,
truncation, unknown types → :class:`SerializationError`) that maps
llama-architecture tensors into
:func:`trueno_rag_tpu_torch.models.nemotron.init_nemotron_params`' layout.

Quantization support: F32, F16, the 32-element block formats Q8_0 /
Q4_0 / Q4_1, and the 256-element k-quant super-blocks Q4_K / Q5_K /
Q6_K / Q8_K (what real NV-Embed-class GGUFs actually ship) dequantize
to f32 on load, then to the port's bf16 matrices and f32 norm scales.
The remaining k-quants (Q2_K/Q3_K) raise a typed ``SerializationError``
naming the unsupported type — fail loudly, not wrongly.

Layout notes:
- GGML dims are stored fastest-first (``ne0`` contiguous); the numpy
  shape is the reverse.
- llama.cpp weight matrices are ``[out, in]`` row-major; our forward
  multiplies ``x @ w`` with ``w [in, out]``, so matrices transpose on
  import.
- Per-layer tensors stay per layer (the port's parameter dict has one
  entry per layer).

``write_gguf`` (F32 only) exists so tests can build tiny synthetic
artifacts and round-trip them without any external model file.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.errors import IndexNotFoundError, SerializationError

GGUF_MAGIC = b"GGUF"

# metadata value types (gguf spec)
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL = range(8)
_T_STR, _T_ARR, _T_U64, _T_I64, _T_F64 = 8, 9, 10, 11, 12
_SCALAR_FMT = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
    _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_BOOL: "<?",
    _T_U64: "<Q", _T_I64: "<q", _T_F64: "<d",
}

# ggml tensor types we can decode (type id -> name)
GGML_F32, GGML_F16, GGML_Q4_0, GGML_Q4_1, GGML_Q8_0 = 0, 1, 2, 3, 8
GGML_Q4_K, GGML_Q5_K, GGML_Q6_K, GGML_Q8_K = 12, 13, 14, 15
_GGML_NAMES = {
    0: "F32", 1: "F16", 2: "Q4_0", 3: "Q4_1", 4: "Q4_2", 5: "Q4_3",
    6: "Q5_0", 7: "Q5_1", 8: "Q8_0", 9: "Q8_1", 10: "Q2_K", 11: "Q3_K",
    12: "Q4_K", 13: "Q5_K", 14: "Q6_K", 15: "Q8_K",
}
_QBLOCK = 32  # elements per quantization block for Q4_0/Q4_1/Q8_0
_QK_K = 256  # elements per k-quant super-block
_SUPPORTED = "F32/F16/Q8_0/Q4_0/Q4_1/Q4_K/Q5_K/Q6_K/Q8_K"


class _Reader:
    def __init__(self, data: memoryview) -> None:
        self.d = data
        self.o = 0

    def take(self, n: int) -> memoryview:
        if self.o + n > len(self.d):
            raise SerializationError("truncated GGUF file")
        out = self.d[self.o : self.o + n]
        self.o += n
        return out

    def scalar(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def string(self) -> str:
        n = self.scalar("<Q")
        return bytes(self.take(n)).decode("utf-8", errors="replace")

    def value(self, vtype: int):
        if vtype in _SCALAR_FMT:
            return self.scalar(_SCALAR_FMT[vtype])
        if vtype == _T_STR:
            return self.string()
        if vtype == _T_ARR:
            etype = self.scalar("<I")
            count = self.scalar("<Q")
            return [self.value(etype) for _ in range(count)]
        raise SerializationError(f"unknown GGUF metadata value type {vtype}")


def _dequantize(raw: np.ndarray, ggml_type: int, n_elems: int) -> np.ndarray:
    """Decode a tensor's raw bytes to f32 (or return the float view)."""
    if ggml_type == GGML_F32:
        return raw.view(np.float32)[:n_elems].astype(np.float32)
    if ggml_type == GGML_F16:
        return raw.view(np.float16)[:n_elems].astype(np.float32)
    nb = n_elems // _QBLOCK
    if ggml_type == GGML_Q8_0:
        rec = raw[: nb * 34].reshape(nb, 34)
        scale = rec[:, :2].copy().view(np.float16).astype(np.float32)  # [nb, 1]
        q = rec[:, 2:].copy().view(np.int8).astype(np.float32)  # [nb, 32]
        return (q * scale).reshape(-1)
    if ggml_type == GGML_Q4_0:
        rec = raw[: nb * 18].reshape(nb, 18)
        scale = rec[:, :2].copy().view(np.float16).astype(np.float32)
        packed = rec[:, 2:]
        lo = (packed & 0x0F).astype(np.float32) - 8.0
        hi = (packed >> 4).astype(np.float32) - 8.0
        return (np.concatenate([lo, hi], axis=1) * scale).reshape(-1)
    if ggml_type == GGML_Q4_1:
        rec = raw[: nb * 20].reshape(nb, 20)
        d = rec[:, :2].copy().view(np.float16).astype(np.float32)
        m = rec[:, 2:4].copy().view(np.float16).astype(np.float32)
        packed = rec[:, 4:]
        lo = (packed & 0x0F).astype(np.float32)
        hi = (packed >> 4).astype(np.float32)
        return (np.concatenate([lo, hi], axis=1) * d + m).reshape(-1)
    if ggml_type in (GGML_Q4_K, GGML_Q5_K, GGML_Q6_K, GGML_Q8_K):
        return _dequantize_kquant(raw, ggml_type, n_elems)
    name = _GGML_NAMES.get(ggml_type, str(ggml_type))
    raise SerializationError(
        f"unsupported GGML tensor type {name}; supported: {_SUPPORTED}"
    )


def _kscale_min(scales: np.ndarray):
    """Unpack the Q4_K/Q5_K 12-byte packed 6-bit (scale, min) pairs →
    (sc [nb, 8], mn [nb, 8]) uint8, the ggml get_scale_min_k4 layout:
    entries 0-3 live in the low 6 bits of bytes 0-3 / 4-7; entries 4-7
    split across the low nibbles of bytes 8-11 and the high 2 bits of
    bytes 0-7."""
    sc = np.empty(scales.shape[:1] + (8,), np.uint8)
    mn = np.empty_like(sc)
    sc[:, :4] = scales[:, :4] & 63
    mn[:, :4] = scales[:, 4:8] & 63
    sc[:, 4:] = (scales[:, 8:12] & 0x0F) | ((scales[:, 0:4] >> 6) << 4)
    mn[:, 4:] = (scales[:, 8:12] >> 4) | ((scales[:, 4:8] >> 6) << 4)
    return sc, mn


def _dequantize_kquant(raw: np.ndarray, ggml_type: int, n_elems: int) -> np.ndarray:
    """Decode the k-quant super-block formats (256 elements/block).

    Layouts follow ggml's reference dequantize_row_q{4,5,6,8}_K exactly
    (llama.cpp ggml-quants.c); the scalar loops there are transcribed
    as vectorized slices here and pinned by a scalar oracle in
    the JAX package's tests/test_gguf.py. Real NV-Embed-class GGUF artifacts ship these
    (the reference consumes them via realizar)."""
    nb = n_elems // _QK_K
    if ggml_type == GGML_Q8_K:
        rec = raw[: nb * 292].reshape(nb, 292)
        d = rec[:, :4].copy().view(np.float32)  # [nb, 1]
        q = rec[:, 4:260].copy().view(np.int8).astype(np.float32)
        return (d * q).reshape(-1)
    if ggml_type == GGML_Q6_K:
        rec = raw[: nb * 210].reshape(nb, 210)
        ql = rec[:, :128]
        qh = rec[:, 128:192]
        sc = rec[:, 192:208].copy().view(np.int8).astype(np.float32)
        d = rec[:, 208:210].copy().view(np.float16).astype(np.float32)
        halves = []
        for h in (0, 1):
            ql_h = ql[:, 64 * h : 64 * h + 64]
            qh_h = qh[:, 32 * h : 32 * h + 32]
            sc_h = sc[:, 8 * h : 8 * h + 8]
            ql_lo, ql_hi = ql_h & 0x0F, ql_h >> 4
            q = np.concatenate(
                [
                    ql_lo[:, :32] | (((qh_h >> 0) & 3) << 4),
                    ql_lo[:, 32:] | (((qh_h >> 2) & 3) << 4),
                    ql_hi[:, :32] | (((qh_h >> 4) & 3) << 4),
                    ql_hi[:, 32:] | (((qh_h >> 6) & 3) << 4),
                ],
                axis=1,
            ).astype(np.float32) - 32.0  # [nb, 128]
            halves.append(np.repeat(sc_h, 16, axis=1) * q)
        return (d * np.concatenate(halves, axis=1)).reshape(-1)
    # Q4_K / Q5_K share the d/dmin + packed-6-bit-scales header
    if ggml_type == GGML_Q4_K:
        rec = raw[: nb * 144].reshape(nb, 144)
        qs, qh = rec[:, 16:144], None
    else:
        rec = raw[: nb * 176].reshape(nb, 176)
        qh, qs = rec[:, 16:48], rec[:, 48:176]
    d = rec[:, 0:2].copy().view(np.float16).astype(np.float32)  # [nb, 1]
    dmin = rec[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mn = _kscale_min(rec[:, 4:16])
    sc_f, mn_f = sc.astype(np.float32), mn.astype(np.float32)
    out = np.empty((rec.shape[0], _QK_K), np.float32)
    for j in range(4):  # 64-element groups, each with two (sc, mn) pairs
        q = qs[:, 32 * j : 32 * j + 32]
        lo = (q & 0x0F).astype(np.float32)
        hi = (q >> 4).astype(np.float32)
        if qh is not None:  # Q5_K: the 5th bit rides qh's 2j / 2j+1 bits
            lo = lo + 16.0 * ((qh & np.uint8(1 << (2 * j))) != 0)
            hi = hi + 16.0 * ((qh & np.uint8(2 << (2 * j))) != 0)
        out[:, 64 * j : 64 * j + 32] = (
            d * sc_f[:, 2 * j : 2 * j + 1] * lo
            - dmin * mn_f[:, 2 * j : 2 * j + 1]
        )
        out[:, 64 * j + 32 : 64 * j + 64] = (
            d * sc_f[:, 2 * j + 1 : 2 * j + 2] * hi
            - dmin * mn_f[:, 2 * j + 1 : 2 * j + 2]
        )
    return out.reshape(-1)


def _tensor_nbytes(ggml_type: int, n_elems: int) -> int:
    if ggml_type == GGML_F32:
        return 4 * n_elems
    if ggml_type == GGML_F16:
        return 2 * n_elems
    per_k = {GGML_Q4_K: 144, GGML_Q5_K: 176, GGML_Q6_K: 210,
             GGML_Q8_K: 292}.get(ggml_type)
    if per_k is not None:
        return per_k * (n_elems // _QK_K)
    per = {GGML_Q8_0: 34, GGML_Q4_0: 18, GGML_Q4_1: 20}.get(ggml_type)
    if per is None:
        name = _GGML_NAMES.get(ggml_type, str(ggml_type))
        raise SerializationError(
            f"unsupported GGML tensor type {name}; supported: {_SUPPORTED}"
        )
    return per * (n_elems // _QBLOCK)


def read_gguf(path: str) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Parse a GGUF file → ``(metadata, {tensor_name: f32 ndarray})``.

    Failure modes mirror the reference's tested taxonomy
    (embed.rs:1661-1691): missing file → :class:`IndexNotFoundError`;
    bad magic / truncation / unknown types →
    :class:`SerializationError`."""
    if not os.path.exists(path):
        raise IndexNotFoundError(f"no GGUF model at {path}")
    data = np.memmap(path, dtype=np.uint8, mode="r")
    r = _Reader(memoryview(data))
    if bytes(r.take(4)) != GGUF_MAGIC:
        raise SerializationError(f"{path}: not a GGUF file (bad magic)")
    version = r.scalar("<I")
    if version not in (2, 3):
        raise SerializationError(f"unsupported GGUF version {version}")
    n_tensors = r.scalar("<Q")
    n_kv = r.scalar("<Q")
    meta: Dict[str, Any] = {}
    for _ in range(n_kv):
        key = r.string()
        vtype = r.scalar("<I")
        meta[key] = r.value(vtype)
    infos: List[Tuple[str, Tuple[int, ...], int, int]] = []
    for _ in range(n_tensors):
        name = r.string()
        n_dims = r.scalar("<I")
        dims = tuple(r.scalar("<Q") for _ in range(n_dims))
        ggml_type = r.scalar("<I")
        offset = r.scalar("<Q")
        infos.append((name, dims, ggml_type, offset))
    align = int(meta.get("general.alignment", 32))
    base = (r.o + align - 1) // align * align
    tensors: Dict[str, np.ndarray] = {}
    for name, dims, ggml_type, offset in infos:
        n_elems = 1
        for d in dims:
            n_elems *= int(d)
        nbytes = _tensor_nbytes(ggml_type, n_elems)
        lo = base + offset
        if lo + nbytes > len(data):
            raise SerializationError(f"{path}: tensor {name!r} overruns the file")
        raw = np.asarray(data[lo : lo + nbytes])
        flat = _dequantize(raw, ggml_type, n_elems)
        # ggml ne0 is fastest-varying -> numpy shape is reversed dims
        tensors[name] = flat.reshape(tuple(reversed([int(d) for d in dims])))
    return meta, tensors


def write_gguf(path: str, metadata: Dict[str, Any], tensors: Dict[str, np.ndarray]) -> None:
    """Minimal GGUF v3 writer (F32 tensors only) — the test-fixture
    counterpart of :func:`read_gguf`."""
    align = 32

    def enc_str(s: str) -> bytes:
        b = s.encode()
        return struct.pack("<Q", len(b)) + b

    def enc_value(v: Any) -> bytes:
        if isinstance(v, bool):
            return struct.pack("<I", _T_BOOL) + struct.pack("<?", v)
        if isinstance(v, int):
            return struct.pack("<I", _T_U32 if 0 <= v < 2**32 else _T_I64) + (
                struct.pack("<I", v) if 0 <= v < 2**32 else struct.pack("<q", v)
            )
        if isinstance(v, float):
            return struct.pack("<I", _T_F32) + struct.pack("<f", v)
        if isinstance(v, str):
            return struct.pack("<I", _T_STR) + enc_str(v)
        raise SerializationError(f"write_gguf cannot encode metadata {type(v)}")

    out = bytearray()
    out += GGUF_MAGIC
    out += struct.pack("<I", 3)
    out += struct.pack("<Q", len(tensors))
    out += struct.pack("<Q", len(metadata))
    for k, v in metadata.items():
        out += enc_str(k)
        out += enc_value(v)
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        dims = tuple(reversed(arr.shape))  # ne0 fastest
        out += enc_str(name)
        out += struct.pack("<I", len(dims))
        for d in dims:
            out += struct.pack("<Q", d)
        out += struct.pack("<I", GGML_F32)
        out += struct.pack("<Q", offset)
        blob = arr.tobytes()
        pad = (-len(blob)) % align
        blobs.append(blob + b"\x00" * pad)
        offset += len(blob) + pad
    pad = (-len(out)) % align
    out += b"\x00" * pad
    for blob in blobs:
        out += blob
    with open(path, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# llama-architecture tensor mapping -> nemotron params
# ---------------------------------------------------------------------------


def load_nemotron_gguf(path: str, config=None, device=None):
    """Load a llama-architecture GGUF into the Nemotron parameter dict on
    ``device`` (default: the CUDA device; raises without one, pass
    ``device="cpu"`` for the CPU) → ``(params, config)``.

    When ``config`` is None the shape is inferred from the GGUF metadata
    (``llama.block_count``, ``llama.embedding_length``, ...). Weight
    matrices transpose from llama's ``[out, in]`` into the ``x @ w``
    ``[in, out]`` layout and are stored in bf16 (the token table too), norm
    scales in f32."""
    from trueno_rag_tpu_torch.models.nemotron import NemotronConfig

    device = resolve_device(device)
    meta, tensors = read_gguf(path)

    def need(name: str) -> np.ndarray:
        if name not in tensors:
            raise SerializationError(f"GGUF missing tensor {name!r}")
        return tensors[name]

    tok = need("token_embd.weight")  # [vocab, h]
    vocab, h = tok.shape
    if config is None:
        arch = meta.get("general.architecture", "llama")
        L = int(meta.get(f"{arch}.block_count", 0))
        if L <= 0:
            L = len({k.split(".")[1] for k in tensors if k.startswith("blk.")})
        config = NemotronConfig(
            vocab_size=vocab,
            hidden_dim=int(meta.get(f"{arch}.embedding_length", h)),
            num_layers=L,
            num_heads=int(meta.get(f"{arch}.attention.head_count", max(1, h // 128))),
            mlp_dim=int(
                meta.get(
                    f"{arch}.feed_forward_length",
                    need("blk.0.ffn_up.weight").shape[0],
                )
            ),
            max_len=int(meta.get(f"{arch}.context_length", 8192)),
            rope_theta=float(meta.get(f"{arch}.rope.freq_base", 10000.0)),
        )
    if (vocab, h) != (config.vocab_size, config.hidden_dim):
        raise SerializationError(
            f"GGUF token_embd {tok.shape} does not match config "
            f"({config.vocab_size}, {config.hidden_dim})"
        )
    m = config.mlp_dim
    expect = {
        "qkv_w": (h, 3 * h),
        "attn_out_w": (h, h),
        "mlp_gate_w": (h, m),
        "mlp_up_w": (h, m),
        "mlp_down_w": (m, h),
    }

    def put(x: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device=device, dtype=dtype)

    layers = []
    for i in range(config.num_layers):
        def layer(name: str) -> np.ndarray:
            return need(f"blk.{i}.{name}")

        lp = {
            "qkv_w": np.concatenate(
                [layer("attn_q.weight").T, layer("attn_k.weight").T, layer("attn_v.weight").T], axis=1
            ),
            "attn_out_w": layer("attn_output.weight").T,
            "rms1_scale": layer("attn_norm.weight"),
            "mlp_gate_w": layer("ffn_gate.weight").T,
            "mlp_up_w": layer("ffn_up.weight").T,
            "mlp_down_w": layer("ffn_down.weight").T,
            "rms2_scale": layer("ffn_norm.weight"),
        }
        for k, shape in expect.items():
            if tuple(lp[k].shape) != shape:
                raise SerializationError(
                    f"GGUF tensor {k} of layer {i} has shape {tuple(lp[k].shape)}, expected {shape}"
                )
        layers.append({k: put(a, torch.bfloat16 if k in expect else torch.float32) for k, a in lp.items()})
    params = {
        "tok_emb": put(tok, torch.bfloat16),
        "layers": layers,
        "final_rms_scale": put(need("output_norm.weight"), torch.float32),
    }
    return params, config
