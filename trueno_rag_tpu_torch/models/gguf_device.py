"""Device-resident k-quant weights, dequantized layer by layer inside the
forward.

PyTorch counterpart of ``trueno_rag_tpu/models/gguf_device.py``. The host
loader (:mod:`~trueno_rag_tpu_torch.models.gguf`) decodes GGUF k-quant
tensors to f32 in numpy; an 8B NV-Embed-class model in bf16 takes 15.8 GB
on the card. This module keeps the RAW k-quant super-block bytes on the
card as ``uint8`` (Q4_K 0.5625 B/param, Q6_K 0.82) and unpacks each
layer's matrices inside the layer loop of
:func:`nemotron_forward_quantized`, so the weights take the quantized
stack plus ONE layer's bf16 matrices at a time.

The unpack is integer bit operations and two broadcast multiplies, in
torch tensor ops (the JAX code is plain ``jnp``, not Pallas); bit layouts
follow ggml's ``dequantize_row_q{4,6}_K`` and the JAX package's operation
order (f32 products, then one cast to the compute dtype), so the values
equal the JAX device dequant and the host decoder bit for bit.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.device import resolve_device

QK_K = 256  # k-quant super-block length
Q4K_BLOCK_BYTES = 144
Q6K_BLOCK_BYTES = 210
_GGML_TYPE = {"q4_k": 12, "q6_k": 14}
_SLAB_BLOCKS = 1 << 16  # super-blocks one host worker quantizes or decodes at a time


def _f16_at(raw: torch.Tensor, col: int) -> torch.Tensor:
    """The little-endian f16 in bytes ``col, col+1`` of each block → ``[nb, 1]`` f32."""
    return raw[:, col:col + 2].contiguous().view(torch.float16).float()


def _kscale_min_device(scales: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed 12-byte 6-bit (scale, min) header of Q4_K/Q5_K ``[nb, 12]``
    uint8 → ``(sc [nb, 8], mn [nb, 8])`` uint8 (ggml's get_scale_min_k4)."""
    sc = torch.cat([scales[:, :4] & 63, (scales[:, 8:12] & 0x0F) | ((scales[:, 0:4] >> 6) << 4)], dim=1)
    mn = torch.cat([scales[:, 4:8] & 63, (scales[:, 8:12] >> 4) | ((scales[:, 4:8] >> 6) << 4)], dim=1)
    return sc, mn


def q4k_dequant(raw: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Q4_K super-blocks ``[nb, 144] uint8`` → values ``[nb, 256]``: ``d``
    f16, ``dmin`` f16, 12 bytes of packed 6-bit scales/mins (8 sub-blocks
    of 32), 128 bytes of 4-bit quants; value = d·sc·q − dmin·mn, each group
    of 64 holding 32 low nibbles then 32 high nibbles of one byte run."""
    d = _f16_at(raw, 0)
    dmin = _f16_at(raw, 2)
    sc, mn = _kscale_min_device(raw[:, 4:16])
    sc, mn = sc.float(), mn.float()
    qs = raw[:, 16:144]
    groups = []
    for j in range(4):
        q = qs[:, 32 * j:32 * j + 32]
        lo = (q & 0x0F).float()
        hi = (q >> 4).float()
        groups.append(d * sc[:, 2 * j:2 * j + 1] * lo - dmin * mn[:, 2 * j:2 * j + 1])
        groups.append(d * sc[:, 2 * j + 1:2 * j + 2] * hi - dmin * mn[:, 2 * j + 1:2 * j + 2])
    return torch.cat(groups, dim=1).to(dtype)


def q6k_dequant(raw: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Q6_K super-blocks ``[nb, 210] uint8`` → values ``[nb, 256]``: 128
    bytes of low 4 bits, 64 of high 2 bits, 16 int8 sub-scales, ``d`` f16;
    value = d · sc[i // 16] · (q − 32)."""
    ql = raw[:, :128]
    qh = raw[:, 128:192]
    sc = raw[:, 192:208].contiguous().view(torch.int8).float()
    d = _f16_at(raw, 208)
    halves = []
    for h in (0, 1):
        ql_h = ql[:, 64 * h:64 * h + 64]
        qh_h = qh[:, 32 * h:32 * h + 32]
        ql_lo, ql_hi = ql_h & 0x0F, ql_h >> 4
        q = torch.cat([
            ql_lo[:, :32] | (((qh_h >> 0) & 3) << 4),
            ql_lo[:, 32:] | (((qh_h >> 2) & 3) << 4),
            ql_hi[:, :32] | (((qh_h >> 4) & 3) << 4),
            ql_hi[:, 32:] | (((qh_h >> 6) & 3) << 4),
        ], dim=1).float() - 32.0
        halves.append(sc[:, 8 * h:8 * h + 8].repeat_interleave(16, dim=1) * q)
    return (d * torch.cat(halves, dim=1)).to(dtype)


_DEQUANT = {"q4_k": q4k_dequant, "q6_k": q6k_dequant}


def dequant_matrix(raw: torch.Tensor, shape: Tuple[int, int], kind: str, dtype=torch.bfloat16) -> torch.Tensor:
    """Raw blocks ``[nb, block_bytes]`` → a weight matrix ``shape``
    (row-major over the flat dequantized stream, the GGUF tensor order)."""
    return _DEQUANT[kind](raw, dtype).reshape(shape)


# ---------------------------------------------------------------------------
# Host-side encoder
# ---------------------------------------------------------------------------

# llama.cpp's Q4_K_M recipe: everything Q4_K except the MLP down
# projection, which gets Q6_K (the quantization-sensitive product)
WEIGHT_KINDS = {
    "qkv_w": "q4_k",
    "attn_out_w": "q4_k",
    "mlp_gate_w": "q4_k",
    "mlp_up_w": "q4_k",
    "mlp_down_w": "q6_k",
}


def quantize_kquant_host(values: np.ndarray, kind: str) -> np.ndarray:
    """Valid k-quant blocks ``[nb, block_bytes] uint8`` from f32 values (flat
    length a multiple of 256), the JAX package's encoder byte for byte: a
    per-sub-block affine fit (not ggml's iterative search; the same bit
    layout, a slightly worse RMSE), decodable by this module and the host
    decoder."""
    flat = np.asarray(values, np.float32).reshape(-1)
    if flat.size % QK_K:
        raise ValueError("length must be a multiple of 256")
    nb = flat.size // QK_K
    blocks = flat.reshape(nb, QK_K)
    if kind == "q6_k":
        out = np.zeros((nb, Q6K_BLOCK_BYTES), np.uint8)
        sub = blocks.reshape(nb, 16, 16)
        amax = np.abs(sub).max(axis=2)  # [nb, 16]
        d = amax.max(axis=1) / (32.0 * 127.0)  # headroom for int8 scales
        d = np.where(d > 0, d, 1.0).astype(np.float16).astype(np.float32)
        sc = np.clip(np.round(amax / (32.0 * d[:, None])), -128, 127)
        scale = d[:, None, None] * sc[:, :, None]
        q = np.clip(np.round(sub / np.where(scale != 0, scale, 1.0)) + 32, 0, 63).astype(np.uint8)
        q = q.reshape(nb, QK_K)
        for h in (0, 1):
            qh128 = q[:, 128 * h:128 * h + 128]
            lo = qh128 & 0x0F
            hi2 = qh128 >> 4  # the 2 high bits
            out[:, 64 * h:64 * h + 32] = lo[:, :32] | (lo[:, 64:96] << 4)
            out[:, 64 * h + 32:64 * h + 64] = lo[:, 32:64] | (lo[:, 96:128] << 4)
            out[:, 128 + 32 * h:128 + 32 * h + 32] = (
                hi2[:, :32] | (hi2[:, 32:64] << 2) | (hi2[:, 64:96] << 4) | (hi2[:, 96:128] << 6))
        out[:, 192:208] = sc.astype(np.int8).view(np.uint8)
        out[:, 208:210] = d.astype(np.float16)[:, None].view(np.uint8)
        return out
    if kind != "q4_k":
        raise ValueError(f"unsupported kind {kind!r}")
    out = np.zeros((nb, Q4K_BLOCK_BYTES), np.uint8)
    sub = blocks.reshape(nb, 8, 32)
    vmax = sub.max(axis=2)
    vmin = np.minimum(sub.min(axis=2), 0.0)
    d = np.maximum(vmax - vmin, 1e-12).max(axis=1) / (63.0 * 15.0)
    d = d.astype(np.float16).astype(np.float32)
    dmin = (-vmin).max(axis=1) / 63.0
    dmin = dmin.astype(np.float16).astype(np.float32)
    sc = np.clip(np.round((vmax - vmin) / (15.0 * d[:, None])), 0, 63)
    mn = np.clip(np.round(-vmin / np.where(dmin > 0, dmin, 1.0)[:, None]), 0, 63)
    scale = d[:, None, None] * sc[:, :, None]
    q = np.clip(
        np.round((sub + dmin[:, None, None] * mn[:, :, None]) / np.where(scale != 0, scale, 1.0)), 0, 15,
    ).astype(np.uint8)  # [nb, 8, 32]
    # ggml's nibble order: group j holds sub-blocks 2j (low) and 2j+1 (high)
    for j in range(4):
        out[:, 16 + 32 * j:16 + 32 * j + 32] = q[:, 2 * j] | (q[:, 2 * j + 1] << 4)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = dmin.astype(np.float16)[:, None].view(np.uint8)
    packed = np.zeros((nb, 12), np.uint8)
    sc8 = sc.astype(np.uint8)
    mn8 = mn.astype(np.uint8)
    packed[:, 0:4] = (sc8[:, :4] & 63) | ((sc8[:, 4:] >> 4) << 6)
    packed[:, 4:8] = (mn8[:, :4] & 63) | ((mn8[:, 4:] >> 4) << 6)
    packed[:, 8:12] = (sc8[:, 4:] & 0x0F) | ((mn8[:, 4:] & 0x0F) << 4)
    out[:, 4:16] = packed
    return out


def _slabs(nb: int):
    return [(lo, min(lo + _SLAB_BLOCKS, nb)) for lo in range(0, nb, _SLAB_BLOCKS)]


def _pool() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(min(8, os.cpu_count() or 1))


def quantize_kquant_parallel(values: np.ndarray, kind: str) -> np.ndarray:
    """:func:`quantize_kquant_host` over slabs of whole super-blocks on a
    thread pool (numpy drops the GIL in its array loops). Blocks are
    independent, so the bytes are the serial encoder's."""
    flat = np.asarray(values, np.float32).reshape(-1)
    if flat.size % QK_K:
        raise ValueError("length must be a multiple of 256")
    parts = _slabs(flat.size // QK_K)
    with _pool() as ex:
        out = list(ex.map(lambda s: quantize_kquant_host(flat[s[0] * QK_K:s[1] * QK_K], kind), parts))
    return np.concatenate(out) if len(out) > 1 else out[0]


def dequantize_kquant_host(raw: np.ndarray, kind: str) -> np.ndarray:
    """Raw blocks ``[nb, block_bytes]`` → flat f32 values through the host
    decoder (:mod:`~trueno_rag_tpu_torch.models.gguf`), slab by slab on a
    thread pool."""
    from trueno_rag_tpu_torch.models.gguf import _dequantize_kquant

    raw = np.asarray(raw, np.uint8)
    parts = _slabs(raw.shape[0])
    with _pool() as ex:
        out = list(ex.map(lambda s: _dequantize_kquant(raw[s[0]:s[1]].reshape(-1), _GGML_TYPE[kind],
                                                       (s[1] - s[0]) * QK_K), parts))
    return np.concatenate(out) if len(out) > 1 else out[0]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _put(x, device, dtype=torch.float32) -> torch.Tensor:
    """A norm scale or the token table → a tensor on ``device`` (copied
    from the host: the source may be a read-only array)."""
    return torch.tensor(_host(x), dtype=dtype, device=device)


def quantize_nemotron_layer(layer: Mapping[str, Any], device=None) -> Dict[str, Any]:
    """One layer's weights (``[in, out]`` matrices and the two RMSNorm
    scales, numpy or tensors) → ``{matrix: raw blocks [nb, block_bytes]
    uint8, "rms1_scale", "rms2_scale": f32}`` on ``device`` (default: the
    card), in the Q4_K_M kinds of :data:`WEIGHT_KINDS`."""
    device = resolve_device(device)
    out: Dict[str, Any] = {
        name: torch.from_numpy(quantize_kquant_parallel(_host(layer[name]), kind)).to(device)
        for name, kind in WEIGHT_KINDS.items()
    }
    for name in ("rms1_scale", "rms2_scale"):
        out[name] = _put(layer[name], device)
    return out


def quantize_nemotron_params(params: Mapping[str, Any], device=None) -> Dict[str, Any]:
    """f32 Nemotron params → the layer-streamed quantized form on ``device``
    (default: the card): ``{"tok_emb": bf16, "final_rms_scale": f32,
    "layers": [quantize_nemotron_layer(...)], "shapes": {matrix: ((in,
    out), kind)}}``; norms and the embedding stay unquantized (llama.cpp
    keeps them so too). ``params`` is either package's layout: the JAX
    package's (per-layer weights stacked on a leading ``[L]`` axis) or the
    port's (``"layers"``: one dict per layer)."""
    device = resolve_device(device)
    if "layers" in params:
        layers = list(params["layers"])
    else:
        n = np.asarray(params["qkv_w"]).shape[0]
        keys = (*WEIGHT_KINDS, "rms1_scale", "rms2_scale")
        layers = [{k: np.asarray(params[k])[i] for k in keys} for i in range(n)]
    return {
        "tok_emb": _put(params["tok_emb"], device, torch.bfloat16),
        "final_rms_scale": _put(params["final_rms_scale"], device),
        "layers": [quantize_nemotron_layer(lp, device) for lp in layers],
        "shapes": {name: (tuple(_host(layers[0][name]).shape), kind) for name, kind in WEIGHT_KINDS.items()},
    }


def dequantize_nemotron_params(qparams: Mapping[str, Any]) -> Dict[str, Any]:
    """The quantized form → the port's Nemotron params (bf16 matrices) on
    the same device, each matrix decoded on the HOST by the GGUF decoder:
    the reference that :func:`nemotron_forward_quantized` is held to."""
    device = qparams["tok_emb"].device
    layers = []
    for lq in qparams["layers"]:
        lp = {}
        for name, (shape, kind) in qparams["shapes"].items():
            values = dequantize_kquant_host(lq[name].cpu().numpy(), kind).reshape(shape)
            lp[name] = torch.from_numpy(values).to(device=device, dtype=torch.bfloat16)
        lp["rms1_scale"], lp["rms2_scale"] = lq["rms1_scale"], lq["rms2_scale"]
        layers.append(lp)
    return {"tok_emb": qparams["tok_emb"], "layers": layers, "final_rms_scale": qparams["final_rms_scale"]}


# ---------------------------------------------------------------------------
# Quantized Nemotron forward (layer-streamed)
# ---------------------------------------------------------------------------


@torch.no_grad()
def nemotron_forward_quantized(qparams: Mapping[str, Any], token_ids: torch.Tensor, config) -> torch.Tensor:
    """The Nemotron forward (:func:`~trueno_rag_tpu_torch.models.nemotron.nemotron_forward`)
    with each layer's matrices unpacked from their k-quant blocks right
    before the layer runs, and freed after it: weight memory is the
    quantized stack plus one layer's matrices in ``config.compute_dtype``.
    Attention at T >= 512 is K4 under ``attention_impl="auto"``."""
    from trueno_rag_tpu_torch.models.nemotron import PAD_ID, _decoder_block, pool_last_token

    mask = token_ids != PAD_ID
    x = qparams["tok_emb"][token_ids].to(config.compute_dtype)
    for lq in qparams["layers"]:
        lp = {name: dequant_matrix(lq[name], shape, kind, dtype=config.compute_dtype)
              for name, (shape, kind) in qparams["shapes"].items()}
        lp["rms1_scale"], lp["rms2_scale"] = lq["rms1_scale"], lq["rms2_scale"]
        x = _decoder_block(x, mask, lp, config)
        del lp
    return pool_last_token(x, mask, qparams["final_rms_scale"], config)
