"""The late-interaction scans as CUDA kernels for Hopper, plus their plain
PyTorch versions (``csrc/maxsim_scan.cu``):

- ``maxsim_scan16_scores``: the bf16 MaxSim of every query against every
  chunk, counterpart of the Pallas TPU kernel
  ``trueno_rag_tpu/ops/pallas/maxsim_scan.py::maxsim_scan16_scores``;
- ``maxsim_scan_int8_scores``: the int8 form (an exact integer dot, the
  token scale after the dot, the query scale after the max), counterpart
  of ``maxsim_scan.py::maxsim_scan_int8_scores``;
- ``maxsim_scan16_scores_v2`` and ``maxsim_scan16_scores_self_v2``: the
  bf16 form with the padding excluded by an l-major additive bias
  (``ops/maxsim.prepare_maxsim_bias_l``), over the l-major pack
  (``prepare_maxsim_scan16_opt``) or the primary ``[N, Lt, H]`` tokens read
  in place, counterparts of ``maxsim_scan.py::maxsim_scan16_scores_v2`` and
  ``maxsim_scan16_scores_self_v2``. On the same bf16 values and valid
  tokens their kernels give the bf16 kernel's scores bit for bit.

Both → ``[B, N]`` f32: ``Σᵢ maxⱼ`` over the chunk's valid tokens, an empty
chunk's best counting 0, -inf at invalid chunks. The Lq-sum runs over i in
ascending order in the kernels and the plain versions alike. The int8
kernel is bit-identical to its plain version; the bf16 kernel sums each
dot's exact products on the tensor cores, 16 at a time, the slices added
in f32 (``csrc/mma_bf16.cuh``), within the certificate's
``κ = (H+Lq)·2⁻²³`` share per program.
Any width H: a width that is not a multiple of the kernels' 16-byte
vector is read byte by byte with zero columns past H
(``csrc/row_load.cuh``), so the zero-copy tier reads the stored tokens in
place at any H.

The bf16 kernel has two programs, chosen by the width alone
(:func:`_k6_program`): at a width whose rows are 16-byte aligned (H a
multiple of 8) a Hopper program on TMA, mbarriers and ``wgmma``
(``csrc/maxsim_wgmma.cuh``), elsewhere the ``cp.async`` and ``mma.sync``
program the other three scans share; both give the same bits.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to
the kernel, or the call raises. The kernels are built at first use by
:mod:`~trueno_rag_tpu_torch.ops.kernels.build`.
"""

from __future__ import annotations

import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.dense import require_fp32
from trueno_rag_tpu_torch.ops.kernels.build import entry

NEG_INF = float("-inf")
_PLAIN_ELEMS = 1 << 26  # f32 interaction entries per slab of the plain versions (256 MiB)
_MASK_BIAS = -(2.0**30)  # the v2 scans' padding bias (the JAX package's ops/pallas/maxsim_scan.py)
_EMPTY_BELOW = -(2.0**29)  # with the _MASK_BIAS padding, a best at or below this is an empty chunk's


def _check(q, tok, t_mask, valid, q_dtype, tok_dtype, name: str) -> None:
    if q.dim() != 3 or tok.dim() != 3 or q.shape[2] != tok.shape[2]:
        raise InvalidConfigError(f"{name}: need q [B, Lq, H] and tokens [N, Lt, H], got "
                                 f"{tuple(q.shape)}, {tuple(tok.shape)}")
    if q.dtype != q_dtype or tok.dtype != tok_dtype:
        raise InvalidConfigError(f"{name}: q must be {q_dtype} and tokens {tok_dtype}, got {q.dtype}, {tok.dtype}")
    n, lt = tok.shape[0], tok.shape[1]
    if t_mask.dtype != torch.bool or tuple(t_mask.shape) != (n, lt):
        raise InvalidConfigError(f"{name}: t_mask must be bool [{n}, {lt}], got {t_mask.dtype} {tuple(t_mask.shape)}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (n,):
        raise InvalidConfigError(f"{name}: valid must be bool [{n}], got {valid.dtype} {tuple(valid.shape)}")
    if q.shape[0] < 1 or q.shape[1] < 1 or n < 1 or lt < 1:
        raise InvalidConfigError(f"{name}: empty input {tuple(q.shape)}, {tuple(tok.shape)}")


def _launch(name: str, tensors, aligned, ints, b: int, n: int, dev) -> torch.Tensor:
    """Launch entry point ``name`` on the current stream of ``dev`` over
    ``tensors`` (all contiguous; the ``aligned`` ones read as 16-byte
    vectors) → the ``[b, n]`` f32 output."""
    if dev.type != "cuda":
        raise InvalidConfigError(f"{name[:-7]} runs on cpu or cuda tensors, got {dev}")
    if len({t.device for t in tensors}) != 1:
        raise InvalidConfigError(f"{name[:-7]}: all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise InvalidConfigError(f"{name[:-7]} needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in aligned):
        raise InvalidConfigError(f"{name[:-7]}: the query and token tensors must be 16-byte aligned")
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    fn = entry(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{name[:-7]} kernel launch failed: cudaError {err}")
    return out


def _lq_sum(best: torch.Tensor, b: int, lq: int, t_q=None) -> torch.Tensor:
    """``best [S, B·Lq]`` → ``[B, S]``: the Lq-sum over i in ascending
    order, each query token's best multiplied by its scale ``t_q [B, Lq]``
    first when one is given."""
    best = best.view(-1, b, lq)
    s = torch.zeros(best.shape[:2], dtype=torch.float32, device=best.device)
    for i in range(lq):
        s = s + (best[:, :, i] if t_q is None else t_q[None, :, i] * best[:, :, i])
    return s.T


def _max_sum(sims: torch.Tensor, t_mask: torch.Tensor, b: int, lq: int, t_q=None) -> torch.Tensor:
    """``sims [S, Lt, B·Lq]`` (overwritten) → ``[B, S]``: the masked max
    over Lt (an empty chunk's -inf best counts 0), then :func:`_lq_sum`."""
    sims.masked_fill_(~t_mask[:, :, None], NEG_INF)
    best = sims.amax(dim=1)
    return _lq_sum(torch.where(torch.isfinite(best), best, 0.0), b, lq, t_q)


def _bias_max_sum(sims: torch.Tensor, bias: torch.Tensor, b: int, lq: int) -> torch.Tensor:
    """``sims [S, Lt, B·Lq]`` (overwritten) plus ``bias [S, Lt]`` → ``[B,
    S]``: the max over every position, a best at or below -2^29 (an empty
    chunk's) reset to 0, then :func:`_lq_sum`: the v2 kernels' program."""
    sims += bias[:, :, None]
    best = sims.amax(dim=1)
    return _lq_sum(torch.where(best > _EMPTY_BELOW, best, 0.0), b, lq)


def _slabs(n: int, lt: int, h: int, bl: int):
    step = max(1, _PLAIN_ELEMS // (lt * max(h, bl)))
    return ((lo, min(n, lo + step)) for lo in range(0, n, step))


def _k6_program(h: int) -> str:
    """The bf16 kernel's program at width ``h``: ``"wgmma"`` where rows are
    16-byte aligned, which TMA needs, else ``"cp.async"``."""
    return "wgmma" if h % 8 == 0 else "cp.async"


def maxsim_scan16_scores(
    q16: torch.Tensor,  # [B, Lq, H] bf16 (padding tokens zeroed)
    tok16: torch.Tensor,  # [N, Lt, H] bf16 replica (or the bf16 primary itself)
    t_mask: torch.Tensor,  # [N, Lt] bool
    valid: torch.Tensor,  # [N] bool
) -> torch.Tensor:
    """→ ``[B, N]`` f32 bf16 MaxSim scores (-inf at invalid chunks).

    CPU tensors run :func:`maxsim_scan16_scores_reference`; CUDA tensors
    launch the kernel (counted in ``maxsim_scan16_scores.launches``) or
    raise. The kernel reads ``tok16`` in place, at any H. A launch of the
    ``wgmma`` program (:func:`_k6_program`) also counts in
    ``maxsim_scan16_scores.wgmma_launches``."""
    _check(q16, tok16, t_mask, valid, torch.bfloat16, torch.bfloat16, "maxsim_scan16_scores")
    if q16.device.type == "cpu":
        return maxsim_scan16_scores_reference(q16, tok16, t_mask, valid)
    b, lq, h = q16.shape
    n, lt = t_mask.shape
    q16 = q16.contiguous()
    wgmma = _k6_program(h) == "wgmma"
    out = _launch("maxsim_scan16_wgmma_launch" if wgmma else "maxsim_scan16_launch", (q16, tok16, t_mask, valid),
                  (q16, tok16), (b, lq, n, lt, h), b, n, q16.device)
    maxsim_scan16_scores.launches += 1
    maxsim_scan16_scores.wgmma_launches += wgmma
    return out


maxsim_scan16_scores.launches = 0
maxsim_scan16_scores.wgmma_launches = 0


def maxsim_scan16_scores_reference(q16, tok16, t_mask, valid) -> torch.Tensor:
    """Plain PyTorch version of the bf16 kernel, on any device: per slab of
    chunks an f32 matmul of the bf16 values (exact products, TF32 off),
    then :func:`_max_sum`."""
    _check(q16, tok16, t_mask, valid, torch.bfloat16, torch.bfloat16, "maxsim_scan16_scores")
    require_fp32()
    b, lq, h = q16.shape
    n, lt = t_mask.shape
    qf = q16.reshape(b * lq, h).float()
    out = torch.empty((b, n), dtype=torch.float32, device=q16.device)
    for lo, hi in _slabs(n, lt, h, b * lq):
        sims = (tok16[lo:hi].reshape(-1, h).float() @ qf.T).view(hi - lo, lt, b * lq)
        out[:, lo:hi] = _max_sum(sims, t_mask[lo:hi], b, lq)
    return out.masked_fill_(~valid[None, :], NEG_INF)


def _check_int8(q8, t_q, tok8, s_tok, t_mask, valid) -> None:
    name = "maxsim_scan_int8_scores"
    _check(q8, tok8, t_mask, valid, torch.int8, torch.int8, name)
    if t_q.dtype != torch.float32 or tuple(t_q.shape) != tuple(q8.shape[:2]):
        raise InvalidConfigError(f"{name}: t_q must be f32 {tuple(q8.shape[:2])}, got {t_q.dtype} {tuple(t_q.shape)}")
    if s_tok.dtype != torch.float32 or tuple(s_tok.shape) != tuple(t_mask.shape):
        raise InvalidConfigError(f"{name}: s_tok must be f32 {tuple(t_mask.shape)}, got {s_tok.dtype} "
                                 f"{tuple(s_tok.shape)}")
    if q8.shape[2] * 127 * 127 >= 1 << 24:
        raise InvalidConfigError(f"{name}: H*127^2 must stay below 2^24 (the integer dot exact in f32)")


def maxsim_scan_int8_scores(
    q8: torch.Tensor,  # [B, Lq, H] int8 (padding tokens all zero)
    t_q: torch.Tensor,  # [B, Lq] f32 per-query-token scales
    tok8: torch.Tensor,  # [N, Lt, H] int8 replica
    s_tok: torch.Tensor,  # [N, Lt] f32 per-token scales
    t_mask: torch.Tensor,  # [N, Lt] bool
    valid: torch.Tensor,  # [N] bool
) -> torch.Tensor:
    """→ ``[B, N]`` f32 int8 MaxSim scores (-inf at invalid chunks), in the
    order ``f32(dot)·s_tok``, masked max over Lt, ``Σᵢ t_qᵢ·bestᵢ`` over i
    ascending (the Pallas kernel's: scale after the max).

    CPU tensors run
    :func:`maxsim_scan_int8_scores_reference`; CUDA tensors launch the
    kernel (counted in ``maxsim_scan_int8_scores.launches``) or raise, at
    any H."""
    _check_int8(q8, t_q, tok8, s_tok, t_mask, valid)
    if q8.device.type == "cpu":
        return maxsim_scan_int8_scores_reference(q8, t_q, tok8, s_tok, t_mask, valid)
    b, lq, h = q8.shape
    n, lt = t_mask.shape
    q8 = q8.contiguous()
    out = _launch("maxsim_scan_int8_launch", (q8, t_q.contiguous(), tok8, s_tok, t_mask, valid), (q8, tok8),
                  (b, lq, n, lt, h), b, n, q8.device)
    maxsim_scan_int8_scores.launches += 1
    return out


maxsim_scan_int8_scores.launches = 0


def maxsim_scan_int8_scores_reference(q8, t_q, tok8, s_tok, t_mask, valid) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel, on any device: per slab an
    f32 matmul of the int8 values (exact in any order: every partial sum is
    an integer below 2²⁴), the token scale, then :func:`_max_sum` with the
    query scales. Its output equals the kernel's bit for bit."""
    _check_int8(q8, t_q, tok8, s_tok, t_mask, valid)
    require_fp32()
    b, lq, h = q8.shape
    n, lt = t_mask.shape
    qf = q8.reshape(b * lq, h).float()
    out = torch.empty((b, n), dtype=torch.float32, device=q8.device)
    for lo, hi in _slabs(n, lt, h, b * lq):
        dots = tok8[lo:hi].reshape(-1, h).float() @ qf.T  # [S·Lt, B·Lq]
        sims = (dots * s_tok[lo:hi].reshape(-1, 1)).view(hi - lo, lt, b * lq)
        out[:, lo:hi] = _max_sum(sims, t_mask[lo:hi], b, lq, t_q)
    return out.masked_fill_(~valid[None, :], NEG_INF)


def _check_v2(q16, tok, bias_l, valid, group: int, name: str, lt=None) -> int:
    """Check the v2 scans' inputs → the token count Lt of a row of groups:
    ``tok`` is the l-major pack ``[Gp·lt·group, H]`` when ``lt`` is given,
    else the primary ``[N, Lt, H]`` (``lt`` read from it); ``bias_l`` is the
    l-major f32 bias of ``Gp = ceil(N/group)`` groups (so a pack with a wrong
    ``lt`` raises instead of being mis-indexed)."""
    lmajor = lt is not None
    if q16.dim() != 3 or tok.dim() != (2 if lmajor else 3) or q16.shape[2] != tok.shape[-1]:
        raise InvalidConfigError(f"{name}: need q [B, Lq, H] and tokens {'[rows, H]' if lmajor else '[N, Lt, H]'}, "
                                 f"got {tuple(q16.shape)}, {tuple(tok.shape)}")
    if not lmajor:
        lt = tok.shape[1]
    if q16.dtype != torch.bfloat16 or tok.dtype != torch.bfloat16:
        raise InvalidConfigError(f"{name}: q and tokens must be bfloat16, got {q16.dtype}, {tok.dtype}")
    if valid.dtype != torch.bool or valid.dim() != 1:
        raise InvalidConfigError(f"{name}: valid must be a bool vector, got {valid.dtype} {tuple(valid.shape)}")
    if bias_l.dtype != torch.float32 or bias_l.dim() != 1:
        raise InvalidConfigError(f"{name}: bias_l must be an f32 vector, got {bias_l.dtype} {tuple(bias_l.shape)}")
    n = valid.shape[0]
    if q16.shape[0] < 1 or q16.shape[1] < 1 or n < 1 or lt < 1 or group < 1:
        raise InvalidConfigError(f"{name}: empty input or lt/group < 1: q {tuple(q16.shape)}, N {n}, lt {lt}, "
                                 f"group {group}")
    if not lmajor and tok.shape[0] != n:
        raise InvalidConfigError(f"{name}: tokens {tuple(tok.shape)} do not match valid [{n}]")
    need = -(-n // group) * lt * group
    if lmajor and tok.shape[0] != need:
        raise InvalidConfigError(f"{name}: the pack of {n} chunks in groups of {lt} x {group} has {need} rows, "
                                 f"got {tok.shape[0]}")
    if bias_l.shape[0] != need:
        raise InvalidConfigError(f"{name}: bias_l of {n} chunks in groups of {lt} x {group} has {need} entries, "
                                 f"got {bias_l.shape[0]}")
    return lt


def maxsim_scan16_scores_v2(
    q16: torch.Tensor,  # [B, Lq, H] bf16 (padding tokens zeroed)
    tok_l: torch.Tensor,  # [Gp·Lt_p·group, H] bf16 l-major pack
    bias_l: torch.Tensor,  # [Gp·Lt_p·group] f32 l-major mask bias
    valid: torch.Tensor,  # [N] bool
    lt: int,  # the pack's PADDED token count Lt_p
    group: int = 256,
) -> torch.Tensor:
    """→ ``[B, N]`` f32 bf16 MaxSim scores over an l-major pack (-inf at
    invalid chunks): chunk c's position l is row ``((c // group)·lt + l)·
    group + c % group`` of ``tok_l`` and entry of ``bias_l`` (0 valid,
    -2^30 padding). Any ``group`` >= 1.

    CPU tensors run :func:`maxsim_scan16_scores_v2_reference`; CUDA tensors
    launch the kernel (counted in ``maxsim_scan16_scores_v2.launches``) or
    raise."""
    _check_v2(q16, tok_l, bias_l, valid, group, "maxsim_scan16_scores_v2", lt)
    if q16.device.type == "cpu":
        return _v2_plain(q16, tok_l, bias_l, valid, lt, group)
    b, lq, h = q16.shape
    n = valid.shape[0]
    q16 = q16.contiguous()
    out = _launch("maxsim_scan16_v2_launch", (q16, tok_l, bias_l, valid), (q16, tok_l),
                  (b, lq, n, lt, h, group), b, n, q16.device)
    maxsim_scan16_scores_v2.launches += 1
    return out


maxsim_scan16_scores_v2.launches = 0


def maxsim_scan16_scores_v2_reference(q16, tok_l, bias_l, valid, lt: int, group: int = 256) -> torch.Tensor:
    """Plain PyTorch version of K11a, on any device: per slab of whole
    groups an f32 matmul of the bf16 values (TF32 off), re-laid chunk-major,
    then :func:`_bias_max_sum`."""
    _check_v2(q16, tok_l, bias_l, valid, group, "maxsim_scan16_scores_v2", lt)
    return _v2_plain(q16, tok_l, bias_l, valid, lt, group)


def _v2_plain(q16, tok_l, bias_l, valid, lt: int, group: int) -> torch.Tensor:
    require_fp32()
    b, lq, h = q16.shape
    n = valid.shape[0]
    qf = q16.reshape(b * lq, h).float()
    out = torch.empty((b, n), dtype=torch.float32, device=q16.device)
    span = lt * group
    for g0, g1 in _slabs(-(-n // group), span, h, b * lq):
        rows = slice(g0 * span, g1 * span)
        sims = (tok_l[rows].float() @ qf.T).view(g1 - g0, lt, group, b * lq).transpose(1, 2)
        bias = bias_l[rows].view(g1 - g0, lt, group).transpose(1, 2)
        s = _bias_max_sum(sims.reshape(-1, lt, b * lq), bias.reshape(-1, lt), b, lq)
        lo, hi = g0 * group, min(n, g1 * group)
        out[:, lo:hi] = s[:, :hi - lo]
    return out.masked_fill_(~valid[None, :], NEG_INF)


def maxsim_scan16_scores_self_v2(
    q16: torch.Tensor,  # [B, Lq, H] bf16 (padding tokens zeroed)
    tokens: torch.Tensor,  # [N, Lt, H] bf16 primary storage
    bias_l: torch.Tensor,  # [ceil(N/group)·Lt·group] f32 l-major mask bias
    valid: torch.Tensor,  # [N] bool
    group: int = 256,
) -> torch.Tensor:
    """→ ``[B, N]`` f32 bf16 MaxSim scores over the primary tokens read in
    place (-inf at invalid chunks), the padding excluded by the l-major
    ``bias_l`` of :func:`~trueno_rag_tpu_torch.ops.maxsim.prepare_maxsim_bias_l`.
    Any N (no tail copy) and any ``group`` >= 1.

    CPU tensors run :func:`maxsim_scan16_scores_self_v2_reference`; CUDA
    tensors launch the kernel (counted in
    ``maxsim_scan16_scores_self_v2.launches``) or raise."""
    lt = _check_v2(q16, tokens, bias_l, valid, group, "maxsim_scan16_scores_self_v2")
    if q16.device.type == "cpu":
        return _self_v2_plain(q16, tokens, bias_l, valid, group)
    b, lq, h = q16.shape
    n = valid.shape[0]
    q16 = q16.contiguous()
    out = _launch("maxsim_scan16_self_v2_launch", (q16, tokens, bias_l, valid), (q16, tokens),
                  (b, lq, n, lt, h, group), b, n, q16.device)
    maxsim_scan16_scores_self_v2.launches += 1
    return out


maxsim_scan16_scores_self_v2.launches = 0


def maxsim_scan16_scores_self_v2_reference(q16, tokens, bias_l, valid, group: int = 256) -> torch.Tensor:
    """Plain PyTorch version of K11b, on any device: per slab of whole
    groups an f32 matmul of the bf16 values (TF32 off), the bias re-laid
    chunk-major, then :func:`_bias_max_sum`."""
    _check_v2(q16, tokens, bias_l, valid, group, "maxsim_scan16_scores_self_v2")
    return _self_v2_plain(q16, tokens, bias_l, valid, group)


def _self_v2_plain(q16, tokens, bias_l, valid, group: int) -> torch.Tensor:
    require_fp32()
    lt = tokens.shape[1]
    b, lq, h = q16.shape
    n = valid.shape[0]
    qf = q16.reshape(b * lq, h).float()
    out = torch.empty((b, n), dtype=torch.float32, device=q16.device)
    span = lt * group
    for g0, g1 in _slabs(-(-n // group), span, h, b * lq):
        lo, hi = g0 * group, min(n, g1 * group)
        sims = (tokens[lo:hi].reshape(-1, h).float() @ qf.T).view(hi - lo, lt, b * lq)
        bias = bias_l[g0 * span:g1 * span].view(g1 - g0, lt, group).transpose(1, 2).reshape(-1, lt)
        out[:, lo:hi] = _bias_max_sum(sims, bias[:hi - lo], b, lq)
    return out.masked_fill_(~valid[None, :], NEG_INF)
