#!/usr/bin/env python3
"""Time the port's scan, block-max and attention kernels at the smoke's
shapes on one NVIDIA GPU, to compare two trees of the repository on the
same card.

    cd <tree root> && PYTHONPATH=$PWD python3 <this file> [--label NAME]

Run it from each tree's root (the ``trueno_rag_tpu_torch`` it imports is
the one on ``PYTHONPATH``), alternating the trees (A, B, B, A) within one
machine session. Prints one JSON line: the card, its power limit and the
median CUDA-event milliseconds of K1 ``scan_select_v3`` and K3
``scan_select_int8_v3`` at 1,048,576 x 384, B = 256, t_top 4, and of K6
``maxsim_scan16_scores`` and K7 ``maxsim_scan_int8_scores`` at 1,048,576
chunks x 32 tokens x 128, B = 8, Lq = 8; of K2 ``score_blockmax`` and K2b
``blockmax_only`` at 1,048,576 x 384, B = 256, f32, beside ``torch.matmul``
+ ``amax``; and of K4 ``block_attention`` at (a) BH 32 x T 8192 x hd 128,
causal and not, half the rows without their last 1,000 keys, beside SDPA
with the same boolean causal-and-key mask and SDPA ``is_causal``, and at (b)
8 rows x 32 heads x T 1024 with ragged masks and an all-PAD row.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

N, DIM, BATCH = 1 << 20, 384, 256
LT, H, BQ, LQ = 32, 128, 8, 8
REPS = 20


def cuda_ms(fn) -> float:
    """Median milliseconds of ``fn()`` over REPS runs after a warm-up."""
    fn()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[REPS // 2]


def unit(shape, gen):
    x = torch.randn(shape, device="cuda", generator=gen)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scan_kernel_times: needs a CUDA device")
    from trueno_rag_tpu_torch.ops import dense_tiered as dt
    from trueno_rag_tpu_torch.ops.dense import require_fp32
    from trueno_rag_tpu_torch.ops.kernels.attention import block_attention
    from trueno_rag_tpu_torch.ops.kernels.dense_score import blockmax_only, score_blockmax
    from trueno_rag_tpu_torch.ops.kernels.maxsim_scan import maxsim_scan16_scores, maxsim_scan_int8_scores
    from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_int8_v3, scan_select_v3

    require_fp32()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"label": args.label}
    m, q = unit((N, DIM), gen), unit((BATCH, DIM), gen)
    valid = torch.ones(N, dtype=torch.int32, device="cuda")
    mb, e, a = dt.prepare_tiered(m)
    qb, u, v = dt._bf16_query_bounds(q)
    out["K1_ms"] = cuda_ms(lambda: scan_select_v3(qb, mb, e, a, valid, u, v, t_top=4))
    m_i8, s_row, e8, a8 = dt.prepare_int8(m)
    q_i8, t_q, u8, v8 = dt._int8_query_bounds(q)
    out["K3_ms"] = cuda_ms(lambda: scan_select_int8_v3(q_i8, m_i8, s_row, e8, a8, valid, t_q, u8, v8, t_top=4))
    del mb, m_i8
    keep = torch.ones(N, dtype=torch.bool, device="cuda")
    out["K2_ms"] = cuda_ms(lambda: score_blockmax(q, m, keep))
    out["K2b_ms"] = cuda_ms(lambda: blockmax_only(q, m, keep))
    out["matmul_amax_ms"] = cuda_ms(lambda: torch.matmul(q, m.T).view(BATCH, -1, 128).amax(dim=2))
    del m

    tok = torch.empty((N, LT, H), dtype=torch.bfloat16, device="cuda")
    for lo in range(0, N, 1 << 16):
        tok[lo:lo + (1 << 16)] = unit((1 << 16, LT, H), gen)
    t_mask = torch.ones((N, LT), dtype=torch.bool, device="cuda")
    tvalid = torch.ones(N, dtype=torch.bool, device="cuda")
    q16 = unit((BQ, LQ, H), gen).to(torch.bfloat16)
    out["K6_ms"] = cuda_ms(lambda: maxsim_scan16_scores(q16, tok, t_mask, tvalid))
    tok8 = torch.empty((N, LT, H), dtype=torch.int8, device="cuda")
    s_tok = torch.empty((N, LT), dtype=torch.float32, device="cuda")
    for lo in range(0, N, 1 << 16):
        codes, scale, _ = dt._quantize_rows(tok[lo:lo + (1 << 16)].float().reshape(-1, H), clip=True)
        tok8[lo:lo + (1 << 16)] = codes.view(-1, LT, H)
        s_tok[lo:lo + (1 << 16)] = scale.view(-1, LT)
    del tok
    q8, tq, _ = dt._quantize_rows(q16.float().reshape(-1, H), clip=True)
    out["K7_ms"] = cuda_ms(lambda: maxsim_scan_int8_scores(q8.view(BQ, LQ, H), tq.view(BQ, LQ), tok8, s_tok,
                                                          t_mask, tvalid))
    del tok8, s_tok

    def qkv(bh, t, hd):
        return [torch.randn(bh, t, hd, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3)]

    def lengths_mask(t, lengths):
        return torch.arange(t, device="cuda")[None, :] < torch.tensor(lengths, device="cuda")[:, None]

    bh, t, hd = 32, 8192, 128
    qa, ka, va = qkv(bh, t, hd)
    mask = lengths_mask(t, [t - 1000 if i % 2 else t for i in range(bh)])
    out["K4_a_ms"] = cuda_ms(lambda: block_attention(qa, ka, va, mask, causal=True))
    out["K4_a_noncausal_ms"] = cuda_ms(lambda: block_attention(qa, ka, va, mask, causal=False))
    both = mask[:, None, :] & torch.ones(t, t, dtype=torch.bool, device="cuda").tril()[None]
    qs, ks, vs = (x[None] for x in (qa, ka, va))
    out["sdpa_masked_a_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=both[None]))
    del both
    out["sdpa_is_causal_a_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True))
    del qa, ka, va, qs, ks, vs
    b, heads, t = 8, 32, 1024
    qb4, kb4, vb4 = qkv(b * heads, t, hd)
    mask = lengths_mask(t, [t, t - 14, t - 21, 0, t - 7, t - 26, t, t - 16])
    out["K4_b_ms"] = cuda_ms(lambda: block_attention(qb4, kb4, vb4, mask, causal=True, heads=heads))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out["card"] = smi.stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
