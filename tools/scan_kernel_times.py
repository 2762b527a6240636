#!/usr/bin/env python3
"""Time the port's scan, block-max and attention kernels at the smoke's
shapes on one NVIDIA GPU, to compare two trees of the repository on the
same card.

    cd <tree root> && PYTHONPATH=$PWD python3 <this file> [--label NAME] [--groups scan,block,maxsim,dense,attention]

Run it from each tree's root (the ``trueno_rag_tpu_torch`` it imports is
the one on ``PYTHONPATH``), alternating the trees (A, B, B, A) within one
machine session. Prints one JSON line: the card, its power limit and the
median CUDA-event milliseconds of, by group,
- scan: K1 ``scan_select_v3`` and K3 ``scan_select_int8_v3`` at 1,048,576
  x 384, B = 256, t_top 4, K1 also on the f32 rows (the inline-cast
  layout) and at the segment path's call shape (B = 64 over 17,825,792
  rows); K10a ``scan_select_v2`` and K10c ``scan_select_int8_v2`` at the
  K1 and K3 shape; K5
  ``scan_select_v3_indirect`` and K10b ``scan_select_v2_indirect`` at
  1,048,576 x 384, B = 8, tile_n 4096, t_top 16, 120 tiles + 8 pads;
- block: K8 ``scan_select`` and K9 ``scan_select_int8`` at 1,048,576 x
  384, B = 256, top 2 (the store's) and 4;
- maxsim: K6 ``maxsim_scan16_scores``, K11a ``maxsim_scan16_scores_v2``
  and K11b ``maxsim_scan16_scores_self_v2`` (group 256) at 1,048,576
  chunks x 32 tokens x 128, and K7 ``maxsim_scan_int8_scores`` on the same
  tokens in int8, B = 8, Lq = 8; K6 also at (B, Lq) = (32, 8) and (8, 32)
  there; K7 at the late-interaction store's launch shape, 262,144 chunks x
  32 x 384, B = 8, Lq = 32 and 16; K6 at late-262k.b32's launch there, B =
  32, Lq = 16, each query 6-14 real tokens and its padding rows zero;
- dense: K2 ``score_blockmax`` and K2b ``blockmax_only`` at 1,048,576 x
  384, B = 256, f32, beside ``torch.matmul`` + ``amax``;
- attention: K4 ``block_attention`` at (a) BH 32 x T 8192 x hd 128,
  causal and not, half the rows without their last 1,000 keys, beside SDPA
  with the same boolean causal-and-key mask and SDPA ``is_causal``, and at
  (b) 8 rows x 32 heads x T 1024 with ragged masks and an all-PAD row,
  beside SDPA with the same boolean causal-and-key mask.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

N, DIM, BATCH = 1 << 20, 384, 256
N_SEG = (1 << 24) + (1 << 20)  # the segment path's rows
TILE_N, K5_LIVE, K5_PADS = 4096, 120, 8  # the clustered path's tile list
LT, H, BQ, LQ, GROUP = 32, 128, 8, 8, 256
LI_N, LI_H = 262_144, 384  # the late-interaction store: chunks, MiniLM-L6's width
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


def scan_group(out, gen) -> None:
    from trueno_rag_tpu_torch.ops import dense_tiered as dt
    from trueno_rag_tpu_torch.ops.kernels import scan_select as ss

    m, q = unit((N, DIM), gen), unit((BATCH, DIM), gen)
    valid = torch.ones(N, dtype=torch.int32, device="cuda")
    mb, e, a = dt.prepare_tiered(m)
    qb, u, v = dt._bf16_query_bounds(q)
    out["K1_ms"] = cuda_ms(lambda: ss.scan_select_v3(qb, mb, e, a, valid, u, v, t_top=4))
    out["K1_f32_rows_ms"] = cuda_ms(lambda: ss.scan_select_v3(qb, m, e, a, valid, u, v, t_top=4))
    out["K10a_ms"] = cuda_ms(lambda: ss.scan_select_v2(qb, mb, e, a, valid, u, v, t_top=4))
    m_i8, s_row, e8, a8 = dt.prepare_int8(m)
    q_i8, t_q, u8, v8 = dt._int8_query_bounds(q)
    out["K3_ms"] = cuda_ms(lambda: ss.scan_select_int8_v3(q_i8, m_i8, s_row, e8, a8, valid, t_q, u8, v8, t_top=4))
    out["K10c_ms"] = cuda_ms(lambda: ss.scan_select_int8_v2(q_i8, m_i8, s_row, e8, a8, valid, t_q, u8, v8, t_top=4))
    del m_i8
    n_tiles = N // TILE_N
    live = torch.sort(torch.randperm(n_tiles, device="cuda", generator=gen)[:K5_LIVE]).values
    ids = torch.cat([live, torch.full((K5_PADS,), n_tiles, device="cuda", dtype=live.dtype)]).to(torch.int32)
    qb8, u8, v8 = dt._bf16_query_bounds(unit((8, DIM), gen))
    out["K5_ms"] = cuda_ms(lambda: ss.scan_select_v3_indirect(qb8, mb, e, a, valid, u8, v8, ids, tile_n=TILE_N,
                                                              t_top=16))
    out["K10b_ms"] = cuda_ms(lambda: ss.scan_select_v2_indirect(qb8, mb, e, a, valid, u8, v8, ids, tile_n=TILE_N,
                                                                t_top=16))
    del m, mb, e, a
    # the segment path's dense stage calls K1 with 64 queries over 17.8M rows
    mb = torch.empty((N_SEG, DIM), dtype=torch.bfloat16, device="cuda")
    e, a = torch.empty(N_SEG, device="cuda"), torch.empty(N_SEG, device="cuda")
    for lo in range(0, N_SEG, N):
        for dest, part in zip((mb, e, a), dt.prepare_tiered(unit((N, DIM), gen))):
            dest[lo:lo + N].copy_(part)
    valid = torch.ones(N_SEG, dtype=torch.int32, device="cuda")
    out["K1_17.8M_B64_ms"] = cuda_ms(lambda: ss.scan_select_v3(qb[:64], mb, e, a, valid, u[:64], v[:64], t_top=4))
    del mb, e, a, valid


def block_group(out, gen) -> None:
    from trueno_rag_tpu_torch.ops import dense_tiered as dt
    from trueno_rag_tpu_torch.ops.kernels import scan_select_v1 as v1

    m, q = unit((N, DIM), gen), unit((BATCH, DIM), gen)
    valid = torch.ones(N, dtype=torch.int32, device="cuda")
    mb, e, a = dt.prepare_tiered(m)
    qb, u, v = dt._bf16_query_bounds(q)
    m_i8, s_row, e8, a8 = dt.prepare_int8(m)
    q_i8, t_q, u8, v8 = dt._int8_query_bounds(q)
    del m
    for top in (2, 4):
        out[f"K8_top{top}_ms"] = cuda_ms(lambda: v1.scan_select(qb, mb, e, a, valid, u, v, top=top))
        out[f"K9_top{top}_ms"] = cuda_ms(lambda: v1.scan_select_int8(q_i8, m_i8, s_row, e8, a8, valid, t_q, u8, v8,
                                                                      top=top))


def dense_group(out, gen) -> None:
    from trueno_rag_tpu_torch.ops.kernels.dense_score import blockmax_only, score_blockmax

    m, q = unit((N, DIM), gen), unit((BATCH, DIM), gen)
    keep = torch.ones(N, dtype=torch.bool, device="cuda")
    out["K2_ms"] = cuda_ms(lambda: score_blockmax(q, m, keep))
    out["K2b_ms"] = cuda_ms(lambda: blockmax_only(q, m, keep))
    out["matmul_amax_ms"] = cuda_ms(lambda: torch.matmul(q, m.T).view(BATCH, -1, 128).amax(dim=2))


def maxsim_group(out, gen) -> None:
    from trueno_rag_tpu_torch.ops import dense_tiered as dt
    from trueno_rag_tpu_torch.ops import maxsim as pm
    from trueno_rag_tpu_torch.ops.kernels import maxsim_scan as km

    tok = torch.empty((N, LT, H), dtype=torch.bfloat16, device="cuda")
    for lo in range(0, N, 1 << 16):
        tok[lo:lo + (1 << 16)] = unit((1 << 16, LT, H), gen)
    t_mask = torch.ones((N, LT), dtype=torch.bool, device="cuda")
    tvalid = torch.ones(N, dtype=torch.bool, device="cuda")
    q16 = unit((BQ, LQ, H), gen).to(torch.bfloat16)
    out["K6_ms"] = cuda_ms(lambda: km.maxsim_scan16_scores(q16, tok, t_mask, tvalid))
    for bq, lq in ((32, 8), (8, 32)):
        qx = unit((bq, lq, H), gen).to(torch.bfloat16)
        out[f"K6_b{bq}_lq{lq}_ms"] = cuda_ms(lambda: km.maxsim_scan16_scores(qx, tok, t_mask, tvalid))
    bias = pm.prepare_maxsim_bias_l(t_mask, GROUP)
    out["K11b_ms"] = cuda_ms(lambda: km.maxsim_scan16_scores_self_v2(q16, tok, bias, tvalid, GROUP))
    del bias
    tok_l, bias_l, _, _ = pm.prepare_maxsim_scan16_opt(tok, t_mask, group=GROUP)
    lt_p = tok_l.shape[0] // (-(-N // GROUP) * GROUP)
    out["K11a_ms"] = cuda_ms(lambda: km.maxsim_scan16_scores_v2(q16, tok_l, bias_l, tvalid, lt_p, GROUP))
    del tok_l, bias_l
    tok8 = torch.empty((N, LT, H), dtype=torch.int8, device="cuda")
    s_tok = torch.empty((N, LT), dtype=torch.float32, device="cuda")
    for lo in range(0, N, 1 << 16):
        codes, scale, _ = dt._quantize_rows(tok[lo:lo + (1 << 16)].float().reshape(-1, H), clip=True)
        tok8[lo:lo + (1 << 16)] = codes.view(-1, LT, H)
        s_tok[lo:lo + (1 << 16)] = scale.view(-1, LT)
    del tok
    q8, tq, _ = dt._quantize_rows(q16.float().reshape(-1, H), clip=True)
    out["K7_ms"] = cuda_ms(lambda: km.maxsim_scan_int8_scores(q8.view(BQ, LQ, H), tq.view(BQ, LQ), tok8, s_tok,
                                                             t_mask, tvalid))
    del tok8, s_tok, t_mask, tvalid
    # the late-interaction store's launch: 262,144 chunks x 32 x 384 (MiniLM-L6), B = 8
    n, h = LI_N, LI_H
    tok8 = torch.empty((n, LT, h), dtype=torch.int8, device="cuda")
    s_tok = torch.empty((n, LT), dtype=torch.float32, device="cuda")
    for lo in range(0, n, 1 << 15):
        codes, scale, _ = dt._quantize_rows(unit((1 << 15, LT, h), gen).reshape(-1, h), clip=True)
        tok8[lo:lo + (1 << 15)] = codes.view(-1, LT, h)
        s_tok[lo:lo + (1 << 15)] = scale.view(-1, LT)
    t_mask = torch.ones((n, LT), dtype=torch.bool, device="cuda")
    tvalid = torch.ones(n, dtype=torch.bool, device="cuda")
    for lq in (LT, LT // 2):  # the retriever pads query tokens to a power of two up to 32: 16 for short queries
        q8, tq, _ = dt._quantize_rows(unit((BQ * lq, h), gen), clip=True)
        out[f"K7_li_lq{lq}_ms"] = cuda_ms(lambda: km.maxsim_scan_int8_scores(q8.view(BQ, lq, h), tq.view(BQ, lq), tok8,
                                                                            s_tok, t_mask, tvalid))
    del tok8, s_tok
    # late-262k.b32's launch: the bf16 replica, 32 queries of 6-14 real tokens padded to Lq 16
    tok = torch.empty((n, LT, h), dtype=torch.bfloat16, device="cuda")
    for lo in range(0, n, 1 << 15):
        tok[lo:lo + (1 << 15)] = unit((1 << 15, LT, h), gen)
    b, lq = 32, 16
    lens = torch.randint(6, 15, (b,), device="cuda", generator=gen)
    q16 = (unit((b, lq, h), gen) * (torch.arange(lq, device="cuda")[None, :] < lens[:, None])[..., None]).to(
        torch.bfloat16)
    out["K6_late_b32_lq16_ms"] = cuda_ms(lambda: km.maxsim_scan16_scores(q16, tok, t_mask, tvalid))
    out["K6_late_q_tokens"] = int(lens.sum())
    out["K6_wgmma_launches"] = getattr(km.maxsim_scan16_scores, "wgmma_launches", 0)


def attention_group(out, gen) -> None:
    from trueno_rag_tpu_torch.ops.kernels.attention import block_attention

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
    keep = mask[:, None, None, :] & torch.ones(t, t, dtype=torch.bool, device="cuda").tril()[None, None]
    qs, ks, vs = (x.view(b, heads, t, hd) for x in (qb4, kb4, vb4))
    out["sdpa_masked_b_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=keep))


GROUPS = {"scan": scan_group, "block": block_group, "maxsim": maxsim_group, "dense": dense_group,
          "attention": attention_group}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--groups", default=",".join(GROUPS), help="comma-separated: " + ", ".join(GROUPS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scan_kernel_times: needs a CUDA device")
    from trueno_rag_tpu_torch.ops.dense import require_fp32

    require_fp32()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"label": args.label}
    for name in args.groups.split(","):
        GROUPS[name](out, gen)
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out["card"] = smi.stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
