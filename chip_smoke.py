#!/usr/bin/env python3
"""Smoke test of trueno_rag_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--seed 0]

Run from the repository root. Phases, each fatal on failure:

1. device: the card's name and power limit (nvidia-smi), TF32 off, and a
   fresh build of the CUDA kernel library from ``trueno_rag_tpu_torch/csrc``;
2. kernel: ``scan_select_v3`` against its plain PyTorch version at the main
   path's shapes (N = 1,048,576 unit rows, a multiple of the store's
   4096-row tile, so no padding; d = 384, B = 256, t_top 4): values within 1e-4, rows equal on >= 99.9% of slots with every
   difference at a near-tie, the emitted bounds sound against float64 true
   scores, and both versions timed with CUDA events;
3. slice: a RagPipeline with ``VectorStoreConfig(scan_tier="auto")`` ingests
   1,048,576 one-chunk documents (60 words from a 20,000-word vocabulary),
   must be on the bf16 tier, and answers 4 batches of 256 queries through
   ``query_with_context_batch(k=5)``; the kernel's launch count must rise,
   the dense candidates must equal the exact fp32 ``dense_topk`` rows and
   scores, and the fused lists must equal the host fusion oracle.

The last two lines of standard output are JSON: the per-kernel record, then
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

N_ROWS = 1 << 20
DIM = 384
BATCH = 256
T_TOP = 4
N_BATCHES = 4
K = 5
VOCAB = 20_000
DOC_WORDS = 60
QUERY_WORDS = 6
V_TOL = 1e-4  # f32 sums of d=384 bf16 products in another order: ~d*2^-24 for unit rows
ROW_AGREE = 0.999


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def phase_device():
    import torch

    from trueno_rag_tpu_torch.ops.dense import require_fp32
    from trueno_rag_tpu_torch.ops.kernels import scan_select as ks

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"nvidia-smi: {smi.stdout.strip()}")
    require_fp32()
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    check(not torch.backends.cudnn.allow_tf32, "TF32 cudnn is on")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    ks.build_library(force=True)
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for line in ks.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  nvcc: {line.strip()}")


def phase_kernel(seed: int) -> dict:
    import torch

    from trueno_rag_tpu_torch.ops import dense_tiered as dt
    from trueno_rag_tpu_torch.ops.kernels.scan_select import (
        BLOCK, SEL, block_bound_maxes, scan_select_v3, scan_select_v3_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = torch.randn(N_ROWS, DIM, device=dev, generator=gen)
    m /= torch.linalg.vector_norm(m, dim=1, keepdim=True)
    q = torch.randn(BATCH, DIM, device=dev, generator=gen)
    q /= torch.linalg.vector_norm(q, dim=1, keepdim=True)
    valid = torch.ones(N_ROWS, dtype=torch.int32, device=dev)
    valid[1000:1040] = 0  # a partly masked block
    valid[5 * BLOCK:6 * BLOCK] = 0  # a fully masked block
    mb, e_l2, a_l2 = dt.prepare_tiered(m)
    check(bool((e_l2 > 0).any()), "prepare_tiered's e_l2 is all zero on the device")
    log(f"prepare_tiered: e_l2 mean {e_l2.mean().item():.3e}, nonzero {int((e_l2 > 0).sum())}/{N_ROWS}")
    qb, u_q, v_q = dt._bf16_query_bounds(q)
    args = (qb, mb, e_l2, a_l2, valid, u_q, v_q)

    vk, rk = scan_select_v3(*args, t_top=T_TOP)
    torch.cuda.synchronize()
    vr, rr = scan_select_v3_reference(*args, t_top=T_TOP)
    torch.cuda.synchronize()
    check(tuple(vk.shape) == (BATCH, T_TOP + 1, N_ROWS // SEL), f"v_pack shape {tuple(vk.shape)}")
    check(tuple(rk.shape) == (BATCH, T_TOP, N_ROWS // SEL), f"r_pack shape {tuple(rk.shape)}")
    inf_k, inf_r = torch.isneginf(vk), torch.isneginf(vr)
    check(torch.equal(inf_k, inf_r), "kernel and plain version disagree on -inf slots")
    check(bool(torch.isfinite(vk[~inf_k]).all()), "non-finite kernel values")
    max_err = (vk[~inf_k] - vr[~inf_r]).abs().max().item()
    log(f"kernel vs plain: v_pack max |diff| {max_err:.3e} (tolerance {V_TOL})")
    check(max_err <= V_TOL, f"v_pack differs by {max_err}")

    eb, ab = block_bound_maxes(e_l2, a_l2)
    corr = eb[:, None] * u_q[None, :] + ab[:, None] * v_q[None, :]  # [N/128, B]

    def upper(rows, bidx):  # raw bf16 score + block correction, f64
        s = (mb[rows].double() * qb[bidx].double()).sum(dim=-1)
        return s + corr[rows // BLOCK, bidx].double()

    diff = rk != rr
    agree = 1.0 - diff.float().mean().item()
    bi, ti, gi = torch.nonzero(diff, as_tuple=True)
    gap = 0.0
    if bi.numel():
        gap = (upper(rk[bi, ti, gi].long(), bi) - upper(rr[bi, ti, gi].long(), bi)).abs().max().item()
    log(f"kernel vs plain: r_pack agreement {agree:.6f} ({int(diff.sum())} slots differ, max |dv| {gap:.3e})")
    check(agree >= ROW_AGREE, f"r_pack agreement {agree} < {ROW_AGREE}")
    check(gap <= V_TOL, f"a differing row is not a near-tie (|dv| = {gap})")

    # soundness: every emitted value and tile threshold bounds the true
    # float64 score of the rows it covers
    g_sub = torch.randperm(N_ROWS // SEL, device=dev, generator=gen)[:8].tolist() + [0]
    qs = torch.randperm(BATCH, device=dev, generator=gen)[:16].tolist()
    m64, q64 = m.double(), q.double()
    worst = float("inf")
    for b in qs:
        for g in g_sub:
            rows = torch.arange(g * SEL, (g + 1) * SEL, device=dev)
            true = m64[rows] @ q64[b]
            true = torch.where(valid[rows] != 0, true, float("-inf"))
            cand = rk[b, :, g].long()
            cv = vk[b, :T_TOP, g].double()
            live = ~torch.isneginf(cv)
            check(bool(((cand[live] >= g * SEL) & (cand[live] < (g + 1) * SEL)).all()), "row outside its tile")
            if live.any():
                slack = (cv[live] - true[cand[live] - g * SEL]).min().item()
                check(slack >= 0.0, f"candidate value below its true score (b={b}, tile={g}, {slack})")
                worst = min(worst, slack)
            covered = torch.ones(SEL, dtype=torch.bool, device=dev)
            covered[cand[live] - g * SEL] = False
            rest = true[covered]
            if (~torch.isneginf(rest)).any():
                slack = vk[b, T_TOP, g].double().item() - rest.max().item()
                check(slack >= 0.0, f"tile threshold below a covered row's true score (b={b}, tile={g})")
                worst = min(worst, slack)
    log(f"soundness: {len(qs)} queries x {len(g_sub)} tiles bounded, least slack {worst:.3e}")

    ms = cuda_ms(lambda: scan_select_v3(*args, t_top=T_TOP), 20)
    plain_ms = cuda_ms(lambda: scan_select_v3_reference(*args, t_top=T_TOP), 5)
    ms2 = cuda_ms(lambda: scan_select_v3(*args, t_top=T_TOP), 20)
    log(f"scan_select_v3 at N={N_ROWS} d={DIM} B={BATCH}: kernel {ms:.3f} / {ms2:.3f} ms, plain {plain_ms:.3f} ms (median, CUDA events)")
    flop = 2.0 * BATCH * N_ROWS * DIM
    log(f"  kernel rate {flop / (min(ms, ms2) * 1e-3) / 1e12:.1f} TFLOP/s fp32 FMA (2*B*N*d / time)")
    del m, q, mb, e_l2, a_l2, vr, rr, m64, q64
    torch.cuda.empty_cache()
    return {
        "name": "scan_select_v3",
        "route": "cuda",
        "source": "trueno_rag_tpu_torch/csrc/scan_select_v3.cu",
        "replaces": "trueno_rag_tpu/ops/pallas/scan_select_v2.py:433",
        "max_abs_err": max_err,
        "ms": min(ms, ms2),
        "plain_ms": plain_ms,
    }


def make_texts(rng, n: int, words: int):
    import numpy as np

    word_arr = np.array([f"w{i:05d}" for i in range(VOCAB)])
    out = []
    for lo in range(0, n, 65536):
        ids = rng.integers(0, VOCAB, size=(min(65536, n - lo), words))
        out.extend(" ".join(row) for row in word_arr[ids])
    return out


def stage_breakdown(pipe, qs) -> None:
    """Host-clock time of each stage of one batch, each call synchronized."""
    import numpy as np
    import torch

    from trueno_rag_tpu_torch.ops.fusion import fuse_topk

    retr = pipe.retriever
    cand = retr.config.candidates_per_source

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    qv, t_embed = timed(lambda: np.asarray(retr.embedder.embed_queries(qs), dtype=np.float32))
    (d_s, d_r), t_dense = timed(lambda: retr.vector_store.search_arrays(qv, cand))
    _, t_slots = timed(lambda: retr.sparse_index._gather_blocks(qs))
    (s_s, s_r), t_sparse = timed(lambda: retr.sparse_index.search_arrays(qs, cand))
    _, t_fuse = timed(lambda: fuse_topk(d_r, d_s, s_r, s_s))
    res, t_retr = timed(lambda: retr.retrieve_batch(qs, 2 * K))
    _, t_post = timed(lambda: [
        pipe.assembler.assemble(pipe.reranker.rerank(q, c, K), query=q) for q, c in zip(qs, res)
    ])
    log(f"stages of one batch (ms, host clock, synchronized): embed {t_embed:.1f}, "
        f"dense tier {t_dense:.1f}, bm25 {t_sparse:.1f} (host slot lists {t_slots:.1f}), "
        f"fusion {t_fuse:.1f}; retrieve_batch {t_retr:.1f}; rerank + assemble {t_post:.1f}")


def phase_slice(seed: int) -> int:
    import numpy as np
    import torch

    import trueno_rag_tpu_torch as rag
    from trueno_rag_tpu_torch.ops.dense import dense_topk
    from trueno_rag_tpu_torch.ops.fusion import fuse_topk
    from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_v3

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    docs = [rag.Document(t, id=f"doc{i}") for i, t in enumerate(make_texts(rng, N_ROWS, DOC_WORDS))]
    log(f"documents: {len(docs)} generated in {time.perf_counter() - t0:.1f} s")
    pipe = (
        rag.RagPipelineBuilder()
        .with_embedder(rag.MockEmbedder(DIM))
        .with_reranker(rag.LexicalReranker())
        .with_vector_config(rag.VectorStoreConfig(scan_tier="auto"))
        .with_device("cuda")
        .build()
    )
    retr = pipe.retriever
    store = retr.vector_store
    t0 = time.perf_counter()
    n_chunks = pipe.index_documents(docs)
    t_ingest = time.perf_counter() - t0
    del docs
    check(n_chunks == N_ROWS, f"indexed {n_chunks} chunks, expected {N_ROWS}")
    log(f"ingest (chunk + embed + index, host): {n_chunks} chunks in {t_ingest:.1f} s = {n_chunks / t_ingest:.0f} chunks/s")
    log(f"native BM25 builder active: {retr.sparse_index.native_active}")
    check(store._effective_tier() == "bf16", f"effective tier {store._effective_tier()!r}, expected 'bf16'")
    t0 = time.perf_counter()
    retr.ensure_ready()
    torch.cuda.synchronize()
    log(f"device build (upload, bf16 replica, BM25 block table): {time.perf_counter() - t0:.1f} s")

    batches = [[" ".join(r) for r in b] for b in (
        np.array([f"w{i:05d}" for i in range(VOCAB)])[rng.integers(0, VOCAB, size=(BATCH, QUERY_WORDS))]
        for _ in range(N_BATCHES)
    )]
    warm = pipe.query_with_context_batch(batches[0], k=K)  # first-call set-up
    check(len(warm) == BATCH, "warm-up batch")

    torch.cuda.reset_peak_memory_stats()
    fb_before = store.tier_fallback_queries
    scan_select_v3.launches = 0
    lat, contexts = [], []
    for qs in batches:
        t0 = time.perf_counter()
        contexts.append(pipe.query_with_context_batch(qs, k=K))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    launches = scan_select_v3.launches
    fallbacks = store.tier_fallback_queries - fb_before
    peak = torch.cuda.max_memory_allocated()
    log(f"main path: scan_select_v3 launches {launches}")
    check(launches > 0, "the main path never launched scan_select_v3")
    for i, t in enumerate(lat):
        log(f"batch {i}: {t * 1e3:.1f} ms = {BATCH / t:.0f} queries/s (host clock, query_with_context_batch k={K})")
    log(f"median batch {sorted(lat)[len(lat) // 2] * 1e3:.1f} ms; {BATCH * len(lat) / sum(lat):.0f} queries/s overall")
    n_q = BATCH * N_BATCHES
    log(f"certified fraction {(n_q - fallbacks) / n_q:.4f} ({fallbacks} of {n_q} queries fell back to fp32)")
    log(f"torch.cuda.max_memory_allocated during queries: {peak / 2**30:.2f} GiB")

    stage_breakdown(pipe, batches[0])

    # outputs: well-formed contexts
    for batch in contexts:
        check(len(batch) == BATCH, "one context per query")
        for ctx in batch:
            check(0 < len(ctx.chunks) <= K, f"{len(ctx.chunks)} chunks in a context")
            check(len(ctx.citations) == len(ctx.chunks), "one citation per chunk")
            check(all(np.isfinite(c.score) for c in ctx.chunks), "non-finite score")
            check(all(c.content for c in ctx.chunks), "empty chunk content")

    # dense candidates: the certified tier equals the exact fp32 path
    # (both report ops.dense.exact_scores, so even near-ties agree)
    cand = retr.config.candidates_per_source
    strategy = retr.config.fusion
    for i, qs in enumerate(batches):
        qv = np.asarray(retr.embedder.embed_queries(qs), dtype=np.float32)
        s_t, r_t = store.search_arrays(qv, cand)
        s_x, r_x = dense_topk(torch.from_numpy(qv).cuda(), store.device_matrix, store.device_valid, cand, "cosine")
        check(torch.equal(r_t, r_x), f"batch {i}: tier rows differ from the exact fp32 rows")
        check(torch.equal(s_t, s_x), f"batch {i}: tier scores differ from the exact fp32 scores")
        s_s, r_s = retr.sparse_index.search_arrays(qs, cand)
        f_r, f_s = fuse_topk(r_t, s_t, r_s, s_s, kind=strategy.kind, param=strategy.device_param)
        f_r, f_s = f_r.cpu().numpy(), f_s.cpu().numpy()
        d_l, s_l = r_t.cpu().numpy(), s_t.cpu().numpy()
        sp_r, sp_s = r_s.cpu().numpy(), s_s.cpu().numpy()
        for j in range(8):
            host = dict(strategy.fuse(
                [(int(r), float(s)) for r, s in zip(d_l[j], s_l[j]) if r >= 0],
                [(int(r), float(s)) for r, s in zip(sp_r[j], sp_s[j]) if r >= 0],
            ))
            dev = {int(r): float(s) for r, s in zip(f_r[j], f_s[j]) if r >= 0}
            check(dev.keys() == host.keys(), f"batch {i} query {j}: fused rows differ from the host oracle")
            check(all(abs(dev[r] - host[r]) <= 1e-6 for r in dev), f"batch {i} query {j}: fused scores differ")
    log(f"dense rows and scores identical to exact fp32 dense_topk for all {n_q} queries; "
        f"fused lists match the host oracle")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs a GPU", file=sys.stderr)
        return 2
    phase_device()
    record = phase_kernel(args.seed)
    record["launches"] = phase_slice(args.seed)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    log(f"nvidia-smi: {smi.stdout.strip()}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: record[k] for k in keys}]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
