#!/usr/bin/env python3
"""Smoke test of trueno_rag_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--seed 0]

Run from the repository root. Phases, each fatal on failure:

1. device: the card's name and power limit (nvidia-smi), TF32 off, and a
   fresh build of the CUDA kernels from ``trueno_rag_tpu_torch/csrc`` (one
   nvcc per source, all started together);
2. kernels, at the main path's shapes (N = 1,048,576 unit rows, d = 384,
   B = 256, t_top 4):
   - K1 ``scan_select_v3`` against its plain PyTorch version: values within
     1e-4, rows equal on >= 99.9% of slots with every difference at a
     near-tie;
   - K3 ``scan_select_int8_v3`` against its plain version: bit-identical
     values and rows;
   - both: the emitted bounds sound against float64 true scores, and both
     versions timed with CUDA events;
3. tags: K1 and K3 with a filter masking whole 128-row blocks and with one
   masking scattered rows, against their plain versions; then K3 on 65,536
   exact int8 rows with a planted three-way tie and masked blocks, bit for
   bit, the tie resolved as the plain version resolves it;
4. tier, at 10,485,760 x 384 device-generated unit rows, B = 256, k = 50:
   ``dense_topk_compact_bf16r`` (K1), ``dense_topk_compact`` (K3; both
   with no fp32 matrix in their inputs) and
   ``dense_topk_int8_tiered2_checked`` (K3 + exact rescore): certified
   fractions, every certified set equal to the float64 exact top-k set, the
   int8 tier equal to the exact fp32 path, batch and kernel times;
5. slice 1: a RagPipeline with ``VectorStoreConfig(scan_tier="auto")``
   ingests 1,048,576 one-chunk documents (60 words from a 20,000-word
   vocabulary), must be on the bf16 tier, and answers 4 batches of 256
   queries through ``query_with_context_batch(k=5)``; K1's launch count
   must rise, the dense candidates must equal the exact fp32
   ``dense_topk`` rows and scores, and the fused lists must equal the host
   fusion oracle;
6. stores on the same corpus (the slice's rows, chunks and BM25 index,
   not ingested again): ``scan_tier="int8"`` (exact) and
   ``scan_tier="compact"`` in the layouts bf16rr, bf16, int8 and bf16r
   (exact sets after the host patch) answer 1 batch of 256 (32 on compact
   int8, whose host patch costs ~0.25 s a query) through
   ``query_with_context_batch(k=5)``; then every chunk gets one of 4 tags
   by row and the compact bf16r store and the bf16 tile store answer a
   batch filtered ``all=["t1"]`` and one filtered ``none=["t0"]``;
7. kernels-K5 (run after phase 2): K5 ``scan_select_v3_indirect`` at the
   clustered path's shapes (1M x 384, B = 8, tile_n 4096, t_top 16, 120
   tiles + 8 pad slots) against its plain version and K1 over a copy of
   the same tiles, its bounds against float64, its tag variant, times;
8. clustered-1M: the slice's chunks, tags and BM25 index behind
   ``VectorStoreConfig(scan_tier="clustered")`` with a 1M blob corpus
   (``convert.retriever_from_state``): 2 batches of 8 and 2 single
   queries through ``query_with_context_batch(k=5)`` at 50 and at 12
   dense candidates per query (K5's launch count must rise; every dense
   set equal to the float64 exact set; fusion equal to the host oracle),
   a tag-filtered batch, and a 1% mutation that must refresh without
   k-means and stay exact; the store's build (``prepare_clustered_stream``
   over host slabs) is timed (no longer the host build
   ``prepare_clustered`` beside it: a depth cut for the smoke's time,
   PERF.md §4);
9. clustered-10.5M: ``prepare_clustered_stream`` over 10,485,760 blob rows
   generated on the card from their ids (its greedy fill held to, and
   timed against, the plain sequential loop), then the pruned op at B = 8 with
   fetch dma and gather (identical results, certified sets exact) against
   the full compact stream, with a torch.profiler trace of each fetch;
10. kernels-K4 (run after phase 7): K4 ``block_attention`` against its
   plain version at (a) BH = 32, T = 8192, hd = 128, causal, half the rows
   without their last 1,000 keys, (b) the Nemotron ingest shape, 8 rows x
   32 heads at T = 1024 with ragged masks and an all-PAD row (which must
   equal the mean of V), (c) T = 528, hd = 64, causal and not, (d) shape
   (b) with left-padded and future-only masks (rows with no kept key at or
   before their position must equal the mean of V over all T keys): every
   element within 2^-7 x max|V| of its head, the mean within 2^-12; times
   beside the plain version, SDPA with the same boolean mask (at (a) and
   (b)) and SDPA ``is_causal``, and the causal kernel beside the same call without
   ``causal`` (the skipped causal future);
11. nemotron-8k: ``NemotronEmbedder(NemotronConfig.full())`` (4096-d, 32
   layers, 32 heads, MLP 14,336, seeded bf16 weights on the card) embeds 8
   texts of 8,190 words (T = 8192, 32 K4 launches): tokens/s, peak
   memory, K4's share of device time (torch.profiler), unit norms, two
   calls bit-identical, and a 600-word text padded into an 8k batch equal
   to itself alone (T = 608, cosine >= 0.999);
12. nemotron-rag: a RagPipeline over that embedder ingests 512 one-chunk
   documents of 990-1,022 words (K4 in every layer of every batch) and
   answers 8 batches of 8 short queries (the materialized path): dense
   top-5 equal to the float64 exact top-5, fusion equal to the host oracle;
13. encoder-262k: ``EncoderEmbedder(EncoderConfig.minilm_l6())`` through
   ``index_documents`` over 262,144 documents like slice 1's (a depth cut
   from 1,048,576 for the smoke's time, PERF.md §4; ``scan_tier="bf16"``,
   which "auto" engages only past 400,000 rows); 4 batches
   of 256 staged on the bf16 tier (K1), one batch with ``fused=True`` over
   the fp32 matrix and 32 queries with ``fused=True`` on a compact bf16r
   store of the same rows (K1 + the host patch), every dense set equal to
   the exact path; then the cross-encoder reranks 32 queries x 50
   candidates;
14. kernels-K6K7 (run after phase 10), at the JAX package's serving shapes
   (``bench.py::bench_maxsim_1m`` and ``bench_maxsim_2m_int8_store``):
   K6 ``maxsim_scan16_scores`` over 1,048,576 chunks x 32 x 128 unit bf16
   tokens made on the card (the zero-copy pack) at (B, Lq) = (8, 8),
   (32, 8) and (8, 32), within 2·κ·C1·n_max of its plain version, its bound
   U = s + W at least the float64 MaxSim on 4,096 sampled chunks; K7
   ``maxsim_scan_int8_scores`` over 2,097,152 x 32 x 128 int8 tokens with
   scales at (8, 8), bit-identical to its plain version, U sound likewise;
   times beside the plain versions and the bounds; K7 again at the
   late-interaction store's launch shape (262,144 x 32 x 384 int8 tokens,
   B = 8, Lq = 32 and 16), bit-identical and timed; then
   ``maxsim_topk_scan16_fused`` and ``maxsim_topk_int8_store`` on random
   and planted queries: at least 75% certified, every certified set equal
   to the float64 exact top-10 set;
15. late-interaction-262k: ``LateInteractionRetriever(EncoderConfig.minilm_l6(),
   max_len=32)`` with the CLI's tiered token store (384-d, 32 tokens)
   indexes 262,144 one-chunk documents of 30 words and answers 4 batches
   of 8 spans of indexed documents and a tag-filtered batch through
   ``retrieve_batch(k=10)`` (K6); the same rows, through ``load_rows``, on
   bf16 storage with the int8 tier (K7), with the zero-copy bf16 tier
   (K6), on the token-pruned scan (1 batch) and on the exact scan: on
   each tiered store its kernel held against its plain version on the
   store's own replica at a batch's shapes (K6 within 2·κ·C1·n_max, K7
   bit for bit) and at least 75% of the queries certified; every answer
   equal to the float64 exact top-10 of the stored values, the f32 stores
   equal row for row, ``e_max`` non-zero; then
   ``LateInteractionReranker`` reranks 32 queries x 50 candidates, its
   scores held to float64 on a sample.

16. kernels-K8K9 (run after phase 2), at the slice's shapes (1,048,576
   unit rows, d = 384, B = 256, top 2 and 4): K8 ``scan_select`` against
   its plain version (values within 1e-4, lanes equal on >= 99.9% of slots
   with every difference at a near-tie), K9 ``scan_select_int8`` bit for
   bit, both sound against float64 (every emitted value at least its row's
   true score, v_{top+1} at least every row of its block not emitted),
   times beside the plain versions; K9 also on planted-tie exact data made
   as phase 3's (lanes 100, 9 at equal values; the masked block's lane
   127), bit for bit;
17. kernels-K2 (after phase 16), the same shapes in fp32: K2
   ``score_blockmax`` within 2(d+1)·2⁻²⁴ of torch.matmul (TF32 off; two
   f32 sums of the same unit-vector products), its maxima exactly the max
   of its scores, K2b ``blockmax_only``'s equal to them;
   ``dense_topk_blockmax`` and ``dense_topk_twopass`` equal to
   ``dense_topk`` (their launches counted there); times beside
   torch.matmul + amax;
18. odd-widths (after phase 14), d = H = 100: K1, K3, K5, K8 and K9 over
   65,536 rows and K6, K7 over 8,192 x 16 tokens against their plain
   versions; a bf16-tier batch of 256 equal to the exact fp32 path and a
   zero-copy token-store batch of 8 equal to its exact scan;
19. block-stores (after phase 6), on the slice's 1M corpus (siblings, no
   second ingest): ``VectorStoreConfig(scan_tier="bf16"|"int8"|"auto",
   scan_kernel="block")`` and ``(storage_dtype="bfloat16")`` each answer a
   batch of 256 through ``query_with_context_batch(k=5)``: K8's and K9's
   launch counts must rise, the block tiers' dense candidates equal the
   exact fp32 ``dense_topk`` rows and scores (certified fraction logged),
   the bf16-storage store's equal the float64 top-k over its own
   bf16-rounded rows up to near-ties;
20. kernels-K12 (after phase 4): a BM25 index over 17,825,792 documents of
   slice 1's text law (postings made on the card in slabs, packed by the
   index's own snapshot past ``MAX_BLOCK_ROWS`` = 2^24), B = 256 queries:
   K12a ``fetch_contribs`` and K12b ``fetch_contribs8`` over the index's
   segment plan against their plain version, rows and contributions bit
   for bit, times beside it and the bound; the tail's time; the index's
   ``search_arrays`` top-50 equal to the plain ``bm25_topk_segments``;
   ``bm25_topk_dma`` over the aligned plan at both widths (the only
   caller of K12a: the segment path runs K12b, so the ``kernels`` line
   counts K12a's launches on the path as 0);
21. segments-17.8M: the same rows as 384-d unit vectors with their bf16
   replica on the card; the staged query (K1 dense top-50, the segment
   BM25 with K12, RRF 60) at B = 256 timed by stage, 8 single queries, and
   ``hybrid_query_arrays_segments`` at B = 32 equal to the staged rows;
22. segments-store-1M (after phase 19), a code-path check: the 1M
   pipeline's BM25 index re-snapshotted with ``MAX_BLOCK_ROWS`` moved to
   2^19; ``query_with_context_batch`` (K1 + K12), single queries, a tag
   batch and a tier-none sibling (``hybrid_query_arrays_segments``) against
   the block path's answers on the same queries (BM25 equal up to counted
   near-ties); then the threshold and the block table restored;
23. kernels-K10 (after phase 7), on phase 2's corpus and batch: K10a
   ``scan_select_v2`` and K10c ``scan_select_int8_v2`` (t_top 4), and K10b
   ``scan_select_v2_indirect`` at phase 7's shapes (B = 8, tile_n 4096,
   t_top 16, 120 tiles + 8 pads), the v2 scans with each row's own bound:
   K10a/K10b against their plain versions as K1 is, K10c bit for bit,
   K10a and K10c also with both tag patterns, all three sound against
   float64 and every emitted value its row's own float64 upper bound; K1,
   K5, K10a and K10b over the f32 rows (the inline-cast layout)
   bit-identical to their bf16-replica runs, and K1 and K5 there also
   against their plain versions fed the f32 rows;
   ``dense_topk_tiered2_checked(m_bf16=None)`` equal to the replica run
   (scores, rows, fallbacks) at k = 50; the certified share of the bf16
   tier's own tail (k = 50) fed K10a's packs, then K1's, and K10c's, then
   K3's, on the same 256 queries, every certified query exact; times of
   each beside K1, K3 and K5 in the same call. Then the slice's path: each
   K10 entry point once (K10a and K10b on the f32 rows) and the inline-cast
   tier, with the counts set to 0 just before and read just after, each
   result equal to its checked run; the ``kernels`` line takes K10's
   launches from there, and K1's count adds the tier's. No other phase
   reaches K10: its counts are set to 0 after this phase and checked
   still 0 at the end of the run.
24. kernels-K11 (after phase 14): (a) over 1,048,576 x 32 x 128 bf16 unit
   tokens made on the card (kernels-K6's corpus), K11b
   ``maxsim_scan16_scores_self_v2`` reads them in place with
   ``prepare_maxsim_bias_l`` and K11a ``maxsim_scan16_scores_v2`` reads the
   l-major pack ``prepare_maxsim_scan16_opt`` (a second 8.6 GB) at (B, Lq)
   = (8, 8), (32, 8), (8, 32): each within 2·κ·C1·n_max of its plain
   version, bit-identical to K6 on the same queries, U = s + W at least the
   float64 MaxSim on 4,096 sampled chunks, and fed into the tier's tail at
   k = 10 the same rows and certificate as K6's; times beside K6 and the
   bound; (b) a ragged corpus (1,048,539 chunks, Lt 30 padded to 32 in the
   pack, an empty and an invalid chunk) at groups 256, 128 and 512, both
   bit-identical to K6; (c) ``prepare_maxsim_bounds`` (timed) and
   ``maxsim_topk_pruned`` (B = 8, Lq = 8, k = 10, rescore 128, select
   exact and approx, timed) on two 1,048,576 x 32 x 128 f32 corpora made on
   the card, ``benches/maxsim_bench.py``'s topic law and a tight law
   (clusters of 16 chunks around at most 8 topics of their own): every
   sampled token inside its radius, every certified answer the float64
   exact top-10, certified fractions logged (the tight law must certify).
   Then the slice's path: K11a and K11b once each, counts set to 0 just
   before and read just after; no later phase reaches K11 (checked 0 at
   the end).

25. mma-probe (after phase 10, before phase 14): the worst-case model of
   the tensor-core dot that K1, K5, K8, K10a/b, K6 and K11a/b share
   (``csrc/mma_bf16.cuh``) held to the card: K6 at Lt = Lq = 1 over 64
   crafted queries x 2,048 crafted rows (``ops.kernels.mma_model``: one
   large product beside fifteen just under its half-ulp or its ulp, a sweep
   of 2^-k terms, cancellation, exponent spreads, random) at H = 1, 15, 16,
   17, 100, 128 and 384, every dot against its float64 exact value: the
   worst |error| over the model's allowance (fatal above 1), the worst
   error in ulps of the largest product and the window the alignment
   appears to keep; then K1 over the same rows at d = 384, sound against
   float64 (``check_sound``) and bit-identical on the f32 rows, and K8
   over them at top 2 and 4, every emitted upper at least its row's
   float64 dot (``check_block_sound``, kernels-K8K9's check).
   Phase 21 also times K1 alone at the dense stage's call shape (B = 64
   over 17,825,792 rows); phases 21 and 22 add their K1 launches to the
   ``kernels`` line.
26. persist-1M (right after phase 5, on its pipeline): the 1,048,576-chunk
   index through ``save_index_streaming`` (the CLI's writer past 50,000
   chunks) under ``default_compression()`` after a free-disk check,
   ``load_index(scan_tier="auto")`` onto the card (``read_index_info`` is
   no longer timed at 1M: a depth cut for the smoke's time), and
   phase 5's four batches through ``query_with_context_batch(k=5)`` (K1):
   every dense row and score and every context identical to the in-memory
   pipeline's; save, load and device-build seconds, artifact bytes, the
   loaded pipeline's queries/s and the host RSS logged;
27. metrics-1M (after phase 26): 256 planted queries (8 words of a known
   chunk) through ``retrieve_batch(k=10)``, ``pad_ids`` and
   ``batched_metrics`` on the card, each query within 1e-6 of the host
   ``RetrievalMetrics``; recall@5, MRR and NDCG@10 logged, not gated;
28. clustered-artifact (inside phase 8, on its clean store after the first
   pass): saved (codec none) and loaded with ``scan_tier="clustered"``: no k-means build
   on load, the same layout, K5 on the loaded path, every dense row and
   score and every context equal to the saved store's;
29. cli (after phase 15): 2,048 .md files of slice 1's text law, a quarter
   in each of three tag folders, through ``cli.main`` in this process:
   ``index --embedder semantic --model mini-lm`` (MiniLM-L6 on the card),
   ``query --scan-tier bf16 --format json`` with and without
   ``--filter-any`` (K1), ``index --multi-vector`` and ``query`` (K6), each
   result equal to an in-memory pipeline's or retriever's over the same
   files; ``info`` and ``demo``;
30. checkpoint (after phase 29): ``save_checkpoint``/``load_checkpoint`` of
   MiniLM-L6 and of the Nemotron-class model at full width and 2 of its 32
   layers (depth cut: the 32-layer f32 file is 31.6 GB), embeddings
   bit-identical after the reload;
31. serve-1M (after phase 8, on phase 5's pipeline): ``prewarm`` and
   ``autotune_serving`` over batch sizes 1-256, then 1,024 single-query
   POSTs from 32 client threads through a ``MicroBatcher`` behind an
   in-process ``RagHTTPServer`` and behind a two-worker
   ``MultiProcessServer``: every answer equal to ``retrieve_batch``'s for
   the same query, ``/health`` on the bf16 tier, K1 launched; served q/s,
   p50/p99 request latency, batches and the mean batch size logged;
32. tri-hybrid-65k (after phase 15): 65,536 documents of phase 5's text
   law (scale cut: the 1M expansion is ~128M postings on the host; 262,144
   until slice 16, cut for the smoke's time),
   ``MockEmbedder(384)`` and a seeded ``SpladeEncoder`` at MiniLM-L6 width
   (64 tokens, 128 document and 32 query terms) through
   ``with_learned_sparse`` on tier "bf16" (staged, K1): 2 batches of 256,
   every learned candidate list against the float64 oracle up to
   near-ties; one batch staged on a sibling store on tier "none" (the fp32
   matrix, the default below the tier crossover), its lists identical to
   the bf16 tier's where the dense scores are tie-free; the index saved
   with its learned section (codec none),
   reloaded with the encoder (fingerprint checked) and identical answers;
   expansion s, postings, host snapshot s and batch ms logged;
33. inside phase 29: ``index --with-learned-sparse`` and ``serve`` on it in
   a subprocess (port 0, ready on its printed address), each query's
   ``/query`` JSON equal to ``query --format json``'s.
34. gguf-quantized (after phase 15's Nemotron phases): the Nemotron-class
   model at ``NemotronConfig.full()`` width (4,096-d, MLP 14,336, 32 heads)
   and GGUF_LAYERS of its 32 layers (depth cut: the host quantizer's time),
   seeded f32 weights made on the card, quantized on the host into Q4_K_M
   blocks (``quantize_nemotron_layer``) and kept on the card as uint8;
   ``nemotron_forward_quantized`` on B = 8 texts at T = 1,024 (K4 under
   ``attention_impl="auto"``, its launches counted) against the bf16
   forward on the host-dequantized copies of the same blocks: cosine >
   0.999 per row; tokens/s, peak allocated memory and the stacks' bytes
   of both logged;
35. hf-import (inside phase 29, on its 2,048 files): a MiniLM-L6-shaped
   BERT checkpoint directory written by the smoke (numpy-seeded weights
   through ``persist.save_params``, ``config.json``, a 30,522-entry
   ``vocab.txt``) indexed by ``python -m trueno_rag_tpu_torch.cli index
   --embedder semantic --model DIR`` in a subprocess and queried through
   ``cli.main`` (``--scan-tier bf16``, K1): every answer equal to an
   in-process pipeline's over ``load_hf_bert_encoder(DIR)``;
36. maxsim-xla (inside phase 16, on the tiered store's replica): one batch
   of 8 through the blockwise tiers ``maxsim_topk_scan16`` (the bf16
   replica) and ``maxsim_topk_int8`` (an int8 replica of the same tokens),
   uncertified queries patched by the exact scan as the store patches
   them: rows and scores equal to the K6/K7 tiers' on the same store and
   to the float64 exact top-10; certified fractions logged;
37. train-minilm (last): ``fit`` on ``EncoderConfig.minilm_l6()`` at full
   width (384-d, 6 layers, vocabulary 30,522, max_len 64) with ICT pairs of
   4,096 three-sentence documents of phase 5's text law, batch 64, 50
   steps: steps/s, the losses, ``evaluate_retrieval`` before and after on
   256 held-out probes (4 words of a document among 4 random words);
   one card step at f32 against the port's CPU step on the same batch and
   state; 3 steps each of the SPLADE, MaxSim and dense-distillation
   objectives; a checkpoint saved, reloaded and stepped identically to the
   state it was saved from; peak memory of a step with and without
   ``remat`` (losses equal).

The last two lines of standard output are JSON: the per-kernel record, then
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time

DEV = "cuda"
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
N_TIER = 10 * (1 << 20)  # 10,485,760 rows: the JAX package's compact design point
TIER_K = 50
TIER_SLAB = 1 << 20  # rows prepped at a time at N_TIER
STORE_BATCHES = 1  # 2 until slice 3; cut to keep the smoke within half its time limit
# the clustered tier (benches/clustered_bench.py's corpus: one Gaussian blob
# per 4096-row tile, sigma 0.025, near-duplicates planted for 64 centres)
CL_TILE = 4096
CL_SIGMA = 0.025
CL_PLANT = 8  # planted rows per blob at 1M (the bench's default k)
CL_PLANTED_BLOBS = 64
CL_BATCH = 8
CL_BATCHES = 2  # 4 until slice 7, and 8 singles: depth cut for the smoke's time
CL_SINGLES = 2  # 8 until slice 7, 4 until slice 16: depth cut for the smoke's time (PERF.md §4)
CL_T_TOP = 16  # the store's t_top for its 50 dense candidates per query
CL_FEW = 12  # a second pass with 12 dense candidates per query
CL_MUTATE = 0.01
CL_SLAB = 1 << 18
K5_LIVE, K5_PADS = 120, 8  # the tile list at kernels-K5: 128 entries
K10_CERT_K = 50  # kernels-K10's certification measurement: dense candidates per query
N_CL_STREAM = 10 * (1 << 20)  # 10,485,760 rows = 2,560 tiles: the tier's design point
CL_PROBE = 16
CL_STREAM_K = 10
# slice 4: K4 and the neural embedders
K4_TOL_MAX = 2.0**-7  # one flipped bf16 rounding of a probability plus the output's own rounding
K4_TOL_MEAN = 2.0**-12
K4_A = (32, 8192, 128)  # BH, T, hd: the 8k context, 32 heads of one text
K4_B = (8, 32, 1024)  # rows, heads, T: a Nemotron ingest batch (hd 128)
K4_C = (64, 528, 64)  # BH, T, hd: T no multiple of the 64-key or 128-row tile
K4_D = ((14, 1024), (500, 1024), (600, 1000), (1023, 1024), (1, 1024), (0, 0), (300, 700), (64, 1010))
# (d): each batch row of shape (b) keeps keys [lo, hi): left padding, kept keys only in a row's future, all-PAD
K4_WARP_ROWS, K4_TILE_KEYS, K4_BLOCK_ROWS = 32, 64, 128  # csrc/block_attention.cu's tiles
NEMO_B = 8  # texts per 8k batch (the embedder's batch size)
NEMO_WORDS = 8190  # + [CLS] and [SEP] = T 8192, the full context
NR_DOCS = 512  # nemotron-rag: ~1,000-word one-chunk documents
NR_QUERY_BATCHES = 8
CP_QUERIES = 32  # the fused compact batch: its uncertified queries are patched on the host
CE_QUERIES = 32
CE_CANDIDATES = 50
# slice 5: late interaction (MaxSim), K6 and K7
MS_N6 = 1 << 20  # bench.py::bench_maxsim_1m: 1M chunks x 32 x 128, the zero-copy bf16 pack
MS_N7 = 2 << 20  # bench.py::bench_maxsim_2m_int8_store: 2M chunks, int8 primary storage
MS_LT, MS_H = 32, 128
MS_SHAPES = ((8, 8), (32, 8), (8, 32))  # (B, Lq): the bench's point, then its sweep
MS_K = 10
MS_SAMPLE = 4096  # chunks whose float64 MaxSim each bound U must cover
MS_SLAB = 1 << 15  # chunks made or scored in float64 at a time
LI_N = 262_144  # late-interaction-262k: one-chunk documents (BEIR TREC-COVID's 171,332 fit)
LI_WORDS = 30
LI_MAX_LEN = 32  # the CLI's multi-vector store: max_len 32, 32 tokens per chunk
LI_H = 384  # MiniLM-L6's hidden width: the store's token width
LI_ENCODE_BATCH = 1024
LI_BATCH = 8
LI_BATCHES = 4
LI_K = 10
RR_QUERIES = 32
RR_CANDIDATES = 50
MMA_PROBE_WIDTHS = (1, 15, 16, 17, 100, 128, 384)  # mma-probe: below, at and past one 16-column slice
MMA_PROBE_Q = 64  # crafted queries: one K1 query group, K6 at Lq = 1
MMA_PROBE_ROWS = 2048  # crafted rows per width (K1: 2 selection tiles at d = 384)
MIN_CERTIFIED = 0.75  # share of queries a certified MaxSim tier must prove (a K6/K7 scoring high proves none)
K11_GROUP = 256  # the v2 scans' default group
K11_RAGGED = ((1 << 20) - 37, 30)  # kernels-K11's ragged corpus (N, Lt): the pack pads Lt to 32
K11_GROUPS = (128, 512)  # the other groups it runs, beside the default
METRIC_QUERIES = 256  # metrics-1M: planted queries (8 words of a known chunk)
METRIC_K = 10
CLI_DOCS = 2048  # cli: .md files of hybrid-1M's text law
CLI_QUERIES = 4
CKPT_NEMO_LAYERS = 2  # checkpoint: the Nemotron-class model at full width, 2 of 32 layers (depth cut)
GGUF_LAYERS = 6  # gguf-quantized: full width, 6 of 32 layers (depth cut: the host quantizer and decoder, PERF.md §4)
GGUF_B = 8
GGUF_WORDS = 1022  # + [CLS] and [SEP] = T 1,024: K4 under attention_impl="auto"
TRAIN_DOCS = 4096  # train-minilm: three-sentence documents of the text law
TRAIN_STEPS = 50
TRAIN_BATCH = 64
TRAIN_MAX_LEN = 64
TRAIN_EVAL_QUERIES = 256
TRAIN_LR = 5e-5
TRAIN_SIDE_STEPS = 3  # SPLADE, MaxSim and distillation steps
PR_N = 1 << 20  # kernels-K11's centroid-pruned corpora: 1,048,576 x 32 x 128 f32
PR_TOPICS, PR_NOISE = 4096, 0.15  # benches/maxsim_bench.py's topic law (its defaults)
PR_DUP, PR_SIGMA = 16, 0.05  # the tight law: 16 chunks share a cluster's topics; token noise of norm ~0.05
PR_RESCORE = 128
PR_SAMPLE = 2048  # chunks whose every token is checked inside its radius, in float64
K8_TOPS = (2, 4)  # kernels-K8K9: the store's scan_block_top, then the kernel's default
TIE_N = 65536  # kernels, kernels-K8K9: rows of the planted-tie exact int8 data
K2_K = 10  # kernels-K2: k of the two top-k functions
ODD_D = 100  # odd-widths: a width no kernel vector divides
ODD_N = 65536
ODD_TOK_N, ODD_LT = 8192, 16
# slice 7: the BM25 segment path
N_SEG = (1 << 24) + (1 << 20)  # 17,825,792 rows: past the block table's f32-exact 2^24
SEG_SLAB = 1 << 20  # documents whose postings are made and sorted at a time
SEG_DENSE_CHUNK = 64  # queries per K1 call at 17.8M: bounds an fp32 re-run's [B, N] scores
SEG_RUNS = 2  # staged batches at 17.8M (the first pays the set-up)
SEG_SINGLES = 8  # single queries through search_arrays
SEG_FUSED_B = 32  # hybrid_query_arrays_segments at 17.8M: its [B, N] fp32 scores take B x 71 MB
SEG_STORE_THRESHOLD = 1 << 19  # the moved MAX_BLOCK_ROWS of segments-store-1M, below its 1M rows
ENC_N = 1 << 18  # encoder-262k's documents: a depth cut from 1,048,576 for the smoke's time (PERF.md §4)
TRI_N = 65_536  # tri-hybrid-65k: scale cut (the 1M expansion: ~128M postings on the host; 262,144 until slice 16)
TRI_BATCHES = 2
TRI_MAX_LEN = 64  # the SpladeEncoder's defaults: 64 tokens, 128 document terms, 32 query terms
TRI_DOC_TOP = 128
TRI_QUERY_TOP = 32
SERVE_REQUESTS = 1024  # serve-1M: single-query POSTs per server
SERVE_CLIENTS = 32
SERVE_BATCH_SIZES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
BM25_ULPS = 16  # BM25 scores of two panel shapes: within 16 ulps of the panel's mass (bm25_near_ties)

# H100 SXM peaks (NVIDIA data sheet) for the kernels' bounds
BF16_FLOP_PER_S = 989e12  # tensor cores, dense: the peak for bf16 operands (K1, K4, K5, K6, K8)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # CUDA-core fp32 FMA: K2/K2b's dot and K12's arithmetic
INT8_OP_PER_S = 1979e12  # tensor cores: K3's and K7's exact integer dot


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


def bound(bytes_moved: float, ops: float, op_rate: float):
    """The least time the card could take: (ms, what bounds it)."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / op_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def unit_rows(n: int, gen, slab: int = 1 << 20):
    """``n`` seeded unit rows of width DIM on the device, made slab by slab."""
    import torch

    m = torch.empty(n, DIM, device=DEV)
    for lo in range(0, n, slab):
        part = m[lo:lo + slab]
        torch.randn(part.shape, device=DEV, generator=gen, out=part)
        part /= torch.linalg.vector_norm(part, dim=1, keepdim=True)
    return m


def phase_device():
    import torch

    from trueno_rag_tpu_torch.ops.dense import require_fp32
    from trueno_rag_tpu_torch.ops.kernels import build

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
    build.build_library(force=True)
    log(f"kernel build (parallel nvcc): {time.perf_counter() - t0:.1f} s")
    for line in build.build_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line or "smem" in line:
            log(f"  nvcc: {line.strip()}")


def check_sound(vk, rk, m64, q64, valid, bidx, tiles, name, t_top=T_TOP, row0=None):
    """Every emitted value and tile threshold bounds the float64 true score
    of the rows it covers → the least slack seen. Output column g covers
    rows ``row0(g)`` .. + 1023 (default ``g * 1024``)."""
    import torch

    from trueno_rag_tpu_torch.ops.kernels.scan_select import SEL

    worst = float("inf")
    for b in bidx:
        for g in tiles:
            r0 = g * SEL if row0 is None else row0(g)
            rows = torch.arange(r0, r0 + SEL, device=DEV)
            true = m64[rows] @ q64[b]
            true = torch.where(valid[rows] != 0, true, float("-inf"))
            cand = rk[b, :, g].long()
            cv = vk[b, :t_top, g].double()
            live = ~torch.isneginf(cv)
            check(bool(((cand[live] >= r0) & (cand[live] < r0 + SEL)).all()), f"{name}: row outside its tile")
            if live.any():
                slack = (cv[live] - true[cand[live] - r0]).min().item()
                check(slack >= 0.0, f"{name}: candidate value below its true score (b={b}, tile={g}, {slack})")
                worst = min(worst, slack)
            covered = torch.ones(SEL, dtype=torch.bool, device=DEV)
            covered[cand[live] - r0] = False
            rest = true[covered]
            if (~torch.isneginf(rest)).any():
                slack = vk[b, t_top, g].double().item() - rest.max().item()
                check(slack >= 0.0, f"{name}: tile threshold below a covered row's true score (b={b}, tile={g})")
                worst = min(worst, slack)
    return worst


def compare_k1(vk, rk, vr, rr, mb, qb, terms, label):
    """K1 (or another bf16 tile scan) against its plain version: -inf slots
    equal, values within V_TOL, rows equal but at near-ties of the two
    summation orders → max |dv|. ``terms(rows, queries)``: the float64
    bound terms added to those rows' raw scores (a v3 scan's block
    correction, a v2 scan's per-row bound)."""
    import torch

    inf_k, inf_r = torch.isneginf(vk), torch.isneginf(vr)
    check(torch.equal(inf_k, inf_r), f"{label}: kernel and plain version disagree on -inf slots")
    check(bool(torch.isfinite(vk[~inf_k]).all()), f"{label}: non-finite kernel values")
    max_err = (vk[~inf_k] - vr[~inf_r]).abs().max().item()
    check(max_err <= V_TOL, f"{label}: v_pack differs by {max_err}")

    def upper(rows, bidx):  # raw bf16 score + bound terms, f64
        s = (mb[rows].double() * qb[bidx].double()).sum(dim=-1)
        return s + terms(rows, bidx)

    diff = rk != rr
    agree = 1.0 - diff.float().mean().item()
    bi, ti, gi = torch.nonzero(diff, as_tuple=True)
    gap = 0.0
    if bi.numel():
        gap = (upper(rk[bi, ti, gi].long(), bi) - upper(rr[bi, ti, gi].long(), bi)).abs().max().item()
    log(f"{label}: v_pack max |diff| {max_err:.3e} (tolerance {V_TOL}); r_pack agreement {agree:.6f} "
        f"({int(diff.sum())} slots differ, max |dv| {gap:.3e})")
    check(agree >= ROW_AGREE, f"{label}: r_pack agreement {agree} < {ROW_AGREE}")
    check(gap <= V_TOL, f"{label}: a differing row is not a near-tie (|dv| = {gap})")
    return max_err


def kernel_inputs(seed: int):
    """The kernels phases' corpus and batch (the same tensors for one
    seed): N_ROWS unit rows, BATCH unit queries, a partly and a fully
    masked block, and the tiles and queries whose bounds are checked
    against float64 → (generator, m, q, valid, tiles, queries)."""
    import torch

    from trueno_rag_tpu_torch.ops.kernels.scan_select import BLOCK, SEL

    gen = torch.Generator(device=DEV).manual_seed(seed)
    m = unit_rows(N_ROWS, gen)
    q = unit_rows(BATCH, gen)
    valid = torch.ones(N_ROWS, dtype=torch.int32, device=DEV)
    valid[1000:1040] = 0  # a partly masked block
    valid[5 * BLOCK:6 * BLOCK] = 0  # a fully masked block
    g_sub = torch.randperm(N_ROWS // SEL, device=DEV, generator=gen)[:8].tolist() + [0]
    qs = torch.randperm(BATCH, device=DEV, generator=gen)[:16].tolist()
    return gen, m, q, valid, g_sub, qs


def tag_filter(pattern: str, b: int, gen):
    """A tag filter over N_ROWS rows and ``b`` queries: one random 4-bit
    word per 128-row block ("blocks") or per row ("rows"), and per-query
    all/any/none words → (tags, allowed [b, N] bool)."""
    import torch

    from trueno_rag_tpu_torch.ops.kernels.scan_select import BLOCK

    if pattern == "blocks":  # one tag word per 128-row block
        bits = torch.randint(0, 16, (N_ROWS // BLOCK,), device=DEV, generator=gen,
                             dtype=torch.int32).repeat_interleave(BLOCK)
    else:
        bits = torch.randint(0, 16, (N_ROWS,), device=DEV, generator=gen, dtype=torch.int32)
    words = [torch.randint(0, 16, (b,), device=DEV, generator=gen, dtype=torch.int32) & w
             for w in (1, 6, 8)]  # all / any / none
    allowed = ((bits[None, :] & words[0][:, None]) == words[0][:, None]) & (
        (words[1][:, None] == 0) | ((bits[None, :] & words[1][:, None]) != 0)) & (
        (bits[None, :] & words[2][:, None]) == 0)  # [b, N]
    check(0.05 < allowed.float().mean().item() < 0.95, "tag filter keeps too few or too many rows")
    return (bits, *words), allowed


def check_filtered(name, v, r, allowed, t_top=T_TOP):
    """No emitted candidate is a row its query's filter forbids."""
    import torch

    live = ~torch.isneginf(v[:, :t_top, :])
    b_idx = torch.arange(v.shape[0], device=DEV)[:, None, None].expand_as(r)
    check(bool(allowed[b_idx[live], r[live].long()].all()), f"{name} emitted a row its filter forbids")


def int8_tie_inputs(n: int, b: int, gen):
    """Exact int8 data for the planted-tie checks: codes in [-3, 3] and
    dyadic row scales, query scales and bound norms, so every score and
    upper bound is exact in f32; row 9 all +-3 (the largest dot any row can
    have with query 0, which equals it) copied into rows 5 and 100 with its
    scale and norms (a three-way tie at the top of block 0); a partly and a
    fully masked block (rows 300-329, block 2) → the 9 arguments of K3, K10c
    and K9 (per-row norms)."""
    import torch

    from trueno_rag_tpu_torch.ops.kernels.scan_select import BLOCK

    def pick(values, size):
        return torch.tensor(values, device=DEV)[torch.randint(0, len(values), (size,), device=DEV, generator=gen)]

    m8 = torch.randint(-3, 4, (n, DIM), device=DEV, generator=gen, dtype=torch.int8)
    q8 = torch.randint(-3, 4, (b, DIM), device=DEV, generator=gen, dtype=torch.int8)
    m8[9] = torch.where(torch.rand(DIM, device=DEV, generator=gen) < 0.5, -3, 3).to(torch.int8)
    s_row, e_l2, a_l2 = pick([0.125, 0.25, 0.5], n), pick([0.0, 0.125, 0.25, 0.375], n), pick([0.25, 0.5, 0.75, 1.0], n)
    planted = torch.tensor([5, 9, 100], device=DEV)
    m8[planted] = m8[9].clone()
    s_row[planted], e_l2[planted], a_l2[planted] = 0.5, 0.375, 1.0
    q8[0] = m8[9]
    valid = torch.ones(n, dtype=torch.int32, device=DEV)
    valid[300:330] = 0
    valid[2 * BLOCK:3 * BLOCK] = 0
    t_q = pick([1.0, 2.0], b)
    u_q, v_q = torch.full((b,), 0.25, device=DEV), torch.full((b,), 0.125, device=DEV)
    return q8, m8, s_row, e_l2, a_l2, valid, t_q, u_q, v_q


def phase_kernels(seed: int):
    """K1 and K3 against their plain versions, soundness and times; then
    their tag variants. → (K1 record, K3 record)."""
    import torch

    from trueno_rag_tpu_torch.ops import dense_tiered as dt
    from trueno_rag_tpu_torch.ops.kernels.scan_select import (
        BLOCK, SEL, block_bound_maxes, scan_select_int8_v3, scan_select_int8_v3_reference,
        scan_select_v3, scan_select_v3_reference,
    )

    gen, m, q, valid, g_sub, qs = kernel_inputs(seed)
    g_sel = N_ROWS // SEL
    m64, q64 = m.double(), q.double()

    # -- K1 -----------------------------------------------------------------
    mb, e_l2, a_l2 = dt.prepare_tiered(m)
    check(bool((e_l2 > 0).any()), "prepare_tiered's e_l2 is all zero on the device")
    log(f"prepare_tiered: e_l2 mean {e_l2.mean().item():.3e}, nonzero {int((e_l2 > 0).sum())}/{N_ROWS}")
    qb, u_q, v_q = dt._bf16_query_bounds(q)
    k1_args = (qb, mb, e_l2, a_l2, valid, u_q, v_q)
    vk, rk = scan_select_v3(*k1_args, t_top=T_TOP)
    torch.cuda.synchronize()
    vr, rr = scan_select_v3_reference(*k1_args, t_top=T_TOP)
    torch.cuda.synchronize()
    check(tuple(vk.shape) == (BATCH, T_TOP + 1, g_sel), f"v_pack shape {tuple(vk.shape)}")
    check(tuple(rk.shape) == (BATCH, T_TOP, g_sel), f"r_pack shape {tuple(rk.shape)}")
    eb, ab = block_bound_maxes(e_l2, a_l2)
    corr = eb[:, None] * u_q[None, :] + ab[:, None] * v_q[None, :]  # [N/128, B]

    def terms(rows, b):  # float64 block corrections of rows for queries b
        return corr[rows // BLOCK, b].double()

    k1_err = compare_k1(vk, rk, vr, rr, mb, qb, terms, "K1 vs plain")
    worst = check_sound(vk, rk, m64, q64, valid, qs, g_sub, "K1")
    log(f"K1 soundness: {len(qs)} queries x {len(g_sub)} tiles bounded, least slack {worst:.3e}")
    del vr, rr
    k1_ms = cuda_ms(lambda: scan_select_v3(*k1_args, t_top=T_TOP), 20)
    k1_plain = cuda_ms(lambda: scan_select_v3_reference(*k1_args, t_top=T_TOP), 5)
    k1_ms2 = cuda_ms(lambda: scan_select_v3(*k1_args, t_top=T_TOP), 20)
    flop = 2.0 * BATCH * N_ROWS * DIM
    out_bytes = BATCH * (2 * T_TOP + 1) * g_sel * 4
    k1_bound = bound(BATCH * DIM * 2 + N_ROWS * DIM * 2 + N_ROWS * 12 + BATCH * 8 + out_bytes, flop,
                     BF16_FLOP_PER_S)
    log(f"K1 scan_select_v3 at N={N_ROWS} d={DIM} B={BATCH}: kernel {k1_ms:.3f} / {k1_ms2:.3f} ms, "
        f"plain {k1_plain:.3f} ms (median, CUDA events); bound {k1_bound[0]:.3f} ms ({k1_bound[1]})")
    log(f"  K1 rate {flop / (min(k1_ms, k1_ms2) * 1e-3) / 1e12:.1f} TFLOP/s on the tensor cores (2*B*N*d / time)")

    # -- K3 -----------------------------------------------------------------
    m_i8, s_row, i8_e, i8_a = dt.prepare_int8(m)
    q_i8, t_q, u8, v8 = dt._int8_query_bounds(q)
    k3_args = (q_i8, m_i8, s_row, i8_e, i8_a, valid, t_q, u8, v8)
    vk3, rk3 = scan_select_int8_v3(*k3_args, t_top=T_TOP)
    torch.cuda.synchronize()
    vr3, rr3 = scan_select_int8_v3_reference(*k3_args, t_top=T_TOP)
    torch.cuda.synchronize()
    k3_err = (vk3 - vr3).abs().nan_to_num(0.0).max().item()  # -inf - -inf is nan
    check(torch.equal(vk3, vr3), f"K3 v_pack differs from the plain version (max |diff| {k3_err})")
    check(torch.equal(rk3, rr3), "K3 r_pack differs from the plain version")
    log(f"K3 vs plain: v_pack and r_pack bit-identical ({vk3.numel()} + {rk3.numel()} entries)")
    worst = check_sound(vk3, rk3, m64, q64, valid, qs, g_sub, "K3")
    log(f"K3 soundness: {len(qs)} queries x {len(g_sub)} tiles bounded, least slack {worst:.3e}")
    del vr3, rr3
    k3_ms = cuda_ms(lambda: scan_select_int8_v3(*k3_args, t_top=T_TOP), 20)
    k3_plain = cuda_ms(lambda: scan_select_int8_v3_reference(*k3_args, t_top=T_TOP), 5)
    k3_ms2 = cuda_ms(lambda: scan_select_int8_v3(*k3_args, t_top=T_TOP), 20)
    k3_bound = bound(BATCH * DIM + N_ROWS * DIM + N_ROWS * 16 + BATCH * 12 + out_bytes, flop, INT8_OP_PER_S)
    log(f"K3 scan_select_int8_v3 at N={N_ROWS} d={DIM} B={BATCH}: kernel {k3_ms:.3f} / {k3_ms2:.3f} ms, "
        f"plain {k3_plain:.3f} ms (median, CUDA events); bound {k3_bound[0]:.3f} ms ({k3_bound[1]})")
    log(f"  K3 rate {flop / (min(k3_ms, k3_ms2) * 1e-3) / 1e12:.1f} TOP/s on the int8 tensor cores (2*B*N*d / time)")

    # -- tag variants ---------------------------------------------------------
    for pattern in ("blocks", "rows"):
        tags, allowed = tag_filter(pattern, BATCH, gen)
        vk, rk = scan_select_v3(*k1_args, t_top=T_TOP, tags=tags)
        vr, rr = scan_select_v3_reference(*k1_args, t_top=T_TOP, tags=tags)
        compare_k1(vk, rk, vr, rr, mb, qb, terms, f"K1 tags ({pattern})")
        vk3, rk3 = scan_select_int8_v3(*k3_args, t_top=T_TOP, tags=tags)
        vr3, rr3 = scan_select_int8_v3_reference(*k3_args, t_top=T_TOP, tags=tags)
        check(torch.equal(vk3, vr3) and torch.equal(rk3, rr3), f"K3 tags ({pattern}) differ from the plain version")
        for name, v, r in (("K1", vk, rk), ("K3", vk3, rk3)):
            check_filtered(name, v, r, allowed)
        t1 = cuda_ms(lambda: scan_select_v3(*k1_args, t_top=T_TOP, tags=tags), 10)
        t3 = cuda_ms(lambda: scan_select_int8_v3(*k3_args, t_top=T_TOP, tags=tags), 10)
        log(f"K3 tags ({pattern}): bit-identical to plain; kept {allowed.float().mean().item():.3f} of "
            f"(row, query) pairs; tagged kernel times K1 {t1:.3f} ms, K3 {t3:.3f} ms")
        del allowed, vr, rr, vr3, rr3

    # -- planted ties on exact data ---------------------------------------------
    tie = int8_tie_inputs(TIE_N, BATCH, gen)
    vt, rt = scan_select_int8_v3(*tie, t_top=T_TOP)
    vtr, rtr = scan_select_int8_v3_reference(*tie, t_top=T_TOP)
    check(torch.equal(vt, vtr) and torch.equal(rt, rtr), "K3 on the planted ties differs from the plain version")
    # rows 100 and 9 lead block 0 (ties: higher lane); in the tournament the
    # higher slot (block 0's second candidate, row 9) wins the tie; row 5 is
    # block 0's third value, so the tile threshold equals them
    check(rt[0, :2, 0].tolist() == [9, 100], f"K3 planted tie: rows {rt[0, :2, 0].tolist()}, want [9, 100]")
    check(vt[0, 0, 0].item() == vt[0, 1, 0].item() == vt[0, T_TOP, 0].item(), "K3 planted tie: values differ")
    log(f"K3 planted ties ({TIE_N} exact int8 rows, B={BATCH}): bit-identical to plain; query 0's tile 0 emits "
        f"rows 9, 100 at equal values and the threshold equal to them")
    del tie, vt, rt, vtr, rtr

    del m, m64, q64, mb, m_i8
    torch.cuda.empty_cache()
    src = "trueno_rag_tpu_torch/csrc/"
    return (
        {"name": "scan_select_v3", "route": "cuda", "source": src + "scan_select_v3.cu",
         "replaces": "trueno_rag_tpu/ops/pallas/scan_select_v2.py:433", "max_abs_err": k1_err,
         "ms": min(k1_ms, k1_ms2), "plain_ms": k1_plain, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "scan_select_int8_v3", "route": "cuda", "source": src + "scan_select_int8_v3.cu",
         "replaces": "trueno_rag_tpu/ops/pallas/scan_select_v2.py:775", "max_abs_err": k3_err,
         "ms": min(k3_ms, k3_ms2), "plain_ms": k3_plain, "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "library_ms": None},
    )


def exact_topk_chunked(q, m, valid, k, chunk=32):
    """The exact fp32 path (``dense_topk``: fp32 preselection of 2k, float64
    re-rank) in query chunks, plus a guard that the preselection cannot
    have missed a float64 top-k row: the best score outside the fp32 2k
    trails the k-th exact score by far more than the fp32 error."""
    import torch

    from trueno_rag_tpu_torch.ops.dense import dense_topk, normalize_queries

    out_s, out_r = [], []
    for lo in range(0, q.shape[0], chunk):
        qc = q[lo:lo + chunk]
        s, r = dense_topk(qc, m, valid, k, "cosine")
        sc = normalize_queries(qc) @ m.T
        margin = s[:, k - 1] - torch.topk(sc, 2 * k + 1, dim=1).values[:, 2 * k]  # check-only library call
        check(bool((margin > 1e-4).all()), "fp32 preselection margin too thin for a float64 reference")
        out_s.append(s)
        out_r.append(r)
        del sc
    return torch.cat(out_s), torch.cat(out_r)


def phase_tier(seed: int) -> None:
    """The compact design point: 10,485,760 rows, B = 256, k = 50."""
    import torch

    from trueno_rag_tpu_torch.ops import dense_tiered as dt
    from trueno_rag_tpu_torch.ops.dense import normalize_queries
    from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_int8_v3, scan_select_v3

    n = N_TIER
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    t0 = time.perf_counter()
    m = unit_rows(n, gen)  # the fp32 yardstick; the compact calls never see it
    q = torch.randn(BATCH, DIM, device=DEV, generator=gen)
    valid = torch.ones(n, dtype=torch.bool, device=DEV)
    reps = None
    for lo in range(0, n, TIER_SLAB):
        s = m[lo:lo + TIER_SLAB]
        parts = dt.prepare_tiered(s) + dt.prepare_residual(s) + dt.prepare_int8(s)
        if reps is None:
            reps = [torch.empty((n,) + p.shape[1:], dtype=p.dtype, device=DEV) for p in parts]
        for dest, part in zip(reps, parts):
            dest[lo:lo + part.shape[0]].copy_(part)
        del parts
    mb, e, a, ri8, rs, e2, mi8, sr, ie, ia = reps
    torch.cuda.synchronize()
    log(f"tier data: {n} x {DIM} unit rows + bf16, residual and int8 replicas in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    t0 = time.perf_counter()
    ref_s, ref_r = exact_topk_chunked(q, m, valid, TIER_K)
    log(f"tier reference (exact fp32 path, float64 re-rank): {time.perf_counter() - t0:.1f} s")
    ref_sets = [set(x) for x in ref_r.cpu().tolist()]

    qn = normalize_queries(q)
    qb, u_q, v_q = dt._bf16_query_bounds(qn)
    q_i8, t_q, u8, v8 = dt._int8_query_bounds(qn)
    vi = valid.to(torch.int32)
    runs = (
        ("dense_topk_compact_bf16r", dt.dense_topk_compact_bf16r, (q, mb, e, a, ri8, rs, e2, valid, TIER_K),
         scan_select_v3, lambda: scan_select_v3(qb, mb, e, a, vi, u_q, v_q, t_top=T_TOP)),
        ("dense_topk_compact (int8 scan)", dt.dense_topk_compact, (q, mb, e, a, mi8, sr, ie, ia, valid, TIER_K),
         scan_select_int8_v3, lambda: scan_select_int8_v3(q_i8, mi8, sr, ie, ia, vi, t_q, u8, v8, t_top=T_TOP)),
    )
    for name, fn, args, kernel, alone in runs:
        kernel.launches = 0
        s, r, ok = fn(*args)
        torch.cuda.synchronize()
        check(kernel.launches == 1, f"{name}: its scan kernel launched {kernel.launches} times")
        check(bool(torch.isfinite(s).all()) and tuple(r.shape) == (BATCH, TIER_K), f"{name}: malformed result")
        ok_l, r_l = ok.cpu().tolist(), r.cpu().tolist()
        for i in range(BATCH):
            if ok_l[i]:
                check(set(r_l[i]) == ref_sets[i], f"{name}: certified query {i} is not the exact top-k set")
        batch_ms = cuda_ms(lambda: fn(*args), 3)
        kern_ms = cuda_ms(alone, 3)
        log(f"tier {name} at N={n}: certified {sum(ok_l) / BATCH:.4f} ({sum(ok_l)}/{BATCH}), every certified "
            f"set exact; batch {batch_ms:.2f} ms, scan kernel alone {kern_ms:.2f} ms (median, CUDA events)")
    scan_select_int8_v3.launches = 0
    s, r, n_fb = dt.dense_topk_int8_tiered2_checked(q, m, mi8, sr, ie, ia, valid, TIER_K)
    torch.cuda.synchronize()
    check(scan_select_int8_v3.launches == 1, "int8 tier: K3 did not launch")
    check(torch.equal(r, ref_r) and torch.equal(s, ref_s), "int8 tier: rows or scores differ from the exact path")
    batch_ms = cuda_ms(lambda: dt.dense_topk_int8_tiered2_checked(q, m, mi8, sr, ie, ia, valid, TIER_K), 3)
    log(f"tier dense_topk_int8_tiered2_checked at N={n}: certified {(BATCH - n_fb) / BATCH:.4f} "
        f"({n_fb} re-run on fp32); rows and scores identical to the exact path; batch {batch_ms:.2f} ms")
    log(f"tier peak allocated {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del m, reps, mb, e, a, ri8, rs, e2, mi8, sr, ie, ia
    torch.cuda.empty_cache()


def make_texts(rng, n: int, words: int):
    """``n`` texts of ``words`` words ``w00000``..: every word is 6 bytes, so
    a slab's texts are one gather of the words' bytes (with their spaces),
    cut at a fixed width and decoded."""
    import numpy as np

    check(VOCAB <= 100_000, "make_texts: words are six bytes")
    table = np.frombuffer("".join(f"w{i:05d} " for i in range(VOCAB)).encode(), np.uint8).reshape(VOCAB, 7)
    width = 7 * words - 1
    out = []
    for lo in range(0, n, 65536):
        ids = rng.integers(0, VOCAB, size=(min(65536, n - lo), words))
        raw = table[ids].reshape(len(ids), 7 * words)[:, :width].tobytes()
        out.extend(raw[i:i + width].decode() for i in range(0, len(raw), width))
    return out


def query_batches(rng, n):
    import numpy as np

    words = np.array([f"w{i:05d}" for i in range(VOCAB)])
    return [[" ".join(r) for r in words[rng.integers(0, VOCAB, size=(BATCH, QUERY_WORDS))]] for _ in range(n)]


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


def check_contexts(contexts, allowed_row=None, registry=None, n=None) -> None:
    """``n`` (default BATCH) well-formed contexts; with ``allowed_row``,
    every chunk passes it."""
    import numpy as np

    check(len(contexts) == (BATCH if n is None else n), "one context per query")
    for ctx in contexts:
        check(len(ctx.chunks) <= K, f"{len(ctx.chunks)} chunks in a context")
        check(allowed_row is not None or len(ctx.chunks) > 0, "an empty context")
        check(len(ctx.citations) == len(ctx.chunks), "one citation per chunk")
        check(all(np.isfinite(c.score) for c in ctx.chunks), "non-finite score")
        check(all(c.content for c in ctx.chunks), "empty chunk content")
        if allowed_row is not None:
            check(all(allowed_row(registry.row_of(c.chunk_id)) for c in ctx.chunks),
                  "a returned chunk fails the tag filter")


def check_fused(strategy, d_r, d_s, s_r, s_s, label) -> None:
    """Device fusion of the candidate lists equals the host fusion oracle
    (first 8 queries, or all of fewer)."""
    from trueno_rag_tpu_torch.ops.fusion import fuse_topk

    f_r, f_s = fuse_topk(d_r, d_s, s_r, s_s, kind=strategy.kind, param=strategy.device_param)
    f_r, f_s = f_r.cpu().numpy(), f_s.cpu().numpy()
    d_l, s_l = d_r.cpu().numpy(), d_s.cpu().numpy()
    sp_r, sp_s = s_r.cpu().numpy(), s_s.cpu().numpy()
    for j in range(min(8, len(d_l))):
        host = dict(strategy.fuse(
            [(int(r), float(s)) for r, s in zip(d_l[j], s_l[j]) if r >= 0],
            [(int(r), float(s)) for r, s in zip(sp_r[j], sp_s[j]) if r >= 0],
        ))
        dev = {int(r): float(s) for r, s in zip(f_r[j], f_s[j]) if r >= 0}
        check(dev.keys() == host.keys(), f"{label} query {j}: fused rows differ from the host oracle")
        check(all(abs(dev[r] - host[r]) <= 1e-6 for r in dev), f"{label} query {j}: fused scores differ")


def phase_slice(seed: int):
    """Slice 1's main path → (pipeline, K1 launches on it)."""
    import numpy as np
    import torch

    import trueno_rag_tpu_torch as rag
    from trueno_rag_tpu_torch.ops.dense import dense_topk
    from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_int8_v3, scan_select_v3

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    docs = [rag.Document(t, id=f"doc{i}") for i, t in enumerate(make_texts(rng, N_ROWS, DOC_WORDS))]
    log(f"documents: {len(docs)} generated in {time.perf_counter() - t0:.1f} s")
    pipe = (
        rag.RagPipelineBuilder()
        .with_embedder(rag.MockEmbedder(DIM))
        .with_reranker(rag.LexicalReranker())
        .with_vector_config(rag.VectorStoreConfig(scan_tier="auto"))
        .with_device(DEV)
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

    batches = query_batches(rng, N_BATCHES)
    warm = pipe.query_with_context_batch(batches[0], k=K)  # first-call set-up
    check(len(warm) == BATCH, "warm-up batch")

    torch.cuda.reset_peak_memory_stats()
    fb_before = store.tier_fallback_queries
    scan_select_v3.launches = scan_select_int8_v3.launches = 0
    lat, contexts = [], []
    for qs in batches:
        t0 = time.perf_counter()
        contexts.append(pipe.query_with_context_batch(qs, k=K))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    launches = scan_select_v3.launches
    fallbacks = store.tier_fallback_queries - fb_before
    peak = torch.cuda.max_memory_allocated()
    log(f"slice 1 main path: scan_select_v3 launches {launches}, scan_select_int8_v3 {scan_select_int8_v3.launches}")
    check(launches > 0, "the main path never launched scan_select_v3")
    for i, t in enumerate(lat):
        log(f"batch {i}: {t * 1e3:.1f} ms = {BATCH / t:.0f} queries/s (host clock, query_with_context_batch k={K})")
    log(f"median batch {sorted(lat)[len(lat) // 2] * 1e3:.1f} ms; {BATCH * len(lat) / sum(lat):.0f} queries/s overall")
    n_q = BATCH * N_BATCHES
    log(f"certified fraction {(n_q - fallbacks) / n_q:.4f} ({fallbacks} of {n_q} queries fell back to fp32)")
    log(f"torch.cuda.max_memory_allocated during queries: {peak / 2**30:.2f} GiB")

    stage_breakdown(pipe, batches[0])
    for batch in contexts:
        check_contexts(batch)

    # dense candidates: the certified tier equals the exact fp32 path
    # (both report ops.dense.exact_scores, so even near-ties agree)
    cand = retr.config.candidates_per_source
    for i, qs in enumerate(batches):
        qv = np.asarray(retr.embedder.embed_queries(qs), dtype=np.float32)
        s_t, r_t = store.search_arrays(qv, cand)
        s_x, r_x = dense_topk(torch.from_numpy(qv).to(DEV), store.device_matrix, store.device_valid, cand, "cosine")
        check(torch.equal(r_t, r_x), f"batch {i}: tier rows differ from the exact fp32 rows")
        check(torch.equal(s_t, s_x), f"batch {i}: tier scores differ from the exact fp32 scores")
        s_s, r_s = retr.sparse_index.search_arrays(qs, cand)
        check_fused(retr.config.fusion, r_t, s_t, r_s, s_s, f"batch {i}")
    log(f"dense rows and scores identical to exact fp32 dense_topk for all {n_q} queries; "
        f"fused lists match the host oracle")
    return pipe, launches, batches


def sibling_pipeline(pipe, vcfg):
    """A pipeline whose vector store has config ``vcfg`` but which shares
    ``pipe``'s ingested state: the chunk registry, the BM25 index and the
    host rows (the store builds its own device replicas from them)."""
    import trueno_rag_tpu_torch as rag

    base = pipe.retriever
    retr = rag.HybridRetriever(base.embedder, config=base.config, vector_config=vcfg, device=DEV)
    retr.registry = base.registry
    retr.sparse_index = base.sparse_index
    store = retr.vector_store
    store.registry = base.registry
    src = base.vector_store
    store._host, store._valid, store._count = src._host, src._valid, src._count
    store._dirty, store._dirty_rows = True, None
    return rag.RagPipeline(pipe.embedder, pipe.reranker, pipe.chunker, retr, pipe.assembler)


def phase_stores(pipe, seed: int):
    """The int8 and compact tiers and the tag filters, through
    query_with_context_batch → (K1 launches, K3 launches) on this path."""
    import numpy as np
    import torch

    import trueno_rag_tpu_torch as rag
    from trueno_rag_tpu_torch.ops.dense import dense_topk
    from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_int8_v3, scan_select_v3
    from trueno_rag_tpu_torch.ops.tags import dense_topk_tagged
    from trueno_rag_tpu_torch.retrieve import resolve_tag_filters

    base = pipe.retriever
    bstore = base.vector_store
    cand = base.config.candidates_per_source
    strategy = base.config.fusion
    rng = np.random.default_rng(seed + 2)
    batches = query_batches(rng, STORE_BATCHES)
    qvs = [np.asarray(base.embedder.embed_queries(qs), dtype=np.float32) for qs in batches]
    exact = [dense_topk(torch.from_numpy(qv).to(DEV), bstore.device_matrix, bstore.device_valid, cand, "cosine")
             for qv in qvs]

    k1_total = k3_total = 0  # launches on the main path only, not in the checks

    def drive(p, qs, **kw):
        """One query_with_context_batch with both launch counts set to 0
        just before it and read just after → (contexts, K1, K3 launches)."""
        nonlocal k1_total, k3_total
        scan_select_v3.launches = scan_select_int8_v3.launches = 0
        ctxs = p.query_with_context_batch(qs, k=K, **kw)
        k1, k3 = scan_select_v3.launches, scan_select_int8_v3.launches
        k1_total, k3_total = k1_total + k1, k3_total + k3
        return ctxs, k1, k3

    configs = [  # (name, store config, queries per batch)
        ("int8", dict(scan_tier="int8"), BATCH),
        ("compact bf16rr", dict(scan_tier="compact", compact_scan="bf16rr"), BATCH),
        ("compact bf16", dict(scan_tier="compact", compact_scan="bf16"), BATCH),
        # depth cut: its host GEMM patch costs ~0.25 s per query, twice (query and check)
        ("compact int8", dict(scan_tier="compact", compact_scan="int8"), CP_QUERIES),
        ("compact bf16r", dict(scan_tier="compact", compact_scan="bf16r", compact_fallback="host"), BATCH),
    ]
    for name, kw, nq in configs:
        p = sibling_pipeline(pipe, rag.VectorStoreConfig(**kw))
        store = p.retriever.vector_store
        t0 = time.perf_counter()
        p.retriever.ensure_ready()
        torch.cuda.synchronize()
        log(f"store {name}: device build {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        lat, k1, k3 = [], 0, 0
        for qs in batches:
            t0 = time.perf_counter()
            ctxs, n1, n3 = drive(p, qs[:nq])
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            check_contexts(ctxs, n=nq)
            k1, k3 = k1 + n1, k3 + n3
        check((k3 if "int8" in name else k1) > 0, f"store {name}: its scan kernel never launched")
        counters = (f"uncertified {store.compact_uncertified}, candidate-patched {store.compact_candidate_patched}, "
                    f"GEMM-patched {store.compact_gemm_patched}, retry-certified {store.compact_retry_certified}"
                    if store.is_compact else f"fp32 re-runs {store.tier_fallback_queries}")
        log(f"store {name}: {STORE_BATCHES} batches of {nq} in {', '.join(f'{t:.1f}' for t in lat)} ms "
            f"(host clock); launches K1 {k1}, K3 {k3}; {counters}")
        for i, (qv, qs) in enumerate(zip(qvs, batches)):
            s_t, r_t = store.search_arrays(qv[:nq], cand)
            x_s, x_r = (x[:nq] for x in exact[i])
            if store.is_compact:
                check(all(set(a) == set(b) for a, b in zip(r_t.cpu().tolist(), x_r.cpu().tolist())),
                      f"store {name} batch {i}: a row set differs from the float64 exact top-k set")
            else:
                check(torch.equal(r_t, x_r) and torch.equal(s_t, x_s),
                      f"store {name} batch {i}: rows or scores differ from the exact fp32 path")
            s_s, r_s = base.sparse_index.search_arrays(qs[:nq], cand)
            check_fused(strategy, r_t, s_t, r_s, s_s, f"store {name} batch {i}")
        log(f"store {name}: dense results {'exact as sets after the host patch' if store.is_compact else 'identical to the exact fp32 path'}; "
            f"fused lists match the host oracle")
        if name != "compact bf16r":
            del p, store
            torch.cuda.empty_cache()
    compact_pipe = p

    # -- tag filters: one of 4 tags per chunk, by row ------------------------
    reg = base.registry
    t0 = time.perf_counter()
    for row in range(reg.capacity_rows):
        cid = reg.id_of(row)
        if cid is not None:
            reg.set_tags(cid, [f"t{row % 4}"])
    log(f"tags: {len(reg)} chunks tagged in {time.perf_counter() - t0:.1f} s")
    filters = (
        ("all=[t1]", rag.TagFilter(all=("t1",)), lambda row: row % 4 == 1),
        ("none=[t0]", rag.TagFilter(none=("t0",)), lambda row: row % 4 != 0),
    )
    qs, qv = batches[0], qvs[0]
    q_t = torch.from_numpy(qv).to(DEV)
    for name, p in (("bf16 tile", pipe), ("compact bf16r", compact_pipe)):
        store = p.retriever.vector_store
        for fname, f, allowed_row in filters:
            t0 = time.perf_counter()
            ctxs, n1, _ = drive(p, qs, tag_filter=f)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            check_contexts(ctxs, allowed_row, reg)
            check(n1 > 0, f"{name} {fname}: the tag filter did not ride K1")
            masks = resolve_tag_filters(reg, f, BATCH)
            masks_t = [torch.from_numpy(x).to(DEV) for x in masks]
            s_t, r_t = store.search_arrays(qv, cand, tag_masks=masks)
            x_s, x_r = dense_topk_tagged(q_t, bstore.device_matrix, bstore.device_valid,
                                         bstore._device_tag_bits(), *masks_t, cand, "cosine")
            if store.is_compact:
                check(all(set(a) == set(b) for a, b in zip(r_t.cpu().tolist(), x_r.cpu().tolist())),
                      f"{name} {fname}: a row set differs from the filtered float64 top-k set")
            else:
                check(torch.equal(r_t, x_r) and torch.equal(s_t, x_s),
                      f"{name} {fname}: rows or scores differ from the tagged exact path")
            s_s, r_s = p.retriever._sparse_candidates(qs, cand, masks)
            check(all(allowed_row(r) for r in r_s.cpu().numpy().ravel() if r >= 0), f"{name} {fname}: BM25 row fails")
            check_fused(strategy, r_t, s_t, r_s, s_s, f"{name} {fname}")
            log(f"tags {name} {fname}: batch {ms:.1f} ms (host clock); every chunk passes; dense rows equal the "
                f"filtered exact top-k{' set' if store.is_compact else ''}; fused lists match the host oracle")
        if store.is_compact:
            log(f"store {name} counters after the tag batches: uncertified {store.compact_uncertified}, "
                f"candidate-patched {store.compact_candidate_patched}, GEMM-patched {store.compact_gemm_patched}")
    log(f"stores path (query_with_context_batch calls only): launches K1 {k1_total}, K3 {k3_total}")
    check(k1_total > 0 and k3_total > 0, "the stores path missed a kernel")
    return k1_total, k3_total


# -- the clustered tier (slice 3) ----------------------------------------------


def mix32(x):
    """lowbias32, a 32-bit integer hash, over int64 tensors holding values
    in [0, 2^32) (products wrap; the mask keeps the low 32 bits)."""
    m32 = 0xFFFFFFFF
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & m32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & m32
    return x ^ (x >> 16)


def blob_vectors(ids, which, centers, sigma, seed: int):
    """Unit rows ``normalize(centers[which] + sigma * noise)`` whose Gaussian
    noise (Box-Muller over hashed uniforms) is a pure function of
    (seed, id, column): an id gives the same row on every call."""
    import torch

    m32 = 0xFFFFFFFF
    h = mix32((ids.long() * 2654435761 + 7919 * seed + 1) & m32)[:, None]
    col = torch.arange(DIM, device=ids.device, dtype=torch.int64)[None, :]
    u1 = (mix32((h + (2 * col + 1) * 0x9E3779B9) & m32).float() + 0.5) * 2.0**-32
    u2 = mix32((h + (2 * col + 2) * 0x9E3779B9) & m32).float() * 2.0**-32
    noise = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    del u1, u2
    rows = centers[which.long()] + sigma[:, None] * noise
    return rows / torch.linalg.vector_norm(rows, dim=1, keepdim=True)


def blob_corpus_rows(ids, centers, plant: int, seed: int):
    """Rows ``ids`` of the blob corpus (benches/clustered_bench.py's
    defaults): row i belongs to blob i // CL_TILE with spread CL_SIGMA; the
    first ``plant`` rows of each of the first CL_PLANTED_BLOBS blobs are
    near-duplicates of the centre (spread 0.01)."""
    import torch

    ids = ids.long().clamp(min=0)
    which = (ids // CL_TILE).clamp(max=centers.shape[0] - 1)
    planted = (ids % CL_TILE < plant) & (ids // CL_TILE < CL_PLANTED_BLOBS)
    sigma = torch.where(planted, 0.01, CL_SIGMA)
    return blob_vectors(ids, which, centers, sigma, seed)


def blob_queries(centers, blobs, gen):
    """One query per listed blob: its centre plus 0.005 Gaussian noise."""
    import torch

    q = centers[torch.as_tensor(blobs, device=DEV)]
    return q + 0.005 * torch.randn(q.shape, device=DEV, generator=gen)


def blob_embedder(vectors):
    """An Embedder (a stand-in for a model) mapping each query text the
    smoke made to the vector it chose for it, near a blob centre."""
    import trueno_rag_tpu_torch as rag

    class BlobEmbedder(rag.Embedder):
        @property
        def dimension(self) -> int:
            return DIM

        @property
        def model_id(self) -> str:
            return "chip-smoke-blob-queries"

        def embed(self, text):
            return vectors[text]

    return BlobEmbedder()


def count_cluster_builds():
    """Wrap the k-means builds of ops/clustered.py → the list of outermost
    calls made from now on (a build over a store with holes recurses)."""
    from trueno_rag_tpu_torch.ops import clustered as cl

    calls, depth = [], [0]
    for name in ("prepare_clustered", "prepare_clustered_device", "prepare_clustered_stream"):
        fn = getattr(cl, name)

        def counted(*a, _fn=fn, _name=name, **k):
            if depth[0] == 0:
                calls.append(_name)
            depth[0] += 1
            try:
                return _fn(*a, **k)
            finally:
                depth[0] -= 1

        setattr(cl, name, counted)
    return calls


def plain_greedy_fill(top_alt, margin, t: int, tile_n: int) -> list:
    """``ops/clustered._greedy_fill`` as the plain sequential loop: rows
    by falling margin take their first alternative with space; rows with
    none spill, after every other row, into the lowest cluster with space."""
    import numpy as np

    visit = np.argsort(-margin, kind="stable")
    space = np.full(t, tile_n, dtype=np.int64)
    members = [[] for _ in range(t)]
    overflow = []
    for r in visit:
        for c in top_alt[r]:
            if space[c] > 0:
                members[c].append(r)
                space[c] -= 1
                break
        else:
            overflow.append(r)
    for r in overflow:
        c = int(np.flatnonzero(space > 0)[0])
        members[c].append(r)
        space[c] -= 1
    return [np.asarray(x, dtype=np.int32) for x in members]


def phase_kernels_k5(seed: int):
    """K5 scan_select_v3_indirect at the clustered path's shapes (1M x 384,
    B = 8, tile_n 4096, t_top 16, 120 live tiles + 8 pad slots) against its
    plain version, float64 soundness, the tag variant, times, and K1 over a
    copy of the same tiles → K5's record."""
    import torch

    from trueno_rag_tpu_torch.ops import dense_tiered as dt
    from trueno_rag_tpu_torch.ops.kernels.scan_select import (
        BLOCK, SEL, block_bound_maxes, scan_select_v3, scan_select_v3_indirect,
        scan_select_v3_indirect_reference,
    )

    gen = torch.Generator(device=DEV).manual_seed(seed + 3)
    n, b, tile_n, t_top = N_ROWS, CL_BATCH, CL_TILE, CL_T_TOP
    n_tiles, spt = n // tile_n, tile_n // SEL
    m = unit_rows(n, gen)
    q = unit_rows(b, gen)
    valid = torch.ones(n, dtype=torch.int32, device=DEV)
    valid[1000:1040] = 0  # a partly masked block of tile 0
    valid[5 * BLOCK:6 * BLOCK] = 0  # a fully masked block of tile 0
    n_live = min(K5_LIVE, n_tiles - 1)
    live = torch.randperm(n_tiles - 1, device=DEV, generator=gen)[:n_live - 1] + 1
    live = torch.sort(torch.cat([torch.zeros(1, dtype=live.dtype, device=DEV), live])).values
    ids = torch.cat([live, torch.full((K5_PADS,), n_tiles, dtype=live.dtype, device=DEV)]).to(torch.int32)
    g_live, g_all = n_live * spt, len(ids) * spt
    mb, e_l2, a_l2 = dt.prepare_tiered(m)
    qb, u_q, v_q = dt._bf16_query_bounds(q)
    args = (qb, mb, e_l2, a_l2, valid, u_q, v_q, ids)
    eb, ab = block_bound_maxes(e_l2, a_l2)
    corr = eb[:, None] * u_q[None, :] + ab[:, None] * v_q[None, :]  # [N/128, B]
    m64, q64 = m.double(), q.double()
    ids_l = ids.tolist()

    def terms(rows, bi):  # float64 block corrections of rows for queries bi
        return corr[rows // BLOCK, bi].double()

    def row0(g):  # the first corpus row of output column g
        return ids_l[g // spt] * tile_n + (g % spt) * SEL

    def compare(vk, rk, vr, rr, label):
        check(tuple(vk.shape) == (b, t_top + 1, g_all) and tuple(rk.shape) == (b, t_top, g_all),
              f"{label}: pack shapes {tuple(vk.shape)}, {tuple(rk.shape)}")
        check(bool(torch.isneginf(vk[:, :, g_live:]).all()), f"{label}: a pad slot holds a finite value")
        check(torch.equal(vk[:, :, g_live:], vr[:, :, g_live:]) and torch.equal(rk[:, :, g_live:], rr[:, :, g_live:]),
              f"{label}: pad slots differ from the plain version")
        return compare_k1(vk[:, :, :g_live], rk[:, :, :g_live], vr[:, :, :g_live], rr[:, :, :g_live],
                          mb, qb, terms, label)

    vk, rk = scan_select_v3_indirect(*args, tile_n=tile_n, t_top=t_top)
    torch.cuda.synchronize()
    vr, rr = scan_select_v3_indirect_reference(*args, tile_n, t_top)
    k5_err = compare(vk, rk, vr, rr, "K5 vs plain")
    cols = torch.randperm(g_live, device=DEV, generator=gen)[:8].tolist() + [0]
    worst = check_sound(vk, rk, m64, q64, valid, range(b), cols, "K5", t_top=t_top, row0=row0)
    log(f"K5 soundness: {b} queries x {len(cols)} columns bounded, least slack {worst:.3e}")

    # K1 over a copy of the listed tiles: the same values, rows mapped back
    sel = ids.long().clamp(max=n_tiles - 1)

    def gather(x):
        return x.view(n_tiles, tile_n, *x.shape[1:])[sel].reshape(-1, *x.shape[1:])

    gv = (gather(valid).view(-1, tile_n) * (ids.long() < n_tiles)[:, None]).reshape(-1).to(torch.int32)
    k1_copy_args = (qb, gather(mb), gather(e_l2), gather(a_l2), gv, u_q, v_q)
    v1, r1 = scan_select_v3(*k1_copy_args, t_top=t_top)
    pos = r1[:, :, :g_live].long()
    mapped = sel[pos // tile_n] * tile_n + pos % tile_n
    check(torch.equal(v1[:, :, :g_live], vk[:, :, :g_live]) and torch.equal(mapped.to(torch.int32), rk[:, :, :g_live]),
          "K1 over the gathered copy differs from K5 on the live tiles")
    log("K5 vs K1 over a copy of the same tiles: live columns bit-identical (rows mapped back)")

    # -- tag variant ------------------------------------------------------------
    bits = torch.randint(0, 16, (n,), device=DEV, generator=gen, dtype=torch.int32)
    words = [torch.randint(0, 16, (b,), device=DEV, generator=gen, dtype=torch.int32) & w for w in (1, 6, 8)]
    tags = (bits, *words)
    vt, rt = scan_select_v3_indirect(*args, tile_n=tile_n, t_top=t_top, tags=tags)
    vtr, rtr = scan_select_v3_indirect_reference(*args, tile_n, t_top, tags)
    compare(vt, rt, vtr, rtr, "K5 tags (rows)")
    live_slots = ~torch.isneginf(vt[:, :t_top, :g_live])
    rows = rt[:, :, :g_live][live_slots].long()
    bidx = torch.arange(b, device=DEV)[:, None, None].expand(b, t_top, g_live)[live_slots]
    rb = bits[rows]
    ok = ((rb & words[0][bidx]) == words[0][bidx]) & ((words[1][bidx] == 0) | ((rb & words[1][bidx]) != 0)) & (
        (rb & words[2][bidx]) == 0)
    check(bool(ok.all()), "K5 emitted a row its filter forbids")
    t_tag = cuda_ms(lambda: scan_select_v3_indirect(*args, tile_n=tile_n, t_top=t_top, tags=tags), 10)
    del vr, rr, vtr, rtr, m64, q64

    k5_ms = cuda_ms(lambda: scan_select_v3_indirect(*args, tile_n=tile_n, t_top=t_top), 20)
    k5_plain = cuda_ms(lambda: scan_select_v3_indirect_reference(*args, tile_n, t_top), 5)
    k1_copy_ms = cuda_ms(lambda: scan_select_v3(*k1_copy_args, t_top=t_top), 20)
    gather_ms = cuda_ms(lambda: gather(mb), 10)
    k5_ms2 = cuda_ms(lambda: scan_select_v3_indirect(*args, tile_n=tile_n, t_top=t_top), 20)
    rows_live = n_live * tile_n
    out_bytes = b * (2 * t_top + 1) * g_all * 4
    k5_bound = bound(b * DIM * 2 + rows_live * (DIM * 2 + 4) + rows_live // BLOCK * 8 + len(ids) * 4 + b * 8
                     + out_bytes, 2.0 * b * rows_live * DIM, BF16_FLOP_PER_S)
    log(f"K5 scan_select_v3_indirect at N={n} d={DIM} B={b} tile_n={tile_n} t_top={t_top}, {n_live} tiles + "
        f"{K5_PADS} pad slots: kernel {k5_ms:.3f} / {k5_ms2:.3f} ms, plain {k5_plain:.3f} ms (median, CUDA "
        f"events); bound {k5_bound[0]:.3f} ms ({k5_bound[1]}); tagged {t_tag:.3f} ms")
    log(f"  K1 over a copy of the same tiles {k1_copy_ms:.3f} ms, plus the tile copy {gather_ms:.3f} ms")
    del m, mb, k1_copy_args
    torch.cuda.empty_cache()
    return {"name": "scan_select_v3_indirect", "route": "cuda",
            "source": "trueno_rag_tpu_torch/csrc/scan_select_v3.cu",
            "replaces": "trueno_rag_tpu/ops/pallas/scan_select_v2.py:579", "max_abs_err": k5_err,
            "ms": min(k5_ms, k5_ms2), "plain_ms": k5_plain, "bound_ms": k5_bound[0],
            "bound_by": k5_bound[1], "library_ms": None}


def check_row_upper(vk, rk, upper64, valid, bidx, tiles, name, t_top=T_TOP, row0=None):
    """The v2 packs carry each row's own bound: every emitted value equals
    the float64 upper bound ``upper64(rows, b)`` of its row within V_TOL
    (the f32 rounding of the kernel's dot and bound), and every tile
    threshold is at least the upper of every row of its tile not emitted,
    less V_TOL → the largest |value − upper| seen."""
    import torch

    from trueno_rag_tpu_torch.ops.kernels.scan_select import SEL

    worst = 0.0
    for b in bidx:
        for g in tiles:
            r0 = g * SEL if row0 is None else row0(g)
            rows = torch.arange(r0, r0 + SEL, device=DEV)
            up = torch.where(valid[rows] != 0, upper64(rows, b), float("-inf"))
            cand = rk[b, :, g].long()
            cv = vk[b, :t_top, g].double()
            live = ~torch.isneginf(cv)
            if live.any():
                dv = (cv[live] - up[cand[live] - r0]).abs().max().item()
                check(dv <= V_TOL, f"{name}: an emitted value is not its row's own upper bound (b={b}, tile={g}, {dv})")
                worst = max(worst, dv)
            covered = torch.ones(SEL, dtype=torch.bool, device=DEV)
            covered[cand[live] - r0] = False
            rest = up[covered]
            if (~torch.isneginf(rest)).any():
                check(vk[b, t_top, g].double().item() >= rest.max().item() - V_TOL,
                      f"{name}: tile threshold below a covered row's upper bound (b={b}, tile={g})")
    return worst


def phase_kernels_k10(seed: int):
    """The v2 tile scans K10a/K10b/K10c and the inline-cast layout, on
    kernels' corpus (K10a, K10c at 1M x 384, B = 256, t_top 4) and at
    kernels-K5's shapes (K10b: B = 8, tile_n 4096, t_top 16, 120 tiles + 8
    pads): each against its plain version (K10c bit for bit), sound
    against float64 and carrying each row's own bound; K1, K5, K10a and
    K10b on the f32 rows bit-identical to their bf16-replica runs;
    ``dense_topk_tiered2_checked(m_bf16=None)`` equal to the replica run;
    and the certified share of the tier's own tail fed K10a's packs, then
    K1's, and K10c's, then K3's, on the same queries; then the slice's path
    with its launches counted → (K10a, K10b, K10c records, K1 launches on
    that path)."""
    import torch

    from trueno_rag_tpu_torch.ops import dense_tiered as dt
    from trueno_rag_tpu_torch.ops.dense import normalize_queries
    from trueno_rag_tpu_torch.ops.kernels import scan_select as ss
    from trueno_rag_tpu_torch.ops.kernels.scan_select import BLOCK, SEL

    t_phase = time.perf_counter()
    gen, m, q, valid, g_sub, qs = kernel_inputs(seed)
    g_sel = N_ROWS // SEL
    m64, q64 = m.double(), q.double()
    mb, e_l2, a_l2 = dt.prepare_tiered(m)
    qb, u_q, v_q = dt._bf16_query_bounds(q)
    args = (qb, mb, e_l2, a_l2, valid, u_q, v_q)
    f32_args = (qb, m) + args[2:]
    flop = 2.0 * BATCH * N_ROWS * DIM
    row_ops = 4.0 * BATCH * N_ROWS  # the per-row bound: 2 multiplies and 2 adds per (row, query)
    out_bytes = BATCH * (2 * T_TOP + 1) * g_sel * 4

    def row_terms(rows, b):  # float64 per-row bound terms e·u + a·v
        return e_l2[rows].double() * u_q[b].double() + a_l2[rows].double() * v_q[b].double()

    def bf16_upper(rows, b):
        return mb[rows].double() @ qb[b].double() + row_terms(rows, b)

    # -- K10a -------------------------------------------------------------------
    va, ra = ss.scan_select_v2(*args, t_top=T_TOP)
    torch.cuda.synchronize()
    vr, rr = ss.scan_select_v2_reference(*args, t_top=T_TOP)
    check(tuple(va.shape) == (BATCH, T_TOP + 1, g_sel) and tuple(ra.shape) == (BATCH, T_TOP, g_sel),
          f"K10a pack shapes {tuple(va.shape)}, {tuple(ra.shape)}")
    k10a_err = compare_k1(va, ra, vr, rr, mb, qb, row_terms, "K10a vs plain")
    worst = check_sound(va, ra, m64, q64, valid, qs, g_sub, "K10a")
    own = check_row_upper(va, ra, bf16_upper, valid, qs, g_sub, "K10a")
    log(f"K10a soundness: {len(qs)} queries x {len(g_sub)} tiles bounded, least slack {worst:.3e}; every "
        f"emitted value its row's own upper bound (max |dv| {own:.3e})")
    del vr, rr
    v32, r32 = ss.scan_select_v2(*f32_args, t_top=T_TOP)
    check(torch.equal(v32, va) and torch.equal(r32, ra), "K10a on the f32 rows differs from its bf16-replica run")
    v1, r1 = ss.scan_select_v3(*args, t_top=T_TOP)
    v1f, r1f = ss.scan_select_v3(*f32_args, t_top=T_TOP)
    check(torch.equal(v1f, v1) and torch.equal(r1f, r1), "K1 on the f32 rows differs from its bf16-replica run")
    log("K1 and K10a on the f32 rows (inline cast): v_pack and r_pack bit-identical to the bf16 replica's")
    eb, ab = ss.block_bound_maxes(e_l2, a_l2)
    corr = eb[:, None] * u_q[None, :] + ab[:, None] * v_q[None, :]  # [N/128, B], K1's block corrections
    vr, rr = ss.scan_select_v3_reference(*f32_args, t_top=T_TOP)
    compare_k1(v1f, r1f, vr, rr, mb, qb, lambda rows, b: corr[rows // BLOCK, b].double(),
               "K1 on the f32 rows vs plain")
    del v32, r32, v1, r1, v1f, r1f, vr, rr, corr
    k10a_ms = cuda_ms(lambda: ss.scan_select_v2(*args, t_top=T_TOP), 20)
    k10a_plain = cuda_ms(lambda: ss.scan_select_v2_reference(*args, t_top=T_TOP), 5)
    k1_ms = cuda_ms(lambda: ss.scan_select_v3(*args, t_top=T_TOP), 20)
    k1_f32 = cuda_ms(lambda: ss.scan_select_v3(*f32_args, t_top=T_TOP), 20)
    k10a_f32 = cuda_ms(lambda: ss.scan_select_v2(*f32_args, t_top=T_TOP), 20)
    k10a_ms2 = cuda_ms(lambda: ss.scan_select_v2(*args, t_top=T_TOP), 20)
    vec_bytes = N_ROWS * 12 + BATCH * 8 + out_bytes  # e_l2, a_l2, valid; u, v; the packs
    k10a_bound = bound(BATCH * DIM * 2 + N_ROWS * DIM * 2 + vec_bytes, flop + row_ops, BF16_FLOP_PER_S)
    f32_bound = bound(BATCH * DIM * 2 + N_ROWS * DIM * 4 + vec_bytes, flop, BF16_FLOP_PER_S)
    log(f"K10a scan_select_v2 at N={N_ROWS} d={DIM} B={BATCH}: kernel {k10a_ms:.3f} / {k10a_ms2:.3f} ms, "
        f"plain {k10a_plain:.3f} ms (median, CUDA events); bound {k10a_bound[0]:.3f} ms ({k10a_bound[1]}); "
        f"K1 in the same call {k1_ms:.3f} ms")
    log(f"  f32 rows (inline cast): K1 {k1_f32:.3f} ms, K10a {k10a_f32:.3f} ms; their bound "
        f"{f32_bound[0]:.3f} ms ({f32_bound[1]})")

    # -- K10c -------------------------------------------------------------------
    m_i8, s_row, i8_e, i8_a = dt.prepare_int8(m)
    q_i8, t_q, u8, v8 = dt._int8_query_bounds(q)
    k10c_args = (q_i8, m_i8, s_row, i8_e, i8_a, valid, t_q, u8, v8)
    vk3, rk3 = ss.scan_select_int8_v2(*k10c_args, t_top=T_TOP)
    torch.cuda.synchronize()
    vr3, rr3 = ss.scan_select_int8_v2_reference(*k10c_args, t_top=T_TOP)
    k10c_err = (vk3 - vr3).abs().nan_to_num(0.0).max().item()  # -inf - -inf is nan
    check(torch.equal(vk3, vr3), f"K10c v_pack differs from the plain version (max |diff| {k10c_err})")
    check(torch.equal(rk3, rr3), "K10c r_pack differs from the plain version")
    del vr3, rr3

    def int8_upper(rows, b):
        s = (m_i8[rows].double() @ q_i8[b].double()) * s_row[rows].double() * t_q[b].double()
        return s + i8_e[rows].double() * u8[b].double() + i8_a[rows].double() * v8[b].double()

    worst = check_sound(vk3, rk3, m64, q64, valid, qs, g_sub, "K10c")
    own = check_row_upper(vk3, rk3, int8_upper, valid, qs, g_sub, "K10c")
    log(f"K10c vs plain: v_pack and r_pack bit-identical; soundness: least slack {worst:.3e}; every emitted "
        f"value its row's own upper bound (max |dv| {own:.3e})")
    k10c_ms = cuda_ms(lambda: ss.scan_select_int8_v2(*k10c_args, t_top=T_TOP), 20)
    k10c_plain = cuda_ms(lambda: ss.scan_select_int8_v2_reference(*k10c_args, t_top=T_TOP), 5)
    k3_ms = cuda_ms(lambda: ss.scan_select_int8_v3(*k10c_args, t_top=T_TOP), 20)
    k10c_ms2 = cuda_ms(lambda: ss.scan_select_int8_v2(*k10c_args, t_top=T_TOP), 20)
    k10c_bound = bound(BATCH * DIM + N_ROWS * DIM + N_ROWS * 16 + BATCH * 12 + out_bytes, flop + row_ops,
                       INT8_OP_PER_S)
    log(f"K10c scan_select_int8_v2 at N={N_ROWS} d={DIM} B={BATCH}: kernel {k10c_ms:.3f} / {k10c_ms2:.3f} ms, "
        f"plain {k10c_plain:.3f} ms (median, CUDA events); bound {k10c_bound[0]:.3f} ms ({k10c_bound[1]}); "
        f"K3 in the same call {k3_ms:.3f} ms; rate {flop / (min(k10c_ms, k10c_ms2) * 1e-3) / 1e12:.1f} TOP/s on the "
        f"int8 tensor cores")

    # -- tag variants of K10a and K10c ------------------------------------------
    for pattern in ("blocks", "rows"):
        tags, allowed = tag_filter(pattern, BATCH, gen)
        vk, rk = ss.scan_select_v2(*args, t_top=T_TOP, tags=tags)
        vr, rr = ss.scan_select_v2_reference(*args, t_top=T_TOP, tags=tags)
        compare_k1(vk, rk, vr, rr, mb, qb, row_terms, f"K10a tags ({pattern})")
        vt, rt = ss.scan_select_int8_v2(*k10c_args, t_top=T_TOP, tags=tags)
        vtr, rtr = ss.scan_select_int8_v2_reference(*k10c_args, t_top=T_TOP, tags=tags)
        check(torch.equal(vt, vtr) and torch.equal(rt, rtr), f"K10c tags ({pattern}) differ from the plain version")
        check_filtered("K10a", vk, rk, allowed)
        check_filtered("K10c", vt, rt, allowed)
        log(f"K10c tags ({pattern}): bit-identical to plain; K10a within tolerance; no forbidden row emitted")
        del allowed, vr, rr, vtr, rtr

    # -- the certification measurement --------------------------------------------
    valid_b = valid != 0
    k_c = K10_CERT_K
    qn = normalize_queries(q)
    qbn, un, vn = dt._bf16_query_bounds(qn)
    q8n, tqn, u8n, v8n = dt._int8_query_bounds(qn)
    ref_s, ref_r = exact_topk_chunked(q, m, valid_b, k_c)
    packs = (
        ("K10a", lambda: ss.scan_select_v2(qbn, mb, e_l2, a_l2, valid, un, vn, t_top=T_TOP)),
        ("K1", lambda: ss.scan_select_v3(qbn, mb, e_l2, a_l2, valid, un, vn, t_top=T_TOP)),
        ("K10c", lambda: ss.scan_select_int8_v2(q8n, m_i8, s_row, i8_e, i8_a, valid, tqn, u8n, v8n, t_top=T_TOP)),
        ("K3", lambda: ss.scan_select_int8_v3(q8n, m_i8, s_row, i8_e, i8_a, valid, tqn, u8n, v8n, t_top=T_TOP)),
    )
    shares = {}
    for name, scan in packs:
        s_c, r_c, ok = dt._select_rescore_verify_tiles(scan(), qn, m, valid_b, N_ROWS, BATCH, BATCH, k_c, 32, 96,
                                                       T_TOP)
        check(torch.equal(r_c[ok], ref_r[ok]) and torch.equal(s_c[ok], ref_s[ok]),
              f"{name}-fed tail: a certified query is not the exact top-{k_c}")
        shares[name] = ok.float().mean().item()
        if name == "K1":
            _, _, ok_tier = dt.dense_topk_tiered2(q, m, mb, e_l2, a_l2, valid_b, k_c)
            check(torch.equal(ok, ok_tier), "the K1-fed tail is not the bf16 tier's own")
    log(f"certification at N={N_ROWS}, B={BATCH}, k={k_c} (the tier's tail, margin 32, rescore 96, t_top "
        f"{T_TOP}): K10a {shares['K10a']:.4f}, K1 {shares['K1']:.4f}; K10c {shares['K10c']:.4f}, "
        f"K3 {shares['K3']:.4f}; every certified query exact")

    # -- the inline-cast tier ---------------------------------------------------------
    rep = dt.dense_topk_tiered2_checked(q, m, mb, e_l2, a_l2, valid_b, k_c)
    inl = dt.dense_topk_tiered2_checked(q, m, None, e_l2, a_l2, valid_b, k_c)
    check(torch.equal(rep[0], inl[0]) and torch.equal(rep[1], inl[1]) and rep[2] == inl[2],
          "dense_topk_tiered2_checked(m_bf16=None) differs from the replica run")
    check(torch.equal(inl[1], ref_r) and torch.equal(inl[0], ref_s), "the inline-cast tier is not exact")
    rep_ms = cuda_ms(lambda: dt.dense_topk_tiered2_checked(q, m, mb, e_l2, a_l2, valid_b, k_c), 3)
    inl_ms = cuda_ms(lambda: dt.dense_topk_tiered2_checked(q, m, None, e_l2, a_l2, valid_b, k_c), 3)
    log(f"dense_topk_tiered2_checked(m_bf16=None) at N={N_ROWS}, B={BATCH}, k={k_c}: scores, rows and "
        f"fallbacks ({inl[2]}) equal to the replica run and the exact path; batch {inl_ms:.2f} ms inline, "
        f"{rep_ms:.2f} ms replica (median, CUDA events)")
    del rep, ref_s, ref_r

    # -- K10b at kernels-K5's shapes ------------------------------------------------------
    b, tile_n, t_top = CL_BATCH, CL_TILE, CL_T_TOP
    n_tiles, spt = N_ROWS // tile_n, tile_n // SEL
    n_live = min(K5_LIVE, n_tiles - 1)
    live = torch.randperm(n_tiles - 1, device=DEV, generator=gen)[:n_live - 1] + 1
    live = torch.sort(torch.cat([torch.zeros(1, dtype=live.dtype, device=DEV), live])).values
    ids = torch.cat([live, torch.full((K5_PADS,), n_tiles, dtype=live.dtype, device=DEV)]).to(torch.int32)
    g_live, g_all = n_live * spt, len(ids) * spt
    ids_l = ids.tolist()
    q8b = q[:b].contiguous()
    qb8, ub8, vb8 = dt._bf16_query_bounds(q8b)
    b_args = (qb8, mb, e_l2, a_l2, valid, ub8, vb8, ids)
    b_f32 = (qb8, m) + b_args[2:]

    def row0(g):  # the first corpus row of output column g
        return ids_l[g // spt] * tile_n + (g % spt) * SEL

    def terms8(rows, bi):
        return e_l2[rows].double() * ub8[bi].double() + a_l2[rows].double() * vb8[bi].double()

    vb, rb = ss.scan_select_v2_indirect(*b_args, tile_n=tile_n, t_top=t_top)
    torch.cuda.synchronize()
    vr, rr = ss.scan_select_v2_indirect_reference(*b_args, tile_n, t_top)
    check(tuple(vb.shape) == (b, t_top + 1, g_all) and tuple(rb.shape) == (b, t_top, g_all),
          f"K10b pack shapes {tuple(vb.shape)}, {tuple(rb.shape)}")
    check(bool(torch.isneginf(vb[:, :, g_live:]).all()), "K10b: a pad slot holds a finite value")
    check(torch.equal(vb[:, :, g_live:], vr[:, :, g_live:]) and torch.equal(rb[:, :, g_live:], rr[:, :, g_live:]),
          "K10b: pad slots differ from the plain version")
    k10b_err = compare_k1(vb[:, :, :g_live], rb[:, :, :g_live], vr[:, :, :g_live], rr[:, :, :g_live], mb, qb8,
                          terms8, "K10b vs plain")
    cols = torch.randperm(g_live, device=DEV, generator=gen)[:8].tolist() + [0]
    worst = check_sound(vb, rb, m64, q8b.double(), valid, range(b), cols, "K10b", t_top=t_top, row0=row0)
    own = check_row_upper(vb, rb, lambda rows, bi: mb[rows].double() @ qb8[bi].double() + terms8(rows, bi), valid,
                          range(b), cols, "K10b", t_top=t_top, row0=row0)
    log(f"K10b soundness: {b} queries x {len(cols)} columns bounded, least slack {worst:.3e}; every emitted value "
        f"its row's own upper bound (max |dv| {own:.3e})")
    del vr, rr, m64, q64
    v32, r32 = ss.scan_select_v2_indirect(*b_f32, tile_n=tile_n, t_top=t_top)
    check(torch.equal(v32, vb) and torch.equal(r32, rb), "K10b on the f32 rows differs from its bf16-replica run")
    v5, r5 = ss.scan_select_v3_indirect(*b_args, tile_n=tile_n, t_top=t_top)
    v5f, r5f = ss.scan_select_v3_indirect(*b_f32, tile_n=tile_n, t_top=t_top)
    check(torch.equal(v5f, v5) and torch.equal(r5f, r5), "K5 on the f32 rows differs from its bf16-replica run")
    log("K5 and K10b on the f32 rows (inline cast): v_pack and r_pack bit-identical to the bf16 replica's")
    corr8 = eb[:, None] * ub8[None, :] + ab[:, None] * vb8[None, :]  # [N/128, b], K5's block corrections
    vr, rr = ss.scan_select_v3_indirect_reference(*b_f32, tile_n, t_top)
    check(torch.equal(v5f[:, :, g_live:], vr[:, :, g_live:]) and torch.equal(r5f[:, :, g_live:], rr[:, :, g_live:]),
          "K5 on the f32 rows: pad slots differ from the plain version")
    compare_k1(v5f[:, :, :g_live], r5f[:, :, :g_live], vr[:, :, :g_live], rr[:, :, :g_live], mb, qb8,
               lambda rows, bi: corr8[rows // BLOCK, bi].double(), "K5 on the f32 rows vs plain")
    del vr, rr, corr8
    k10b_ms = cuda_ms(lambda: ss.scan_select_v2_indirect(*b_args, tile_n=tile_n, t_top=t_top), 20)
    k10b_plain = cuda_ms(lambda: ss.scan_select_v2_indirect_reference(*b_args, tile_n, t_top), 5)
    k5_ms = cuda_ms(lambda: ss.scan_select_v3_indirect(*b_args, tile_n=tile_n, t_top=t_top), 20)
    k5_f32 = cuda_ms(lambda: ss.scan_select_v3_indirect(*b_f32, tile_n=tile_n, t_top=t_top), 20)
    k10b_f32 = cuda_ms(lambda: ss.scan_select_v2_indirect(*b_f32, tile_n=tile_n, t_top=t_top), 20)
    k10b_ms2 = cuda_ms(lambda: ss.scan_select_v2_indirect(*b_args, tile_n=tile_n, t_top=t_top), 20)
    rows_live = n_live * tile_n
    ind_bytes = b * DIM * 2 + rows_live * 12 + len(ids) * 4 + b * 8 + b * (2 * t_top + 1) * g_all * 4
    ind_ops = 2.0 * b * rows_live * DIM
    k10b_bound = bound(ind_bytes + rows_live * DIM * 2, ind_ops + 4.0 * b * rows_live, BF16_FLOP_PER_S)
    k5_f32_bound = bound(ind_bytes + rows_live * DIM * 4, ind_ops, BF16_FLOP_PER_S)
    log(f"K10b scan_select_v2_indirect at N={N_ROWS} d={DIM} B={b} tile_n={tile_n} t_top={t_top}, {n_live} tiles "
        f"+ {K5_PADS} pad slots: kernel {k10b_ms:.3f} / {k10b_ms2:.3f} ms, plain {k10b_plain:.3f} ms (median, "
        f"CUDA events); bound {k10b_bound[0]:.3f} ms ({k10b_bound[1]}); K5 in the same call {k5_ms:.3f} ms")
    log(f"  f32 rows (inline cast): K5 {k5_f32:.3f} ms, K10b {k10b_f32:.3f} ms; their bound "
        f"{k5_f32_bound[0]:.3f} ms ({k5_f32_bound[1]})")
    del v32, r32, v5, r5, v5f, r5f

    # -- the slice's path: each K10 entry point once and the inline-cast tier,
    # the counts set to 0 just before and read just after (the comparisons and
    # timings above are not counted); each result equal to its checked run ------
    counted = (ss.scan_select_v2, ss.scan_select_v2_indirect, ss.scan_select_int8_v2, ss.scan_select_v3)
    for kern in counted:
        kern.launches = 0
    p_a = ss.scan_select_v2(*f32_args, t_top=T_TOP)
    p_b = ss.scan_select_v2_indirect(*b_f32, tile_n=tile_n, t_top=t_top)
    p_c = ss.scan_select_int8_v2(*k10c_args, t_top=T_TOP)
    p_t = dt.dense_topk_tiered2_checked(q, m, None, e_l2, a_l2, valid_b, k_c)
    n10a, n10b, n10c, n1 = (kern.launches for kern in counted)
    check((n10a, n10b, n10c) == (1, 1, 1) and n1 > 0,
          f"kernels-K10 path launches: K10a {n10a}, K10b {n10b}, K10c {n10c}, K1 {n1}")
    for name, got, want in (("K10a", p_a, (va, ra)), ("K10b", p_b, (vb, rb)), ("K10c", p_c, (vk3, rk3)),
                            ("the inline-cast tier", p_t[:2], inl[:2])):
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"kernels-K10 path: {name} differs from its checked run")
    check(p_t[2] == inl[2], "kernels-K10 path: the inline-cast tier's fallback count changed")
    log(f"kernels-K10 path (K10a, K10b on the f32 rows, K10c, dense_topk_tiered2_checked(m_bf16=None)): launches "
        f"K10a {n10a}, K10b {n10b}, K10c {n10c}, K1 {n1}; every result equal to its checked run")
    del m, mb, m_i8, va, ra, vb, rb, vk3, rk3, inl, p_a, p_b, p_c, p_t
    torch.cuda.empty_cache()
    log(f"kernels-K10 phase: {time.perf_counter() - t_phase:.1f} s")
    src = "trueno_rag_tpu_torch/csrc/"
    site = "trueno_rag_tpu/ops/pallas/scan_select_v2.py:"
    return (
        {"name": "scan_select_v2", "route": "cuda", "source": src + "scan_select_v3.cu", "replaces": site + "274",
         "launches": n10a, "max_abs_err": k10a_err, "ms": min(k10a_ms, k10a_ms2), "plain_ms": k10a_plain,
         "bound_ms": k10a_bound[0], "bound_by": k10a_bound[1], "library_ms": None},
        {"name": "scan_select_v2_indirect", "route": "cuda", "source": src + "scan_select_v3.cu",
         "replaces": site + "664", "launches": n10b, "max_abs_err": k10b_err, "ms": min(k10b_ms, k10b_ms2),
         "plain_ms": k10b_plain, "bound_ms": k10b_bound[0], "bound_by": k10b_bound[1], "library_ms": None},
        {"name": "scan_select_int8_v2", "route": "cuda", "source": src + "scan_select_int8_v3.cu",
         "replaces": site + "847", "launches": n10c, "max_abs_err": k10c_err, "ms": min(k10c_ms, k10c_ms2),
         "plain_ms": k10c_plain, "bound_ms": k10c_bound[0], "bound_by": k10c_bound[1], "library_ms": None},
        n1,
    )


def device_profile(fn, label: str, reps: int = 3, warm: bool = True):
    """Trace ``reps`` calls of ``fn`` with torch.profiler (after one untraced
    call if ``warm``) → log the host-clock time per call (tracing included),
    the device's busy and idle shares of it, and the device ops that took
    the most time; return [(device ms per call, calls per call, name)]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
        # host-side entries (aten:: ops, the runtime's "Command Buffer Full")
        # carry their kernels' device time again: count the kernels only
        if us > 0 and not e.key.startswith("aten::") and e.key != "Command Buffer Full":
            rows.append((us / 1e3 / reps, e.count / reps, e.key))
    busy = sum(r[0] for r in rows)
    log(f"{label}: {wall:.3f} ms per call traced (host clock); device busy {busy:.3f} ms = {busy / wall:.1%}, "
        f"idle {1 - busy / wall:.1%}")
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        log(f"  device {ms:.3f} ms, {count:g} per call: {key[:100]}")
    return rows


def exact_sets(q, m, valid, k):
    """Float64 exact top-k row sets (``exact_topk_chunked``)."""
    _, r = exact_topk_chunked(q, m, valid, k)
    return [set(x) for x in r.cpu().tolist()]


def phase_clustered_store(pipe, seed: int) -> int:
    """Slice 3's main path: the clustered tier behind the slice's chunks and
    BM25 index, with a 1M blob corpus in place of the MockEmbedder rows →
    K5 launches on it."""
    import numpy as np
    import torch

    import trueno_rag_tpu_torch as rag
    from trueno_rag_tpu_torch.chunking import Chunk, ChunkMetadata
    from trueno_rag_tpu_torch.convert import retriever_from_state
    from trueno_rag_tpu_torch.ops import clustered as cl
    from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_v3_indirect
    from trueno_rag_tpu_torch.ops.tags import dense_topk_tagged
    from trueno_rag_tpu_torch.retrieve import resolve_tag_filters

    base = pipe.retriever
    reg = base.registry
    n = reg.capacity_rows
    gen = torch.Generator(device=DEV).manual_seed(seed + 4)
    centers = unit_rows(n // CL_TILE, gen)
    t0 = time.perf_counter()
    host = np.empty((n, DIM), np.float32)
    for lo in range(0, n, CL_SLAB):
        ids = torch.arange(lo, min(lo + CL_SLAB, n), device=DEV)
        host[lo:lo + len(ids)] = blob_corpus_rows(ids, centers, CL_PLANT, seed).cpu().numpy()
    log(f"clustered-1M corpus: {n} x {DIM} rows in {n // CL_TILE} blobs (sigma {CL_SIGMA}, {CL_PLANT} planted "
        f"per blob for {CL_PLANTED_BLOBS} blobs) in {time.perf_counter() - t0:.1f} s")

    # query texts from the slice's vocabulary, each embedded near a chosen
    # planted blob's centre
    rng = np.random.default_rng(seed + 5)
    n_q = CL_BATCHES * CL_BATCH + CL_SINGLES
    n_pl = min(CL_PLANTED_BLOBS, n // CL_TILE)
    blobs = rng.choice(n_pl, size=n_q, replace=n_q > n_pl)
    texts = [" ".join(r) for r in np.array([f"w{i:05d}" for i in range(VOCAB)])[
        rng.integers(0, VOCAB, size=(n_q, QUERY_WORDS))]]
    check(len(set(texts)) == n_q, "query texts repeat")
    qvecs = blob_queries(centers, blobs, gen).cpu().numpy()
    embedder = blob_embedder(dict(zip(texts, qvecs)))

    t0 = time.perf_counter()
    vcfg = rag.VectorStoreConfig(scan_tier="clustered", compact_fallback="host")
    retr = retriever_from_state(
        embedder, [reg.chunk_of(r) for r in range(n)], host, np.ones(n, bool),
        rag.BM25Index(device="cpu").state_dict(), config=base.config, vector_config=vcfg, device=DEV,
        tag_bits=reg.tags_host(n), tag_vocab=reg.tag_state([])[0],
    )
    # the slice's BM25 index serves as it is (same rows); its state_dict()
    # would round-trip 60M postings through Python dicts
    retr.sparse_index = base.sparse_index
    log(f"clustered-1M retriever from state: {time.perf_counter() - t0:.1f} s")
    # (the host build prepare_clustered is no longer timed beside the
    # store's build here: a depth cut for the smoke's time, PERF.md §4)
    del host
    store = retr.vector_store
    builds = count_cluster_builds()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store.ensure_ready()
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    order, _, _, radii = store._cluster
    check(builds == ["prepare_clustered_stream"], f"builds {builds}")
    check(store._device_matrix is None, "the clustered store kept an fp32 device matrix")
    log(f"clustered-1M store build (stream k-means over host slabs, permuted replicas): {t_build:.1f} s; "
        f"{len(radii)} tiles, median radius {float(radii.median()):.4f}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated after")
    p = rag.RagPipeline(embedder, pipe.reranker, pipe.chunker, retr, pipe.assembler)

    # each call of the pruned op inside the store: certified flags and the
    # scanned-tile count (return_stats)
    seen = []
    op = cl.dense_topk_compact_bf16r_clustered

    def recording(*a, **kw):
        out = op(*a, return_stats=True, **kw)
        seen.append((out[2].cpu().numpy().copy(), int(out[-1])))
        return out[:-1]

    cl.dense_topk_compact_bf16r_clustered = recording
    k5_total = 0

    def drive(qs, **kw):
        """One query_with_context_batch, K5's count set to 0 just before
        and read just after → (contexts, ms, K5 launches)."""
        nonlocal k5_total
        torch.cuda.synchronize()
        scan_select_v3_indirect.launches = 0
        t0 = time.perf_counter()
        ctxs = p.query_with_context_batch(qs, k=K, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n5 = scan_select_v3_indirect.launches
        k5_total += n5
        return ctxs, ms, n5

    m_dev = torch.from_numpy(store._host).to(DEV)
    v_dev = torch.from_numpy(store._valid).to(DEV)
    counters = ("compact_uncertified", "compact_candidate_patched", "compact_gemm_patched")
    try:
        drive(texts[:CL_BATCH])  # first-call set-up
        runs = [texts[i * CL_BATCH:(i + 1) * CL_BATCH] for i in range(CL_BATCHES)]
        runs += [[t] for t in texts[CL_BATCHES * CL_BATCH:]]
        def measure(label):
            """Every run through query_with_context_batch, then its dense sets
            against the float64 exact sets and its fusion against the oracle."""
            cand = retr.config.candidates_per_source
            n_cert = n_all = 0
            for i, qs in enumerate(runs):
                before = [getattr(store, c) for c in counters]
                seen.clear()
                ctxs, ms, n5 = drive(qs)
                check(n5 > 0, f"clustered-1M {label} run {i}: K5 did not launch")
                check_contexts(ctxs, n=len(qs))
                ok, scanned = seen[0]
                n_cert += int(ok.sum())
                n_all += len(ok)
                delta = [getattr(store, c) - b for c, b in zip(counters, before)]
                log(f"clustered-1M {label} B={len(qs)} run {i}: {ms:.1f} ms (host clock, query_with_context_batch "
                    f"k={K}); scanned {scanned}/{len(radii)} tiles; certified {int(ok.sum())}/{len(ok)}; "
                    f"uncertified {delta[0]}, candidate-patched {delta[1]}, GEMM-patched {delta[2]}; K5 launches {n5}")
                qv = np.asarray(embedder.embed_queries(qs), np.float32)
                want = exact_sets(torch.from_numpy(qv).to(DEV), m_dev, v_dev, cand)
                seen.clear()
                s_t, r_t = store.search_arrays(qv, cand)
                got = [set(x) for x in r_t.cpu().tolist()]
                check(all(g == w for g, w in zip(got, want)), f"{label} run {i}: a dense set is not the exact set")
                check(bool((seen[0][0] == ok).all()), f"{label} run {i}: the certificate changed between two calls")
                s_s, r_s = retr.sparse_index.search_arrays(qs, cand)
                check_fused(retr.config.fusion, r_t, s_t, r_s, s_s, f"clustered-1M {label} run {i}")
            log(f"clustered-1M {label}: device-certified {n_cert}/{n_all}; every dense set (certified or patched) "
                f"equals the float64 exact top-{cand} set over the whole corpus; fused lists match the host oracle")

        measure(f"{retr.config.candidates_per_source} candidates")
        # the clean store through an artifact and back
        k5_total += phase_clustered_artifact(retr, p, embedder, runs, pipe)
        # fewer dense candidates per query (a top-k that fits the kernel's
        # 16 per 1024-row tile), the regime the tier certifies in
        retr.config = dataclasses.replace(base.config, candidates_per_source=CL_FEW)
        measure(f"{CL_FEW} candidates")
        device_profile(lambda: p.query_with_context_batch(runs[0], k=K),  # reps 3 until slice 16: the smoke's time
                       f"clustered-1M {CL_FEW} candidates B={CL_BATCH} profile", reps=1)
        retr.config = base.config
        cand = retr.config.candidates_per_source

        # -- one tag-filtered batch ------------------------------------------
        f = rag.TagFilter(all=("t1",))
        qs = runs[0]
        ctxs, ms, n5 = drive(qs, tag_filter=f)
        check(n5 > 0, "the tag-filtered batch did not ride K5")
        check_contexts(ctxs, lambda row: row % 4 == 1, retr.registry, n=len(qs))
        masks = resolve_tag_filters(retr.registry, f, len(qs))
        qv = np.asarray(embedder.embed_queries(qs), np.float32)
        s_t, r_t = store.search_arrays(qv, cand, tag_masks=masks)
        x_s, x_r = dense_topk_tagged(torch.from_numpy(qv).to(DEV), m_dev, v_dev,
                                     torch.from_numpy(retr.registry.tags_host(n)).to(DEV),
                                     *(torch.from_numpy(x).to(DEV) for x in masks), cand, "cosine")
        check(all(set(a) == set(b) for a, b in zip(r_t.cpu().tolist(), x_r.cpu().tolist())),
              "tagged: a dense set differs from the filtered exact top-k set")
        log(f"clustered-1M tag batch all=[t1]: {ms:.1f} ms; every chunk passes; dense sets equal the filtered "
            f"exact top-{cand} sets; K5 launches {n5}")
        del x_s, x_r

        # -- mutate 1% of the rows within the incremental budget -------------
        live_rows = np.flatnonzero(store._valid)
        n_mut = max(3, int(CL_MUTATE * len(live_rows))) // 3
        pick = rng.choice(live_rows, size=2 * n_mut, replace=False)
        gone, upd = pick[:n_mut], pick[n_mut:]

        def new_vectors(id0, rows):  # fresh rows of the blobs of ``rows`` (a row's blob is row // CL_TILE)
            ids = torch.arange(id0, id0 + len(rows), device=DEV)
            which = torch.from_numpy(np.minimum(rows // CL_TILE, n // CL_TILE - 1)).to(DEV)
            return blob_vectors(ids, which, centers, torch.full((len(rows),), CL_SIGMA, device=DEV),
                                seed + 6).cpu().numpy()

        t0 = time.perf_counter()
        for r in gone.tolist():
            cid = retr.registry.id_of(int(r))
            check(store.remove(cid), "remove failed")
            retr.registry.remove(cid)
        upd_vec = new_vectors(2 * n, upd)
        store.insert_many([Chunk(id=retr.registry.id_of(int(r)), document_id="u", content="u", start_offset=0,
                                 end_offset=1, metadata=ChunkMetadata(), embedding=v.tolist())
                           for r, v in zip(upd.tolist(), upd_vec)])
        t_host = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.ensure_ready()
        torch.cuda.synchronize()
        t_ref1 = time.perf_counter() - t0
        ins_vec = new_vectors(3 * n, gone)
        new_chunks = [Chunk(id=f"new{i}", document_id="n", content="n", start_offset=0, end_offset=1,
                            metadata=ChunkMetadata(), embedding=v.tolist()) for i, v in enumerate(ins_vec)]
        store.insert_many(new_chunks)
        t0 = time.perf_counter()
        store.ensure_ready()
        torch.cuda.synchronize()
        t_ref2 = time.perf_counter() - t0
        check(builds == ["prepare_clustered_stream"], f"a mutation within budget re-ran k-means: {builds}")
        new_rows = [retr.registry.row_of(c.id) for c in new_chunks]
        check(all(store._cluster[0][store._cluster_inv[r]] == r for r in new_rows), "an inserted row has no slot")
        log(f"clustered-1M mutation: removed {n_mut}, updated {n_mut}, inserted {n_mut} rows "
            f"({3 * n_mut / len(live_rows):.4f} of live rows; budget {store.config.cluster_incremental_limit}); "
            f"host-side calls {t_host:.2f} s; incremental refreshes {t_ref1:.3f} s (remove + update) and "
            f"{t_ref2:.3f} s (insert) against the full build's {t_build:.1f} s; no k-means ran; "
            f"median radius {float(store._cluster[3].median()):.4f}")
        m_dev.copy_(torch.from_numpy(store._host))
        v_dev = torch.from_numpy(store._valid).to(DEV)
        qs = runs[1]
        qv = np.asarray(embedder.embed_queries(qs), np.float32)
        qv = np.concatenate([qv, ins_vec[:4]])  # also ask for freshly inserted rows
        want = exact_sets(torch.from_numpy(qv).to(DEV), m_dev, v_dev, cand)
        seen.clear()
        before = [getattr(store, c) for c in counters]
        s_t, r_t = store.search_arrays(qv, cand)
        got = [set(x) for x in r_t.cpu().tolist()]
        check(all(g == w for g, w in zip(got, want)), "after the mutation: a dense set is not the exact set")
        check(all(new_rows[i] in got[len(qs) + i] for i in range(4)), "an inserted row is invisible")
        delta = [getattr(store, c) - b for c, b in zip(counters, before)]
        log(f"clustered-1M after the mutation: {len(qv)} queries exact (certified {int(seen[0][0].sum())}, "
            f"scanned {seen[0][1]} tiles; uncertified {delta[0]}, candidate-patched {delta[1]}, GEMM-patched "
            f"{delta[2]})")
    finally:
        cl.dense_topk_compact_bf16r_clustered = op
    log(f"clustered-1M path (query_with_context_batch calls only): K5 launches {k5_total}")
    check(k5_total > 0, "the clustered path never launched K5")
    del m_dev, retr, store, p
    torch.cuda.empty_cache()
    return k5_total


def phase_clustered_stream(seed: int) -> None:
    """The clustered tier's design point at the ops level: N_CL_STREAM blob
    rows generated on the card by their id, built with
    prepare_clustered_stream (the fp32 corpus never exists), queried at
    B = 8 with both fetches and against the full compact stream."""
    import numpy as np
    import torch

    from trueno_rag_tpu_torch.ops import clustered as cl
    from trueno_rag_tpu_torch.ops import dense_tiered as dt
    from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_v3, scan_select_v3_indirect

    n, k = N_CL_STREAM, CL_STREAM_K
    t = n // CL_TILE
    gen = torch.Generator(device=DEV).manual_seed(seed + 7)
    centers = unit_rows(t, gen)

    def rows_of(ids):  # the corpus as a pure function of row ids
        return blob_corpus_rows(torch.as_tensor(np.asarray(ids), device=DEV), centers, k, seed + 8)

    fill, fill_args = cl._greedy_fill, []

    def recorded_fill(*a):
        fill_args.append(a)
        return fill(*a)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cl._greedy_fill = recorded_fill
    try:
        order, cent, radii = cl.prepare_clustered_stream(rows_of, n, DIM, tile_n=CL_TILE, slab=CL_SLAB)
    finally:
        cl._greedy_fill = fill
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    check(len(order) == n and (np.sort(order) == np.arange(n)).all(), "the stream build lost or repeated a row")
    reps = None
    for lo in range(0, n, CL_SLAB):
        ms = rows_of(order[lo:lo + CL_SLAB])
        parts = dt.prepare_tiered(ms) + dt.prepare_residual(ms)
        if reps is None:
            reps = [torch.empty((n,) + x.shape[1:], dtype=x.dtype, device=DEV) for x in parts]
        for dest, part in zip(reps, parts):
            dest[lo:lo + part.shape[0]].copy_(part)
        del ms, parts
    torch.cuda.synchronize()
    t_reps = time.perf_counter() - t0 - t_build
    valid = torch.ones(n, dtype=torch.bool, device=DEV)
    order_t = torch.from_numpy(order).to(DEV)
    cent_t, radii_t = torch.from_numpy(cent).to(DEV), torch.from_numpy(radii).to(DEV)
    log(f"clustered-{n}: stream build {t_build:.1f} s ({t} tiles, median radius {np.median(radii):.4f}), "
        f"replicas in cluster order {t_reps:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    got = fill(*fill_args[0])
    t_vec = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_fill = plain_greedy_fill(*fill_args[0])
    t_plain = time.perf_counter() - t0
    check(all(np.array_equal(g, w) for g, w in zip(got, want_fill)), "the greedy fill differs from the plain loop")
    log(f"clustered-{n}: greedy fill of the build's alternatives {t_vec:.2f} s, the plain sequential loop "
        f"{t_plain:.2f} s (host clock); placements identical")
    del fill_args, got, want_fill

    blobs = np.random.default_rng(seed + 9).permutation(min(CL_PLANTED_BLOBS, t))[:CL_BATCH]
    q = blob_queries(centers, blobs, gen)
    qn = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    t0 = time.perf_counter()
    best_s = torch.full((len(q), k + 1), float("-inf"), dtype=torch.float64, device=DEV)
    best_r = torch.full((len(q), k + 1), -1, dtype=torch.int64, device=DEV)
    for lo in range(0, n, CL_SLAB):  # float64 exact top-(k+1), streamed (check-only library top-k)
        s = qn.double() @ rows_of(np.arange(lo, min(lo + CL_SLAB, n))).double().T
        cat_s = torch.cat([best_s, s], dim=1)
        cat_r = torch.cat([best_r, torch.arange(lo, lo + s.shape[1], device=DEV).expand(len(q), -1)], dim=1)
        best_s, i = torch.topk(cat_s, k + 1, dim=1)
        best_r = torch.gather(cat_r, 1, i)
    gap = (best_s[:, k - 1] - best_s[:, k]).min().item()
    check(gap > 0.0, "the float64 reference has a tie at rank k")
    want = [set(x) for x in best_r[:, :k].cpu().tolist()]
    log(f"clustered-{n} reference (float64, streamed): {time.perf_counter() - t0:.1f} s; least gap between "
        f"the k-th and (k+1)-th score {gap:.3e}")

    kw = dict(probe_tiles=CL_PROBE, row_map=order_t, tile_n=CL_TILE, return_stats=True)
    res = {}
    for fetch in ("dma", "gather"):
        torch.cuda.reset_peak_memory_stats()
        scan_select_v3_indirect.launches = scan_select_v3.launches = 0
        s, r, ok, scanned = cl.dense_topk_compact_bf16r_clustered(q, *reps, valid, k, cent_t, radii_t,
                                                                  fetch=fetch, **kw)
        torch.cuda.synchronize()
        launched = scan_select_v3_indirect.launches if fetch == "dma" else scan_select_v3.launches
        check(launched == 1, f"clustered {fetch}: its scan kernel launched {launched} times")
        check(bool(torch.isfinite(s).all()) and tuple(r.shape) == (len(q), k), f"clustered {fetch}: malformed")
        ok_l, r_l = ok.cpu().tolist(), r.cpu().tolist()
        for i in range(len(q)):
            if ok_l[i]:
                check(set(r_l[i]) == want[i], f"clustered {fetch}: certified query {i} is not the exact set")
        res[fetch] = (s, r, ok)
        captured = {}
        kernel = scan_select_v3_indirect if fetch == "dma" else scan_select_v3
        name = kernel.__name__

        def capture(*a, _k=kernel, **kwa):
            captured["call"] = (a, kwa)
            return _k(*a, **kwa)

        setattr(cl, name, capture)
        try:
            cl.dense_topk_compact_bf16r_clustered(q, *reps, valid, k, cent_t, radii_t, fetch=fetch, **kw)
        finally:
            setattr(cl, name, kernel)
        a, kwa = captured["call"]
        batch_ms = cuda_ms(lambda: cl.dense_topk_compact_bf16r_clustered(q, *reps, valid, k, cent_t, radii_t,
                                                                          fetch=fetch, **kw), 10)
        kern_ms = cuda_ms(lambda: kernel(*a, **kwa), 10)
        log(f"clustered-{n} B={len(q)} fetch={fetch}: certified {sum(ok_l)}/{len(q)}, every certified set exact; "
            f"scanned {int(scanned)}/{t} tiles; batch {batch_ms:.3f} ms, {name} alone {kern_ms:.3f} ms (median, "
            f"CUDA events); peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(all(torch.equal(x, y) for x, y in zip(res["dma"], res["gather"])), "dma and gather results differ")
    log("clustered dma and gather: scores, rows and certificates identical")
    for fetch in ("dma", "gather"):
        device_profile(lambda: cl.dense_topk_compact_bf16r_clustered(q, *reps, valid, k, cent_t, radii_t,
                                                                     fetch=fetch, **kw),
                       f"clustered-{n} B={len(q)} fetch={fetch} profile")

    scan_select_v3.launches = 0
    s, r, ok = dt.dense_topk_compact_bf16r(q, *reps, valid, k)
    torch.cuda.synchronize()
    check(scan_select_v3.launches == 1, "full stream: K1 did not launch once")
    r = torch.where(r >= 0, order_t[r.clamp(min=0).long()], r)
    ok_l, r_l = ok.cpu().tolist(), r.cpu().tolist()
    for i in range(len(q)):
        if ok_l[i]:
            check(set(r_l[i]) == want[i], f"full stream: certified query {i} is not the exact set")
    full_ms = cuda_ms(lambda: dt.dense_topk_compact_bf16r(q, *reps, valid, k), 5)
    log(f"full-stream dense_topk_compact_bf16r at N={n} B={len(q)}: certified {sum(ok_l)}/{len(q)}, every "
        f"certified set exact; batch {full_ms:.3f} ms (median, CUDA events)")
    del reps, valid, order_t
    torch.cuda.empty_cache()


def k4_inputs(bh: int, t: int, hd: int, lengths, gen):
    """Seeded bf16 q, k, v [bh, t, hd] on the card and a right-padded key
    mask with the given per-row lengths."""
    import torch

    q, k, v = (torch.randn(bh, t, hd, device=DEV, generator=gen).to(torch.bfloat16) for _ in range(3))
    lengths = torch.as_tensor(lengths, device=DEV)
    mask = torch.arange(t, device=DEV)[None, :] < lengths[:, None]
    return q, k, v, mask


def compare_k4(got, want, v, heads: int, label: str):
    """The kernel against its plain version: every element within
    K4_TOL_MAX·max|V| of its head, the mean within K4_TOL_MEAN·max|V|, no
    NaN → the largest error as a share of its head's max|V|."""
    import torch

    check(bool(torch.isfinite(got.float()).all()), f"{label}: non-finite kernel output")
    scale = v.float().abs().amax(dim=(1, 2))  # [BH]
    err = (got.float() - want.float()).abs() / scale[:, None, None]
    worst, mean = err.max().item(), err.mean().item()
    log(f"{label}: max |kernel - plain| {worst:.3e} x max|V| (tolerance {K4_TOL_MAX:.3e}), "
        f"mean {mean:.3e} (tolerance {K4_TOL_MEAN:.3e})")
    check(worst <= K4_TOL_MAX, f"{label}: an element differs by {worst} x max|V|")
    check(mean <= K4_TOL_MEAN, f"{label}: the mean difference is {mean} x max|V|")
    return worst


def k4_tile_work(mask, heads: int, causal: bool):
    """The (32-row warp, 64-key tile) products csrc/block_attention.cu does
    for a key mask [BH / heads, T] → (Q K^T, P V) counts, summed over BH.
    A block of 128 rows walks the key tiles up to its last row, or all of
    them if a row below T has no kept key at or before its position; a warp
    skips a tile with no kept key at or before its last row once each of
    its rows has a kept key at or before its position (in pass 1: one in an
    earlier tile). Pass 1 takes Q K^T and pass 2 Q K^T and P V of each tile
    it walks, but no Q K^T where the tile holds no kept key."""
    import numpy as np

    mask = mask.cpu().numpy()
    n, t = mask.shape
    n_kt = -(-t // K4_TILE_KEYS)
    n_w = -(-t // K4_BLOCK_ROWS) * (K4_BLOCK_ROWS // K4_WARP_ROWS)
    k0 = np.arange(n_kt) * K4_TILE_KEYS  # [KT]
    lo = np.arange(n_w) * K4_WARP_ROWS  # [W]: each warp's first row
    q0 = lo // K4_BLOCK_ROWS * K4_BLOCK_ROWS
    pad = np.zeros((n, n_kt * K4_TILE_KEYS), bool)
    pad[:, :t] = mask
    kept = pad.reshape(n, n_kt, K4_TILE_KEYS)
    pos = np.where(kept, np.arange(K4_TILE_KEYS), K4_TILE_KEYS).min(axis=2) + k0  # first kept key per tile
    first = np.where(mask.any(axis=1), mask.argmax(axis=1), t)  # [n]: each row's first kept key (t: none)
    qk = pv = 0
    for r in range(n):
        empty = pos[r][None, :] >= k0[None, :] + K4_TILE_KEYS  # [1, KT]: no kept key in the tile
        none = empty
        if causal:
            none = none | (pos[r][None, :] > lo[:, None] + K4_WARP_ROWS - 1)
            past = first[r] <= lo[:, None]  # every row of the warp has a kept key at or before it
            last = (np.minimum(q0 + K4_BLOCK_ROWS, t) - 1) // K4_TILE_KEYS + 1
            walk = np.where(first[r] > q0, n_kt, last)[:, None] > np.arange(n_kt)[None, :]
        else:
            past = np.full((n_w, 1), first[r] < t)
            walk = np.ones((n_w, n_kt), bool)
        live = walk & (lo < t)[:, None]
        pass1 = live & ~(none & past & (first[r] < k0)[None, :])
        pass2 = live & ~(none & past)
        qk += int((pass1 & ~empty).sum()) + int((pass2 & ~empty).sum())
        pv += int(pass2.sum())
    return qk * heads, pv * heads


def phase_kernels_k4(seed: int):
    """K4 against its plain version at (a) the 8k shape, (b) the Nemotron
    ingest shape with ragged masks and an all-PAD row, (c) a ragged T, (d)
    shape (b) with left-padded and future-only masks; its times beside the
    plain version, SDPA and the bound → the K4 record."""
    import torch
    import torch.nn.functional as F

    from trueno_rag_tpu_torch.ops.kernels.attention import block_attention, block_attention_reference

    gen = torch.Generator(device=DEV).manual_seed(seed + 11)
    src = "trueno_rag_tpu_torch/csrc/block_attention.cu"

    # (a) BH = 32, T = 8192, hd = 128, causal; half the rows lose their last 1000 keys
    bh, t, hd = K4_A
    q, k, v, mask = k4_inputs(bh, t, hd, [t - 1000 if i % 2 else t for i in range(bh)], gen)
    got = block_attention(q, k, v, mask, causal=True)
    torch.cuda.synchronize()
    want = block_attention_reference(q, k, v, mask, causal=True)
    err_a = compare_k4(got, want, v, 1, f"K4 (a) BH={bh} T={t} hd={hd} causal")
    del got, want
    ms_a = cuda_ms(lambda: block_attention(q, k, v, mask, causal=True), 5)
    plain_a = cuda_ms(lambda: block_attention_reference(q, k, v, mask, causal=True), 2)
    ms_a2 = cuda_ms(lambda: block_attention(q, k, v, mask, causal=True), 5)
    keep = mask[:, None, :] & torch.ones(t, t, dtype=torch.bool, device=DEV).tril()[None]  # [BH, T, T]
    qs, ks_, vs = (x[None] for x in (q, k, v))  # [1, BH, T, hd]: heads on dim 1
    lib_a = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks_, vs, attn_mask=keep[None]), 3)
    del keep
    flash_a = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks_, vs, is_causal=True), 5)
    flop_a = 2.0 * bh * t * t * hd  # the causal half of one pass's two products
    bound_a = bound(4 * bh * t * hd * 2 + bh * t, flop_a, BF16_FLOP_PER_S)
    log(f"K4 (a): kernel {ms_a:.3f} / {ms_a2:.3f} ms, plain {plain_a:.3f} ms, SDPA with the boolean "
        f"causal-and-key mask {lib_a:.3f} ms, SDPA is_causal (no key mask) {flash_a:.3f} ms (median, CUDA "
        f"events); bound {bound_a[0]:.3f} ms ({bound_a[1]})")
    full_a = cuda_ms(lambda: block_attention(q, k, v, mask, causal=False), 3)
    qk, pv = k4_tile_work(mask, 1, True)
    done = (qk + pv) * 2.0 * K4_WARP_ROWS * K4_TILE_KEYS * hd
    log(f"  K4 (a) rate {done / (min(ms_a, ms_a2) * 1e-3) / 1e12:.1f} TFLOP/s bf16 (the products the kernel does: "
        f"Q K^T on {qk} and P V on {pv} (32-row warp, 64-key tile) pairs, {done:.3e} FLOP, "
        f"{done / (3 * 2.0 * bh * t * t * hd):.1%} of three full products); the causal half of two products "
        f"{flop_a / (min(ms_a, ms_a2) * 1e-3) / 1e12:.1f} TFLOP/s; without causal {full_a:.3f} ms "
        f"(causal / not {min(ms_a, ms_a2) / full_a:.3f})")
    del q, k, v, mask, qs, ks_, vs

    # (b) the Nemotron ingest shape: B = 8 rows x 32 heads, T = 1024, one all-PAD row
    b, heads, t = K4_B
    lengths = [t, t - 14, t - 21, 0, t - 7, t - 26, t, t - 16][:b]
    q, k, v, mask = k4_inputs(b * heads, t, hd, lengths, gen)
    got = block_attention(q, k, v, mask, causal=True, heads=heads)
    torch.cuda.synchronize()
    want = block_attention_reference(q, k, v, mask, causal=True, heads=heads)
    compare_k4(got, want, v, heads, f"K4 (b) BH={b * heads} T={t} ragged, all-PAD row 3")
    pad = slice(3 * heads, 4 * heads)  # no kept key: the plain mean of V over T keys
    mean_v = v[pad].float().mean(dim=1, keepdim=True).expand(-1, t, -1)
    compare_k4(got[pad], mean_v, v[pad], 1, "K4 (b) all-PAD row against the mean of V")
    ms_b = cuda_ms(lambda: block_attention(q, k, v, mask, causal=True, heads=heads), 10)
    plain_b = cuda_ms(lambda: block_attention_reference(q, k, v, mask, causal=True, heads=heads), 3)
    bound_b = bound(4 * b * heads * t * hd * 2 + b * t, 2.0 * b * heads * t * t * hd, BF16_FLOP_PER_S)
    qs, ks_, vs = (x.view(b, heads, t, hd) for x in (q, k, v))
    keep = mask[:, None, None, :] & torch.ones(t, t, dtype=torch.bool, device=DEV).tril()[None, None]
    lib_b = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks_, vs, attn_mask=keep), 5)
    log(f"K4 (b): kernel {ms_b:.3f} ms, plain {plain_b:.3f} ms, SDPA with the boolean causal-and-key mask "
        f"{lib_b:.3f} ms (median, CUDA events); bound {bound_b[0]:.3f} ms ({bound_b[1]})")
    del q, k, v, mask, got, want, qs, ks_, vs, keep

    # (d) shape (b) with left-padded and future-only masks: the rows with no
    # kept key at or before their position average V over all T keys
    q, k, v, _ = k4_inputs(b * heads, t, hd, [t] * b, gen)
    j = torch.arange(t, device=DEV)[None, :]
    lo, hi = (torch.tensor(x, device=DEV)[:, None] for x in zip(*K4_D))
    mask = (j >= lo) & (j < hi)  # [b, t]
    got = block_attention(q, k, v, mask, causal=True, heads=heads)
    torch.cuda.synchronize()
    want = block_attention_reference(q, k, v, mask, causal=True, heads=heads)
    compare_k4(got, want, v, heads, f"K4 (d) BH={b * heads} T={t} left-padded and future-only masks")
    bare = ~(torch.cummax(mask.int(), dim=1).values.bool())  # [b, t]: no kept key at or before
    bare = bare.repeat_interleave(heads, dim=0)[..., None]
    mean_v = v.float().mean(dim=1, keepdim=True).expand(-1, t, -1)
    compare_k4(got, torch.where(bare, mean_v, want.float()), v, heads,
               f"K4 (d) its {int(bare.sum()) // heads} rows per head without a past kept key against the mean of V")
    log(f"K4 (d): kernel {cuda_ms(lambda: block_attention(q, k, v, mask, causal=True, heads=heads), 5):.3f} ms "
        f"(median, CUDA events; (b)'s right-padded masks {ms_b:.3f} ms)")
    del q, k, v, mask, got, want, bare, mean_v

    # (c) T = 528 (no multiple of 64 or 128), hd = 64, both causal values
    bh, t, hd = K4_C
    for causal in (True, False):
        q, k, v, mask = k4_inputs(bh, t, hd, [t - 7 * i for i in range(bh - 1)] + [0], gen)
        got = block_attention(q, k, v, mask, causal=causal)
        torch.cuda.synchronize()
        compare_k4(got, block_attention_reference(q, k, v, mask, causal=causal), v, 1,
                   f"K4 (c) BH={bh} T={t} hd={hd} causal={causal}")
    del q, k, v, mask, got
    torch.cuda.empty_cache()
    return {"name": "block_attention", "route": "cuda", "source": src,
            "replaces": "trueno_rag_tpu/ops/pallas/attention.py:70", "max_abs_err": err_a,
            "ms": min(ms_a, ms_a2), "plain_ms": plain_a, "bound_ms": bound_a[0], "bound_by": bound_a[1],
            "library_ms": lib_a}


def long_texts(rng, n: int, lo: int, hi: int):
    """``n`` texts of lo..hi words from the slice's vocabulary."""
    import numpy as np

    words = np.array([f"w{i:05d}" for i in range(VOCAB)])
    return [" ".join(words[rng.integers(0, VOCAB, size=int(ln))]) for ln in rng.integers(lo, hi + 1, size=n)]


def phase_nemotron_8k(seed: int):
    """Nemotron at full width on 8 texts of 8,190 words (T = 8192) →
    (embedder, K4 launches)."""
    import numpy as np
    import torch

    import trueno_rag_tpu_torch as rag
    from trueno_rag_tpu_torch.ops.kernels.attention import block_attention

    cfg = rag.NemotronConfig.full()
    t0 = time.perf_counter()
    emb = rag.NemotronEmbedder(config=cfg, seed=seed, device=DEV)
    torch.cuda.synchronize()
    log(f"nemotron full ({cfg.hidden_dim}-d, {cfg.num_layers} layers, {cfg.num_heads} heads, MLP {cfg.mlp_dim}, "
        f"vocab {cfg.vocab_size}): seeded bf16 weights on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    rng = np.random.default_rng(seed + 12)
    texts = long_texts(rng, NEMO_B, NEMO_WORDS, NEMO_WORDS)
    ids = emb.tokenizer.encode_batch(texts)
    check(ids.shape == (NEMO_B, cfg.max_len), f"token batch {ids.shape}, expected ({NEMO_B}, {cfg.max_len})")
    # the first call (library set-up included) is traced for K4's share
    rows = device_profile(lambda: emb.embed_batch(texts), "nemotron-8k profile (first batch)", reps=1, warm=False)
    busy = sum(r[0] for r in rows)
    k4 = sum(r[0] for r in rows if "block_attention" in r[2])
    log(f"nemotron-8k: K4 {k4:.1f} ms of {busy:.1f} ms device time = {k4 / busy:.1%}")
    out = emb.embed_batch(texts)
    torch.cuda.reset_peak_memory_stats()
    block_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out2 = emb.embed_batch(texts)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    launches = block_attention.launches  # the rest of the phase keeps counting
    peak = torch.cuda.max_memory_allocated()
    check(launches == cfg.num_layers, f"K4 launched {launches} times in one 8k batch, expected {cfg.num_layers}")
    check(out2.shape == (NEMO_B, cfg.hidden_dim) and np.isfinite(out2).all(), "nemotron-8k: malformed embeddings")
    norms = np.linalg.norm(out2, axis=1)
    check(bool((np.abs(norms - 1.0) <= 1e-3).all()), f"nemotron-8k: norms {norms}")
    check(np.array_equal(out, out2), "nemotron-8k: two calls differ")
    tokens = int((ids != 0).sum())
    log(f"nemotron-8k: B={NEMO_B} T={ids.shape[1]}: {dt_s:.2f} s = {tokens / dt_s:.0f} tokens/s (host clock, "
        f"synchronized); K4 launches {launches}; peak allocated {peak / 2**30:.2f} GiB; norms within "
        f"{np.abs(norms - 1).max():.1e} of 1; two calls bit-identical")

    # a short text padded into an 8k batch (block path, ragged T = 608 alone)
    short = long_texts(rng, 1, 600, 600)[0]
    together = emb.embed_batch([short, texts[0]])
    alone = emb.embed_batch([short])
    check(emb.tokenizer.encode_batch([short]).shape[1] == 608, "the short text is not T = 608")
    cos = float(together[0] @ alone[0])
    log(f"nemotron-8k: a 600-word text in an 8k batch vs alone (T=608, block path): cosine {cos:.6f}")
    check(cos >= 0.999, f"nemotron-8k: padded and alone differ (cosine {cos})")
    return emb, block_attention.launches


def phase_nemotron_rag(emb, seed: int) -> int:
    """A RagPipeline over the full-width Nemotron embedder: ingest ~1,000-word
    documents (block path), answer short queries (naive path) → K4 launches."""
    import numpy as np
    import torch

    import trueno_rag_tpu_torch as rag
    from trueno_rag_tpu_torch.ops.kernels.attention import block_attention

    rng = np.random.default_rng(seed + 13)
    docs = [rag.Document(t, id=f"ndoc{i}") for i, t in enumerate(long_texts(rng, NR_DOCS, 990, 1022))]
    pipe = (
        rag.RagPipelineBuilder()
        .with_embedder(emb)
        .with_reranker(rag.LexicalReranker())
        .with_chunker(rag.RecursiveChunker(chunk_size=16384, overlap=0))
        .with_device(DEV)
        .build()
    )
    block_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_chunks = pipe.index_documents(docs)
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    launches = block_attention.launches
    check(n_chunks == NR_DOCS, f"nemotron-rag: {n_chunks} chunks for {NR_DOCS} documents")
    tokens = sum(len(emb.tokenizer.encode(d.content)) for d in docs)
    n_batches = -(-NR_DOCS // emb.batch_size)
    log(f"nemotron-rag ingest: {n_chunks} chunks, {tokens} tokens in {t_ingest:.1f} s = {n_chunks / t_ingest:.1f} "
        f"chunks/s, {tokens / t_ingest:.0f} tokens/s (host clock); K4 launches {launches} "
        f"({n_batches} batches x {emb.nemotron_config.num_layers} layers)")
    check(launches == n_batches * emb.nemotron_config.num_layers, "nemotron-rag: K4 did not run every ingest layer")

    retr = pipe.retriever
    store = retr.vector_store
    words = np.array([f"w{i:05d}" for i in range(VOCAB)])
    batches = [[" ".join(words[rng.integers(0, VOCAB, size=int(n))]) for n in rng.integers(3, 13, size=8)]
               for _ in range(NR_QUERY_BATCHES)]
    pipe.query_with_context_batch(batches[0], k=K)  # warm-up
    block_attention.launches = 0
    lat = []
    for qs in batches:
        t0 = time.perf_counter()
        contexts = pipe.query_with_context_batch(qs, k=K)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        check_contexts(contexts, n=len(qs))
    check(block_attention.launches == 0, "nemotron-rag: short queries took the block path")
    log(f"nemotron-rag queries: {len(batches)} batches of 8, median {sorted(lat)[len(lat) // 2] * 1e3:.1f} ms per "
        f"batch, {8 * len(lat) / sum(lat):.1f} queries/s (host clock, query_with_context_batch k={K}, naive path)")
    host = store._host[store._valid].astype(np.float64)
    for i, qs in enumerate(batches):
        qv = np.asarray(emb.embed_queries(qs), dtype=np.float32)
        s_t, r_t = store.search_arrays(qv, K)
        qn = qv.astype(np.float64) / np.linalg.norm(qv.astype(np.float64), axis=1, keepdims=True)
        s64 = qn @ host.T
        want = np.lexsort((np.broadcast_to(np.arange(host.shape[0]), s64.shape), -s64), axis=1)[:, :K]
        check(np.array_equal(r_t.cpu().numpy(), want), f"nemotron-rag batch {i}: dense top-{K} != float64 exact")
        cand = retr.config.candidates_per_source
        s_d, r_d = store.search_arrays(qv, cand)
        s_s, r_s = retr.sparse_index.search_arrays(qs, cand)
        check_fused(retr.config.fusion, r_d, s_d, r_s, s_s, f"nemotron-rag batch {i}")
    log(f"nemotron-rag: dense top-{K} equal to the float64 exact top-{K} for all {8 * len(batches)} queries; "
        f"fused lists match the host oracle")
    return launches


def phase_encoder_262k(seed: int) -> int:
    """MiniLM-L6 through index_documents at ENC_N one-chunk documents (a
    depth cut from 1M for the smoke's time), then the
    staged bf16 tier (K1), the fused query over the fp32 matrix and the fused
    compact query (K1 + host patch), then the cross-encoder → K1 launches."""
    import numpy as np
    import torch

    import trueno_rag_tpu_torch as rag
    from trueno_rag_tpu_torch.ops import hybrid as hy
    from trueno_rag_tpu_torch.ops.dense import dense_topk
    from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_v3

    rng = np.random.default_rng(seed + 14)
    t0 = time.perf_counter()
    docs = [rag.Document(t, id=f"edoc{i}") for i, t in enumerate(make_texts(rng, ENC_N, DOC_WORDS))]
    log(f"encoder-262k documents: {len(docs)} generated in {time.perf_counter() - t0:.1f} s")
    emb = rag.EncoderEmbedder(config=rag.EncoderConfig.minilm_l6(), seed=seed, device=DEV)
    pipe = (
        rag.RagPipelineBuilder()
        .with_embedder(emb)
        .with_reranker(rag.LexicalReranker())
        # "bf16": below 400,000 rows "auto" would keep the fp32 matrix
        .with_vector_config(rag.VectorStoreConfig(dimension=emb.dimension, scan_tier="bf16"))
        .with_device(DEV)
        .build()
    )
    retr = pipe.retriever
    store = retr.vector_store
    t0 = time.perf_counter()
    n_chunks = pipe.index_documents(docs)
    t_ingest = time.perf_counter() - t0
    del docs
    check(n_chunks == ENC_N, f"encoder-262k: indexed {n_chunks} chunks")
    check(store._effective_tier() == "bf16", f"encoder-262k: tier {store._effective_tier()!r}, expected 'bf16'")
    log(f"encoder-262k ingest (chunk + MiniLM-L6 embed on the card + index): {n_chunks} chunks in {t_ingest:.1f} s = "
        f"{n_chunks / t_ingest:.0f} chunks/s (host clock)")
    retr.ensure_ready()
    cand = retr.config.candidates_per_source
    batches = query_batches(rng, N_BATCHES + 1)

    def exact_rows(qs):
        q = emb.embed_queries_device(qs)
        return dense_topk(q, store.device_matrix, store.device_valid, cand, "cosine")[1]

    # staged (fused=None on the bf16 tier): K1
    pipe.query_with_context_batch(batches[0], k=K)  # warm-up
    scan_select_v3.launches = 0
    lat = []
    for qs in batches[:N_BATCHES]:
        t0 = time.perf_counter()
        check_contexts(pipe.query_with_context_batch(qs, k=K))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    launches = scan_select_v3.launches
    check(launches >= N_BATCHES, f"encoder-262k staged: K1 launched {launches} times")
    for i, qs in enumerate(batches[:N_BATCHES]):
        _, r_t = store.search_arrays(np.asarray(emb.embed_queries(qs), np.float32), cand)
        check(torch.equal(r_t, exact_rows(qs)), f"encoder-262k staged batch {i}: rows differ from the exact path")
    log(f"encoder-262k staged (bf16 tier, K1 launches {launches}): median {sorted(lat)[len(lat) // 2] * 1e3:.1f} ms per "
        f"batch of {BATCH}, {BATCH * len(lat) / sum(lat):.0f} queries/s; dense rows equal to the exact path")

    # fused=True over the fp32 matrix (fused_hybrid_query)
    qs = batches[N_BATCHES]
    calls = []
    fused = hy.fused_hybrid_query
    hy.fused_hybrid_query = lambda *a, **kw: calls.append(1) or fused(*a, **kw)
    try:
        retr.config = dataclasses.replace(retr.config, fused=True)
        retr.retrieve_batch(qs, 2 * K)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = retr.retrieve_batch(qs, 2 * K)
        torch.cuda.synchronize()
        t_fused = time.perf_counter() - t0
    finally:
        hy.fused_hybrid_query = fused
        retr.config = dataclasses.replace(retr.config, fused=None)
    check(len(calls) == 2 and len(res) == BATCH and all(res), "encoder-262k: the fused query did not run")
    ids, bids, blo, bhi = retr._fused_preamble(qs)
    out = fused(emb.params, ids, store.device_matrix, store.device_valid, bids, blo, bhi,
                retr.sparse_index._snap["blocks"], encoder_config=emb.encoder_config, cand=cand, k=2 * K)
    want = exact_rows(qs)
    check(all(set(a) == set(b) for a, b in zip(out[2][:BATCH].tolist(), want.tolist())),
          "encoder-262k fused: dense row sets differ from the exact path")
    log(f"encoder-262k fused=True over the fp32 matrix: {t_fused * 1e3:.1f} ms per batch of {BATCH} = "
        f"{BATCH / t_fused:.0f} queries/s (retrieve_batch, host clock); dense sets equal to the exact path")

    # fused=True on a compact bf16r store of the same rows
    cp = sibling_pipeline(pipe, rag.VectorStoreConfig(dimension=emb.dimension, scan_tier="compact",
                                                      compact_scan="bf16r"))
    cr = cp.retriever
    cr.config = dataclasses.replace(retr.config, fused=True)
    cr.ensure_ready()
    cs = cr.vector_store
    qs_c = qs[:CP_QUERIES]
    patched = []
    patch = cs._compact_exact_patch
    cs._compact_exact_patch = lambda *a, **kw: patched.append(patch(*a, **kw)) or patched[-1]
    scan_select_v3.launches = 0
    t0 = time.perf_counter()
    handle = cr.retrieve_batch_submit(qs_c, 2 * K)
    res = cr.retrieve_batch_collect(handle)
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t0
    n_k1 = scan_select_v3.launches  # the scan, plus any widened retry of the host patch
    check(handle[0] == "fused_compact" and n_k1 >= 1, "encoder-262k: the fused compact query did not run K1")
    launches += n_k1
    b = len(qs_c)
    ok = handle[1][6].cpu().numpy()[:b]
    d_r = patched[-1][1] if patched else handle[1][2].cpu().numpy()
    check(all(set(x) == set(y) for x, y in zip(d_r[:b].tolist(), exact_rows(qs_c).tolist())),
          "encoder-262k fused compact: dense row sets (after the host patch) differ from the exact path")
    check(len(res) == b and all(res), "encoder-262k fused compact: empty results")
    log(f"encoder-262k fused=True on a compact bf16r store: {t_compact * 1e3:.1f} ms per batch of {b} = "
        f"{b / t_compact:.0f} queries/s (submit + collect, first call, host clock); certified {int(ok.sum())}/{b} "
        f"(the rest host-patched: {cs.compact_candidate_patched} by candidates, {cs.compact_gemm_patched} by "
        f"GEMM); K1 launches {n_k1}; dense sets equal to the exact path")
    del cp, cr, cs
    torch.cuda.empty_cache()

    # the cross-encoder reranks 32 queries x 50 candidates
    ce = rag.CrossEncoderReranker(config=rag.EncoderConfig.minilm_l6(), seed=seed, device=DEV)
    qs = batches[0][:CE_QUERIES]
    cands = retr.retrieve_batch(qs, CE_CANDIDATES)
    ce.rerank(qs[0], cands[0], K)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reranked = [ce.rerank(q, c, K) for q, c in zip(qs, cands)]
    torch.cuda.synchronize()
    t_ce = time.perf_counter() - t0
    for r in reranked:
        s = [x.rerank_score for x in r]
        check(len(r) == K and all(0.0 < x < 1.0 for x in s) and s == sorted(s, reverse=True),
              "cross-encoder: malformed rerank")
    log(f"cross-encoder (MiniLM-L6 trunk) reranks {len(qs)} queries x {CE_CANDIDATES} candidates in "
        f"{t_ce * 1e3:.1f} ms = {len(qs) * CE_CANDIDATES / t_ce:.0f} pairs/s (host clock)")
    return launches


# -- late interaction (slice 5) -------------------------------------------------


def maxsim64(q, qm, tokens, t_mask, valid, stored=None, slab: int = MS_SLAB):
    """float64 MaxSim of every query against every chunk → [B, N] f64 (-inf
    at invalid chunks): the per-token dots, the masked max and the Lq-sum in
    float64 over the stored values (``stored(lo, hi)``, default the slab of
    ``tokens`` upcast)."""
    import torch

    b, lq, h = q.shape
    n, lt = t_mask.shape
    qd = torch.where(qm[:, :, None], q, 0.0).double().reshape(b * lq, h)
    out = torch.empty((b, n), dtype=torch.float64, device=DEV)
    for lo in range(0, n, slab):
        hi = min(n, lo + slab)
        t = stored(lo, hi) if stored is not None else tokens[lo:hi]
        sim = (t.double().reshape(-1, h) @ qd.T).view(hi - lo, lt, b, lq)
        sim.masked_fill_(~t_mask[lo:hi][:, :, None, None], float("-inf"))
        best = sim.amax(dim=1)
        best = torch.where(qm[None] & torch.isfinite(best), best, 0.0)
        out[:, lo:hi] = best.sum(dim=2).T
        del sim, best
    return out.masked_fill_(~valid[None, :], float("-inf"))


def exact_rows64(q, qm, tokens, t_mask, valid, k, stored=None):
    """The float64 exact top-k, rounded to f32 once and ordered (score
    desc, row asc) → rows [B, k] (-1 at invalid slots), on the host."""
    import torch

    from trueno_rag_tpu_torch.ops.dense import topk_desc

    s, r = topk_desc(maxsim64(q, qm, tokens, t_mask, valid, stored).float(), k)
    return torch.where(torch.isneginf(s), -1, r).cpu().numpy()


def check_certified(rows, cert, want, label):
    """Every certified query's row set equals the float64 exact set →
    (certified count, how many of them also match in order)."""
    import numpy as np

    cert = np.asarray(cert)
    for i in np.flatnonzero(cert):
        check(set(rows[i].tolist()) == set(want[i].tolist()),
              f"{label}: certified query {i} differs from the float64 exact top-{want.shape[1]} set")
    return int(cert.sum()), int(sum(np.array_equal(rows[i], want[i]) for i in np.flatnonzero(cert)))


def planted_queries(tokens, lq, b, gen, stored=None):
    """``b`` queries at stored chunks: a chunk's first ``lq`` tokens (its
    stored values) plus N(0, 0.1²) noise → q [B, Lq, H] f32."""
    import torch

    n = tokens.shape[0]
    idx = torch.randperm(n, device=DEV, generator=gen)[:b]
    base = stored(idx) if stored is not None else tokens[idx].float()
    return base[:, :lq] + 0.1 * torch.randn(base[:, :lq].shape, device=DEV, generator=gen)


def unit_token_slab(rows: int, lt: int, h: int, gen):
    """``[rows, lt, h]`` f32 seeded unit tokens on the device."""
    import torch

    t = torch.randn((rows, lt, h), device=DEV, generator=gen)
    return t / torch.linalg.vector_norm(t, dim=2, keepdim=True)


def phase_kernels_k6k7(seed: int):
    """K6 and K7 at the JAX package's serving shapes (bench_maxsim_1m,
    bench_maxsim_2m_int8_store): against their plain versions, U sound
    against float64, times and bounds, then the tiers they serve →
    (K6 record, K7 record)."""
    import numpy as np
    import torch

    from trueno_rag_tpu_torch.ops import maxsim as ms
    from trueno_rag_tpu_torch.ops.kernels.maxsim_scan import (
        maxsim_scan16_scores, maxsim_scan16_scores_reference, maxsim_scan_int8_scores,
        maxsim_scan_int8_scores_reference,
    )

    gen = torch.Generator(device=DEV).manual_seed(seed + 15)
    lt, h = MS_LT, MS_H
    src = "trueno_rag_tpu_torch/csrc/maxsim_scan.cu"

    def unit_slab(rows):
        return unit_token_slab(rows, lt, h, gen)

    # -- K6 over the zero-copy bf16 pack: 1M x 32 x 128 unit tokens ---------
    n = MS_N6
    t0 = time.perf_counter()
    tok16 = torch.empty((n, lt, h), dtype=torch.bfloat16, device=DEV)
    for lo in range(0, n, MS_SLAB):
        tok16[lo:lo + MS_SLAB] = unit_slab(min(MS_SLAB, n - lo))
    t_mask = torch.ones((n, lt), dtype=torch.bool, device=DEV)
    valid = torch.ones(n, dtype=torch.bool, device=DEV)
    e_max, n_max = ms.prepare_maxsim_self16(tok16, t_mask)
    torch.cuda.synchronize()
    log(f"kernels-K6: {n} x {lt} x {h} bf16 unit tokens ({tok16.numel() * 2 / 1e9:.2f} GB) and the zero-copy pack "
        f"made on the card in {time.perf_counter() - t0:.1f} s")
    rec6 = None
    for bq, lq in MS_SHAPES:
        q = torch.randn((bq, lq, h), device=DEV, generator=gen)  # the bench's queries
        qm = torch.ones((bq, lq), dtype=torch.bool, device=DEV)
        q16, a_c, c1, q_w = ms._scan16_query_pack(q, qm)
        got = maxsim_scan16_scores(q16, tok16, t_mask, valid)
        torch.cuda.synchronize()
        want = maxsim_scan16_scores_reference(q16, tok16, t_mask, valid)
        check(bool(torch.isfinite(got).all()), f"K6 ({bq}, {lq}): non-finite scores")
        err = (got - want).abs()
        tol = 2 * (h + lq) * 2.0**-23 * c1[:, None] * n_max[None, :]
        check(bool((err <= tol).all()), f"K6 ({bq}, {lq}): differs from its plain version by {err.max().item():.3e} "
                                        f"(2·κ·C1·n_max >= {tol.min().item():.3e})")
        max_err = err.max().item()
        del want, err, tol
        idx = torch.randperm(n, device=DEV, generator=gen)[:MS_SAMPLE]
        u = got[:, idx].double() + ms._scan16_fused_widths(a_c, c1, q_w, e_max[idx], n_max[idx], h, lq).double()
        slack = (u - maxsim64(q, qm, tok16[idx], t_mask[idx], valid[idx])).min().item()
        check(slack >= 0.0, f"K6 ({bq}, {lq}): U below the float64 MaxSim on a sampled chunk ({slack})")
        ms_k = cuda_ms(lambda: maxsim_scan16_scores(q16, tok16, t_mask, valid), 10)
        ms_p = cuda_ms(lambda: maxsim_scan16_scores_reference(q16, tok16, t_mask, valid), 3)
        ms_k2 = cuda_ms(lambda: maxsim_scan16_scores(q16, tok16, t_mask, valid), 10)
        flop = 2.0 * bq * lq * n * lt * h
        bnd = bound(n * lt * h * 2 + n * lt + n + bq * n * 4 + bq * lq * h * 2, flop, BF16_FLOP_PER_S)
        log(f"K6 B={bq} Lq={lq}: kernel {ms_k:.3f} / {ms_k2:.3f} ms, plain {ms_p:.3f} ms (median, CUDA events); bound "
            f"{bnd[0]:.3f} ms ({bnd[1]}); {flop / (min(ms_k, ms_k2) * 1e-3) / 1e12:.1f} TFLOP/s on the tensor cores; "
            f"max |kernel - plain| {max_err:.3e}; "
            f"U - float64 >= {slack:.3e} on {MS_SAMPLE} sampled chunks")
        if rec6 is None:  # the bench's point: B = 8, Lq = 8
            rec6 = {"name": "maxsim_scan16_scores", "route": "cuda", "source": src,
                    "replaces": "trueno_rag_tpu/ops/pallas/maxsim_scan.py:268", "max_abs_err": max_err,
                    "ms": min(ms_k, ms_k2), "plain_ms": ms_p, "bound_ms": bnd[0], "bound_by": bnd[1],
                    "library_ms": None}
        del got, u
        # the tier it serves: random queries, then a batch planted at stored chunks
        qp = planted_queries(tok16, lq, bq, gen)
        for label, qq in (("random", q), ("planted", qp)):
            s, r, cert = ms.maxsim_topk_scan16_fused(qq, qm, tok16, t_mask, tok16, e_max, n_max, valid, MS_K)
            want_r = exact_rows64(qq, qm, tok16, t_mask, valid, MS_K)
            n_cert, n_order = check_certified(r.cpu().numpy(), cert.cpu().numpy(), want_r,
                                              f"maxsim_topk_scan16_fused {label} B={bq} Lq={lq}")
            check(n_cert >= MIN_CERTIFIED * bq, f"maxsim_topk_scan16_fused {label} B={bq} Lq={lq}: "
                                                f"certified {n_cert}/{bq}")
            t_ms = cuda_ms(lambda: ms.maxsim_topk_scan16_fused(qq, qm, tok16, t_mask, tok16, e_max, n_max, valid,
                                                               MS_K), 3)
            log(f"  maxsim_topk_scan16_fused (zero-copy bf16, N={n}) {label} B={bq} Lq={lq}: {t_ms:.3f} ms per batch = "
                f"{bq / t_ms * 1e3:.1f} queries/s (CUDA events); certified {n_cert}/{bq}, every certified set equal "
                f"to the float64 exact top-{MS_K} set ({n_order} in the same order)")
    del tok16, t_mask, valid, e_max, n_max
    torch.cuda.empty_cache()

    # -- K7 over int8 primary storage: 2M x 32 x 128 --------------------------
    n = MS_N7
    t0 = time.perf_counter()
    tok8 = torch.empty((n, lt, h), dtype=torch.int8, device=DEV)
    s_tok = torch.empty((n, lt), dtype=torch.float32, device=DEV)
    n_max = torch.empty(n, dtype=torch.float32, device=DEV)
    t_mask = torch.ones((n, lt), dtype=torch.bool, device=DEV)
    valid = torch.ones(n, dtype=torch.bool, device=DEV)
    for lo in range(0, n, MS_SLAB):
        t8, st, _, nm = ms._int8_slab(unit_slab(min(MS_SLAB, n - lo)), t_mask[lo:lo + MS_SLAB])
        tok8[lo:lo + MS_SLAB], s_tok[lo:lo + MS_SLAB], n_max[lo:lo + MS_SLAB] = t8, st, nm
    torch.cuda.synchronize()
    log(f"kernels-K7: {n} x {lt} x {h} int8 tokens with scales ({(tok8.numel() + s_tok.numel() * 4) / 1e9:.2f} GB, "
        f"no float corpus) made on the card in {time.perf_counter() - t0:.1f} s")

    def stored8(lo, hi=None):  # the dequantized stored values f32(tok8)·s_tok
        sl = lo if hi is None else slice(lo, hi)
        return tok8[sl].float() * s_tok[sl][..., None]

    bq, lq = MS_SHAPES[0]
    q = torch.randn((bq, lq, h), device=DEV, generator=gen)
    qm = torch.ones((bq, lq), dtype=torch.bool, device=DEV)
    _, q8, t_q, _, vsum, qsum_w = ms._int8_query_pack(q, qm)
    got = maxsim_scan_int8_scores(q8, t_q, tok8, s_tok, t_mask, valid)
    torch.cuda.synchronize()
    want = maxsim_scan_int8_scores_reference(q8, t_q, tok8, s_tok, t_mask, valid)
    check(torch.equal(got, want), f"K7: not bit-identical to its plain version (max |diff| "
                                  f"{(got - want).abs().max().item():.3e})")
    idx = torch.randperm(n, device=DEV, generator=gen)[:MS_SAMPLE]
    w = ((vsum + ms._tier_rounding_coeff(lq, h) * qsum_w)[:, None] * n_max[idx][None, :]) * ms._BOUND_SLACK \
        + ms._BOUND_EPS
    slack = (got[:, idx].double() + w.double()
             - maxsim64(q, qm, None, t_mask[idx], valid[idx], lambda a, b: stored8(idx[a:b]))).min().item()
    check(slack >= 0.0, f"K7: U below the float64 MaxSim on a sampled chunk ({slack})")
    del want
    ms_k = cuda_ms(lambda: maxsim_scan_int8_scores(q8, t_q, tok8, s_tok, t_mask, valid), 10)
    ms_p = cuda_ms(lambda: maxsim_scan_int8_scores_reference(q8, t_q, tok8, s_tok, t_mask, valid), 3)
    ms_k2 = cuda_ms(lambda: maxsim_scan_int8_scores(q8, t_q, tok8, s_tok, t_mask, valid), 10)
    ops = 2.0 * bq * lq * n * lt * h
    bnd = bound(n * lt * h + n * lt * 4 + n * lt + n + bq * n * 4 + bq * lq * (h + 4), ops, INT8_OP_PER_S)
    log(f"K7 B={bq} Lq={lq}: kernel {ms_k:.3f} / {ms_k2:.3f} ms, plain {ms_p:.3f} ms (median, CUDA events); bound "
        f"{bnd[0]:.3f} ms ({bnd[1]}); {ops / (min(ms_k, ms_k2) * 1e-3) / 1e12:.1f} TOP/s int8; bit-identical to the "
        f"plain version; U - float64 >= {slack:.3e} on {MS_SAMPLE} sampled chunks")
    rec7 = {"name": "maxsim_scan_int8_scores", "route": "cuda", "source": src,
            "replaces": "trueno_rag_tpu/ops/pallas/maxsim_scan.py:344", "max_abs_err": 0.0,
            "ms": min(ms_k, ms_k2), "plain_ms": ms_p, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}
    del got
    qp = planted_queries(tok8, lq, bq, gen, stored=stored8)
    for label, qq in (("random", q), ("planted", qp)):
        s, r, cert = ms.maxsim_topk_int8_store(qq, qm, tok8, s_tok, t_mask, n_max, valid, MS_K)
        want_r = exact_rows64(qq, qm, None, t_mask, valid, MS_K, stored=stored8)
        n_cert, n_order = check_certified(r.cpu().numpy(), cert.cpu().numpy(), want_r,
                                          f"maxsim_topk_int8_store {label}")
        check(n_cert >= MIN_CERTIFIED * bq, f"maxsim_topk_int8_store {label}: certified {n_cert}/{bq}")
        t_ms = cuda_ms(lambda: ms.maxsim_topk_int8_store(qq, qm, tok8, s_tok, t_mask, n_max, valid, MS_K), 3)
        log(f"  maxsim_topk_int8_store (int8 primary, N={n}) {label} B={bq} Lq={lq}: {t_ms:.3f} ms per batch = "
            f"{bq / t_ms * 1e3:.1f} queries/s (CUDA events); certified {n_cert}/{bq}, every certified set equal to "
            f"the float64 exact top-{MS_K} set ({n_order} in the same order)")
    del tok8, s_tok, n_max, t_mask, valid
    torch.cuda.empty_cache()

    # -- K7 at the late-interaction store's launch shape: 262,144 x 32 x 384, B = 8, Lq = LI_MAX_LEN --
    n, lt_li, h_li = LI_N, LI_MAX_LEN, LI_H
    tok8 = torch.empty((n, lt_li, h_li), dtype=torch.int8, device=DEV)
    s_tok = torch.empty((n, lt_li), dtype=torch.float32, device=DEV)
    t_mask = torch.ones((n, lt_li), dtype=torch.bool, device=DEV)
    valid = torch.ones(n, dtype=torch.bool, device=DEV)
    for lo in range(0, n, MS_SLAB):
        t8, st, _, _ = ms._int8_slab(unit_token_slab(min(MS_SLAB, n - lo), lt_li, h_li, gen), t_mask[lo:lo + MS_SLAB])
        tok8[lo:lo + MS_SLAB], s_tok[lo:lo + MS_SLAB] = t8, st
    # the retriever pads a batch's query tokens to a power of two up to LI_MAX_LEN: 16 for late-interaction's
    # 6-12-word queries (li_kernel_check logs the shape), 32 at most
    for lq in (LI_MAX_LEN, LI_MAX_LEN // 2):
        q = torch.randn((bq, lq, h_li), device=DEV, generator=gen)
        _, q8, t_q, _, _, _ = ms._int8_query_pack(q, torch.ones((bq, lq), dtype=torch.bool, device=DEV))
        got = maxsim_scan_int8_scores(q8, t_q, tok8, s_tok, t_mask, valid)
        torch.cuda.synchronize()
        check(torch.equal(got, maxsim_scan_int8_scores_reference(q8, t_q, tok8, s_tok, t_mask, valid)),
              f"K7 at {n} x {lt_li} x {h_li}, Lq={lq}: not bit-identical to its plain version")
        ms_k = cuda_ms(lambda: maxsim_scan_int8_scores(q8, t_q, tok8, s_tok, t_mask, valid), 10)
        ms_p = cuda_ms(lambda: maxsim_scan_int8_scores_reference(q8, t_q, tok8, s_tok, t_mask, valid), 3)
        ms_k2 = cuda_ms(lambda: maxsim_scan_int8_scores(q8, t_q, tok8, s_tok, t_mask, valid), 10)
        ops = 2.0 * bq * lq * n * lt_li * h_li
        bnd = bound(n * lt_li * h_li + n * lt_li * 4 + n * lt_li + n + bq * n * 4 + bq * lq * (h_li + 4), ops,
                    INT8_OP_PER_S)
        log(f"K7 at the late-interaction store's launch, N={n} Lt={lt_li} H={h_li} B={bq} Lq={lq}: kernel "
            f"{ms_k:.3f} / {ms_k2:.3f} ms, plain {ms_p:.3f} ms (median, CUDA events); bound {bnd[0]:.3f} ms "
            f"({bnd[1]}); {ops / (min(ms_k, ms_k2) * 1e-3) / 1e12:.1f} TOP/s int8; bit-identical to the plain version")
        del got
    del tok8, s_tok, t_mask, valid
    torch.cuda.empty_cache()
    return rec6, rec7


def phase_mma_probe(seed: int):
    """The tensor-core dot's worst-case model (csrc/mma_bf16.cuh) held to
    the card: K6 at Lt = 1, Lq = 1 (each output the raw dot) over crafted
    queries and rows of ``ops.kernels.mma_model`` at every width of
    MMA_PROBE_WIDTHS, each of the 64 x 2048 dots against its float64 exact
    value: the worst ratio of |error| to the model's allowance (fails above
    1), the worst error in ulps of the largest product, and the window the
    alignment keeps (the largest 2^-k of the largest term that still counts
    at H = 16: the smallest k lost, where no k above the largest k kept
    counts); then K1 over the same crafted rows at d = 384 under
    check_sound, on the bf16 replica and the f32 rows (bit-identical), and
    K8 over them (top 2 and 4) under check_block_sound."""
    import numpy as np
    import torch

    from trueno_rag_tpu_torch.ops import dense_tiered as dt
    from trueno_rag_tpu_torch.ops.kernels import mma_model as mm
    from trueno_rag_tpu_torch.ops.kernels.maxsim_scan import maxsim_scan16_scores
    from trueno_rag_tpu_torch.ops.kernels.scan_select import SEL, scan_select_v3
    from trueno_rag_tpu_torch.ops.kernels.scan_select_v1 import scan_select

    worst, worst_ulps, counted, lost = 0.0, 0.0, 0, 99
    for h in MMA_PROBE_WIDTHS:
        qn, tn, kinds = mm.crafted_pairs(h, MMA_PROBE_ROWS, seed + h, n_q=MMA_PROBE_Q)
        q32, t32 = torch.from_numpy(qn).to(DEV), torch.from_numpy(tn).to(DEV)
        n = t32.shape[0]
        got = maxsim_scan16_scores(q32.to(torch.bfloat16)[:, None, :], t32.to(torch.bfloat16)[:, None, :],
                                   torch.ones((n, 1), dtype=torch.bool, device=DEV),
                                   torch.ones(n, dtype=torch.bool, device=DEV))
        q64, t64 = q32.double(), t32.double()
        exact = q64 @ t64.T
        mass = q64.abs() @ t64.abs().T
        big = torch.cat([(q64.abs()[:, None, :] * t64.abs()[None, lo:lo + 1024, :]).amax(dim=2)
                         for lo in range(0, n, 1024)], dim=1)
        err = (got.double() - exact).abs()
        ratio = torch.where(err > 0, err / (mm.allowance(h) * mass), 0.0)
        ulps = torch.where(big > 0, err / torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 24), 0.0)
        w_h, u_h = ratio.max().item(), ulps.max().item()
        check(bool(torch.isfinite(got).all()), f"mma-probe H={h}: non-finite dots")
        check(w_h <= 1.0, f"mma-probe H={h}: a dot's error is {w_h:.3f} x the model's allowance: the tensor-core "
                          f"accumulation model does not hold on this card")
        per_kind = {k: ratio[np.arange(n) % MMA_PROBE_Q, np.arange(n)][torch.from_numpy(kinds == k).to(DEV)].max().item()
                    for k in mm.KINDS}
        if h == 16:  # matched sweep pairs: 1 and fifteen 2^-k of it (times a common power of two and sign)
            idx = np.flatnonzero(kinds == "sweep")
            p = q64[idx % MMA_PROBE_Q] * t64[idx]
            top = p.abs().amax(dim=1)
            k = torch.round(-torch.log2(p.abs().amin(dim=1) / top)).long()
            count = got[idx % MMA_PROBE_Q, idx].double().abs() > top
            if bool(count.any()):
                counted = max(counted, int(k[count].max()))
            if bool((~count).any()):
                lost = min(lost, int(k[~count].min()))
        log(f"mma-probe H={h}: {MMA_PROBE_Q} x {n} crafted dots through K6 (Lt = Lq = 1); worst |error| / "
            f"allowance {w_h:.4f} (allowance {mm.allowance(h) / 2.0**-23:g} x 2^-23 x sum|p|); worst error "
            f"{u_h:.3f} ulps of the largest product; matched pairs by kind: "
            + ", ".join(f"{k} {v:.4f}" for k, v in per_kind.items()))
        worst, worst_ulps = max(worst, w_h), max(worst_ulps, u_h)
        if h == DIM:  # K1 over the same rows, under its certificate
            m = t32
            mb, e, a = dt.prepare_tiered(m)
            qb, u, v = dt._bf16_query_bounds(q32)
            valid = torch.ones(n, dtype=torch.int32, device=DEV)
            vk, rk = scan_select_v3(qb, mb, e, a, valid, u, v, t_top=T_TOP)
            vf, rf = scan_select_v3(qb, m, e, a, valid, u, v, t_top=T_TOP)
            torch.cuda.synchronize()
            check(torch.equal(vk, vf) and torch.equal(rk, rf), "mma-probe K1: the f32 rows differ from the replica")
            slack = check_sound(vk, rk, t64, q64, valid, range(MMA_PROBE_Q), range(n // SEL), "mma-probe K1")
            log(f"mma-probe K1 at d={h}: {MMA_PROBE_Q} crafted queries x {n} crafted rows, every emitted bound at "
                f"least its float64 true score (least slack {slack:.3e}); f32 rows bit-identical to the replica")
            # K8 over the same rows, with each row's own bound: every emitted upper at least its row's float64
            # dot, v_(top+1) at least every row of its block it did not emit (kernels-K8K9's check)
            for top in K8_TOPS:
                out8 = scan_select(qb, mb, e, a, valid, u, v, tile_n=1024, top=top)
                torch.cuda.synchronize()
                slack8 = check_block_sound(out8, top, (t64 @ q64.T).contiguous(),
                                           torch.arange(MMA_PROBE_Q, device=DEV), f"mma-probe K8 top {top}")
                log(f"mma-probe K8 at d={h} (top {top}): {MMA_PROBE_Q} crafted queries x {n} crafted rows, every "
                    f"emitted upper at least its row's float64 dot and v_(top+1) every unemitted row's (least "
                    f"slack {slack8:.3e})")
                del out8
        del got, exact, mass, big, err, ratio, ulps
    window = (f"an apparent window of {lost} bits" if counted < lost
              else "no plain window: fifteen small terms survive together where one alone would not")
    log(f"mma-probe: worst |error| / allowance {worst:.4f} (<= 1: the model holds); worst error {worst_ulps:.3f} "
        f"ulps of the largest product; at H = 16 fifteen terms of 2^-k of the largest still count at k <= {counted} "
        f"and are lost at k >= {lost} ({window})")
    torch.cuda.empty_cache()


def k11_bound(bq: int, lq: int, n: int, lt: int, h: int, tok_rows: int, bias_entries: int):
    """K11's bound: (ms, what bounds it), its work ``2·B·Lq·N·Lt·H`` at the
    bf16 peak, its bytes the tokens, the bias, valid, q and the scores."""
    return bound(tok_rows * h * 2 + bias_entries * 4 + n + bq * n * 4 + bq * lq * h * 2, 2.0 * bq * lq * n * lt * h,
                 BF16_FLOP_PER_S)


def tight_corpus(n: int, lt: int, h: int, gen):
    """The tight law: chunks in clusters of PR_DUP (a templated document's
    near-duplicates) whose tokens lie around the cluster's own m ∈ {1, 2,
    4, 8} unit topics, each topic a contiguous run of Lt/m positions, noise
    of norm ~PR_SIGMA → (tokens [N, Lt, H] f32 unit, topics [N/PR_DUP, 8,
    H], m [N/PR_DUP])."""
    import torch

    n_cl = n // PR_DUP
    topics = unit_token_slab(n_cl, 8, h, gen)
    m = 2 ** torch.randint(0, 4, (n_cl,), device=DEV, generator=gen)
    tokens = torch.empty((n, lt, h), device=DEV)
    pos = torch.arange(lt, device=DEV)
    for lo in range(0, n, MS_SLAB):
        hi = min(n, lo + MS_SLAB)
        cl = torch.arange(lo, hi, device=DEV) // PR_DUP
        which = pos[None, :] * m[cl][:, None] // lt  # [S, Lt]: the run a position lies in
        t = torch.gather(topics[cl], 1, which[:, :, None].expand(hi - lo, lt, h))
        t = t + PR_SIGMA / math.sqrt(h) * torch.randn(t.shape, device=DEV, generator=gen)
        tokens[lo:hi] = t / torch.linalg.vector_norm(t, dim=2, keepdim=True)
    return tokens, topics, m


def phase_kernels_k11(seed: int):
    """K11a ``maxsim_scan16_scores_v2`` over the l-major pack and K11b
    ``maxsim_scan16_scores_self_v2`` over the primary tokens in place, at
    kernels-K6's shapes (1M x 32 x 128 bf16, (B, Lq) = (8, 8), (32, 8),
    (8, 32)): against their plain versions, bit for bit against K6, U sound
    against float64, the tier's certificate equal to K6's; then a ragged
    corpus at three groups; then ``maxsim_topk_pruned`` with
    ``prepare_maxsim_bounds`` on two 1M-chunk corpora; and the slice's
    path with its launches counted → (K11a, K11b records)."""
    import torch

    from trueno_rag_tpu_torch.ops import maxsim as ms
    from trueno_rag_tpu_torch.ops.kernels import maxsim_scan as km

    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(seed + 19)
    lt, h, g = MS_LT, MS_H, K11_GROUP
    src = "trueno_rag_tpu_torch/csrc/maxsim_scan.cu"
    site = "trueno_rag_tpu/ops/pallas/maxsim_scan.py:"

    # -- (a) kernels-K6's corpus: 1M x 32 x 128 bf16 unit tokens --------------
    n = MS_N6
    tok16 = torch.empty((n, lt, h), dtype=torch.bfloat16, device=DEV)
    for lo in range(0, n, MS_SLAB):
        tok16[lo:lo + MS_SLAB] = unit_token_slab(min(MS_SLAB, n - lo), lt, h, gen)
    t_mask = torch.ones((n, lt), dtype=torch.bool, device=DEV)
    valid = torch.ones(n, dtype=torch.bool, device=DEV)
    e_max, n_max = ms.prepare_maxsim_self16(tok16, t_mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bias = ms.prepare_maxsim_bias_l(t_mask, g)
    torch.cuda.synchronize()
    t_bias = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tok_l, bias_l, e2, n2 = ms.prepare_maxsim_scan16_opt(tok16, t_mask, g)
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    lt_p = tok_l.shape[0] // (-(-n // g) * g)
    check(lt_p == lt and not e2.any() and torch.equal(n2, n_max) and torch.equal(bias_l, bias),
          "kernels-K11: the opt pack of a bf16 corpus is not its residual-free replica")
    log(f"kernels-K11: {n} x {lt} x {h} bf16 unit tokens; bias_l {bias.numel() * 4 / 1e9:.3f} GB in {t_bias:.2f} s; "
        f"the l-major pack ({tok_l.numel() * 2 / 1e9:.2f} GB) in {t_pack:.2f} s, "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB above the corpus at its peak (host clock)")
    recs = {}
    for bq, lq in MS_SHAPES:
        q = torch.randn((bq, lq, h), device=DEV, generator=gen)
        qm = torch.ones((bq, lq), dtype=torch.bool, device=DEV)
        q16, a_c, c1, q_w = ms._scan16_query_pack(q, qm)
        k6 = km.maxsim_scan16_scores(q16, tok16, t_mask, valid)
        got = {"K11a": km.maxsim_scan16_scores_v2(q16, tok_l, bias_l, valid, lt_p, g),
               "K11b": km.maxsim_scan16_scores_self_v2(q16, tok16, bias, valid, g)}
        torch.cuda.synchronize()
        tol = 2 * (h + lq) * 2.0**-23 * c1[:, None] * n_max[None, :]
        plain = {"K11a": lambda: km.maxsim_scan16_scores_v2_reference(q16, tok_l, bias_l, valid, lt_p, g),
                 "K11b": lambda: km.maxsim_scan16_scores_self_v2_reference(q16, tok16, bias, valid, g)}
        kern = {"K11a": lambda: km.maxsim_scan16_scores_v2(q16, tok_l, bias_l, valid, lt_p, g),
                "K11b": lambda: km.maxsim_scan16_scores_self_v2(q16, tok16, bias, valid, g)}
        idx = torch.randperm(n, device=DEV, generator=gen)[:MS_SAMPLE]
        f64 = maxsim64(q, qm, tok16[idx], t_mask[idx], valid[idx])
        widths = ms._scan16_fused_widths(a_c, c1, q_w, e_max, n_max, h, lq)
        qv = torch.where(qm[:, :, None], q, 0.0)
        tier6 = ms._select_rescore_certify(qv, qm, tok16, t_mask, k6 + widths, MS_K, min(1024, n))
        k6_ms = cuda_ms(lambda: km.maxsim_scan16_scores(q16, tok16, t_mask, valid), 10)
        for name, s in got.items():
            check(torch.equal(s, k6), f"{name} ({bq}, {lq}): not bit-identical to K6 (max |diff| "
                                      f"{(s - k6).abs().max().item():.3e})")
            err = (s - plain[name]()).abs()
            check(bool((err <= tol).all()), f"{name} ({bq}, {lq}): differs from its plain version by "
                                            f"{err.max().item():.3e} (2·κ·C1·n_max >= {tol.min().item():.3e})")
            max_err = err.max().item()
            del err
            slack = (s[:, idx].double() + widths[:, idx].double() - f64).min().item()
            check(slack >= 0.0, f"{name} ({bq}, {lq}): U below the float64 MaxSim on a sampled chunk ({slack})")
            tier = ms._select_rescore_certify(qv, qm, tok16, t_mask, s + widths, MS_K, min(1024, n))
            check(all(torch.equal(a, b) for a, b in zip(tier, tier6)),
                  f"{name} ({bq}, {lq}): its tier's rows or certificate differ from K6's")
            t_k = cuda_ms(kern[name], 10)
            t_p = cuda_ms(plain[name], 3)
            t_k2 = cuda_ms(kern[name], 10)
            rows = tok_l.shape[0] if name == "K11a" else n * lt
            bnd = k11_bound(bq, lq, n, lt, h, rows, rows)
            flop = 2.0 * bq * lq * n * lt * h
            log(f"{name} B={bq} Lq={lq} group={g}: kernel {t_k:.3f} / {t_k2:.3f} ms, plain {t_p:.3f} ms, K6 in the same "
                f"call {k6_ms:.3f} ms (median, CUDA events); bound {bnd[0]:.3f} ms ({bnd[1]}); "
                f"{flop / (t_k * 1e-3) / 1e12:.1f} TFLOP/s; bit-identical to K6; max |kernel - plain| "
                f"{max_err:.3e}; U - float64 >= {slack:.3e} on {MS_SAMPLE} sampled chunks; tier certified "
                f"{int(tier[2].sum())}/{bq}, rows and certificate equal to K6's tier")
            if name not in recs:  # the bench's point: B = 8, Lq = 8
                recs[name] = {"name": "maxsim_scan16_scores_v2" if name == "K11a" else
                              "maxsim_scan16_scores_self_v2", "route": "cuda", "source": src,
                              "replaces": site + ("512" if name == "K11a" else "564"), "max_abs_err": max_err,
                              "ms": min(t_k, t_k2), "plain_ms": t_p, "bound_ms": bnd[0], "bound_by": bnd[1],
                              "library_ms": None}
        del got, f64, tier6

    # -- the slice's path: each K11 entry point once, the counts set to 0 just
    # before and read just after (the comparisons above are not counted) -------
    bq, lq = MS_SHAPES[0]
    q = torch.randn((bq, lq, h), device=DEV, generator=gen)
    q16 = ms._scan16_query_pack(q, torch.ones((bq, lq), dtype=torch.bool, device=DEV))[0]
    want = km.maxsim_scan16_scores(q16, tok16, t_mask, valid)
    km.maxsim_scan16_scores_v2.launches = km.maxsim_scan16_scores_self_v2.launches = 0
    p_a = km.maxsim_scan16_scores_v2(q16, tok_l, bias_l, valid, lt_p, g)
    p_b = km.maxsim_scan16_scores_self_v2(q16, tok16, bias, valid, g)
    n_a, n_b = km.maxsim_scan16_scores_v2.launches, km.maxsim_scan16_scores_self_v2.launches
    check((n_a, n_b) == (1, 1), f"kernels-K11 path launches: K11a {n_a}, K11b {n_b}")
    check(torch.equal(p_a, want) and torch.equal(p_b, want), "kernels-K11 path: K11a or K11b differs from K6")
    recs["K11a"]["launches"], recs["K11b"]["launches"] = n_a, n_b
    log(f"kernels-K11 path (K11a over the pack, K11b over the primary, B={bq} Lq={lq}): launches K11a {n_a}, "
        f"K11b {n_b}; both equal to K6")
    del tok16, tok_l, bias_l, bias, t_mask, valid, e_max, n_max, e2, n2, p_a, p_b, want
    torch.cuda.empty_cache()

    # -- (b) ragged N, Lt = 30 (the pack pads to 32), an empty and an invalid
    # chunk, at groups 256, 128 and 512 ----------------------------------------
    n, lt_r = K11_RAGGED
    tok16 = torch.empty((n, lt_r, h), dtype=torch.bfloat16, device=DEV)
    for lo in range(0, n, MS_SLAB):
        tok16[lo:lo + MS_SLAB] = unit_token_slab(min(MS_SLAB, n - lo), lt_r, h, gen)
    lens = torch.randint(1, lt_r + 1, (n,), device=DEV, generator=gen)
    lens[5] = 0
    t_mask = torch.arange(lt_r, device=DEV)[None, :] < lens[:, None]
    valid = torch.ones(n, dtype=torch.bool, device=DEV)
    valid[11] = False
    bq, lq = MS_SHAPES[0]
    q = torch.randn((bq, lq, h), device=DEV, generator=gen)
    q16, _, c1, _ = ms._scan16_query_pack(q, torch.ones((bq, lq), dtype=torch.bool, device=DEV))
    k6 = km.maxsim_scan16_scores(q16, tok16, t_mask, valid)
    check(bool((k6[:, 5] == 0).all()) and bool(torch.isneginf(k6[:, 11]).all()),
          "kernels-K11 ragged: K6 scores the empty chunk other than 0 or the invalid one other than -inf")
    n_max = torch.where(t_mask, torch.linalg.vector_norm(tok16.float(), dim=2), 0.0).amax(dim=1)
    tol = 2 * (h + lq) * 2.0**-23 * c1[:, None] * n_max[None, :]
    fin = torch.isfinite(k6)
    for grp in (g,) + K11_GROUPS:
        bias = ms.prepare_maxsim_bias_l(t_mask, grp)
        tok_l, bias_l, _, _ = ms.prepare_maxsim_scan16_opt(tok16, t_mask, grp)
        lt_p = tok_l.shape[0] // (-(-n // grp) * grp)
        for name, s, want in (
                ("K11a", km.maxsim_scan16_scores_v2(q16, tok_l, bias_l, valid, lt_p, grp),
                 lambda: km.maxsim_scan16_scores_v2_reference(q16, tok_l, bias_l, valid, lt_p, grp)),
                ("K11b", km.maxsim_scan16_scores_self_v2(q16, tok16, bias, valid, grp),
                 lambda: km.maxsim_scan16_scores_self_v2_reference(q16, tok16, bias, valid, grp))):
            check(torch.equal(s, k6), f"{name} ragged N={n} Lt={lt_r} group={grp}: not bit-identical to K6")
            w = want()
            check(torch.equal(torch.isneginf(w), torch.isneginf(s)) and bool(((s - w).abs()[fin] <= tol[fin]).all()),
                  f"{name} ragged N={n} Lt={lt_r} group={grp}: differs from its plain version")
            del w
        log(f"K11a/K11b ragged N={n} Lt={lt_r} (pack Lt_p={lt_p}) group={grp}: bit-identical to K6, within "
            f"2·κ·C1·n_max of their plain versions; the empty chunk 0, the invalid chunk -inf")
        del tok_l, bias_l, bias
        torch.cuda.empty_cache()
    del tok16, t_mask, valid, k6, n_max, tol, fin
    torch.cuda.empty_cache()

    # -- (c) the centroid-pruned tier on two 1M x 32 x 128 f32 corpora ---------
    n, lt = PR_N, MS_LT
    bq, lq = MS_SHAPES[0]
    valid = torch.ones(n, dtype=torch.bool, device=DEV)
    for law in ("topic", "tight"):
        t0 = time.perf_counter()
        if law == "topic":  # benches/maxsim_bench.py's gen_tokens: topic + noise, lengths in [Lt/2, Lt]
            topics = unit_token_slab(PR_TOPICS, 1, h, gen)[:, 0]
            tokens = torch.empty((n, lt, h), device=DEV)
            for lo in range(0, n, MS_SLAB):
                rows = min(MS_SLAB, n - lo)
                t = topics[torch.randint(0, PR_TOPICS, (rows, lt), device=DEV, generator=gen)]
                t = t + PR_NOISE * torch.randn(t.shape, device=DEV, generator=gen)
                tokens[lo:lo + rows] = t / torch.linalg.vector_norm(t, dim=2, keepdim=True)
            lens = torch.randint(max(1, lt // 2), lt + 1, (n,), device=DEV, generator=gen)
            t_mask = torch.arange(lt, device=DEV)[None, :] < lens[:, None]
            q = topics[torch.randint(0, PR_TOPICS, (bq, lq), device=DEV, generator=gen)]
            q = q + PR_NOISE * torch.randn(q.shape, device=DEV, generator=gen)
        else:  # queries at B random clusters: their topics in turn, with the same noise
            tokens, topics, m = tight_corpus(n, lt, h, gen)
            t_mask = torch.ones((n, lt), dtype=torch.bool, device=DEV)
            cl = torch.randint(0, n // PR_DUP, (bq,), device=DEV, generator=gen)
            which = torch.arange(lq, device=DEV)[None, :] % m[cl][:, None]
            q = torch.gather(topics[cl], 1, which[:, :, None].expand(bq, lq, h))
            q = q + PR_SIGMA / math.sqrt(h) * torch.randn(q.shape, device=DEV, generator=gen)
            del topics, m
        q = q / torch.linalg.vector_norm(q, dim=2, keepdim=True)
        qm = torch.ones((bq, lq), dtype=torch.bool, device=DEV)
        torch.cuda.synchronize()
        t_make = time.perf_counter() - t0
        t0 = time.perf_counter()
        btok, brad, bmask = ms.prepare_maxsim_bounds(tokens, t_mask)
        torch.cuda.synchronize()
        t_prep = time.perf_counter() - t0
        idx = torch.randperm(n, device=DEV, generator=gen)[:PR_SAMPLE]
        d = torch.linalg.vector_norm(tokens[idx].double()[:, :, None] - btok[idx].double()[:, None], dim=3)
        covered = ((d <= brad[idx].double()[:, None]) & bmask[idx][:, None]).any(dim=2)
        check(bool(covered[t_mask[idx]].all()), f"pruned {law}: a stored token lies outside every radius")
        med_r = brad[bmask].median().item()
        log(f"kernels-K11 pruned ({law} law): {n} x {lt} x {h} f32 tokens made on the card in {t_make:.1f} s; "
            f"prepare_maxsim_bounds (K=8, 8 iterations, k-means f32 + float64 radius pass on the card) "
            f"{t_prep:.1f} s (host clock); every token of {PR_SAMPLE} sampled chunks inside its radius; median "
            f"radius {med_r:.4f}")
        del d, covered
        want = None
        for select in ("exact", "approx"):
            s, r, cert = ms.maxsim_topk_pruned(q, qm, tokens, t_mask, btok, brad, bmask, valid, MS_K, PR_RESCORE,
                                               select=select)
            n_cert, n_order = 0, 0
            if bool(cert.any()):
                if want is None:
                    want = exact_rows64(q, qm, tokens, t_mask, valid, MS_K)
                n_cert, n_order = check_certified(r.cpu().numpy(), cert.cpu().numpy(), want,
                                                  f"maxsim_topk_pruned {law} select={select}")
            t_ms = cuda_ms(lambda: ms.maxsim_topk_pruned(q, qm, tokens, t_mask, btok, brad, bmask, valid, MS_K,
                                                         PR_RESCORE, select=select), 3)
            log(f"  maxsim_topk_pruned ({law} law, N={n}) B={bq} Lq={lq} k={MS_K} rescore={PR_RESCORE} "
                f"select={select}: {t_ms:.3f} ms per batch (CUDA events); certified {n_cert}/{bq}, every certified "
                f"set equal to the float64 exact top-{MS_K} set ({n_order} in the same order)")
            check(law == "topic" or n_cert > 0, f"maxsim_topk_pruned tight law select={select}: no query certified")
        del tokens, t_mask, btok, brad, bmask, q, s, r, cert, want
        torch.cuda.empty_cache()
    log(f"kernels-K11 phase: {time.perf_counter() - t_phase:.1f} s")
    return recs["K11a"], recs["K11b"]


def li_queries(rng, texts, n):
    """``n`` queries, each a span of 6-12 words of an indexed document."""
    out = []
    for i in rng.integers(0, len(texts), size=n):
        words = texts[i].split()
        ln = int(rng.integers(6, 13))
        lo = int(rng.integers(0, len(words) - ln + 1))
        out.append(" ".join(words[lo:lo + ln]))
    return out


def li_drive(retr, batches, k, tag_filter=None):
    """retrieve_batch over ``batches`` with the K6 and K7 counts set to 0
    just before and read just after → (results, ms per batch, K6, K7)."""
    import torch

    from trueno_rag_tpu_torch.ops.kernels.maxsim_scan import maxsim_scan16_scores, maxsim_scan_int8_scores

    maxsim_scan16_scores.launches = maxsim_scan_int8_scores.launches = 0
    res, lat = [], []
    for qs in batches:
        t0 = time.perf_counter()
        res.append(retr.retrieve_batch(qs, k, tag_filter=tag_filter))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return res, lat, maxsim_scan16_scores.launches, maxsim_scan_int8_scores.launches


def li_unit_queries(retr, qs):
    """A batch encoded and L2-normalized as ``TokenVectorStore.search_arrays``
    does → (q [B, Lq, H] f32, q_mask [B, Lq]) on the card."""
    import numpy as np
    import torch

    q, qm = retr._encode(qs)
    norms = np.sqrt(np.einsum("bij,bij->bi", q, q))[:, :, None]
    q = q / np.where(norms > 0.0, norms, 1.0)
    return torch.from_numpy(q).to(DEV), torch.from_numpy(qm).to(DEV)


def li_kernel_check(retr, qs, label):
    """The tiered store's kernel on the store's own replica at one batch's
    shapes, held against its plain version on the same inputs: K6 within
    2·κ·C1·n_max per entry, K7 bit for bit → max |kernel - plain|. Called
    outside ``li_drive``, so these launches are not the path's."""
    import torch

    from trueno_rag_tpu_torch.ops import maxsim as ms
    from trueno_rag_tpu_torch.ops.kernels.maxsim_scan import (
        maxsim_scan16_scores, maxsim_scan16_scores_reference, maxsim_scan_int8_scores,
        maxsim_scan_int8_scores_reference,
    )

    store = retr.store
    _, t_mask, valid = store._device()
    tier = store._device_tier()
    q, qm = li_unit_queries(retr, qs)
    b, lq, h = q.shape
    if tier[0] == "int8":
        _, tok8, s_tok, _, _ = tier
        _, q8, t_q, _, _, _ = ms._int8_query_pack(q, qm)
        got = maxsim_scan_int8_scores(q8, t_q, tok8, s_tok, t_mask, valid)
        torch.cuda.synchronize()
        want = maxsim_scan_int8_scores_reference(q8, t_q, tok8, s_tok, t_mask, valid)
        check(torch.equal(got, want), f"{label}: K7 is not bit-identical to its plain version on the store")
        err, what = 0.0, f"K7 on the store's int8 replica ({tok8.shape[0]} x {tok8.shape[1]} x {h}) bit-identical"
    else:
        _, tok16, _, n_max = tier
        q16, _, c1, _ = ms._scan16_query_pack(q, qm)
        got = maxsim_scan16_scores(q16, tok16, t_mask, valid)
        torch.cuda.synchronize()
        want = maxsim_scan16_scores_reference(q16, tok16, t_mask, valid)
        check(torch.equal(torch.isneginf(got), torch.isneginf(want)), f"{label}: K6 and its plain version "
                                                                        f"disagree on which chunks are invalid")
        fin = torch.isfinite(want)
        diff = torch.where(fin, got - want, 0.0).abs()
        tol = 2 * (h + lq) * 2.0**-23 * c1[:, None] * n_max[None, :]
        check(bool(torch.isfinite(got[fin]).all()) and bool((diff <= tol).all()),
              f"{label}: K6 differs from its plain version on the store by {diff.max().item():.3e}")
        err = diff.max().item()
        what = (f"K6 on the store's {'primary' if tok16 is store._device()[0] else 'bf16 replica'} "
                f"({tok16.shape[0]} x {tok16.shape[1]} x {h}) within 2·κ·C1·n_max of its plain version "
                f"(max |diff| {err:.3e})")
    log(f"{label}: {what} at B={b} Lq={lq}")
    return err


def li_exact_split(retr, qs, label):
    """Where the exact scan's time goes, for one batch: ``maxsim_scan_topk``
    and its f32 scan alone (CUDA events), and the preselection widths it
    tried (its ``blockwise_topk`` calls)."""
    from trueno_rag_tpu_torch.ops import maxsim as ms

    store = retr.store
    tokens, t_mask, valid = store._device()
    q, qm = li_unit_queries(retr, qs)
    block = store.config.scan_block
    widths = []
    topk = ms.blockwise_topk
    ms.blockwise_topk = lambda s, kk, *a: widths.append(kk) or topk(s, kk, *a)
    try:
        t_all = cuda_ms(lambda: ms.maxsim_scan_topk(q, qm, tokens, t_mask, valid, LI_K, block, store._d_norm), 3)
    finally:
        ms.blockwise_topk = topk
    t_scan = cuda_ms(lambda: ms._scan_scores(q, qm, tokens, t_mask, valid, block), 3)
    log(f"{label}: maxsim_scan_topk {t_all:.1f} ms per batch of {q.shape[0]} (CUDA events), of which the f32 scan "
        f"{t_scan:.1f} ms; preselection widths tried {sorted(set(widths))}")


def li_check(retr, batches, results, k, label, allowed=None):
    """Every answer equals the float64 exact top-k of the store's stored
    values (as rows; ``allowed`` joins the valid mask) → the answers as
    row arrays."""
    import numpy as np
    import torch

    store = retr.store
    tokens, t_mask, valid = store._device()
    if allowed is not None:
        valid = valid & torch.from_numpy(allowed).to(DEV)
    rows_all = []
    for qs, res in zip(batches, results):
        q, qm = li_unit_queries(retr, qs)
        want = exact_rows64(q, qm, tokens, t_mask, valid, k)
        got = np.full((len(qs), k), -1, np.int64)
        for i, hits in enumerate(res):
            rows = [store.registry.row_of(h.chunk.id) for h in hits]
            got[i, :len(rows)] = rows
        check(np.array_equal(got, want), f"{label}: an answer differs from the float64 exact top-{k}")
        rows_all.append(got)
    return rows_all


def phase_maxsim_xla(retr, qs, want_rows) -> None:
    """maxsim-xla, on the late-interaction store: one batch through the
    blockwise tiers (the bf16 replica; an int8 replica of the same tokens)
    and the K6/K7 tiers, uncertified queries patched by the exact scan as
    the store patches them: rows and scores equal, rows the float64 exact
    top-k ``want_rows``."""
    import numpy as np
    import torch

    from trueno_rag_tpu_torch.ops import maxsim as ms

    store = retr.store
    tokens, t_mask, valid = store._device()
    tier = store._device_tier()
    check(tier[0] == "bfloat16", f"maxsim-xla: the store's replica is {tier[0]}, expected bfloat16")
    q, qm = li_unit_queries(retr, qs)
    t0 = time.perf_counter()
    pack8 = ms.prepare_maxsim_int8(tokens, t_mask)
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    block, rescore = store.config.scan_block, max(store.config.rescore, LI_K)
    runs = (("scan16 blockwise", ms.maxsim_topk_scan16, tier[1:], {"block": block}),
            ("K6 tier", ms.maxsim_topk_scan16_fused, tier[1:], {}),
            ("int8 blockwise", ms.maxsim_topk_int8, pack8, {"block": block}),
            ("K7 tier", ms.maxsim_topk_int8_fused, pack8, {}))
    out = {}
    for label, fn, pack, kw in runs:
        fn(q, qm, tokens, t_mask, *pack, valid, LI_K, rescore=rescore, **kw)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, r, cert = fn(q, qm, tokens, t_mask, *pack, valid, LI_K, rescore=rescore, **kw)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        miss = torch.nonzero(~cert).flatten()
        if miss.numel():
            s_e, r_e = ms.maxsim_scan_topk(q[miss], qm[miss], tokens, t_mask, valid, LI_K, block, store._d_norm)
            s, r = s.clone(), r.clone()
            s[miss], r[miss] = s_e, r_e
        out[label] = (s.cpu().numpy(), r.cpu().numpy())
        check(np.array_equal(out[label][1], want_rows), f"maxsim-xla {label}: rows differ from the float64 top-k")
        log(f"maxsim-xla {label}: B={q.shape[0]} at {tokens.shape[0]} x {tokens.shape[1]} x {tokens.shape[2]}: "
            f"{dt:.1f} ms (host clock, synchronized); certified {int(cert.sum())}/{q.shape[0]}")
    for a, b in (("scan16 blockwise", "K6 tier"), ("int8 blockwise", "K7 tier")):
        check(np.array_equal(out[a][1], out[b][1]) and np.array_equal(out[a][0], out[b][0]),
              f"maxsim-xla: {a} and {b} answer differently")
    log(f"maxsim-xla: int8 replica packed in {t_pack:.1f} s; both blockwise tiers' rows and scores equal to the "
        f"K6/K7 tiers' on the same store and to the float64 exact top-{LI_K}")
    del pack8


def phase_late_interaction(seed: int):
    """Slice 5's main path: LateInteractionRetriever (MiniLM-L6, seeded
    weights) with the CLI's tiered token store at 262,144 one-chunk
    documents; then the same rows in the bf16-storage (K7), zero-copy bf16
    (K6), token-pruned and exact stores; then the reranker → (K6 launches,
    K7 launches)."""
    import numpy as np
    import torch

    import trueno_rag_tpu_torch as rag
    from trueno_rag_tpu_torch.chunking import Chunk, chunk_id_from_int
    from trueno_rag_tpu_torch.models.encoder import encoder_token_states, pad_batch_pow2
    from trueno_rag_tpu_torch.models.late_interaction import _l2_tokens

    rng = np.random.default_rng(seed + 16)
    t0 = time.perf_counter()
    texts = make_texts(rng, LI_N, LI_WORDS)
    chunks = [Chunk(document_id=f"ldoc{i}", content=t, start_offset=0, end_offset=len(t), id=chunk_id_from_int(i))
              for i, t in enumerate(texts)]
    log(f"late-interaction: {LI_N} one-chunk documents of {LI_WORDS} words made in {time.perf_counter() - t0:.1f} s")
    enc = rag.EncoderConfig.minilm_l6()

    def store_config(**kw):
        return rag.TokenStoreConfig(hidden_dim=enc.hidden_dim, max_tokens=LI_MAX_LEN, initial_capacity=LI_N, **kw)

    retr = rag.LateInteractionRetriever(config=enc, seed=seed, max_len=LI_MAX_LEN, device=DEV,
                                        store_config=store_config(scan="tiered"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    retr.index_batch(chunks, encode_batch=LI_ENCODE_BATCH)
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    check(len(retr) == LI_N, f"late-interaction: {len(retr)} chunks indexed")
    t0 = time.perf_counter()
    retr.ensure_ready()
    torch.cuda.synchronize()
    t_ready = time.perf_counter() - t0
    store = retr.store
    _, e_max, n_max = store._tier[1:]
    nonempty = torch.from_numpy(store._t_mask.any(axis=1) & store._valid).to(DEV)
    check(bool((e_max[nonempty] > 0).all()), "late-interaction: a zero bf16 residual bound (folded round trip?)")
    log(f"late-interaction ingest (MiniLM-L6 token states on the card + host token store): {LI_N} chunks in "
        f"{t_ingest:.1f} s = {LI_N / t_ingest:.0f} chunks/s (host clock); device replica + bf16 pack "
        f"{t_ready:.1f} s; e_max > 0 on all {int(nonempty.sum())} non-empty chunks (min {e_max[nonempty].min().item():.3e}); "
        f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    batches = [li_queries(rng, texts, LI_BATCH) for _ in range(LI_BATCHES)]
    li_kernel_check(retr, batches[0], "late-interaction tiered")
    retr.retrieve_batch(batches[0], LI_K)  # warm-up
    store.uncertified = 0
    res, lat, k6, k7 = li_drive(retr, batches, LI_K)
    check(k6 >= LI_BATCHES and k7 == 0, f"late-interaction tiered: K6 launched {k6} times, K7 {k7}")
    k6_total, k7_total = k6, 0
    rows_main = li_check(retr, batches, res, LI_K, "late-interaction tiered")
    n_q = LI_BATCHES * LI_BATCH
    check(n_q - store.uncertified >= MIN_CERTIFIED * n_q,
          f"late-interaction tiered: certified {n_q - store.uncertified}/{n_q}, below {MIN_CERTIFIED}")
    log(f"late-interaction tiered (f32 storage, K6 on the bf16 replica): {LI_BATCHES} batches of {LI_BATCH}, median "
        f"{sorted(lat)[len(lat) // 2]:.1f} ms per batch = {LI_BATCH * len(lat) / sum(lat) * 1e3:.1f} queries/s "
        f"(retrieve_batch, host clock); certified {n_q - store.uncertified}/{n_q} (at least {MIN_CERTIFIED:.0%} "
        f"required); K6 launches {k6}; every answer equal to the float64 exact top-{LI_K}")

    phase_maxsim_xla(retr, batches[0], rows_main[0])
    gc.collect()
    torch.cuda.empty_cache()

    rows = device_profile(lambda: retr.retrieve_batch(batches[0], LI_K), "late-interaction-262k profile (one batch)")
    busy = sum(r[0] for r in rows)
    k6_ms = sum(r[0] for r in rows if "maxsim_scan" in r[2])
    check(busy > 0, "late-interaction-262k: the trace shows no device time")
    log(f"late-interaction-262k: K6 {k6_ms:.1f} ms of {busy:.1f} ms device time per batch = {k6_ms / busy:.1%}")

    # a tag-filtered batch: one of 4 tags per chunk, by row
    reg = store.registry
    for row in range(LI_N):
        reg.set_tags(chunk_id_from_int(row), [f"t{row % 4}"])
    allowed = (np.arange(store._host.shape[0]) % 4) == 1
    res_t, lat_t, k6, _ = li_drive(retr, batches[:1], LI_K, tag_filter=rag.TagFilter(all=("t1",)))
    k6_total += k6
    li_check(retr, batches[:1], res_t, LI_K, "late-interaction tagged", allowed=allowed)
    check(all(reg.row_of(h.chunk.id) % 4 == 1 for q in res_t[0] for h in q), "late-interaction tagged: a row fails")
    log(f"late-interaction tag batch all=[t1]: {lat_t[0]:.1f} ms (host clock); K6 launches {k6}; every chunk passes, "
        f"answers equal the filtered float64 exact top-{LI_K}")

    # the same rows in sibling stores, through load_rows (no re-encoding)
    siblings = [
        ("bf16 storage, scan_dtype auto (int8, K7)", dict(scan="tiered", storage_dtype="bfloat16")),
        ("bf16 storage, scan_dtype bfloat16 (zero-copy K6)",
         dict(scan="tiered", storage_dtype="bfloat16", scan_dtype="bfloat16")),
        ("scan token", dict(scan="token")),
        ("scan exact", dict(scan="exact")),
    ]
    for name, kw in siblings:
        sib = rag.LateInteractionRetriever(config=enc, params=retr.params, max_len=LI_MAX_LEN, device=DEV,
                                           store_config=store_config(**kw))
        t0 = time.perf_counter()
        sib.store.load_rows(chunks, store._host[:LI_N], store._t_mask[:LI_N])
        sib.ensure_ready()
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        if kw["scan"] == "tiered":
            li_kernel_check(sib, batches[0], f"late-interaction {name}")
        qb = batches[:1] if kw["scan"] == "token" else batches
        sib.retrieve_batch(qb[0], LI_K)  # warm-up
        sib.store.uncertified = 0
        torch.cuda.reset_peak_memory_stats()
        res_s, lat_s, k6, k7 = li_drive(sib, qb, LI_K)
        peak = torch.cuda.max_memory_allocated() / 2**30
        rows = li_check(sib, qb, res_s, LI_K, f"late-interaction {name}")
        if kw.get("storage_dtype") != "bfloat16":  # the same stored values as the main store
            check(all(np.array_equal(a, b) for a, b in zip(rows, rows_main)),
                  f"late-interaction {name}: rows differ from the tiered store")
        if "K7" in name:
            check(k7 >= len(qb) and k6 == 0, f"late-interaction {name}: K7 launched {k7} times, K6 {k6}")
        if "K6" in name:
            check(k6 >= len(qb) and k7 == 0, f"late-interaction {name}: K6 launched {k6} times, K7 {k7}")
        k6_total, k7_total = k6_total + k6, k7_total + k7
        n_q = len(qb) * LI_BATCH
        if kw["scan"] == "tiered":
            check(n_q - sib.store.uncertified >= MIN_CERTIFIED * n_q,
                  f"late-interaction {name}: certified {n_q - sib.store.uncertified}/{n_q}, below {MIN_CERTIFIED}")
        cert = "" if kw["scan"] == "exact" else f"certified {n_q - sib.store.uncertified}/{n_q}; "
        log(f"late-interaction {name}: load_rows + device build {t_load:.1f} s; {len(qb)} batch(es) of {LI_BATCH}, "
            f"median {sorted(lat_s)[len(lat_s) // 2]:.1f} ms per batch (host clock); {cert}launches K6 {k6}, K7 {k7}; "
            f"peak allocated {peak:.2f} GiB in the queries; every answer equal to the float64 exact top-{LI_K}"
            f"{'' if kw.get('storage_dtype') == 'bfloat16' else ' and to the tiered store row for row'}")
        if kw["scan"] == "exact":
            li_exact_split(sib, qb[0], f"late-interaction {name}")
        del sib
        gc.collect()
        torch.cuda.empty_cache()

    # late-interaction-rerank: the MiniLM-L6 trunk reranks 32 queries x 50 candidates
    rr = rag.LateInteractionReranker(config=enc, params=retr.params, max_len=LI_MAX_LEN, device=DEV)
    qs = [q for b in batches for q in b][:RR_QUERIES]
    cands = retr.retrieve_batch(qs, RR_CANDIDATES)
    rr.rerank(qs[0], cands[0], K)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reranked = [rr.rerank(q, c, K) for q, c in zip(qs, cands)]
    torch.cuda.synchronize()
    t_rr = time.perf_counter() - t0
    worst = 0.0
    for i in range(0, RR_QUERIES, RR_QUERIES // 4):  # a sample, against float64
        contents = [c.chunk.content for c in cands[i]]
        got = rr.score_batch(qs[i], contents)
        ids_q = torch.from_numpy(rr.tokenizer.encode_batch([qs[i]])).to(DEV)
        ids_d = torch.from_numpy(pad_batch_pow2(rr.tokenizer.encode_batch(contents))).to(DEV)
        qt, qmk = encoder_token_states(rr.params, ids_q, enc)
        dt, dmk = encoder_token_states(rr.params, ids_d, enc)
        qt, dt = _l2_tokens(qt[0]).double(), _l2_tokens(dt[: len(contents)]).double()
        sim = torch.einsum("qh,kth->kqt", qt, dt).masked_fill(~dmk[: len(contents), None, :], float("-inf"))
        best = sim.amax(dim=2)
        want = torch.where(qmk[0][None, :] & torch.isfinite(best), best, 0.0).sum(dim=1).cpu().numpy()
        worst = max(worst, float(np.abs(got - want).max()))
        order = [r.chunk.id for r in reranked[i]]
        check(order == [cands[i][j].chunk.id for j in np.lexsort((np.arange(len(want)), -got))[:K]],
              "late-interaction-rerank: order differs from the scores")
    check(worst <= 1e-4, f"late-interaction-rerank: scores differ from float64 by {worst:.3e}")
    log(f"late-interaction-rerank (MiniLM-L6 trunk): {RR_QUERIES} queries x {RR_CANDIDATES} candidates in "
        f"{t_rr * 1e3:.1f} ms = {RR_QUERIES * RR_CANDIDATES / t_rr:.0f} pairs/s (host clock); scores within "
        f"{worst:.1e} of float64 MaxSim on a sample")
    log(f"late-interaction path (retrieve_batch calls only): launches K6 {k6_total}, K7 {k7_total}")
    check(k6_total > 0 and k7_total > 0, "the late-interaction path missed a kernel")
    return k6_total, k7_total


# -- slice 6: the block kernels, the fp32 block-max kernels, the block and
# bf16-storage stores, odd widths ---------------------------------------------


def check_block_sound(out, top, true, qs, name):
    """Every emitted value bounds the float64 true score of its row, and
    v_{top+1} every row of its block it did not emit (queries ``qs``;
    ``true`` [N, len(qs)] with -inf on invalid rows) → the least slack."""
    import torch

    from trueno_rag_tpu_torch.ops.kernels.scan_select_v1 import BLOCK

    tb = true.view(-1, BLOCK, true.shape[1])  # [G, 128, Q]
    vals = torch.stack([out[t][qs].T for t in range(top + 1)]).double()  # [top+1, G, Q]
    seen = torch.zeros(tb.shape, dtype=torch.bool, device=DEV)
    worst = float("inf")
    for t in range(top):
        lanes = out[top + 1 + t][qs].T.long()[:, None, :]  # [G, 1, Q]
        emitted = torch.gather(tb, 1, lanes)[:, 0, :]
        live = ~torch.isneginf(emitted)
        slack = (vals[t] - emitted)[live]
        check(bool((slack >= 0).all()), f"{name}: an emitted value is below its row's true score")
        worst = min(worst, slack.min().item())
        seen.scatter_(1, lanes, True)
    rest = torch.where(seen, float("-inf"), tb).amax(dim=1)
    live = ~torch.isneginf(rest)
    slack = (vals[top] - rest)[live]
    check(bool((slack >= 0).all()), f"{name}: v_(top+1) is below an unemitted row's true score")
    return min(worst, slack.min().item())


def compare_k8(got, want, top, upper64, label):
    """K8 against its plain version: -inf slots equal, values within V_TOL,
    lanes equal on >= ROW_AGREE of the slots and every difference at a
    near-tie of the two summation orders (``upper64(rows, queries)``: the
    float64 upper bound of those rows) → max |dv|."""
    import torch

    from trueno_rag_tpu_torch.ops.kernels.scan_select_v1 import BLOCK

    max_err = 0.0
    for t in range(top + 1):
        inf_k, inf_r = torch.isneginf(got[t]), torch.isneginf(want[t])
        check(torch.equal(inf_k, inf_r), f"{label}: -inf slots differ at v{t + 1}")
        check(bool(torch.isfinite(got[t][~inf_k]).all()), f"{label}: non-finite kernel values")
        max_err = max(max_err, (got[t][~inf_k] - want[t][~inf_r]).abs().max().item())
    check(max_err <= V_TOL, f"{label}: values differ by {max_err}")
    lk, lr = torch.stack(got[top + 1:]), torch.stack(want[top + 1:])  # [top, B, G]
    diff = lk != lr
    agree = 1.0 - diff.float().mean().item()
    _, bi, gi = torch.nonzero(diff, as_tuple=True)
    gap = 0.0
    if bi.numel():
        gap = (upper64(gi * BLOCK + lk[diff].long(), bi) - upper64(gi * BLOCK + lr[diff].long(), bi)).abs().max().item()
    log(f"{label}: values max |diff| {max_err:.3e} (tolerance {V_TOL}); lanes agree {agree:.6f} "
        f"({int(diff.sum())} differ, max |dv| {gap:.3e})")
    check(agree >= ROW_AGREE, f"{label}: lane agreement {agree} < {ROW_AGREE}")
    check(gap <= V_TOL, f"{label}: a differing lane is not a near-tie (|dv| = {gap})")
    return max_err


def phase_kernels_k8k9(seed: int):
    """K8 scan_select and K9 scan_select_int8 at the slice's shapes (N =
    1,048,576 unit rows, d = 384, B = 256, top 2 and 4) against their plain
    versions, their bounds against float64 and times → (K8, K9 records)."""
    import torch

    from trueno_rag_tpu_torch.ops import dense_tiered as dt
    from trueno_rag_tpu_torch.ops.kernels.scan_select_v1 import (
        BLOCK, scan_select, scan_select_int8, scan_select_int8_reference, scan_select_reference,
    )

    gen = torch.Generator(device=DEV).manual_seed(seed + 21)
    m = unit_rows(N_ROWS, gen)
    q = unit_rows(BATCH, gen)
    valid = torch.ones(N_ROWS, dtype=torch.int32, device=DEV)
    valid[1000:1040] = 0  # a partly masked block
    valid[5 * BLOCK:6 * BLOCK] = 0  # a fully masked block
    g = N_ROWS // BLOCK
    qs = torch.randperm(BATCH, device=DEV, generator=gen)[:16]
    true = torch.where(valid[:, None] != 0, m.double() @ q[qs].double().T, float("-inf"))  # [N, 16]

    mb, e_l2, a_l2 = dt.prepare_tiered(m)
    qb, u_q, v_q = dt._bf16_query_bounds(q)
    args8 = (qb, mb, e_l2, a_l2, valid, u_q, v_q)

    def upper64(rows, bidx):
        s = (mb[rows].double() * qb[bidx].double()).sum(dim=-1)
        return s + e_l2[rows].double() * u_q[bidx].double() + a_l2[rows].double() * v_q[bidx].double()

    m_i8, s_row, i8_e, i8_a = dt.prepare_int8(m)
    q_i8, t_q, u8, v8 = dt._int8_query_bounds(q)
    args9 = (q_i8, m_i8, s_row, i8_e, i8_a, valid, t_q, u8, v8)
    k8_err = k9_err = 0.0
    for top in K8_TOPS:
        got = scan_select(*args8, tile_n=1024, top=top)
        torch.cuda.synchronize()
        check(len(got) == 2 * top + 1 and tuple(got[0].shape) == (BATCH, g), "K8 output shapes")
        want = scan_select_reference(*args8, tile_n=1024, top=top)
        k8_err = max(k8_err, compare_k8(got, want, top, upper64, f"K8 vs plain (top {top})"))
        worst = check_block_sound(got, top, true, qs, f"K8 top {top}")
        log(f"K8 soundness (top {top}): 16 queries x {g} blocks bounded, least slack {worst:.3e}")
        del got, want
        got = scan_select_int8(*args9, tile_n=1024, top=top)
        torch.cuda.synchronize()
        want = scan_select_int8_reference(*args9, tile_n=1024, top=top)
        for t, (a, b) in enumerate(zip(got, want)):
            if t <= top:
                k9_err = max(k9_err, (a - b).abs().nan_to_num(0.0).max().item())  # -inf - -inf is nan
            check(torch.equal(a, b), f"K9 (top {top}) output {t} differs from the plain version")
        log(f"K9 vs plain (top {top}): values and lanes bit-identical ({sum(x.numel() for x in got)} entries)")
        worst = check_block_sound(got, top, true, qs, f"K9 top {top}")
        log(f"K9 soundness (top {top}): 16 queries x {g} blocks bounded, least slack {worst:.3e}")
        del got, want
    del true
    tie = int8_tie_inputs(TIE_N, BATCH, gen)
    for top in K8_TOPS:
        got = scan_select_int8(*tie, tile_n=1024, top=top)
        want = scan_select_int8_reference(*tie, tile_n=1024, top=top)
        check(all(torch.equal(a, b) for a, b in zip(got, want)), f"K9 (top {top}) on the planted ties differs from plain")
        # block 0, query 0: lanes 100 then 9 (equal values: the larger lane first), the next value row 5's
        check([got[top + 1 + t][0, 0].item() for t in range(2)] == [100, 9], f"K9 (top {top}): planted tie lanes")
        check(got[0][0, 0].item() == got[1][0, 0].item() == got[2][0, 0].item(), f"K9 (top {top}): planted tie values")
        check(all(bool((x[:, 2] == BLOCK - 1).all()) for x in got[top + 1:]), f"K9 (top {top}): masked block lanes")
        check(all(bool(torch.isneginf(x[:, 2]).all()) for x in got[:top + 1]), f"K9 (top {top}): masked block values")
    log(f"K9 planted ties ({TIE_N} exact int8 rows, B={BATCH}, top {K8_TOPS}): bit-identical to plain; lanes 100, 9 "
        f"at equal values; the masked block emits lane 127 and -inf")
    del tie, got, want

    top = K8_TOPS[0]  # the store's scan_block_top
    k8_ms = cuda_ms(lambda: scan_select(*args8, tile_n=1024, top=top), 20)
    k8_plain = cuda_ms(lambda: scan_select_reference(*args8, tile_n=1024, top=top), 3)
    k8_ms2 = cuda_ms(lambda: scan_select(*args8, tile_n=1024, top=top), 20)
    k9_ms = cuda_ms(lambda: scan_select_int8(*args9, tile_n=1024, top=top), 20)
    k9_plain = cuda_ms(lambda: scan_select_int8_reference(*args9, tile_n=1024, top=top), 3)
    k9_ms2 = cuda_ms(lambda: scan_select_int8(*args9, tile_n=1024, top=top), 20)
    k8_top4 = cuda_ms(lambda: scan_select(*args8, tile_n=1024, top=4), 10)
    k9_top4 = cuda_ms(lambda: scan_select_int8(*args9, tile_n=1024, top=4), 10)
    flop = 2.0 * BATCH * N_ROWS * DIM
    out_bytes = BATCH * (2 * top + 1) * g * 4
    k8_bound = bound(BATCH * DIM * 2 + N_ROWS * DIM * 2 + N_ROWS * 12 + BATCH * 8 + out_bytes, flop,
                     BF16_FLOP_PER_S)
    k9_bound = bound(BATCH * DIM + N_ROWS * DIM + N_ROWS * 16 + BATCH * 12 + out_bytes, flop, INT8_OP_PER_S)
    log(f"K8 scan_select at N={N_ROWS} d={DIM} B={BATCH} top {top}: kernel {k8_ms:.3f} / {k8_ms2:.3f} ms, "
        f"plain {k8_plain:.3f} ms (median, CUDA events); top 4 {k8_top4:.3f} ms; bound {k8_bound[0]:.3f} ms "
        f"({k8_bound[1]}); rate {flop / (min(k8_ms, k8_ms2) * 1e-3) / 1e12:.1f} TFLOP/s on the tensor cores")
    log(f"K9 scan_select_int8 at N={N_ROWS} d={DIM} B={BATCH} top {top}: kernel {k9_ms:.3f} / {k9_ms2:.3f} ms, "
        f"plain {k9_plain:.3f} ms (median, CUDA events); top 4 {k9_top4:.3f} ms; bound {k9_bound[0]:.3f} ms "
        f"({k9_bound[1]}); rate {flop / (min(k9_ms, k9_ms2) * 1e-3) / 1e12:.1f} TOP/s on the int8 tensor cores")
    del m, mb, m_i8
    torch.cuda.empty_cache()
    src = "trueno_rag_tpu_torch/csrc/scan_select_v1.cu"
    return (
        {"name": "scan_select", "route": "cuda", "source": src,
         "replaces": "trueno_rag_tpu/ops/pallas/scan_select.py:107", "max_abs_err": k8_err,
         "ms": min(k8_ms, k8_ms2), "plain_ms": k8_plain, "bound_ms": k8_bound[0],
         "bound_by": k8_bound[1], "library_ms": None},
        {"name": "scan_select_int8", "route": "cuda", "source": src,
         "replaces": "trueno_rag_tpu/ops/pallas/scan_select_int8.py:107", "max_abs_err": k9_err,
         "ms": min(k9_ms, k9_ms2), "plain_ms": k9_plain, "bound_ms": k9_bound[0],
         "bound_by": k9_bound[1], "library_ms": None},
    )


def phase_kernels_k2(seed: int):
    """K2 score_blockmax and K2b blockmax_only at N = 1,048,576 unit rows,
    d = 384, B = 256 in fp32 against their plain version (torch.matmul, TF32
    off), their top-k functions (the port's pallas_dense_topk and
    pallas_dense_topk_twopass) against dense_topk, times beside torch.matmul
    + amax → (K2, K2b records)."""
    import torch

    from trueno_rag_tpu_torch.ops.dense import dense_topk
    from trueno_rag_tpu_torch.ops.kernels.dense_score import (
        BLOCK, blockmax_only, dense_topk_blockmax, dense_topk_twopass, score_blockmax, score_blockmax_reference,
    )

    gen = torch.Generator(device=DEV).manual_seed(seed + 23)
    m = unit_rows(N_ROWS, gen)
    q = unit_rows(BATCH, gen)
    valid = torch.ones(N_ROWS, dtype=torch.bool, device=DEV)
    valid[1000:1040] = False
    valid[5 * BLOCK:6 * BLOCK] = False
    s, bm = score_blockmax(q, m, valid)
    bm2 = blockmax_only(q, m, valid)
    torch.cuda.synchronize()
    s_r, bm_r = score_blockmax_reference(q, m, valid)
    # two f32 evaluations of the same unit-vector dot: each within
    # (d+1)·2⁻²⁴·Σ|q_i m_i| ≤ (d+1)·2⁻²⁴ of the true value
    tol = 2 * (DIM + 1) * 2.0**-24
    check(torch.equal(torch.isneginf(s), torch.isneginf(s_r)), "K2: -inf entries differ from the plain version")
    fin = torch.isfinite(s_r)
    k2_err = (s[fin] - s_r[fin]).abs().max().item()
    check(k2_err <= tol, f"K2 scores differ from torch.matmul by {k2_err} > {tol}")
    check(torch.equal(bm, s.view(BATCH, -1, BLOCK).amax(dim=2)), "K2's maxima are not the max of its scores")
    check(torch.equal(bm2, bm), "K2b's maxima differ from K2's")
    bm_err = (bm - bm_r).abs().nan_to_num(0.0).max().item()
    log(f"K2 vs plain (torch.matmul, TF32 off): scores max |diff| {k2_err:.3e} (tolerance {tol:.3e}: two f32 "
        f"sums of d = {DIM} products); maxima exactly the max of K2's scores; K2b's maxima equal K2's "
        f"(max |diff| to plain {bm_err:.3e})")
    del s, bm, bm2, s_r, bm_r, fin
    torch.cuda.empty_cache()

    x_s, x_r = dense_topk(q, m, valid, K2_K, "cosine")
    launches = {}
    for fn, counted in ((dense_topk_blockmax, score_blockmax), (dense_topk_twopass, blockmax_only)):
        score_blockmax.launches = blockmax_only.launches = 0
        t_s, t_r = fn(q, m, valid, K2_K, "cosine")
        launches[counted.__name__] = counted.launches
        check(counted.launches > 0, f"{fn.__name__} never launched {counted.__name__}")
        check(torch.equal(t_r, x_r) and torch.equal(t_s, x_s), f"{fn.__name__}: rows or scores differ from dense_topk")
    t_bm = cuda_ms(lambda: dense_topk_blockmax(q, m, valid, K2_K, "cosine"), 3)
    t_tp = cuda_ms(lambda: dense_topk_twopass(q, m, valid, K2_K, "cosine"), 3)
    t_dt = cuda_ms(lambda: dense_topk(q, m, valid, K2_K, "cosine"), 3)
    log(f"top-{K2_K} at N={N_ROWS} B={BATCH}: dense_topk_blockmax {t_bm:.3f} ms, dense_topk_twopass {t_tp:.3f} ms, "
        f"dense_topk {t_dt:.3f} ms (CUDA events); rows and scores identical for all {BATCH} queries")

    k2_ms = cuda_ms(lambda: score_blockmax(q, m, valid), 10)
    k2b_ms = cuda_ms(lambda: blockmax_only(q, m, valid), 10)
    plain = cuda_ms(lambda: score_blockmax_reference(q, m, valid), 5)
    lib = cuda_ms(lambda: torch.matmul(q, m.T).view(BATCH, -1, BLOCK).amax(dim=2), 5)
    k2_ms2 = cuda_ms(lambda: score_blockmax(q, m, valid), 10)
    k2b_ms2 = cuda_ms(lambda: blockmax_only(q, m, valid), 10)
    flop = 2.0 * BATCH * N_ROWS * DIM
    in_bytes = N_ROWS * DIM * 4 + BATCH * DIM * 4 + N_ROWS
    bm_bytes = BATCH * (N_ROWS // BLOCK) * 4
    k2_bound = bound(in_bytes + BATCH * N_ROWS * 4 + bm_bytes, flop, FP32_FLOP_PER_S)
    k2b_bound = bound(in_bytes + bm_bytes, flop, FP32_FLOP_PER_S)
    log(f"K2 score_blockmax at N={N_ROWS} d={DIM} B={BATCH} f32: kernel {k2_ms:.3f} / {k2_ms2:.3f} ms, plain "
        f"{plain:.3f} ms, torch.matmul + amax {lib:.3f} ms (median, CUDA events); bound {k2_bound[0]:.3f} ms "
        f"({k2_bound[1]}); rate {flop / (min(k2_ms, k2_ms2) * 1e-3) / 1e12:.1f} TFLOP/s")
    log(f"K2b blockmax_only: kernel {k2b_ms:.3f} / {k2b_ms2:.3f} ms; bound {k2b_bound[0]:.3f} ms ({k2b_bound[1]}); "
        f"rate {flop / (min(k2b_ms, k2b_ms2) * 1e-3) / 1e12:.1f} TFLOP/s")
    del m, q, valid
    torch.cuda.empty_cache()
    src = "trueno_rag_tpu_torch/csrc/dense_score.cu"
    return (
        {"name": "score_blockmax", "route": "cuda", "source": src,
         "replaces": "trueno_rag_tpu/ops/pallas/dense_score.py:75", "launches": launches["score_blockmax"],
         "max_abs_err": k2_err, "ms": min(k2_ms, k2_ms2), "plain_ms": plain, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": lib},
        {"name": "blockmax_only", "route": "cuda", "source": src,
         "replaces": "trueno_rag_tpu/ops/pallas/dense_score.py:124", "launches": launches["blockmax_only"],
         "max_abs_err": bm_err, "ms": min(k2b_ms, k2b_ms2), "plain_ms": plain, "bound_ms": k2b_bound[0],
         "bound_by": k2b_bound[1], "library_ms": lib},
    )


def check_bf16_storage(store, qv, s_t, r_t, label):
    """The bf16-storage store's dense candidates against the float64 top-k
    over its own bf16-rounded rows: position by position within 1e-6 (the
    store normalizes queries in f32 and rounds each float64 score once),
    so rows may differ only at such near-ties → the share of equal rows."""
    import torch

    m64 = store.device_matrix.double()
    q64 = torch.from_numpy(qv).to(DEV).double()
    q64 = q64 / torch.linalg.vector_norm(q64, dim=1, keepdim=True)
    valid = store.device_valid
    k = r_t.shape[1]
    check(bool((r_t >= 0).all()), f"{label}: a missing row")
    agree, worst = 0, 0.0
    for lo in range(0, q64.shape[0], 32):
        sc = torch.where(valid[None, :], q64[lo:lo + 32] @ m64.T, float("-inf"))  # [32, N]
        top_v, top_i = torch.topk(sc, k, dim=1)  # check-only library call
        got = torch.gather(sc, 1, r_t[lo:lo + 32].long())
        worst = max(worst, (got - top_v).abs().max().item(), (s_t[lo:lo + 32].double() - got).abs().max().item())
        agree += int((r_t[lo:lo + 32].long() == top_i).sum())
    check(worst <= 1e-6, f"{label}: scores differ from the float64 top-k by {worst}")
    del m64
    return agree / r_t.numel()


def phase_block_stores(pipe, seed: int):
    """The slice's main path: ``scan_kernel="block"`` on the bf16, int8 and
    auto tiers and ``storage_dtype="bfloat16"``, each a sibling of the 1M
    pipeline (no second ingest) answering one batch of 256 through
    ``query_with_context_batch(k=5)`` → (K8 launches, K9 launches)."""
    import numpy as np
    import torch

    import trueno_rag_tpu_torch as rag
    from trueno_rag_tpu_torch.ops.dense import dense_topk
    from trueno_rag_tpu_torch.ops.kernels.scan_select_v1 import scan_select, scan_select_int8

    base = pipe.retriever
    bstore = base.vector_store
    cand = base.config.candidates_per_source
    rng = np.random.default_rng(seed + 6)
    qs = query_batches(rng, 1)[0]
    qv = np.asarray(base.embedder.embed_queries(qs), dtype=np.float32)
    x_s, x_r = dense_topk(torch.from_numpy(qv).to(DEV), bstore.device_matrix, bstore.device_valid, cand, "cosine")
    configs = [
        ("bf16 block", dict(scan_tier="bf16", scan_kernel="block"), "bf16"),
        ("int8 block", dict(scan_tier="int8", scan_kernel="block"), "int8"),
        ("auto block", dict(scan_tier="auto", scan_kernel="block"), "bf16"),
        ("bf16 storage", dict(storage_dtype="bfloat16"), "none"),
    ]
    k8_total = k9_total = 0
    for name, kw, tier in configs:
        p = sibling_pipeline(pipe, rag.VectorStoreConfig(**kw))
        store = p.retriever.vector_store
        t0 = time.perf_counter()
        p.retriever.ensure_ready()
        torch.cuda.synchronize()
        log(f"store {name}: device build {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        check(store._effective_tier() == tier, f"store {name}: tier {store._effective_tier()!r}, expected {tier!r}")
        fb0 = store.tier_fallback_queries
        scan_select.launches = scan_select_int8.launches = 0
        t0 = time.perf_counter()
        ctxs = p.query_with_context_batch(qs, k=K)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n8, n9 = scan_select.launches, scan_select_int8.launches
        k8_total, k9_total = k8_total + n8, k9_total + n9
        fell = store.tier_fallback_queries - fb0
        check_contexts(ctxs)
        s_t, r_t = store.search_arrays(qv, cand)
        if tier == "none":
            check(n8 == n9 == 0, f"store {name}: a block kernel launched on tier none")
            check(store.device_matrix.dtype == torch.bfloat16, f"store {name}: the device matrix is not bf16")
            agree = check_bf16_storage(store, qv, s_t, r_t, f"store {name}")
            result = (f"dense candidates equal the float64 top-{cand} of its bf16 rows up to near-ties "
                      f"({agree:.4f} of rows identical)")
        else:
            n_kernel, n_other = (n9, n8) if tier == "int8" else (n8, n9)
            check(n_kernel > 0 and n_other == 0, f"store {name}: launches K8 {n8}, K9 {n9}")
            check(torch.equal(r_t, x_r) and torch.equal(s_t, x_s),
                  f"store {name}: rows or scores differ from the exact fp32 path")
            result = (f"certified {(BATCH - fell) / BATCH:.4f} ({fell} of {BATCH} re-ran on fp32); dense rows and "
                      f"scores identical to the exact fp32 dense_topk")
        s_s, r_s = base.sparse_index.search_arrays(qs, cand)
        check_fused(base.config.fusion, r_t, s_t, r_s, s_s, f"store {name}")
        log(f"store {name}: 1 batch of {BATCH} in {ms:.1f} ms (host clock, query_with_context_batch k={K}) = "
            f"{BATCH / ms * 1e3:.0f} queries/s; launches K8 {n8}, K9 {n9}; {result}; fused lists match the host oracle")
        if name == "bf16 block":
            stage_breakdown(p, qs)
        del p, store, ctxs
        gc.collect()
        torch.cuda.empty_cache()
    log(f"block stores path (query_with_context_batch calls only): launches K8 {k8_total}, K9 {k9_total}")
    check(k8_total > 0 and k9_total > 0, "the block stores path missed a kernel")
    return k8_total, k9_total


def phase_odd_widths(seed: int):
    """d (H) = 100 on the card: K1, K3, K5, K8 and K9 over 65,536 rows and K6,
    K7 over 8,192 chunks x 16 tokens against their plain versions; then one
    bf16-tier batch (K1) and one zero-copy token-store batch (K6) at that
    width → (K1 launches, K6 launches) of the two batches."""
    import numpy as np
    import torch

    import trueno_rag_tpu_torch as rag
    from trueno_rag_tpu_torch.ops import dense_tiered as dt
    from trueno_rag_tpu_torch.ops.dense import dense_topk
    from trueno_rag_tpu_torch.ops.kernels import maxsim_scan as km
    from trueno_rag_tpu_torch.ops.kernels import scan_select as ks
    from trueno_rag_tpu_torch.ops.kernels import scan_select_v1 as k1v

    d = ODD_D
    gen = torch.Generator(device=DEV).manual_seed(seed + 25)
    m = torch.randn((ODD_N, d), device=DEV, generator=gen)
    m /= torch.linalg.vector_norm(m, dim=1, keepdim=True)
    q = torch.randn((BATCH, d), device=DEV, generator=gen)
    q /= torch.linalg.vector_norm(q, dim=1, keepdim=True)
    valid = torch.ones(ODD_N, dtype=torch.int32, device=DEV)
    valid[1000:1040] = 0
    mb, e, a = dt.prepare_tiered(m)
    qb, u, v = dt._bf16_query_bounds(q)
    m_i8, s_row, e8, a8 = dt.prepare_int8(m)
    q_i8, t_q, u8, v8 = dt._int8_query_bounds(q)

    def close(got, want, label):
        vk, vr = got[0], want[0]
        check(torch.equal(torch.isneginf(vk), torch.isneginf(vr)), f"{label}: -inf slots differ")
        fin = torch.isfinite(vr)
        err = (vk[fin] - vr[fin]).abs().max().item()
        agree = 1.0 - (got[1] != want[1]).float().mean().item()
        check(err <= V_TOL and agree >= ROW_AGREE, f"{label}: max |diff| {err}, rows agree {agree}")
        return f"{label} within {err:.1e} (rows agree {agree:.4f})"

    notes = [close(ks.scan_select_v3(qb, mb, e, a, valid, u, v, t_top=T_TOP),
                   ks.scan_select_v3_reference(qb, mb, e, a, valid, u, v, T_TOP), "K1")]
    ids = torch.tensor([0, 3, 7, 15, 16], dtype=torch.int32, device=DEV)
    notes.append(close(ks.scan_select_v3_indirect(qb[:8], mb, e, a, valid, u[:8], v[:8], ids, tile_n=4096, t_top=8),
                       ks.scan_select_v3_indirect_reference(qb[:8], mb, e, a, valid, u[:8], v[:8], ids, 4096, 8),
                       "K5"))
    args3 = (q_i8, m_i8, s_row, e8, a8, valid, t_q, u8, v8)
    got, want = ks.scan_select_int8_v3(*args3, t_top=T_TOP), ks.scan_select_int8_v3_reference(*args3, T_TOP)
    check(all(torch.equal(x, y) for x, y in zip(got, want)), "K3 at d = 100 differs from its plain version")
    got = k1v.scan_select(qb, mb, e, a, valid, u, v, tile_n=1024, top=2)
    want = k1v.scan_select_reference(qb, mb, e, a, valid, u, v, tile_n=1024, top=2)
    notes.append(close((torch.stack(got[:3]), torch.stack(got[3:])), (torch.stack(want[:3]), torch.stack(want[3:])),
                       "K8"))
    got = k1v.scan_select_int8(*args3, tile_n=1024, top=2)
    want = k1v.scan_select_int8_reference(*args3, tile_n=1024, top=2)
    check(all(torch.equal(x, y) for x, y in zip(got, want)), "K9 at d = 100 differs from its plain version")
    tok = torch.randn((ODD_TOK_N, ODD_LT, d), device=DEV, generator=gen)
    tok /= torch.linalg.vector_norm(tok, dim=2, keepdim=True)
    tq = torch.randn((8, 8, d), device=DEV, generator=gen)
    t_mask = torch.rand((ODD_TOK_N, ODD_LT), device=DEV, generator=gen) < 0.8
    tvalid = torch.ones(ODD_TOK_N, dtype=torch.bool, device=DEV)
    tok16, tq16 = tok.to(torch.bfloat16), tq.to(torch.bfloat16)
    got = km.maxsim_scan16_scores(tq16, tok16, t_mask, tvalid)
    want = km.maxsim_scan16_scores_reference(tq16, tok16, t_mask, tvalid)
    k6_err = (got - want).abs().max().item()
    check(k6_err <= V_TOL, f"K6 at H = 100: max |diff| {k6_err}")
    tok8, s_tok, _ = dt._quantize_rows(tok.reshape(-1, d), clip=True)
    tq8, t_qq, _ = dt._quantize_rows(tq.reshape(-1, d), clip=True)
    args7 = (tq8.view(8, 8, d), t_qq.view(8, 8), tok8.view(ODD_TOK_N, ODD_LT, d), s_tok.view(ODD_TOK_N, ODD_LT),
             t_mask, tvalid)
    check(torch.equal(km.maxsim_scan_int8_scores(*args7), km.maxsim_scan_int8_scores_reference(*args7)),
          "K7 at H = 100 differs from its plain version")
    log(f"odd widths (d = H = {d}): {'; '.join(notes)}; K6 within {k6_err:.1e}; K3, K7 and K9 bit-identical")

    # one bf16-tier batch at d = 100 through the store
    host = m.cpu().numpy()
    store = rag.VectorStore(rag.VectorStoreConfig(dimension=d, scan_tier="bf16", initial_capacity=ODD_N), device=DEV)
    store.insert_many([rag.Chunk(document_id="d", content=f"c{i}", start_offset=0, end_offset=2, embedding=host[i],
                                 id=f"r{i}") for i in range(ODD_N)])
    qv = q.cpu().numpy()
    ks.scan_select_v3.launches = 0
    s_t, r_t = store.search_arrays(qv, K)
    k1 = ks.scan_select_v3.launches
    check(k1 > 0, "the d = 100 bf16 store never launched K1")
    x_s, x_r = dense_topk(q, store.device_matrix, store.device_valid, K, "cosine")
    check(torch.equal(r_t, x_r) and torch.equal(s_t, x_s), "the d = 100 bf16 store differs from the exact fp32 path")
    # one token-store batch at H = 100: bf16 storage, read in place by K6
    cfg = dict(hidden_dim=d, max_tokens=ODD_LT, storage_dtype="bfloat16")
    chunks = [rag.Chunk(document_id="d", content=f"c{i}", start_offset=0, end_offset=2, id=rag.chunk_id_from_int(i))
              for i in range(ODD_TOK_N)]
    tstore = rag.TokenVectorStore(rag.TokenStoreConfig(scan="tiered", scan_dtype="bfloat16", **cfg), device=DEV)
    exact = rag.TokenVectorStore(rag.TokenStoreConfig(scan="exact", **cfg), device=DEV)
    toks, tms = tok.cpu().numpy(), t_mask.cpu().numpy()
    tstore.load_rows(chunks, toks, tms)
    exact.load_rows(chunks, toks, tms)
    plant = [11, ODD_TOK_N // 2]
    qt = np.concatenate([toks[plant][:, :8], tq[:6].cpu().numpy()])
    km.maxsim_scan16_scores.launches = 0
    s_k, r_k = tstore.search_arrays(qt, None, 10)
    k6 = km.maxsim_scan16_scores.launches
    check(k6 > 0, "the H = 100 token store never launched K6")
    s_e, r_e = exact.search_arrays(qt, None, 10)
    check(np.array_equal(r_k, r_e) and np.array_equal(s_k, s_e), "the H = 100 token store differs from its exact scan")
    check(r_k[:2, 0].tolist() == plant, "the H = 100 token store missed a planted chunk")
    log(f"odd widths: a bf16-tier batch of {BATCH} at d = {d} equals the exact fp32 path (K1 launches {k1}); a "
        f"zero-copy token-store batch of 8 at H = {d} equals its exact scan (K6 launches {k6})")
    del m, mb, m_i8, tok, tok16, tok8, store, tstore, exact
    torch.cuda.empty_cache()
    return k1, k6


# -- the BM25 segment path past 2^24 rows (slice 7) ------------------------------


def seg_postings(n: int, seed: int):
    """The text law's postings for ``n`` one-chunk documents, made on the
    card slab by slab: DOC_WORDS word ids per document, uniform over VOCAB,
    from a generator seeded per slab; repeated words become tf. Pass 1
    counts each term's documents, pass 2 makes the slabs again and scatters
    them into CSR order (term, then row) → host (indptr int64 [V+1], rows
    int32 [P], tfs f32 [P])."""
    import torch

    def slab(i, lo, hi):
        gen = torch.Generator(device=DEV).manual_seed(seed * 1_000_003 + i)
        ids = torch.randint(0, VOCAB, (hi - lo, DOC_WORDS), device=DEV, generator=gen)
        key = ids * (hi - lo) + torch.arange(hi - lo, device=DEV)[:, None]
        key, tf = torch.unique(key.reshape(-1), sorted=True, return_counts=True)
        return key // (hi - lo), key % (hi - lo), tf

    bounds = [(i, lo, min(lo + SEG_SLAB, n)) for i, lo in enumerate(range(0, n, SEG_SLAB))]
    df = torch.zeros(VOCAB, dtype=torch.int64, device=DEV)
    for i, lo, hi in bounds:
        df += torch.bincount(slab(i, lo, hi)[0], minlength=VOCAB)
    indptr = torch.zeros(VOCAB + 1, dtype=torch.int64, device=DEV)
    indptr[1:] = torch.cumsum(df, 0)
    p = int(indptr[-1])
    rows = torch.empty(p, dtype=torch.int32, device=DEV)
    tfs = torch.empty(p, dtype=torch.float32, device=DEV)
    cursor = indptr[:-1].clone()
    for i, lo, hi in bounds:
        term, local, tf = slab(i, lo, hi)
        cnt = torch.bincount(term, minlength=VOCAB)
        pos = cursor[term] + torch.arange(term.shape[0], device=DEV) - (torch.cumsum(cnt, 0) - cnt)[term]
        rows[pos] = (local + lo).to(torch.int32)
        tfs[pos] = tf.to(torch.float32)
        cursor += cnt
    check(torch.equal(cursor, indptr[1:]), "postings: a term's run was not filled exactly")
    return indptr.cpu().numpy(), rows.cpu().numpy(), tfs.cpu().numpy()


def seg_index(n: int, seed: int):
    """A BM25 index over ``n`` documents of the text law past the block
    threshold, fed the way the native export feeds it
    (``BM25Index._refresh_snapshot``): the index's own packing runs."""
    import numpy as np
    import torch

    from trueno_rag_tpu_torch.index.bm25 import BM25Index

    t0 = time.perf_counter()
    indptr, rows, tfs = seg_postings(n, seed)
    t_post = time.perf_counter() - t0
    idx = BM25Index(device=DEV, use_native=False)
    idx._doc_len = range(n)  # avg_doc_length reads only its length (a dict of n rows: ~2 GB of host memory)
    idx._total_len = DOC_WORDS * n  # every document has DOC_WORDS tokens
    df = np.maximum(np.diff(indptr), 1).astype(np.float64)
    idf = np.log((n - df + 0.5) / (df + 0.5) + 1.0).astype(np.float32)
    doc_len = np.full(n, DOC_WORDS, dtype=np.float32)
    vocab = {f"w{i:05d}": i for i in range(VOCAB)}
    t0 = time.perf_counter()
    idx._finish_snapshot(vocab, indptr, rows, tfs, idf, doc_len, n)
    torch.cuda.synchronize()
    t_snap = time.perf_counter() - t0
    packed = idx._snap["packed"]
    p = len(rows)
    check(idx._snap["blocks"] is None and tuple(packed.shape) == (p + 256, 4), "the snapshot did not take the segments")
    head = torch.from_numpy(rows[:SEG_SLAB]).to(DEV)
    check(torch.equal(packed[:SEG_SLAB, 0].contiguous().view(torch.int32), head)
          and torch.equal(packed[p - SEG_SLAB:p, 1].cpu(), torch.from_numpy(tfs[p - SEG_SLAB:])),
          "packed postings disagree with the CSR arrays")
    log(f"segment index: {n} documents, {p} postings ({p / n:.2f} per document, {p / VOCAB:.0f} per term) made on "
        f"the card in {t_post:.1f} s; snapshot (host pack_postings + upload of {packed.numel() * 4 / 1e9:.2f} GB) "
        f"{t_snap:.1f} s")
    return idx, p


def bm25_near_ties(s_a, r_a, s_b, r_b, mass, label) -> int:
    """Two BM25 top-k answers ``(scores, rows)`` (host arrays) of one batch
    whose candidate tails ran at other panel shapes → the number of queries
    whose rows differ. A run's score is the difference of two f32 prefix
    sums of up to the panel's contribution mass ``mass[i]`` (ROADMAP Queue
    3, "BM25 rounding"), each within a few ulps of it in any scan order:
    scores must agree within BM25_ULPS ulps of the mass, and a row that only
    one answer holds must tie with the last rank within that band."""
    import numpy as np

    n = 0
    for i in range(len(r_a)):
        if np.array_equal(r_a[i], r_b[i]):
            continue
        n += 1
        tol = BM25_ULPS * 2.0**-24 * float(mass[i])
        fin = np.isfinite(s_a[i])
        check(np.array_equal(fin, np.isfinite(s_b[i])), f"{label} query {i}: different hit counts")
        check(bool(np.all(np.abs(s_a[i][fin] - s_b[i][fin]) <= tol)), f"{label} query {i}: scores differ past {tol}")
        score = {**dict(zip(r_a[i].tolist(), s_a[i].tolist())), **dict(zip(r_b[i].tolist(), s_b[i].tolist()))}
        last = max(s_a[i][fin][-1], s_b[i][fin][-1])
        for r in set(r_a[i].tolist()) ^ set(r_b[i].tolist()):
            check(score[r] - last <= tol, f"{label} query {i}: row {r} differs past a near-tie at the last rank")
    return n


def phase_kernels_k12(seed: int):
    """K12a fetch_contribs and K12b fetch_contribs8 at the segment path's
    shape: 17,825,792 documents, B = 256 queries of QUERY_WORDS words, against
    their plain version (bit for bit), times, bound, the tail → (K12a, K12b
    records, the index, the queries)."""
    import numpy as np
    import torch

    from trueno_rag_tpu_torch.ops.bm25 import _candidate_topk, bm25_topk_segments, slab_contribs
    from trueno_rag_tpu_torch.ops.kernels import bm25_fetch as bf

    torch.cuda.reset_peak_memory_stats()
    idx, _ = seg_index(N_SEG, seed)
    rng = np.random.default_rng(seed + 17)
    qs = query_batches(rng, 1)[0]
    t0 = time.perf_counter()
    starts, lens = idx._gather_segments(qs)
    t_gather = (time.perf_counter() - t0) * 1e3
    n_seg = (lens > 0).sum(axis=1)
    log(f"kernels-K12: _gather_segments {t_gather:.1f} ms (host) for {BATCH} queries: {n_seg.mean():.1f} segments "
        f"per query (max {n_seg.max()}), S = {starts.shape[1]}, {starts.size} slots")
    packed, avgdl = idx._snap["packed"], idx._snap["avgdl"]
    st, ln = (torch.from_numpy(x).to(DEV).reshape(-1) for x in (starts, lens))
    n_slots = st.shape[0]
    r_p, c_p = slab_contribs(st, torch.zeros_like(st), ln, packed, avgdl)
    plain_ms = cuda_ms(lambda: slab_contribs(st, torch.zeros_like(st), ln, packed, avgdl), 3)
    rows = torch.empty_like(r_p)
    contribs = torch.empty_like(c_p)
    # bytes the function must move: each live posting once, both outputs, the slot lists
    live = int(lens.sum())
    k12_bound = bound(16 * live + 8 * n_slots * 256 + 8 * n_slots, 12 * live, FP32_FLOP_PER_S)
    recs = {}
    for kern in (bf.fetch_contribs, bf.fetch_contribs8):
        name = kern.__name__
        rows.fill_(0)
        contribs.fill_(-1.0)
        bf._launch(name, st, None, ln, packed, 1, avgdl, 1.2, 0.75, rows, contribs)
        torch.cuda.synchronize()
        check(torch.equal(rows, r_p), f"{name}: rows differ from the plain version")
        check(torch.equal(contribs.view(torch.int32), c_p.view(torch.int32)),
              f"{name}: contributions differ from the plain version")
        err = (contribs - c_p).abs().max().item()
        ms = cuda_ms(lambda: bf._launch(name, st, None, ln, packed, 1, avgdl, 1.2, 0.75, rows, contribs), 10)
        one = cuda_ms(lambda: bf._launch(name, st[:starts.shape[1]], None, ln[:starts.shape[1]], packed, 1, avgdl,
                                         1.2, 0.75, rows, contribs), 10)
        recs[name] = {"name": name, "route": "cuda", "source": "trueno_rag_tpu_torch/csrc/bm25_fetch.cu",
                      "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": k12_bound[0], "bound_by": k12_bound[1], "library_ms": None}
        log(f"{name} (segment plan, {n_slots} slots, {live} live postings): kernel {ms:.3f} ms, one query "
            f"({starts.shape[1]} slots) {one:.4f} ms; plain {plain_ms:.3f} ms (median, CUDA events); bound "
            f"{k12_bound[0]:.3f} ms ({k12_bound[1]}); {16 * live / 1e9:.3f} GB of postings read at "
            f"{(16 * live + 8 * n_slots * 256) / (ms * 1e-3) / 1e12:.2f} TB/s; rows and contributions bit-identical "
            f"to the plain version")
    recs["fetch_contribs"]["replaces"] = "trueno_rag_tpu/ops/pallas/bm25_fetch.py:89"
    recs["fetch_contribs8"]["replaces"] = "trueno_rag_tpu/ops/pallas/bm25_fetch.py:152"
    tail_ms = cuda_ms(lambda: _candidate_topk(r_p.view(BATCH, -1), c_p.view(BATCH, -1), TIER_K), 3)
    mass = c_p.view(BATCH, -1).double().sum(dim=1).cpu().numpy()
    del r_p, c_p, rows, contribs
    torch.cuda.empty_cache()
    sw, rw = bm25_topk_segments(st.view(BATCH, -1), ln.view(BATCH, -1), packed, avgdl, TIER_K)
    sg, rg = idx.search_arrays(qs, TIER_K)
    check(torch.equal(rg, rw) and torch.equal(sg, sw), "search_arrays differs from the plain bm25_topk_segments")
    check(bool((rg[:, 0] >= 0).all()), "a query found no BM25 hit")
    log(f"kernels-K12: tail (row sort, prefix sums, top-{TIER_K} over [{BATCH}, {starts.shape[1] * 256}]) "
        f"{tail_ms:.3f} ms; search_arrays top-{TIER_K} equals the plain bm25_topk_segments row for row and "
        f"score for score; panel mass per query {mass.min():.0f}-{mass.max():.0f}")

    # the aligned plan of the JAX package's bm25_topk_dma, both widths
    t0 = time.perf_counter()
    bids, lo, hi, s_slots, _ = bf.gather_aligned_segments(idx._snap["indptr"], None, idx._snap["vocab"],
                                                          idx._tokenize, qs, packed.shape[0] - 256)
    t_plan = time.perf_counter() - t0
    bids, lo, hi = (torch.from_numpy(x).to(DEV) for x in (bids, lo, hi))
    # K12a runs only here, in the aligned plan of bm25_topk_dma: these
    # launches are not the main path's and stay out of the records
    bf.fetch_contribs.launches = bf.fetch_contribs8.launches = 0
    s_a, r_a = bf.bm25_topk_dma(bids, lo, hi, packed, avgdl, TIER_K, s_slots, wide=False)
    s_b, r_b = bf.bm25_topk_dma(bids, lo, hi, packed, avgdl, TIER_K, s_slots, wide=True)
    check(bf.fetch_contribs.launches == bf.fetch_contribs8.launches == 1, "bm25_topk_dma: not one launch per width")
    check(torch.equal(r_a, r_b) and torch.equal(s_a, s_b), "bm25_topk_dma: the two widths differ")
    near = bm25_near_ties(s_a.cpu().numpy(), r_a.cpu().numpy(), sg.cpu().numpy(), rg.cpu().numpy(), mass,
                          "aligned plan")
    log(f"kernels-K12: bm25_topk_dma over the aligned plan ({s_slots} slots per query, host plan {t_plan:.1f} s): "
        f"one launch of each width, both identical; equal to the segment plan's top-{TIER_K} but for {near} of {BATCH} queries whose "
        f"rows differ at near-ties ({BM25_ULPS} ulps of the panel mass); peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return recs["fetch_contribs"], recs["fetch_contribs8"], idx, qs


def phase_segments_17m(idx, qs, seed: int):
    """The slice's path at 17,825,792 rows, ops level: unit rows x 384 and
    their bf16 replica made on the card beside the segment index; the staged
    query (K1 dense top-50, the index's segment BM25 with K12, RRF 60) at
    B = 256, single queries through the index, and
    hybrid_query_arrays_segments at B = SEG_FUSED_B against the staged path
    on the same queries, and K1 alone timed at the dense stage's call shape
    → (K1, K12a, K12b launches) on this path."""
    import torch

    from trueno_rag_tpu_torch.ops import dense_tiered as dt
    from trueno_rag_tpu_torch.ops.bm25 import slab_contribs
    from trueno_rag_tpu_torch.ops.fusion import fuse_topk
    from trueno_rag_tpu_torch.ops.hybrid import hybrid_query_arrays_segments
    from trueno_rag_tpu_torch.ops.kernels.bm25_fetch import fetch_contribs, fetch_contribs8
    from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_v3

    n = N_SEG
    gen = torch.Generator(device=DEV).manual_seed(seed + 29)
    t0 = time.perf_counter()
    m = unit_rows(n, gen)
    mb = torch.empty(n, DIM, dtype=torch.bfloat16, device=DEV)
    e = torch.empty(n, device=DEV)
    a = torch.empty(n, device=DEV)
    for lo in range(0, n, TIER_SLAB):
        for dest, part in zip((mb, e, a), dt.prepare_tiered(m[lo:lo + TIER_SLAB])):
            dest[lo:lo + part.shape[0]].copy_(part)
    valid = torch.ones(n, dtype=torch.bool, device=DEV)
    q = torch.randn(BATCH, DIM, device=DEV, generator=gen)
    torch.cuda.synchronize()
    log(f"segments-17.8M: {n} x {DIM} unit rows + bf16 replica in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated with the packed postings")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def dense(qt):  # query chunks bound an fp32 re-run's [B, N] scores
        parts = [dt.dense_topk_tiered2_checked(qt[lo:lo + SEG_DENSE_CHUNK], m, mb, e, a, valid, TIER_K)
                 for lo in range(0, qt.shape[0], SEG_DENSE_CHUNK)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]), sum(p[2] for p in parts)

    def staged(qq, qt):
        (d_s, d_r, n_fb), t_d = timed(lambda: dense(qt))
        (s_s, s_r), t_s = timed(lambda: idx.search_arrays(qq, TIER_K))
        (f_r, f_s), t_f = timed(lambda: fuse_topk(d_r, d_s, s_r, s_s, kind="rrf", param=60.0))
        return (f_r, f_s, d_r, d_s, s_r, s_s), n_fb, (t_d, t_s, t_f)

    packed, avgdl = idx._snap["packed"], idx._snap["avgdl"]
    torch.cuda.reset_peak_memory_stats()
    scan_select_v3.launches = fetch_contribs.launches = fetch_contribs8.launches = 0
    for i in range(SEG_RUNS):
        out, n_fb, (t_d, t_s, t_f) = staged(qs, q)
        log(f"segments-17.8M staged batch {i} (B = {BATCH}, host clock, synchronized): dense tier {t_d:.1f} ms "
            f"(K1, {n_fb} fp32 re-runs), BM25 {t_s:.1f} ms (host slot lists + K12 + tail), fusion {t_f:.1f} ms; "
            f"total {t_d + t_s + t_f:.1f} ms = {BATCH / (t_d + t_s + t_f) * 1e3:.0f} queries/s")
    f_r, f_s = out[:2]
    check(bool(torch.isfinite(f_s[:, 0]).all()) and tuple(f_r.shape) == (BATCH, 2 * TIER_K), "malformed fusion")
    singles, near = [], 0
    s_b, r_b = out[5].cpu().numpy(), out[4].cpu().numpy()
    for i, qq in enumerate(qs[:SEG_SINGLES]):
        (one_s, one_r), t1 = timed(lambda: idx.search_arrays([qq], TIER_K))
        singles.append(t1)
        # a one-row cumsum runs as a device-wide scan whose f32 sums may
        # associate differently from call to call: the batch's answer
        # agrees up to near-ties
        st1, ln1 = idx.gather_segment_tensors([qq])
        _, c1 = slab_contribs(st1[0], torch.zeros_like(st1[0]), ln1[0], packed, avgdl)
        near += bm25_near_ties(one_s.cpu().numpy(), one_r.cpu().numpy(), s_b[i:i + 1], r_b[i:i + 1],
                               [float(c1.double().sum())], f"single query {i}")
    b = SEG_FUSED_B
    ref, _, _ = staged(qs[:b], q[:b])
    st, ln = idx.gather_segment_tensors(qs[:b])
    k12_before = fetch_contribs.launches + fetch_contribs8.launches
    hyb, t_h = timed(lambda: hybrid_query_arrays_segments(
        q[:b], m, valid, st, ln, packed, avgdl, cand=TIER_K, fusion_kind="rrf", fusion_param=60.0))
    check(fetch_contribs.launches + fetch_contribs8.launches == k12_before + 1,
          "hybrid_query_arrays_segments: not one K12 launch")
    for name, x, y in zip(("fused rows", "fused scores", "dense rows", "dense scores", "BM25 rows", "BM25 scores"),
                          hyb, ref):
        check(torch.equal(x, y), f"hybrid_query_arrays_segments: {name} differ from the staged path's")
    n1, na, nb = scan_select_v3.launches, fetch_contribs.launches, fetch_contribs8.launches
    peak = torch.cuda.max_memory_allocated()
    check(n1 > 0 and na + nb > 0, f"segments-17.8M launches: K1 {n1}, K12a {na}, K12b {nb}")
    # K1 alone at the call shape of the dense stage: SEG_DENSE_CHUNK queries over every row
    qb, u, v = dt._bf16_query_bounds(q[:SEG_DENSE_CHUNK] / torch.linalg.vector_norm(q[:SEG_DENSE_CHUNK], dim=1,
                                                                                    keepdim=True))
    vi = valid.int()
    k1_ms = cuda_ms(lambda: scan_select_v3(qb, mb, e, a, vi, u, v, t_top=T_TOP), 5)
    b1 = SEG_DENSE_CHUNK
    k1_bound = bound(b1 * DIM * 2 + n * DIM * 2 + n * 12 + b1 * 8 + b1 * (2 * T_TOP + 1) * (n // 1024) * 4,
                     2.0 * b1 * n * DIM, BF16_FLOP_PER_S)
    log(f"segments-17.8M K1 alone at the dense stage's call shape (B = {b1}, N = {n}, d = {DIM}, t_top {T_TOP}): "
        f"{k1_ms:.3f} ms (median of 5, CUDA events); bound {k1_bound[0]:.3f} ms ({k1_bound[1]}); "
        f"{2.0 * b1 * n * DIM / (k1_ms * 1e-3) / 1e12:.1f} TFLOP/s")
    del vi
    log(f"segments-17.8M single queries through search_arrays: {', '.join(f'{t:.1f}' for t in singles)} ms, "
        f"each equal to its batch row ({near} with a near-tie swap); hybrid_query_arrays_segments at B = {b}: {t_h:.1f} ms (host clock; "
        f"dense by the exact fp32 scan, [{b}, {n}] scores), every output identical to the staged path on the same "
        f"queries; launches K1 {n1}, K12a {na}, K12b {nb}; peak allocated {peak / 2**30:.1f} GiB")
    del m, mb, e, a, valid, out, ref, hyb
    gc.collect()
    torch.cuda.empty_cache()
    return n1, na, nb


def phase_segments_store(pipe, seed: int):
    """A code-path check at 1M, not a deployment: hybrid-1M's pipeline with
    ``ops.bm25.MAX_BLOCK_ROWS`` moved below its row count, so its BM25 index
    re-snapshots to the segment layout; query_with_context_batch (auto tier:
    K1 + K12), single queries, a tag-filtered batch and a tier-none sibling
    (hybrid_query_arrays_segments) against the block path on the same
    queries; the threshold and the block table restored afterwards →
    (K1, K12a, K12b launches) on this path."""
    import numpy as np
    import torch

    import trueno_rag_tpu_torch as rag
    from trueno_rag_tpu_torch.ops import bm25 as ops_bm25
    from trueno_rag_tpu_torch.ops.kernels.bm25_fetch import fetch_contribs, fetch_contribs8
    from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_v3

    retr = pipe.retriever
    idx = retr.sparse_index
    cand = retr.config.candidates_per_source
    rng = np.random.default_rng(seed + 31)
    qs = query_batches(rng, 1)[0]
    blk_res = retr.retrieve_batch(qs, 2 * K)
    blk_s, blk_r = (x.cpu().numpy() for x in idx.search_arrays(qs, cand))
    check(idx._snap["blocks"] is not None, "segments-store-1M: the pipeline is not on the block table")
    saved = ops_bm25.MAX_BLOCK_ROWS
    ops_bm25.MAX_BLOCK_ROWS = SEG_STORE_THRESHOLD
    try:
        idx._dirty = True
        t0 = time.perf_counter()
        idx.ensure_ready()
        torch.cuda.synchronize()
        check(idx._snap["blocks"] is None, "segments-store-1M: the moved threshold kept the block table")
        log(f"segments-store-1M: MAX_BLOCK_ROWS moved to {SEG_STORE_THRESHOLD} (a code-path check at "
            f"{retr.registry.capacity_rows} rows); segment snapshot {time.perf_counter() - t0:.1f} s")
        scan_select_v3.launches = fetch_contribs.launches = fetch_contribs8.launches = 0
        t0 = time.perf_counter()
        ctxs = pipe.query_with_context_batch(qs, k=K)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        singles = [pipe.query_with_context(q, k=K) for q in qs[:SEG_SINGLES]]
        tagged = pipe.query_with_context_batch(qs, k=K, tag_filter=rag.TagFilter(all=("t1",)))
        seg_res = retr.retrieve_batch(qs, 2 * K)
        sib = sibling_pipeline(pipe, rag.VectorStoreConfig(scan_tier="none"))
        n_before = fetch_contribs.launches + fetch_contribs8.launches
        t1 = time.perf_counter()
        none_res = sib.retriever.retrieve_batch(qs, 2 * K)
        torch.cuda.synchronize()
        t_none = (time.perf_counter() - t1) * 1e3
        n1, na, nb = scan_select_v3.launches, fetch_contribs.launches, fetch_contribs8.launches
        check(na + nb == n_before + 1, "the tier-none sibling did not answer through one K12 launch")
        check(n1 > 0 and na + nb > 0, f"segments-store-1M launches: K1 {n1}, K12a {na}, K12b {nb}")
        del sib
        gc.collect()
        torch.cuda.empty_cache()
        check_contexts(ctxs)
        check_contexts(singles, n=SEG_SINGLES)
        check_contexts(tagged, lambda row: row % 4 == 1, retr.registry)
        key = [[(r.chunk.id, r.fused_score) for r in q] for q in seg_res]
        check([[(r.chunk.id, r.fused_score) for r in q] for q in none_res] == key,
              "segments-store-1M: the tier-none one dispatch differs from the staged segment path")
        st, ln = idx.gather_segment_tensors(qs)
        _, c = ops_bm25.slab_contribs(st.reshape(-1), torch.zeros_like(st.reshape(-1)), ln.reshape(-1),
                                      idx._snap["packed"], idx._snap["avgdl"])
        mass = c.view(BATCH, -1).double().sum(dim=1).cpu().numpy()
        del c
        seg_s, seg_r = (x.cpu().numpy() for x in idx.search_arrays(qs, cand))
        near = bm25_near_ties(seg_s, seg_r, blk_s, blk_r, mass, "segments-store-1M")
        blk_key = [[(r.chunk.id, r.fused_score) for r in q] for q in blk_res]
        check(all(key[i] == blk_key[i] for i in range(BATCH) if np.array_equal(seg_r[i], blk_r[i])),
              "segments-store-1M: fused lists differ from the block path's where BM25 agrees")
        log(f"segments-store-1M: query_with_context_batch {ms:.1f} ms = {BATCH / ms * 1e3:.0f} queries/s (host clock), "
            f"{SEG_SINGLES} single queries, a tag batch all=[t1]; launches K1 {n1}, K12a {na}, K12b {nb}; BM25 top-{cand} equal "
            f"to the block path's but for {near} of {BATCH} queries whose rows differ at near-ties ({BM25_ULPS} ulps "
            f"of panel masses {mass.min():.0f}-{mass.max():.0f}); fused lists equal where BM25 agrees; tier-none "
            f"hybrid_query_arrays_segments {t_none:.1f} ms, fused lists identical to the staged path's")
    finally:
        ops_bm25.MAX_BLOCK_ROWS = saved
        idx._dirty = True
        idx.ensure_ready()
    check(idx._snap["blocks"] is not None, "segments-store-1M: the block table was not restored")
    return n1, na, nb


def rss_gib() -> float:
    """This process's resident set (VmRSS) in GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def need_disk(path: str, nbytes: float, label: str) -> None:
    """Fail the run when the file system under ``path`` has less than
    ``nbytes`` free (a phase is never shrunk to fit)."""
    import shutil

    free = shutil.disk_usage(path).free
    log(f"{label}: {free / 2**30:.1f} GiB free under {path}, {nbytes / 2**30:.1f} GiB needed")
    check(free >= nbytes, f"{label}: {free / 2**30:.1f} GiB free under {path}, {nbytes / 2**30:.1f} GiB needed")


def context_rows(contexts):
    """Every chunk of every context with its score and citation."""
    return [[(c.chunk_id, c.document_id, c.content, c.score, c.citation_id) for c in ctx.chunks]
            + [(cit.id, cit.chunk_id, cit.snippet) for cit in ctx.citations] for ctx in contexts]


def phase_persist_1m(pipe, batches, seed: int) -> int:
    """persist-1M: hybrid-1M's index through the CLI's large-index writer
    (``save_index_streaming``) and ``load_index`` onto the card
    (``scan_tier="auto"``), then hybrid-1M's batches: every dense
    row and score and every context identical to the in-memory pipeline's
    → K1 launches on the loaded path."""
    import numpy as np

    import os
    import shutil
    import tempfile

    import torch

    import trueno_rag_tpu_torch as rag
    from trueno_rag_tpu_torch import persist
    from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_v3

    retr = pipe.retriever
    store = retr.vector_store
    n = len(retr.registry)
    tmp = tempfile.mkdtemp(prefix="smoke_persist_")
    try:
        # the matrix, the header (~1 KB of chunk text and postings a row),
        # and the atomic writer's temporary file beside a previous artifact
        need_disk(tmp, 2.0 * n * (DIM * 4 + 1024), "persist-1M")
        codec = persist.default_compression()
        path = os.path.join(tmp, "index.trag")
        info = {"type": "mock", "dimension": DIM}
        t0 = time.perf_counter()
        stats = persist.save_index_streaming(path, retr, embedder_info=info, codec=codec)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        log(f"persist-1M save_index_streaming ({codec.value}): {n} chunks in {t_save:.1f} s; {size} bytes "
            f"({stats['matrix_frames']} matrix frames, {stats['matrix_compressed_bytes']} bytes of matrix); "
            f"host RSS {rss_gib():.1f} GiB")
        # (read_index_info is no longer timed here at 1M: a depth cut for the
        # smoke's time, PERF.md §4; the cli phase reads its indexes' headers)
        t0 = time.perf_counter()
        loaded, emb_info = persist.load_index(path, rag.MockEmbedder(DIM), scan_tier="auto", device=DEV)
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded.ensure_ready()
        torch.cuda.synchronize()
        t_ready = time.perf_counter() - t0
        lstore = loaded.vector_store
        check(emb_info == info and len(loaded.registry) == n, "the loaded index")
        check(lstore._effective_tier() == "bf16", f"loaded tier {lstore._effective_tier()!r}, expected 'bf16'")
        check(bool((lstore._host[:n] == store._host[[retr.registry.row_of(c) for c in loaded.registry.ids()]]).all()),
              "a loaded row differs from its saved row")
        log(f"persist-1M load_index {t_load:.1f} s; device build "
            f"(upload, bf16 replica, BM25 block table) {t_ready:.1f} s; host RSS {rss_gib():.1f} GiB")
        lp = rag.RagPipeline(pipe.embedder, pipe.reranker, pipe.chunker, loaded, pipe.assembler)
        lp.query_with_context_batch(batches[0], k=K)  # first-call set-up
        torch.cuda.synchronize()
        scan_select_v3.launches = 0
        lat, got = [], []
        for qs in batches:
            t0 = time.perf_counter()
            got.append(lp.query_with_context_batch(qs, k=K))
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        launches = scan_select_v3.launches
        check(launches > 0, "the loaded index never launched scan_select_v3")
        log(f"persist-1M loaded path: scan_select_v3 launches {launches}; batches "
            f"{', '.join(f'{t * 1e3:.1f}' for t in lat)} ms = {BATCH * len(lat) / sum(lat):.0f} queries/s "
            f"(host clock, query_with_context_batch k={K})")
        cand = retr.config.candidates_per_source
        for i, qs in enumerate(batches):
            check(context_rows(got[i]) == context_rows(pipe.query_with_context_batch(qs, k=K)),
                  f"persist-1M batch {i}: a context differs from the in-memory pipeline's")
            qv = np.asarray(retr.embedder.embed_queries(qs), dtype=np.float32)
            s_a, r_a = store.search_arrays(qv, cand)
            s_b, r_b = lstore.search_arrays(qv, cand)
            check(torch.equal(r_a, r_b) and torch.equal(s_a, s_b),
                  f"persist-1M batch {i}: dense rows or scores differ from the in-memory store's")
        log(f"persist-1M: every dense row and score and every context of {BATCH * len(batches)} queries "
            f"identical to the in-memory pipeline's")
        del lp, loaded, lstore
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_metrics_1m(pipe, seed: int) -> None:
    """metrics-1M: planted queries (8 words of a known chunk, relevant =
    that chunk) through ``retrieve_batch(k=10)``, scored by ``pad_ids`` +
    ``batched_metrics`` on the card and held per query to the host
    ``RetrievalMetrics``."""
    import numpy as np

    import torch

    from trueno_rag_tpu_torch.metrics import AggregatedMetrics, RetrievalMetrics
    from trueno_rag_tpu_torch.ops.metrics import batched_metrics, pad_ids

    rng = np.random.default_rng(seed + 14)
    retr = pipe.retriever
    reg = retr.registry
    rows = rng.choice(reg.capacity_rows, size=METRIC_QUERIES, replace=False)
    queries = [" ".join(rng.choice(reg.chunk_of(int(r)).content.split(), size=8, replace=False)) for r in rows]
    t0 = time.perf_counter()
    res = retr.retrieve_batch(queries, METRIC_K)
    t_retr = time.perf_counter() - t0
    ks = (1, 5, 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ret = pad_ids([[reg.row_of(r.chunk.id) for r in q] for q in res], METRIC_K, device=DEV)
    rel = pad_ids([[int(r)] for r in rows], 1, device=DEV)
    dev = batched_metrics(ret, rel, k_values=ks)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    check(all(v.device == ret.device for v in dev.values()), "batched_metrics left the card")
    dev = {k: v.cpu().numpy() for k, v in dev.items()}
    host = [RetrievalMetrics.compute([r.chunk.id for r in q], [reg.id_of(int(row))], ks)
            for q, row in zip(res, rows)]
    worst = 0.0
    for i, m in enumerate(host):
        pairs = [(m.mrr, dev["mrr"][i]), (m.map, dev["map"][i])]
        for k in ks:
            pairs += [(m.recall[k], dev[f"recall@{k}"][i]), (m.precision[k], dev[f"precision@{k}"][i]),
                      (m.ndcg[k], dev[f"ndcg@{k}"][i])]
        worst = max(worst, max(abs(a - float(b)) for a, b in pairs))
    check(worst <= 1e-6, f"batched_metrics differs from RetrievalMetrics by {worst:.2e}")
    agg = AggregatedMetrics.aggregate(host)
    log(f"metrics-1M: {METRIC_QUERIES} planted queries, retrieve_batch(k={METRIC_K}) {t_retr * 1e3:.1f} ms, "
        f"pad_ids + batched_metrics on the card {t_dev * 1e3:.1f} ms; max |device - host| {worst:.2e}; "
        f"recall@5 {agg.mean_recall[5]:.4f}, MRR {agg.mean_mrr:.4f}, NDCG@10 {agg.mean_ndcg[10]:.4f} "
        f"(recorded, not gated: the embedder is the hash mock)")


def run_cli(argv):
    """``cli.main(argv)`` in this process → (exit code, standard output)."""
    import contextlib
    import io

    from trueno_rag_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


CLI_FIELDS = ("title", "content", "score", "dense_score", "sparse_score", "fused_score")


def cli_rows(results):
    """Retrieval results as the CLI's JSON fields."""
    return [{"title": r.chunk.metadata.title, "content": r.chunk.content, "score": r.best_score(),
             "dense_score": r.dense_score, "sparse_score": r.sparse_score, "fused_score": r.fused_score}
            for r in results]


def json_rows(rows):
    """The CLI's JSON results, the fields :func:`cli_rows` gives."""
    return [{k: r[k] for k in CLI_FIELDS} for r in rows]


def phase_cli(seed: int):
    """cli: CLI_DOCS .md files of hybrid-1M's text law (a quarter in each
    of three tag folders) through ``cli.main`` in this process: ``index
    --embedder semantic --model mini-lm`` and ``query --scan-tier bf16``
    (K1; also ``--filter-any``) against an in-memory pipeline of the same
    files and embedder; ``index --multi-vector`` and ``query`` (K6) against
    an in-memory ``LateInteractionRetriever``; ``info`` and ``demo`` →
    (K1 launches, K6 launches) of the CLI's queries."""
    import numpy as np

    import argparse
    import json
    import os
    import shutil
    import tempfile

    import trueno_rag_tpu_torch as rag
    from trueno_rag_tpu_torch import cli
    from trueno_rag_tpu_torch.models.encoder import EncoderConfig, EncoderEmbedder
    from trueno_rag_tpu_torch.ops.kernels.maxsim_scan import maxsim_scan16_scores
    from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_v3

    rng = np.random.default_rng(seed + 15)
    texts = make_texts(rng, CLI_DOCS, DOC_WORDS)
    tmp = tempfile.mkdtemp(prefix="smoke_cli_")
    try:
        need_disk(tmp, 1 << 30, "cli")
        docs_dir = os.path.join(tmp, "docs")
        folders = ["", "tag_a", "tag_b", "tag_c"]
        for sub in folders:
            os.makedirs(os.path.join(docs_dir, sub), exist_ok=True)
        for i, t in enumerate(texts):
            with open(os.path.join(docs_dir, folders[i % 4], f"doc{i:05d}.md"), "w") as f:
                f.write(t)
        queries = [" ".join(rng.choice(texts[j].split(), size=QUERY_WORDS, replace=False))
                   for j in rng.choice(CLI_DOCS, size=CLI_QUERIES, replace=False)]
        hybrid_dir, mv_dir = os.path.join(tmp, "hybrid"), os.path.join(tmp, "mv")

        t0 = time.perf_counter()
        rc, out = run_cli(["index", "--path", docs_dir, "--output", hybrid_dir, "--embedder", "semantic",
                           "--model", "mini-lm", "--tag-by-dir"])
        check(rc == 0, f"cli index exit {rc}")
        log(f"cli index --embedder semantic --model mini-lm: {out.strip()} ({time.perf_counter() - t0:.1f} s)")
        scan_select_v3.launches = 0
        t0 = time.perf_counter()
        plain = [json.loads(run_cli(["query", q, "--index", hybrid_dir, "--scan-tier", "bf16", "--format",
                                     "json"])[1]) for q in queries]
        filtered = [json.loads(run_cli(["query", q, "--index", hybrid_dir, "--scan-tier", "bf16", "--format",
                                        "json", "--filter-any", "dir:tag_a,dir:tag_b"])[1]) for q in queries]
        t_query = time.perf_counter() - t0
        k1 = scan_select_v3.launches
        check(k1 > 0, "the CLI's bf16-tier queries never launched scan_select_v3")

        # the in-memory reference: the same files, chunker, tags and embedder
        docs = cli._walk_documents(docs_dir)
        tags = cli._doc_tags_for(docs, argparse.Namespace(tags=None, tag_by_dir=True, path=docs_dir))
        emb = EncoderEmbedder(config=EncoderConfig.minilm_l6(), seed=0, model_name="mini-lm", device=DEV)
        ref = (rag.RagPipelineBuilder().with_embedder(emb).with_reranker(rag.NoOpReranker())
               .with_chunker(rag.RecursiveChunker(chunk_size=512, overlap=64))
               .with_vector_config(rag.VectorStoreConfig(dimension=emb.dimension, scan_tier="bf16"))
               .with_device(DEV).build())
        ref.index_documents(docs, tags=tags)
        f_any = rag.TagFilter(any=("dir:tag_a", "dir:tag_b"))
        for q, a, b in zip(queries, plain, filtered):
            check(json_rows(a) == cli_rows(ref.retriever.retrieve(q, 5)),
                  f"cli query {q!r}: results differ from the in-memory pipeline's")
            check(len(b) > 0 and all(int(r["title"][3:8]) % 4 in (1, 2) for r in b),
                  f"cli query {q!r} --filter-any: a result outside the filter")
            check(json_rows(b) == cli_rows(ref.retriever.retrieve(q, 5, tag_filter=f_any)),
                  f"cli query {q!r} --filter-any: results differ from the in-memory pipeline's")
        log(f"cli query --scan-tier bf16 --format json: {2 * len(queries)} queries ({len(queries)} with "
            f"--filter-any) in {t_query:.1f} s, scan_select_v3 launches {k1}; every result equal to the "
            f"in-memory pipeline's over the same files")
        del ref, emb

        t0 = time.perf_counter()
        rc, out = run_cli(["index", "--path", docs_dir, "--output", mv_dir, "--multi-vector", "--tag-by-dir"])
        check(rc == 0, f"cli index --multi-vector exit {rc}")
        log(f"cli index --multi-vector: {out.strip()} ({time.perf_counter() - t0:.1f} s)")
        maxsim_scan16_scores.launches = 0
        mv = [json.loads(run_cli(["query", q, "--index", mv_dir, "--format", "json"])[1]) for q in queries]
        k6 = maxsim_scan16_scores.launches
        check(k6 > 0, "the CLI's multi-vector queries never launched maxsim_scan16_scores")
        li = cli._multi_vector_retriever(DEV)
        chunker = rag.RecursiveChunker(chunk_size=512, overlap=64)
        for d, t in zip(docs, tags):
            chunks = chunker.chunk(d)
            li.index_batch(chunks)
            for c in chunks:
                if t:
                    li.store.registry.set_tags(c.id, t)
        for q, a in zip(queries, mv):
            check(json_rows(a) == cli_rows(li.retrieve(q, 5)),
                  f"cli multi-vector query {q!r}: results differ from the in-memory retriever's")
        log(f"cli query (multi-vector): {len(queries)} queries, maxsim_scan16_scores launches {k6}; every result "
            f"equal to the in-memory LateInteractionRetriever's")
        del li
        phase_cli_tri_serve(docs_dir, os.path.join(tmp, "tri"), queries)
        k1 += phase_hf_import(docs_dir, tmp, queries, seed)
        for argv in (["info"], ["demo"]):
            rc, out = run_cli(argv)
            check(rc == 0 and out, f"cli {argv[0]} exit {rc}")
        log("cli info and demo: exit 0")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return k1, k6


def write_minilm_checkpoint(path: str, seed: int) -> None:
    """A MiniLM-L6-shaped BERT checkpoint directory (all-MiniLM-L6-v2's
    config: 384-d, 6 layers, 12 heads, MLP 1,536, vocabulary 30,522, 512
    positions) with numpy-seeded weights: ``model.safetensors`` through
    ``persist.save_params``, ``config.json`` and a ``vocab.txt`` whose
    words include the text law's."""
    import numpy as np

    import json
    import os

    from trueno_rag_tpu_torch.persist import save_params

    h, layers, mlp, vocab_n = 384, 6, 1536, 30522
    rng = np.random.default_rng(seed + 35)

    def normal(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * 0.05).astype(np.float32)

    state = {"embeddings.word_embeddings.weight": normal(vocab_n, h),
             "embeddings.position_embeddings.weight": normal(512, h),
             "embeddings.token_type_embeddings.weight": normal(2, h),
             "embeddings.LayerNorm.weight": np.ones(h, np.float32),
             "embeddings.LayerNorm.bias": np.zeros(h, np.float32)}
    for i in range(layers):
        p = f"encoder.layer.{i}."
        for name, shape in (("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)), ("attention.output.dense", (h, h)),
                            ("intermediate.dense", (mlp, h)), ("output.dense", (h, mlp))):
            state[p + name + ".weight"] = normal(*shape)
            state[p + name + ".bias"] = normal(shape[0])
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            state[p + ln + ".weight"] = np.ones(h, np.float32)
            state[p + ln + ".bias"] = np.zeros(h, np.float32)
    os.makedirs(path, exist_ok=True)
    save_params(os.path.join(path, "model.safetensors"), state)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "bert", "_name_or_path": "smoke-minilm-l6", "vocab_size": vocab_n,
                   "hidden_size": h, "num_hidden_layers": layers, "num_attention_heads": 12,
                   "intermediate_size": mlp, "max_position_embeddings": 512, "pad_token_id": 0}, f)
    words = [f"w{i:05d}" for i in range(VOCAB)]
    special = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    pieces = [f"##{i}" for i in range(10)] + [str(i) for i in range(10)]
    filler = [f"[unused{i}]" for i in range(vocab_n - len(special) - len(words) - len(pieces))]
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(special + pieces + words + filler) + "\n")


def phase_hf_import(docs_dir: str, tmp: str, queries, seed: int) -> int:
    """Inside cli: a MiniLM-L6-shaped checkpoint directory indexed by the
    CLI in a subprocess (``python -m trueno_rag_tpu_torch.cli index
    --embedder semantic --model DIR``) and queried through ``cli.main``
    (K1), each answer equal to an in-process pipeline's over
    ``load_hf_bert_encoder(DIR)`` → K1 launches of the CLI's queries."""
    import json
    import os

    import trueno_rag_tpu_torch as rag
    from trueno_rag_tpu_torch import cli
    from trueno_rag_tpu_torch.models.hf_import import load_hf_bert_encoder
    from trueno_rag_tpu_torch.models.tokenization import WordPieceTokenizer
    from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_v3

    model_dir, out_dir = os.path.join(tmp, "minilm_hf"), os.path.join(tmp, "hf_index")
    t0 = time.perf_counter()
    write_minilm_checkpoint(model_dir, seed)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "trueno_rag_tpu_torch.cli", "index", "--path", docs_dir,
                           "--output", out_dir, "--embedder", "semantic", "--model", model_dir, "--tag-by-dir"],
                          capture_output=True, text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    t_index = time.perf_counter() - t0
    check(proc.returncode == 0, f"hf-import: cli index exit {proc.returncode}: {proc.stderr[-2000:]}")
    log(f"hf-import: checkpoint written in {t_write:.1f} s; python -m trueno_rag_tpu_torch.cli index --embedder "
        f"semantic --model DIR: {proc.stdout.strip()} ({t_index:.1f} s, a subprocess)")
    scan_select_v3.launches = 0
    answers = [json.loads(run_cli(["query", q, "--index", out_dir, "--scan-tier", "bf16", "--format", "json"])[1])
               for q in queries]
    k1 = scan_select_v3.launches
    check(k1 > 0, "hf-import: the CLI's bf16-tier queries never launched scan_select_v3")
    emb = load_hf_bert_encoder(model_dir, device=DEV)
    check(isinstance(emb.tokenizer, WordPieceTokenizer) and emb.encoder_config.hidden_dim == 384
          and emb.encoder_config.num_layers == 6, "hf-import: the loaded encoder is not MiniLM-L6-shaped")
    docs = cli._walk_documents(docs_dir)
    import argparse

    tags = cli._doc_tags_for(docs, argparse.Namespace(tags=None, tag_by_dir=True, path=docs_dir))
    ref = (rag.RagPipelineBuilder().with_embedder(emb).with_reranker(rag.NoOpReranker())
           .with_chunker(rag.RecursiveChunker(chunk_size=512, overlap=64))
           .with_vector_config(rag.VectorStoreConfig(dimension=emb.dimension, scan_tier="bf16"))
           .with_device(DEV).build())
    ref.index_documents(docs, tags=tags)
    for q, a in zip(queries, answers):
        check(len(a) > 0 and json_rows(a) == cli_rows(ref.retriever.retrieve(q, 5)),
              f"hf-import: cli query {q!r} differs from the in-process pipeline over load_hf_bert_encoder")
    log(f"hf-import: {len(queries)} queries through cli query --scan-tier bf16, scan_select_v3 launches {k1}; "
        f"every answer equal to the in-process pipeline's over load_hf_bert_encoder(DIR)")
    del ref, emb
    return k1


SERVE_FIELDS = ("title", "content", "score", "dense_score", "sparse_score", "fused_score", "learned_score")


def phase_cli_tri_serve(docs_dir: str, tri_dir: str, queries) -> None:
    """Inside cli: ``index --with-learned-sparse`` in this process, then
    ``serve`` on that index in a subprocess (``--port 0``; ready when it
    prints its address), every query's /query JSON equal to ``query --format
    json``'s; the server is terminated in a ``finally``."""
    import os
    import select
    import urllib.request

    t0 = time.perf_counter()
    rc, out = run_cli(["index", "--path", docs_dir, "--output", tri_dir, "--with-learned-sparse", "--tag-by-dir"])
    check(rc == 0, f"cli index --with-learned-sparse exit {rc}")
    log(f"cli index --with-learned-sparse: {out.strip()} ({time.perf_counter() - t0:.1f} s)")
    want = [json.loads(run_cli(["query", q, "--index", tri_dir, "--format", "json"])[1]) for q in queries]
    check(all(want) and any(r["learned_score"] is not None for w in want for r in w),
          "cli query of the tri-hybrid index: no learned scores")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-u", "-m", "trueno_rag_tpu_torch.cli", "serve", "--index", tri_dir,
                             "--port", "0", "--max-batch", "8"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=root)
    try:
        seen, line = [], ""
        deadline = time.monotonic() + 300
        while "serving" not in line:
            ready, _, _ = select.select([proc.stdout], [], [], max(0.0, deadline - time.monotonic()))
            check(bool(ready), f"cli serve: no address within 300 s: {''.join(seen)[-2000:]}")
            line = proc.stdout.readline()
            check(bool(line), f"cli serve exited {proc.poll()}: {''.join(seen)[-2000:]}")
            seen.append(line)
        url = line.split(" on ")[1].split()[0]
        t_ready = time.perf_counter() - t0
        for q, w in zip(queries, want):
            req = urllib.request.Request(url + "/query", data=json.dumps({"query": q, "k": 5}).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                got = json.loads(resp.read())["results"]
            check([{f: r[f] for f in SERVE_FIELDS} for r in got] == [{f: r[f] for f in SERVE_FIELDS} for r in w],
                  f"cli serve {q!r}: /query differs from cli query's JSON")
        log(f"cli serve (subprocess, tri-hybrid index): ready in {t_ready:.1f} s at {url}; {len(queries)} "
            f"queries over HTTP equal to cli query's JSON")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
        proc.stdout.close()


def phase_checkpoint(seed: int) -> None:
    """checkpoint: ``save_checkpoint`` / ``load_checkpoint`` on the card,
    MiniLM-L6 at full size and the Nemotron-class model at full width and
    CKPT_NEMO_LAYERS layers (depth cut: the 32-layer f32 file is 31.6 GB);
    every embedding bit-identical after the reload."""
    import numpy as np

    import os
    import shutil
    import tempfile

    import torch

    from trueno_rag_tpu_torch.models.encoder import EncoderConfig, EncoderEmbedder
    from trueno_rag_tpu_torch.models.nemotron import NemotronConfig, NemotronEmbedder

    rng = np.random.default_rng(seed + 16)
    texts = make_texts(rng, 64, 30)
    tmp = tempfile.mkdtemp(prefix="smoke_ckpt_")
    try:
        n_cfg = dataclasses.replace(NemotronConfig.full(), num_layers=CKPT_NEMO_LAYERS)
        n_params = n_cfg.vocab_size * n_cfg.hidden_dim + n_cfg.num_layers * (
            4 * n_cfg.hidden_dim ** 2 + 3 * n_cfg.hidden_dim * n_cfg.mlp_dim)
        need_disk(tmp, 2.0 * 4 * n_params, "checkpoint")
        for label, cls, cfg, n_texts in (("MiniLM-L6", EncoderEmbedder, EncoderConfig.minilm_l6(), 64),
                                         (f"Nemotron full width, {CKPT_NEMO_LAYERS} layers", NemotronEmbedder,
                                          n_cfg, 8)):
            model = cls(config=cfg, seed=seed + 16, device=DEV)
            want = model.embed_batch(texts[:n_texts])
            path = os.path.join(tmp, "model.safetensors")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.save_checkpoint(path)
            t_save = time.perf_counter() - t0
            size = os.path.getsize(path)
            del model
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            back = cls.load_checkpoint(path, config=cfg, device=DEV)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            got = back.embed_batch(texts[:n_texts])
            check(np.array_equal(want, got), f"checkpoint {label}: embeddings differ after the reload")
            log(f"checkpoint {label}: {size} bytes of safetensors, save {t_save:.1f} s, load onto the card "
                f"{t_load:.1f} s; {n_texts} embeddings bit-identical after the reload")
            del back
            os.unlink(path)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_gguf_quantized(seed: int) -> int:
    """gguf-quantized: the Nemotron-class model at full width and
    GGUF_LAYERS layers in device k-quant blocks, its forward against the
    bf16 forward on the host-dequantized blocks → K4 launches of the
    quantized forward."""
    import numpy as np
    import torch

    from trueno_rag_tpu_torch.models import gguf_device as gd
    from trueno_rag_tpu_torch.models.encoder import HashTokenizer
    from trueno_rag_tpu_torch.models.nemotron import NemotronConfig, nemotron_forward
    from trueno_rag_tpu_torch.ops.kernels.attention import block_attention

    cfg = dataclasses.replace(NemotronConfig.full(), num_layers=GGUF_LAYERS)
    h, m = cfg.hidden_dim, cfg.mlp_dim
    shapes = {"qkv_w": (h, 3 * h), "attn_out_w": (h, h), "mlp_gate_w": (h, m), "mlp_up_w": (h, m),
              "mlp_down_w": (m, h)}
    gen = torch.Generator(device=DEV).manual_seed(seed + 34)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=DEV).mul_(0.02)

    t0 = time.perf_counter()
    layers, t_layer = [], []
    for _ in range(cfg.num_layers):
        t1 = time.perf_counter()
        layer = {name: normal(shape).cpu().numpy() for name, shape in shapes.items()}
        layer["rms1_scale"] = layer["rms2_scale"] = np.ones(h, np.float32)
        layers.append(gd.quantize_nemotron_layer(layer, DEV))
        del layer
        t_layer.append(time.perf_counter() - t1)
    qp = {"tok_emb": normal((cfg.vocab_size, h)).to(torch.bfloat16),
          "final_rms_scale": torch.ones(h, device=DEV), "layers": layers,
          "shapes": {name: (shape, gd.WEIGHT_KINDS[name]) for name, shape in shapes.items()}}
    t_quant = time.perf_counter() - t0
    q_bytes = sum(lq[name].numel() for lq in layers for name in shapes)
    bf16_bytes = 2 * cfg.num_layers * sum(a * b for a, b in shapes.values())
    log(f"gguf-quantized: {cfg.num_layers} of 32 layers at full width ({h}-d, MLP {m}) made on the card and "
        f"quantized on the host (Q4_K_M) in {t_quant:.1f} s ({np.median(t_layer):.1f} s a layer); the stack "
        f"{q_bytes / 2**30:.3f} GiB of k-quant blocks against {bf16_bytes / 2**30:.3f} GiB of bf16 matrices")

    rng = np.random.default_rng(seed + 34)
    texts = long_texts(rng, GGUF_B, GGUF_WORDS, GGUF_WORDS)
    ids = torch.from_numpy(HashTokenizer(cfg.vocab_size, 1024).encode_batch(texts)).to(DEV)
    check(tuple(ids.shape) == (GGUF_B, 1024), f"gguf-quantized: token batch {tuple(ids.shape)}")
    gd.nemotron_forward_quantized(qp, ids, cfg)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    block_attention.launches = 0
    t0 = time.perf_counter()
    got = gd.nemotron_forward_quantized(qp, ids, cfg)
    torch.cuda.synchronize()
    dt_q = time.perf_counter() - t0
    k4 = block_attention.launches
    peak_q = torch.cuda.max_memory_allocated()
    check(k4 == cfg.num_layers, f"gguf-quantized: K4 launched {k4} times, expected {cfg.num_layers}")
    tokens = int((ids != 0).sum())

    t0 = time.perf_counter()
    ref_params = gd.dequantize_nemotron_params(qp)
    t_deq = time.perf_counter() - t0
    del qp, layers
    gc.collect()
    torch.cuda.empty_cache()
    nemotron_forward(ref_params, ids, cfg)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    want = nemotron_forward(ref_params, ids, cfg)
    torch.cuda.synchronize()
    dt_b = time.perf_counter() - t0
    peak_b = torch.cuda.max_memory_allocated()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    check(got.shape == (GGUF_B, h) and np.isfinite(got).all(), "gguf-quantized: malformed embeddings")
    cos = (got * want).sum(axis=1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    check(bool((cos > 0.999).all()), f"gguf-quantized: cosine to the dequantized bf16 forward {cos}")
    log(f"gguf-quantized: B={GGUF_B} T=1024, {tokens} tokens: quantized forward {dt_q:.3f} s = "
        f"{tokens / dt_q:.0f} tokens/s, peak allocated {peak_q / 2**30:.2f} GiB (weights resident before it "
        f"{base / 2**30:.2f} GiB); bf16 forward on the host-dequantized blocks ({t_deq:.1f} s to decode) "
        f"{dt_b:.3f} s = {tokens / dt_b:.0f} tokens/s, peak allocated {peak_b / 2**30:.2f} GiB; K4 launches "
        f"{k4}; cosine per row min {cos.min():.6f}")
    del ref_params
    gc.collect()
    torch.cuda.empty_cache()
    return k4


def train_texts(rng, n: int):
    """``n`` documents of three 20-word sentences of the text law."""
    out = []
    for t in make_texts(rng, n, 60):
        w = t.split()
        out.append(". ".join(" ".join(w[i:i + 20]) for i in range(0, 60, 20)) + ".")
    return out


def phase_train_minilm(seed: int) -> None:
    """train-minilm: ``fit`` on MiniLM-L6 at full width with ICT pairs, a
    card step against the CPU step, the other objectives, a checkpoint
    resume and remat's peak memory."""
    import numpy as np
    import os
    import shutil
    import tempfile

    import torch

    from trueno_rag_tpu_torch.chunking import Chunk, chunk_id_from_int
    from trueno_rag_tpu_torch.convert import params_to_jax
    from trueno_rag_tpu_torch.models.encoder import EncoderConfig, HashTokenizer
    from trueno_rag_tpu_torch.models.cross_encoder import CrossEncoderReranker
    from trueno_rag_tpu_torch.train import checkpoint as tck, contrastive as tc, distill as td, loop as tl
    from trueno_rag_tpu_torch.train.data import PairBatcher, ict_pairs

    import random

    cfg = dataclasses.replace(EncoderConfig.minilm_l6(), max_len=TRAIN_MAX_LEN)
    rng = np.random.default_rng(seed + 37)
    texts = train_texts(rng, TRAIN_DOCS)
    chunks = [Chunk(document_id=f"tdoc{i}", content=t, start_offset=0, end_offset=len(t), id=chunk_id_from_int(i))
              for i, t in enumerate(texts)]
    tok = HashTokenizer(cfg.vocab_size, TRAIN_MAX_LEN)
    # held-out probes: 4 words of a document among 4 random words (the
    # self-ICT probes are substrings of their chunk: an untrained encoder
    # already finds them all)
    words = np.array([f"w{i:05d}" for i in range(VOCAB)])
    rows = rng.choice(TRAIN_DOCS, size=TRAIN_EVAL_QUERIES, replace=False)
    probes = [" ".join(rng.permutation(np.concatenate([rng.choice(texts[r].replace(".", "").split(), 4,
                                                                  replace=False),
                                                       words[rng.integers(0, VOCAB, 4)]])))
              for r in rows]
    evalset = tl.EvalSet(queries=probes, relevant=[[int(r)] for r in rows])
    gen = torch.Generator(device=DEV).manual_seed(seed + 37)
    state, tx = tc.create_train_state(gen, cfg, learning_rate=TRAIN_LR, device=DEV)
    n_params = sum(t.numel() for t in tc.tree_leaves(state.params))

    losses, step_s = [], []
    real_step = tl.train_step

    def timed_step(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_step(*a, **kw)
        losses.append(float(out[1]["loss"]))  # a host read: synchronizes
        step_s.append(time.perf_counter() - t0)
        return out

    tl.train_step = timed_step
    try:
        t0 = time.perf_counter()
        result = tl.fit(state, tx, cfg, tok, chunks, steps=TRAIN_STEPS, batch_size=TRAIN_BATCH,
                        max_len=TRAIN_MAX_LEN, eval_every=TRAIN_STEPS, k=10, seed=seed, evalset=evalset)
        t_fit = time.perf_counter() - t0
    finally:
        tl.train_step = real_step
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), "train-minilm: a loss is not finite")
    before, after = result.history[0], result.history[-1]
    check(after["step"] == TRAIN_STEPS and result.best_step in (0, TRAIN_STEPS), "train-minilm: history")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    log(f"train-minilm: MiniLM-L6 ({n_params} f32 master parameters), {TRAIN_STEPS} steps of {TRAIN_BATCH} ICT "
        f"pairs at max_len {TRAIN_MAX_LEN}: fit {t_fit:.1f} s (2 evaluations included); step median "
        f"{steady * 1e3:.1f} ms = {1 / steady:.2f} steps/s (host clock, synchronized; the first step "
        f"{step_s[0] * 1e3:.0f} ms); loss {losses[0]:.4f} -> {losses[-1]:.4f} (every 10th: "
        f"{[round(x, 4) for x in losses[::10]]})")
    log(f"train-minilm: evaluate_retrieval over {TRAIN_DOCS} documents, {TRAIN_EVAL_QUERIES} held-out probes: "
        f"before recall@10 {before['recall@10']:.4f} mrr {before['mrr']:.4f}; after recall@10 "
        f"{after['recall@10']:.4f} mrr {after['mrr']:.4f}; best step {result.best_step}")
    check(losses[-1] < losses[0], f"train-minilm: loss did not fall ({losses[0]:.4f} -> {losses[-1]:.4f})")

    # one step at f32 on the card against the same step on the CPU
    batcher = PairBatcher(tok, batch_size=TRAIN_BATCH, max_len=TRAIN_MAX_LEN)
    stream = batcher.batches(ict_pairs(chunks, random.Random(seed + 1)))
    q_ids, d_ids = next(stream)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    s_card = result.state
    s_cpu = tc.TrainState(tc.tree_map(lambda t: t.cpu(), s_card.params),
                          s_card.opt_state._replace(mu=tc.tree_map(lambda t: t.cpu(), s_card.opt_state.mu),
                                                    nu=tc.tree_map(lambda t: t.cpu(), s_card.opt_state.nu)),
                          s_card.step)
    a, ma = tc.train_step(s_card, q_ids, d_ids, tx, cfg32)
    t0 = time.perf_counter()
    b, mb = tc.train_step(s_cpu, q_ids, d_ids, tx, cfg32)
    t_cpu = time.perf_counter() - t0
    la, lb = float(ma["loss"]), float(mb["loss"])
    check(abs(la - lb) <= 1e-4 * abs(lb) + 1e-6, f"train-minilm: card loss {la} vs CPU {lb}")
    diffs = np.concatenate([(x.cpu() - y).abs().flatten().numpy()
                            for x, y in zip(tc.tree_leaves(a.params), tc.tree_leaves(b.params))])
    close = float((diffs <= 5e-4 * TRAIN_LR).mean())
    check(close >= 0.99 and diffs.max() <= 2.01 * TRAIN_LR,
          f"train-minilm: card and CPU steps differ (within 5e-4·lr: {close:.4f}, max {diffs.max():.3e})")
    log(f"train-minilm: one f32 step on the card vs the port's CPU step ({t_cpu:.1f} s) on the same batch and "
        f"state: loss {la:.6f} vs {lb:.6f}; {close:.4%} of parameters within 5e-4·lr, max |diff| "
        f"{diffs.max():.3e} (<= 2·lr: Adam's step of a gradient near its rounding noise)")
    del a, b, s_cpu

    # the other objectives, a few steps each
    sp, stx = tc.create_train_state(gen, cfg, learning_rate=TRAIN_LR, kind="splade", device=DEV)
    side = {}
    for name, st, stx_, fn, kw in (("splade", sp, stx, tc.splade_train_step,
                                    {"score_norm": "cosine", "temperature": 0.05}),
                                   ("maxsim", result.state, tx, tc.maxsim_train_step, {})):
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_SIDE_STEPS):
            qb, db = next(stream)
            st, mt = fn(st, qb, db, stx_, cfg, **kw)
            out.append(float(mt["loss"]))
        side[name] = (out, (time.perf_counter() - t0) / TRAIN_SIDE_STEPS)
        check(all(np.isfinite(out)) and st.step == (TRAIN_SIDE_STEPS if name == "splade" else
                                                    result.state.step + TRAIN_SIDE_STEPS), f"train-minilm {name}")
    del sp
    teacher = CrossEncoderReranker(config=cfg, seed=seed + 37, max_len=TRAIN_MAX_LEN, device=DEV)
    qs = [texts[i].split(". ")[0] for i in range(16)]
    slates = [[texts[(i + j) % TRAIN_DOCS] for j in range(4)] for i in range(16)]
    teach = td.teacher_slate_scores(teacher, qs, slates)
    q_ids = tok.encode_batch(qs)
    cand = np.stack([np.pad(x, ((0, 0), (0, TRAIN_MAX_LEN - x.shape[1])))[:, :TRAIN_MAX_LEN]
                     for x in (tok.encode_batch(s) for s in slates)])
    st, out = result.state, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_SIDE_STEPS):
        st, mt = td.distill_step(st, q_ids, cand, teach, tx, cfg)
        out.append(float(mt["loss"]))
    side["distill"] = (out, (time.perf_counter() - t0) / TRAIN_SIDE_STEPS)
    check(all(np.isfinite(out)), "train-minilm distill: a loss is not finite")
    log("train-minilm other objectives (" + "; ".join(
        f"{k}: losses {[round(x, 4) for x in v[0]]}, {v[1] * 1e3:.0f} ms a step" for k, v in side.items())
        + f"; SPLADE and MaxSim at batch {TRAIN_BATCH}, distillation 16 queries x 4 candidates)")
    del teacher, st

    # checkpoint: saved, reloaded, both stepped once
    tmp = tempfile.mkdtemp(prefix="smoke_train_")
    try:
        need_disk(tmp, 16 * n_params, "train-minilm")
        path = os.path.join(tmp, "state")
        tck.save_train_state(path, result.state)
        back = tck.load_train_state(path, device=DEV)
        qb, db = next(stream)
        x, _ = tc.train_step(result.state, qb, db, tx, cfg)
        y, _ = tc.train_step(back, qb, db, tx, cfg)
        fx, fy = params_to_jax(x.params), params_to_jax(y.params)
        same = sorted(fx) == sorted(fy) and all(np.array_equal(fx[k], fy[k]) for k in fx)
        check(back.step == result.state.step and same, "train-minilm: the resumed step differs")
        log(f"train-minilm: checkpoint of {os.path.getsize(os.path.join(path, tck.STATE_FILE))} bytes; the "
            f"reloaded state's next step bit-identical to the saved state's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # remat: peak memory of one step with and without
    peaks, step_losses = {}, {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, mt = tc.train_step(result.state, qb, db, tx, c)
        step_losses[remat] = float(mt["loss"])
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 2**20
    check(step_losses[False] == step_losses[True], f"train-minilm: remat changed the loss {step_losses}")
    log(f"train-minilm: one step of {TRAIN_BATCH} x {TRAIN_MAX_LEN}: peak allocated above the resident state "
        f"{peaks[False]:.0f} MiB without remat, {peaks[True]:.0f} MiB with remat; losses equal")


def phase_clustered_artifact(retr, p, embedder, runs, pipe) -> int:
    """clustered-artifact (inside clustered-1M, on its clean store): the
    store saved with its k-means layout and loaded with
    ``scan_tier="clustered"``: no k-means build on load, K5 on the loaded
    path, every dense row and score and every context equal to the saved
    store's → K5 launches on the loaded path."""
    import numpy as np

    import os
    import shutil
    import tempfile

    import torch

    import trueno_rag_tpu_torch as rag
    from trueno_rag_tpu_torch import persist
    from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_v3_indirect

    store = retr.vector_store
    n = len(retr.registry)
    tmp = tempfile.mkdtemp(prefix="smoke_clustered_")
    try:
        need_disk(tmp, 2.0 * n * (DIM * 4 + 1024), "clustered-artifact")
        path = os.path.join(tmp, "index.trag")
        t0 = time.perf_counter()
        # no codec: the layout is what this phase carries (persist-1M covers
        # the card's default codec), and compressing 1.9 GB costs ~20 s
        persist.save_index_streaming(path, retr, embedder_info={"type": "blob"},
                                     codec=persist.Compression.NONE)
        t_save = time.perf_counter() - t0
        builds = count_cluster_builds()
        t0 = time.perf_counter()
        loaded, _ = persist.load_index(path, embedder, scan_tier="clustered", device=DEV)
        lstore = loaded.vector_store
        check(lstore._cluster_preset is not None, "the artifact carried no clustered layout")
        loaded.ensure_ready()
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        check(builds == [], f"k-means ran on load: {builds}")
        check(np.array_equal(lstore._cluster[0], store._cluster[0])
              and torch.equal(lstore._cluster[3], store._cluster[3]), "the loaded layout differs from the saved one")
        log(f"clustered-artifact: {os.path.getsize(path)} bytes saved in {t_save:.1f} s; loaded and built "
            f"(scan_tier='clustered', the saved layout as the preset, no k-means) in {t_load:.1f} s")
        lp = rag.RagPipeline(embedder, pipe.reranker, pipe.chunker, loaded, pipe.assembler)
        lp.query_with_context_batch(runs[0], k=K)  # first-call set-up
        torch.cuda.synchronize()
        scan_select_v3_indirect.launches = 0
        got = [lp.query_with_context_batch(qs, k=K) for qs in runs]
        n5 = scan_select_v3_indirect.launches
        check(n5 > 0, "the loaded clustered store never launched K5")
        cand = retr.config.candidates_per_source
        for i, qs in enumerate(runs):
            check(context_rows(got[i]) == context_rows(p.query_with_context_batch(qs, k=K)),
                  f"clustered-artifact run {i}: a context differs from the saved store's")
            qv = np.asarray(embedder.embed_queries(qs), np.float32)
            s_a, r_a = store.search_arrays(qv, cand)
            s_b, r_b = lstore.search_arrays(qv, cand)
            check(torch.equal(r_a, r_b) and torch.equal(s_a, s_b),
                  f"clustered-artifact run {i}: dense rows or scores differ from the saved store's")
        log(f"clustered-artifact: K5 launches {n5} on the loaded path; every dense row and score and every "
            f"context of {sum(len(r) for r in runs)} queries equal to the saved store's")
        del lp, loaded, lstore
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return n5


def learned_mass(li, q_terms, q_weights):
    """Per query, the float64 sum of every contribution its panel holds
    (Σ_t q_w · Σ of term t's document weights): the bound the candidate
    tail's f32 prefix sums round against."""
    import numpy as np

    snap = li._snap
    csum = np.concatenate([[0.0], np.cumsum(snap["weights"], dtype=np.float64)])
    term_sum = csum[snap["indptr"][1:]] - csum[snap["indptr"][:-1]]
    pos = np.clip(np.searchsorted(snap["term_ids"], q_terms), 0, max(len(snap["term_ids"]) - 1, 0))
    hit = (q_terms >= 0) & (q_weights > 0) & (snap["term_ids"][pos] == q_terms)
    return (np.where(hit, term_sum[pos], 0.0) * q_weights).sum(axis=1)


def check_learned_exact(li, q_terms, q_weights, scores, rows, cand, label) -> int:
    """Every query's learned top-``cand`` (device) against the float64 oracle
    ``search_host``: scores within BM25_ULPS ulps of the panel's mass, rows
    equal up to near-ties (``bm25_near_ties``) → queries whose rows differ."""
    import numpy as np

    mass = learned_mass(li, q_terms, q_weights)
    s_host = np.full(scores.shape, -np.inf, np.float32)
    r_host = np.full(rows.shape, -1, np.int32)
    for i in range(len(q_terms)):
        for j, (r, s) in enumerate(li.search_host(q_terms[i], q_weights[i], cand)):
            r_host[i, j], s_host[i, j] = r, s
    worst = 0.0
    for i in range(len(q_terms)):
        host = dict(zip(r_host[i].tolist(), s_host[i].tolist()))
        err = [abs(float(s) - host[r]) / host[r] for r, s in zip(rows[i].tolist(), scores[i].tolist()) if r in host]
        worst = max([worst] + err)
        if np.array_equal(rows[i], r_host[i]):
            fin = rows[i] >= 0
            tol = BM25_ULPS * 2.0**-24 * float(mass[i])
            check(bool(np.all(np.abs(scores[i][fin] - s_host[i][fin]) <= tol)),
                  f"{label} query {i}: a learned score differs from float64 past {tol}")
    n = bm25_near_ties(s_host, r_host, scores, rows, mass, label)
    log(f"{label}: learned scores off the float64 oracle by at most {worst:.2e} relative (panel mass "
        f"{float(np.median(mass)):.3g} median, {float(mass.max()):.3g} max); {n} of {len(q_terms)} lists differ "
        f"only at near-ties within {BM25_ULPS} ulps of the mass")
    return n


def phase_tri_hybrid(seed: int) -> int:
    """tri-hybrid-65k: hybrid-1M's text law at TRI_N documents,
    ``MockEmbedder(384)`` and a seeded ``SpladeEncoder`` at MiniLM-L6 width
    through ``RagPipelineBuilder.with_learned_sparse`` on tier "bf16"
    (staged, K1), the learned candidates held to the float64 oracle, one
    batch on a sibling store at tier "none" held to the bf16 tier's lists
    where the dense scores are tie-free, and the index saved with its
    learned section, reloaded with the encoder and asked again → K1 launches
    of the bf16 tier."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    import trueno_rag_tpu_torch as rag
    from trueno_rag_tpu_torch import persist
    from trueno_rag_tpu_torch.models.splade import SpladeEncoder
    from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_v3

    rng = np.random.default_rng(seed + 17)
    t0 = time.perf_counter()
    docs = [rag.Document(t, id=f"tri{i}") for i, t in enumerate(make_texts(rng, TRI_N, DOC_WORDS))]
    log(f"tri-hybrid: {TRI_N} documents made in {time.perf_counter() - t0:.1f} s")
    enc = SpladeEncoder(config=rag.EncoderConfig.minilm_l6(), seed=seed + 17, max_len=TRI_MAX_LEN,
                        doc_top=TRI_DOC_TOP, query_top=TRI_QUERY_TOP, device=DEV)
    spent = [0.0]
    expand = enc.expand_documents

    def timed_expand(texts):  # the expansion's share of the ingest, synchronized by its host copy
        t = time.perf_counter()
        out = expand(texts)
        spent[0] += time.perf_counter() - t
        return out

    enc.expand_documents = timed_expand  # an instance attribute over the method, removed after the ingest
    pipe = (rag.RagPipelineBuilder().with_embedder(rag.MockEmbedder(DIM)).with_reranker(rag.LexicalReranker())
            .with_vector_config(rag.VectorStoreConfig(scan_tier="bf16")).with_learned_sparse(enc)
            .with_device(DEV).build())
    retr = pipe.retriever
    t0 = time.perf_counter()
    check(pipe.index_documents(docs) == TRI_N, "tri-hybrid: chunk count")
    t_ingest = time.perf_counter() - t0
    del docs, enc.expand_documents
    li = retr.learned_index
    t0 = time.perf_counter()
    li.ensure_ready()
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    postings = int(li._snap["indptr"][-1])
    sizes = np.diff(li._snap["indptr"])
    log(f"tri-hybrid ingest (chunk, embed, BM25, dense, SPLADE expansion): {t_ingest:.1f} s, of which expansion "
        f"(MiniLM-L6 trunk + f32 head, {TRI_N} x {TRI_MAX_LEN} tokens) {spent[0]:.1f} s; {postings} postings "
        f"({postings / TRI_N:.1f} a document) over {len(sizes)} terms (largest list {int(sizes.max())}); host "
        f"snapshot + block table upload {t_pack:.1f} s")
    check(postings > 0 and len(li) == TRI_N, "tri-hybrid: the learned index")
    retr.ensure_ready()
    check(retr.vector_store._effective_tier() == "bf16", "tri-hybrid: the store's tier")
    batches = query_batches(rng, TRI_BATCHES)
    cand = retr.config.candidates_per_source
    strategy = retr.config.fusion
    retr.retrieve_batch(batches[0], K)  # first-call set-up
    torch.cuda.synchronize()
    times = []
    scan_select_v3.launches = 0
    staged = []
    for qs in batches:
        t0 = time.perf_counter()
        staged.append(retr.retrieve_batch(qs, K))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = scan_select_v3.launches
    check(launches > 0, "tri-hybrid: the bf16 tier never launched scan_select_v3")
    log(f"tri-hybrid retrieve_batch (k={K}, B = {BATCH}) staged on bf16 (K1 launches {launches}): "
        f"{', '.join(f'{t:.1f}' for t in times)} ms (host clock, synchronized)")
    n_near = 0
    for i, qs in enumerate(batches):
        q_terms, q_w = enc.expand_queries(qs)
        t0 = time.perf_counter()
        s_l, r_l = li.search_arrays(q_terms, q_w, cand)
        torch.cuda.synchronize()
        t_l = (time.perf_counter() - t0) * 1e3
        n_near += check_learned_exact(li, q_terms, q_w, s_l.cpu().numpy(), r_l.cpu().numpy(), cand,
                                      f"tri-hybrid batch {i}")
        log(f"tri-hybrid batch {i}: LearnedSparseIndex.search_arrays {t_l:.1f} ms (B = {BATCH}, "
            f"{cand} candidates)")
    log(f"tri-hybrid: every learned candidate list equal to the float64 oracle up to near-ties ({n_near} of "
        f"{BATCH * TRI_BATCHES} queries differ only there)")
    # one batch staged on tier "none" (the fp32 matrix), the default route
    # of a tri-hybrid index below the tier crossover
    sib = sibling_pipeline(pipe, rag.VectorStoreConfig(scan_tier="none"))
    sretr = sib.retriever
    sretr.learned_encoder, sretr.learned_index = retr.learned_encoder, li
    sretr.ensure_ready()
    check(sretr.vector_store._effective_tier() == "none", "tri-hybrid: the sibling store's tier")
    qs = batches[0]
    qv = np.asarray(retr.embedder.embed_queries(qs), np.float32)
    sretr.retrieve_batch(qs, K)  # first-call set-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sretr.retrieve_batch(qs, K)
    torch.cuda.synchronize()
    t_none = (time.perf_counter() - t0) * 1e3
    a = retr._tri_candidates(qs, qv, cand, None, strategy, True, True)
    b = sretr._tri_candidates(qs, qv, cand, None, strategy, True, True)
    s_d, _ = retr.vector_store.search_arrays(qv, cand + 1)  # the boundary's next score
    gaps = np.abs(np.diff(s_d.cpu().numpy(), axis=1)).min(axis=1)
    tie_free = np.flatnonzero(gaps > 1e-6)
    for name, x, y in zip(("fused rows", "fused scores", "dense rows", "dense scores", "bm25 rows",
                           "bm25 scores", "learned rows", "learned scores"), a, b):
        x, y = x.cpu().numpy(), y.cpu().numpy()
        for j in tie_free:
            check(np.array_equal(x[j], y[j]), f"tri-hybrid query {j}: tiers none and bf16 differ in {name}")
    log(f"tri-hybrid on tier none: {t_none:.1f} ms per batch of {BATCH} (host clock, synchronized); on "
        f"{len(tie_free)} queries with tie-free dense scores the fused, dense, BM25 and learned lists equal "
        f"the bf16 tier's")
    del sib, sretr
    tmp = tempfile.mkdtemp(prefix="smoke_tri_")
    try:
        need_disk(tmp, 2.0 * TRI_N * (DIM * 4 + 4096), "tri-hybrid")
        path = os.path.join(tmp, "index.trag")
        t0 = time.perf_counter()
        persist.save_index_streaming(path, retr, embedder_info={"type": "mock", "dimension": DIM},
                                     codec=persist.Compression.NONE)
        t_save = time.perf_counter() - t0
        # the encoder rebuilt from its seed; load_index checks its fingerprint
        # against the artifact's (the header read of read_index_info costs a
        # second decode at this size: the cli phase exercises it)
        enc2 = SpladeEncoder(config=rag.EncoderConfig.minilm_l6(), seed=seed + 17, max_len=TRI_MAX_LEN,
                             doc_top=TRI_DOC_TOP, query_top=TRI_QUERY_TOP, device=DEV)
        t0 = time.perf_counter()
        loaded, _ = persist.load_index(path, rag.MockEmbedder(DIM), scan_tier="bf16", learned_encoder=enc2,
                                       device=DEV)
        loaded.ensure_ready()
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        got = [loaded.retrieve_batch(qs, K) for qs in batches]
        for i in range(len(batches)):
            check([[(r.chunk.id, r.dense_score, r.sparse_score, r.fused_score, r.learned_score) for r in res]
                   for res in got[i]] ==
                  [[(r.chunk.id, r.dense_score, r.sparse_score, r.fused_score, r.learned_score) for r in res]
                   for res in staged[i]], f"tri-hybrid batch {i}: the reloaded index answers otherwise")
        log(f"tri-hybrid artifact: {os.path.getsize(path)} bytes (codec none) saved in {t_save:.1f} s, loaded "
            f"with the rebuilt encoder (fingerprint checked) and built in {t_load:.1f} s; every answer of "
            f"{BATCH * TRI_BATCHES} queries identical")
        del loaded
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del pipe, retr, li
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def drive_http(url: str, queries, n_clients: int):
    """``queries`` as single POST /query requests from ``n_clients`` threads,
    each on its own keep-alive connection → (answers by query index,
    request latencies ms, wall s)."""
    import http.client
    import threading
    from urllib.parse import urlparse

    host = urlparse(url)
    answers = [None] * len(queries)
    lat = []
    lock = threading.Lock()
    errors = []

    def client(c):
        conn = http.client.HTTPConnection(host.hostname, host.port, timeout=120)
        try:
            for i in range(c, len(queries), n_clients):
                body = json.dumps({"query": queries[i], "k": K})
                t = time.perf_counter()
                conn.request("POST", "/query", body, {"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = json.loads(resp.read())
                ms = (time.perf_counter() - t) * 1e3
                if resp.status != 200:
                    raise RuntimeError(f"HTTP {resp.status}: {data}")
                answers[i] = data["results"]
                with lock:
                    lat.append(ms)
        except Exception as e:  # noqa: BLE001 — reported as a failed check below
            errors.append(e)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads), f"serve: client failures {errors[:3]}")
    return answers, sorted(lat), wall


def phase_serve_1m(pipe, seed: int) -> int:
    """serve-1M: hybrid-1M's retriever behind the port's server: ``prewarm``,
    ``autotune_serving`` over batch sizes 1-256, then SERVE_REQUESTS single
    queries from SERVE_CLIENTS client threads through a ``MicroBatcher``
    behind an in-process ``RagHTTPServer`` and behind a two-worker
    ``MultiProcessServer``: every answer equal to ``retrieve_batch``'s,
    ``/health`` on the bf16 tier → K1 launches of the served runs."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from trueno_rag_tpu_torch import serve, tune
    from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_v3

    retr = pipe.retriever
    rng = np.random.default_rng(seed + 18)
    words = np.array([f"w{i:05d}" for i in range(VOCAB)])
    queries = [" ".join(r) for r in words[rng.integers(0, VOCAB, size=(SERVE_REQUESTS, QUERY_WORDS))]]
    t0 = time.perf_counter()
    serve.prewarm(retr, max(SERVE_BATCH_SIZES), k=K, sample_queries=tune.calibration_queries(retr, 16))
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    tuned = tune.autotune_serving(retr, k=K, batch_sizes=SERVE_BATCH_SIZES, iters=3)
    log(f"serve-1M: prewarm {t_warm:.1f} s; autotune_serving {time.perf_counter() - t0:.1f} s → max_batch "
        f"{tuned.max_batch}, max_wait_ms {tuned.max_wait_ms:.2f}; table (batch: p50 ms, q/s): "
        + ", ".join(f"{p.batch_size}: {p.p50_ms:.2f}, {p.qps:.0f}" for p in tuned.table))
    launches = 0
    served = {}
    for label in ("in-process", "2 workers"):
        batcher = serve.MicroBatcher(retr, max_batch=tuned.max_batch, max_wait_ms=tuned.max_wait_ms)
        srv = mp = thread = None
        try:
            if label == "in-process":
                srv = serve.RagHTTPServer(("127.0.0.1", 0), serve.make_handler(batcher))
                thread = threading.Thread(target=srv.serve_forever, daemon=True)
                thread.start()
                url = f"http://127.0.0.1:{srv.server_address[1]}"
            else:
                mp = serve.MultiProcessServer(batcher, "127.0.0.1", 0, 2)
                url = f"http://127.0.0.1:{mp.port}"
            scan_select_v3.launches = 0
            answers, lat, wall = drive_http(url, queries, SERVE_CLIENTS)
            n1 = scan_select_v3.launches
            with urllib.request.urlopen(url + "/health", timeout=60) as resp:
                health = json.loads(resp.read())
        finally:
            if srv is not None:
                srv.shutdown()
                srv.server_close()
                thread.join(timeout=60)
            if mp is not None:
                mp.stop()
            batcher.shutdown()
        check(n1 > 0, f"serve-1M {label}: the served queries never launched scan_select_v3")
        check(health["scan_tier"] == "bf16", f"serve-1M {label}: /health scan_tier {health['scan_tier']!r}")
        check(health["queries_served"] == SERVE_REQUESTS, f"serve-1M {label}: {health['queries_served']} served")
        launches += n1
        served[label] = answers
        pick = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]  # noqa: E731
        log(f"serve-1M {label}: {SERVE_REQUESTS} single-query POSTs from {SERVE_CLIENTS} clients in {wall:.2f} s "
            f"= {SERVE_REQUESTS / wall:.0f} q/s served; request latency p50 {pick(0.5):.1f} ms, p99 "
            f"{pick(0.99):.1f} ms; {health['batches_served']} batches, mean batch "
            f"{health['queries_served'] / health['batches_served']:.1f}; K1 launches {n1}")
    want = []
    for lo in range(0, SERVE_REQUESTS, BATCH):
        want.extend([serve.result_to_dict(r) for r in res] for res in retr.retrieve_batch(queries[lo:lo + BATCH], K))
    for label, answers in served.items():
        bad = [i for i in range(SERVE_REQUESTS) if answers[i] != want[i]]
        for i in bad[:2]:  # what differs, before the check fails
            fields = ("chunk_id", "dense_score", "sparse_score", "fused_score")
            log(f"serve-1M {label} query {i} {queries[i]!r}: served {[tuple(r[f] for f in fields) for r in answers[i]]}; "
                f"batched {[tuple(r[f] for f in fields) for r in want[i]]}; alone "
                f"{[(r.chunk.id, r.dense_score, r.sparse_score, r.fused_score) for r in retr.retrieve_batch([queries[i]], K)[0]]}")
        check(not bad, f"serve-1M {label}: {len(bad)} answers differ from retrieve_batch's (first: query {bad[:1]})")
    log(f"serve-1M: every served answer ({2 * SERVE_REQUESTS}) equal to retrieve_batch's for the same query")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs a GPU", file=sys.stderr)
        return 2
    from trueno_rag_tpu_torch.ops.kernels import scan_select as ss
    t_start = time.perf_counter()

    def timed(phase, *a):
        """``phase(*a)``, then a log line with the smoke's elapsed seconds."""
        out = phase(*a)
        log(f"-- {phase.__name__[len('phase_'):]} done at {time.perf_counter() - t_start:.0f} s")
        return out

    timed(phase_device)
    k1, k3 = timed(phase_kernels, args.seed)
    k8, k9 = timed(phase_kernels_k8k9, args.seed)
    k2, k2b = timed(phase_kernels_k2, args.seed)
    k5 = timed(phase_kernels_k5, args.seed)
    k10a, k10b, k10c, k1_inline = timed(phase_kernels_k10, args.seed)
    k10_kernels = (ss.scan_select_v2, ss.scan_select_v2_indirect, ss.scan_select_int8_v2)
    for kern in k10_kernels:  # no later phase reaches K10: checked still 0 at the end
        kern.launches = 0
    k4 = timed(phase_kernels_k4, args.seed)
    timed(phase_mma_probe, args.seed)
    k6, k7 = timed(phase_kernels_k6k7, args.seed)
    k11a, k11b = timed(phase_kernels_k11, args.seed)
    from trueno_rag_tpu_torch.ops.kernels import maxsim_scan as km
    k11_kernels = (km.maxsim_scan16_scores_v2, km.maxsim_scan16_scores_self_v2)
    for kern in k11_kernels:  # no later phase reaches K11: checked still 0 at the end
        kern.launches = 0
    k1_odd, k6_odd = timed(phase_odd_widths, args.seed)
    timed(phase_tier, args.seed)
    k12a, k12b, seg_idx, seg_qs = timed(phase_kernels_k12, args.seed)
    k1_seg, k12a["launches"], k12b["launches"] = timed(phase_segments_17m, seg_idx, seg_qs, args.seed)
    del seg_idx
    gc.collect()
    torch.cuda.empty_cache()
    pipe, k1["launches"], batches = timed(phase_slice, args.seed)
    k1["launches"] += timed(phase_persist_1m, pipe, batches, args.seed)
    timed(phase_metrics_1m, pipe, args.seed)
    _, k3["launches"] = timed(phase_stores, pipe, args.seed)
    k8["launches"], k9["launches"] = timed(phase_block_stores, pipe, args.seed)
    n_1, n_a, n_b = timed(phase_segments_store, pipe, args.seed)
    k1["launches"] += k1_seg + n_1
    k12a["launches"] += n_a
    k12b["launches"] += n_b
    check(k12b["launches"] > 0, "the segment path never launched fetch_contribs8")
    k5["launches"] = timed(phase_clustered_store, pipe, args.seed)
    k1["launches"] += timed(phase_serve_1m, pipe, args.seed)
    del pipe
    timed(phase_clustered_stream, args.seed)
    emb, k4["launches"] = timed(phase_nemotron_8k, args.seed)
    k4["launches"] += timed(phase_nemotron_rag, emb, args.seed)
    del emb
    gc.collect()
    torch.cuda.empty_cache()
    k4["launches"] += timed(phase_gguf_quantized, args.seed)
    k1["launches"] += timed(phase_encoder_262k, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    k6["launches"], k7["launches"] = timed(phase_late_interaction, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    k1["launches"] += timed(phase_tri_hybrid, args.seed)
    k1_cli, k6_cli = timed(phase_cli, args.seed)
    k1["launches"] += k1_cli
    k6["launches"] += k6_cli
    timed(phase_checkpoint, args.seed)
    timed(phase_train_minilm, args.seed)
    k1["launches"] += k1_odd + k1_inline
    k6["launches"] += k6_odd
    n10 = [kern.launches for kern in k10_kernels]
    log(f"K10a/K10b/K10c launches after kernels-K10 (every later phase, the store and pipeline paths): {n10}")
    check(n10 == [0, 0, 0], "a phase after kernels-K10 launched a v2 tile scan")
    n11 = [kern.launches for kern in k11_kernels]
    log(f"K11a/K11b launches after kernels-K11 (every later phase): {n11}")
    check(n11 == [0, 0], "a phase after kernels-K11 launched an l-major MaxSim scan")
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
          and torch.get_float32_matmul_precision() == "highest", "TF32 was turned on during the run")
    log(f"smoke wall time {time.perf_counter() - t_start:.0f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    log(f"nvidia-smi: {smi.stdout.strip()}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in (k1, k2, k2b, k3, k4, k5, k6, k7, k8, k9, k10a, k10b, k10c, k11a, k11b, k12a, k12b)]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
