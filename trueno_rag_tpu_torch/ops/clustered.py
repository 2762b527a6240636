"""Cluster-pruned certified dense tier: scan only the tiles that can
matter, keep the exact-set certificate.

PyTorch counterpart of ``trueno_rag_tpu/ops/clustered.py``. The compact
tiers stream the whole corpus per batch, which a large batch amortizes
and a single query does not. Real embedding corpora are clustered, so
most tiles provably cannot hold a top-k row:

- **Build** (:func:`prepare_clustered` and the device/stream forms):
  balanced k-means assigns every row to one of ``T = N/tile_n`` clusters
  of capacity ``tile_n``; ``order`` permutes rows so cluster ``c`` IS
  storage tile ``c``. Per tile: the f32 centroid ``µ_c`` and a sound radius
  ``R_c ≥ max_{x∈c} ‖x − µ_c‖₂`` (slack-widened).
- **Query** (:func:`dense_topk_compact_bf16r_clustered`): by
  Cauchy-Schwarz every row of tile c scores at most
  ``U_c = q·µ_c + ‖q‖·R_c``. Each query probes its ``probe_tiles`` best
  tiles by ``U``; the batch union is scanned by the compact bf16r tier's
  kernel and tail, and the largest ``U`` over unscanned tiles joins the
  exclusion threshold, so a certified set is provably the exact top-k of
  the FULL corpus (fail-closed otherwise).

The union is scanned in place by K5 ``scan_select_v3_indirect``
(``fetch="dma"``, the default on the card) or copied and scanned by K1
(``fetch="gather"``). Every [N, d] pass of the device/stream builds runs
on the rows' device; placement (the greedy fill) and the final layout are
host work over O(N) vectors. :func:`prepare_clustered` is the host build.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.dense import NEG_INF, require_fp32, topk_desc
from trueno_rag_tpu_torch.ops.dense_tiered import (
    _BOUND_EPS,
    _BOUND_SLACK,
    _bf16_query_bounds,
    _metric_queries,
    _pad_tags,
    _pad_to,
    _tile_candidates,
    _trim_rescore_verify_compact,
)
from trueno_rag_tpu_torch.ops.kernels.scan_select import (
    BLOCK,
    SEL,
    scan_select_v3,
    scan_select_v3_indirect,
)


def _empty_layout(tile_n: int, d: int):
    """No live row: one tile of holes."""
    return (np.full(tile_n, -1, np.int32), np.zeros((1, d), np.float32), np.zeros(1, np.float32))


def _lift_order(sub_order: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """An order over the live subset ``keep`` → an order over all rows."""
    return np.where(sub_order >= 0, keep[np.clip(sub_order, 0, len(keep) - 1)], -1).astype(np.int32)


def _interleave(rows: np.ndarray, tile_n: int) -> np.ndarray:
    """In-tile positions of a tile's members sorted by centroid score:
    member j goes to block j mod nb, so score-adjacent rows (a query's
    concentrated top rows) land in distinct 128-row blocks, whose top-2
    the scan keeps."""
    nb = max(tile_n // BLOCK, 1)
    j = np.arange(len(rows))
    return (j % nb) * BLOCK + j // nb


# ---------------------------------------------------------------------------
# Build: balanced k-means → tile permutation + certified tile bounds
# ---------------------------------------------------------------------------


def prepare_clustered(
    matrix,
    tile_n: int = 4096,
    metric: str = "cosine",
    iters: int = 8,
    sample: int = 65_536,
    seed: int = 0,
    alternatives: int = 8,
    slab: int = 1 << 18,
    valid: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cluster host rows into ``T = ceil(N/tile_n)`` balanced tiles →
    ``(order [T·tile_n] int32, centroids [T, d] f32, radii [T] f32)``.

    ``order[i]`` is the original row stored at permuted position ``i``
    (-1: a hole). Apply it with :func:`apply_cluster_order` to every
    per-row array. ``radii`` are sound against the exact f32 values (f64
    evaluation, slack-widened), so certification never depends on k-means
    quality; only pruning does. Rows with ``valid`` False become holes and
    never join a tile. The clustering is Euclidean k-means whatever
    ``metric`` (cosine rows are normalized at insert, so the two agree).

    The whole build runs on the host, as in the JAX package: the [rows, T]
    products in f32 torch, the rest in numpy. The store builds with
    :func:`prepare_clustered_stream`, which keeps every [N, d] pass on the
    device."""
    m = np.asarray(matrix, dtype=np.float32)
    if valid is not None:
        keep = np.flatnonzero(np.asarray(valid, bool))
        if len(keep) == 0:
            return _empty_layout(tile_n, m.shape[1])
        if len(keep) < m.shape[0]:
            sub_order, centroids, radii = prepare_clustered(
                m[keep], tile_n=tile_n, metric=metric, iters=iters, sample=sample,
                seed=seed, alternatives=alternatives, slab=slab,
            )
            return _lift_order(sub_order, keep), centroids, radii
    n, d = m.shape
    if n == 0:
        return _empty_layout(tile_n, d)
    require_fp32()
    t = -(-n // tile_n)
    rng = np.random.default_rng(seed)

    def products(rows: np.ndarray, cent: np.ndarray) -> np.ndarray:
        return (torch.from_numpy(np.ascontiguousarray(rows)) @ torch.from_numpy(cent).T).numpy()

    # -- Lloyd's on a sample, farthest-first seeded (one seed per separated
    # clump; random seeding leaves clumps unclaimed and blows radii) -------
    s_idx = rng.choice(n, size=min(sample, n), replace=False)
    s_rows = m[s_idx]
    cent = np.zeros((t, d), dtype=np.float32)
    cent[0] = s_rows[rng.integers(len(s_rows))]
    d2 = ((s_rows - cent[0]) ** 2).sum(axis=1)
    for c in range(1, t):
        cent[c] = s_rows[int(np.argmax(d2))]
        d2 = np.minimum(d2, ((s_rows - cent[c]) ** 2).sum(axis=1))
    for _ in range(max(iters, 1)):
        # argmin ‖x − µ‖² == argmax (x·µ − ‖µ‖²/2); a plain dot is norm-biased
        scores = products(s_rows, cent) - 0.5 * (cent * cent).sum(axis=1)[None, :]
        assign = scores.argmax(axis=1)
        for c in range(t):
            members = s_rows[assign == c]
            if len(members):
                cent[c] = members.mean(axis=0)

    # -- full assignment with alternatives ----------------------------------
    n_alt = min(alternatives, t)
    top_alt = np.zeros((n, n_alt), dtype=np.int32)
    top_val = np.zeros((n, n_alt), dtype=np.float32)
    half_norm2 = 0.5 * (cent * cent).sum(axis=1)
    for lo in range(0, n, slab):
        sc = products(m[lo : lo + slab], cent) - half_norm2[None, :]
        part = np.argpartition(-sc, n_alt - 1, axis=1)[:, :n_alt]
        vals = np.take_along_axis(sc, part, axis=1)
        o = np.argsort(-vals, axis=1, kind="stable")
        top_alt[lo : lo + slab] = np.take_along_axis(part, o, axis=1)
        top_val[lo : lo + slab] = np.take_along_axis(vals, o, axis=1)
    margin = top_val[:, 0] - (top_val[:, 1] if n_alt > 1 else 0.0)
    members = _greedy_fill(top_alt, margin, t, tile_n)

    # -- final layout + sound per-tile bounds over the f32 values ----------
    order = np.full(t * tile_n, -1, dtype=np.int32)
    centroids = np.zeros((t, d), dtype=np.float32)
    radii = np.zeros(t, dtype=np.float32)
    for c in range(t):
        rows = members[c]
        if len(rows) == 0:
            continue
        mu64 = m[rows].astype(np.float64).mean(axis=0)
        centroids[c] = mu64.astype(np.float32)
        cscore = m[rows].astype(np.float64) @ mu64
        rows = rows[np.argsort(-cscore, kind="stable")]
        order[c * tile_n + _interleave(rows, tile_n)] = rows
        diff = m[rows].astype(np.float64) - centroids[c].astype(np.float64)
        r_max = float(np.sqrt((diff * diff).sum(axis=1)).max())
        radii[c] = np.float32(r_max * _BOUND_SLACK + _BOUND_EPS)
    return order, centroids, radii


def _greedy_fill(top_alt: np.ndarray, margin: np.ndarray, t: int, tile_n: int) -> list:
    """Balanced greedy fill → ``members[c]`` (int32 rows of cluster c, in
    the order they joined it). The most confident rows (largest margin,
    best − second-best score) claim a slot in their best cluster first; a
    row whose alternatives are all full spills, after every other row,
    into the lowest-numbered cluster with space.

    The same placement as the JAX package's loop, computed in runs: rows
    are taken in visit order while their first alternative with space (as
    of the run's start) does not overflow; the first row that would
    overflow a cluster ends the run and is placed on its own. Every run
    but the last ends with a cluster filling up, so there are at most
    ``t + N/run`` runs."""
    n, n_alt = top_alt.shape
    visit = np.argsort(-margin, kind="stable")
    space = np.full(t, tile_n, dtype=np.int64)
    asg = np.full(n, -1, dtype=np.int64)  # cluster per row, -1 = overflow
    chunk = 1 << 16
    i = 0
    while i < n:
        chunk = min(chunk, 1 << 16)
        rows = visit[i : i + chunk]
        alts = top_alt[rows]  # [R, n_alt]
        open_ = space[alts] > 0
        first = np.where(open_.any(axis=1), open_.argmax(axis=1), -1)
        c = np.where(first >= 0, alts[np.arange(len(rows)), np.maximum(first, 0)], -1)
        # each row's rank among the run's rows choosing its cluster
        live = c >= 0
        key = np.where(live, c, t)
        srt = np.argsort(key, kind="stable")
        ks = key[srt]
        start = np.searchsorted(ks, ks, side="left")
        rank = np.empty(len(rows), dtype=np.int64)
        rank[srt] = np.arange(len(rows)) - start
        over = live & (rank >= space[np.where(live, c, 0)])
        stop = int(np.argmax(over)) if over.any() else len(rows)
        take = c[:stop]
        ok = take >= 0
        asg[rows[:stop][ok]] = take[ok]
        np.subtract.at(space, take[ok], 1)
        i += stop
        # a run that stopped early grows back from twice its length
        chunk = 2 * chunk if stop == len(rows) else max(2 * stop, 256)
        if stop < len(rows):  # one row on its own: its cluster just filled
            r = rows[stop]
            for cc in top_alt[r]:
                if space[cc] > 0:
                    asg[r] = cc
                    space[cc] -= 1
                    break
            i += 1
    # members in joining order: placed rows by visit rank, then overflow
    rank_of = np.empty(n, dtype=np.int64)
    rank_of[visit] = np.arange(n)
    overflow = visit[asg[visit] < 0]
    if len(overflow):  # all alternatives full: any cluster with space
        slots = np.repeat(np.arange(t), space)  # lowest cluster first
        asg[overflow] = slots[: len(overflow)]
        rank_of[overflow] += n  # after every placed row
    by = np.lexsort((rank_of, asg))
    bounds = np.searchsorted(asg[by], np.arange(t + 1))
    return [by[bounds[c] : bounds[c + 1]].astype(np.int32) for c in range(t)]


def apply_cluster_order(arr, order: np.ndarray, fill=0):
    """Permute a per-row host array into the clustered layout:
    ``out[i] = arr[order[i]]`` with ``fill`` at holes; ``[N]`` or
    ``[N, d]`` → ``[len(order), ...]``."""
    arr = np.asarray(arr)
    out = np.full((len(order),) + arr.shape[1:], fill, dtype=arr.dtype)
    present = order >= 0
    out[present] = arr[order[present]]
    return out


def apply_cluster_order_device(arr: torch.Tensor, order, fill=0) -> torch.Tensor:
    """Device counterpart of :func:`apply_cluster_order`: one row gather of
    the device-resident ``arr`` into the clustered layout (holes get
    ``fill``), so the permuted matrix never visits the host."""
    order = torch.as_tensor(np.asarray(order), device=arr.device).long()
    if arr.shape[0] == 0:
        return torch.full((order.shape[0],) + tuple(arr.shape[1:]), fill, dtype=arr.dtype, device=arr.device)
    out = arr.index_select(0, order.clamp(0, arr.shape[0] - 1))
    mask = (order >= 0).view((order.shape[0],) + (1,) * (arr.dim() - 1))
    return torch.where(mask, out, torch.tensor(fill, dtype=arr.dtype, device=arr.device))


# --- device build helpers (every [rows, d] pass on the rows' device) -------


def _ff_init_device(s_rows: torch.Tensor, first: int, t: int) -> torch.Tensor:
    """Farthest-first seeding on the device (the host path's traversal);
    the argmax index stays on the device, so the loop never syncs."""
    cent = torch.zeros((t, s_rows.shape[1]), dtype=torch.float32, device=s_rows.device)
    cent[0] = s_rows[first]
    d2 = torch.sum((s_rows - cent[0]) ** 2, dim=1)
    for c in range(1, t):
        nxt = s_rows.index_select(0, torch.argmax(d2).view(1))[0]
        cent[c] = nxt
        d2 = torch.minimum(d2, torch.sum((s_rows - nxt) ** 2, dim=1))
    return cent


def _one_hot_sums(rows: torch.Tensor, asg: torch.Tensor, t: int):
    """Per-cluster (sum [t, d], count [t]) of ``rows`` as a one-hot
    product, which sums in a fixed order (a scatter-add with atomics would
    not be reproducible)."""
    oh = torch.zeros((rows.shape[0], t), dtype=torch.float32, device=rows.device)
    oh.scatter_(1, asg.long()[:, None], 1.0)  # [S, t]
    return oh.T @ rows, oh.sum(dim=0)


def _lloyd_device(s_rows: torch.Tensor, cent: torch.Tensor, t: int, iters: int) -> torch.Tensor:
    """Lloyd's on the sample, on the device: shifted-dot assignment, then
    one-hot-product centroid means; an empty cluster keeps its centroid."""
    for _ in range(iters):
        sc = s_rows @ cent.T - 0.5 * torch.sum(cent * cent, dim=1)[None, :]
        sums, cnt = _one_hot_sums(s_rows, torch.argmax(sc, dim=1), t)
        cent = torch.where(cnt[:, None] > 0, sums / torch.clamp(cnt, min=1.0)[:, None], cent)
    return cent


def _top_alternatives(sc: torch.Tensor, n_alt: int) -> torch.Tensor:
    """Indices of the ``n_alt`` largest entries per row, ordered value
    desc then index asc (``lax.top_k``, as :func:`topk_desc`) without
    sorting whole rows: ``torch.topk`` fixes the set wherever the
    ``n_alt``-th value has no tie beyond it; rows with such a tie take the
    full stable sort."""
    vals, idx = torch.topk(sc, n_alt, dim=1)
    kth = vals[:, -1:]
    tie = (sc >= kth).sum(dim=1) > n_alt
    idx, _ = torch.sort(idx, dim=1)
    v = torch.gather(sc, 1, idx)
    _, o = torch.sort(v, dim=1, descending=True, stable=True)
    idx = torch.gather(idx, 1, o)
    bad = torch.nonzero(tie).flatten()
    if bad.numel():
        idx[bad] = topk_desc(sc[bad], n_alt)[1]
    return idx


def _assign_slab_device(ms: torch.Tensor, cent: torch.Tensor, n_alt: int):
    """Top-``n_alt`` cluster alternatives of one slab of rows → (margin
    [S] f32, idx [S, n_alt]); only the margin and the ids (int16 when
    they fit) leave the device."""
    sc = ms @ cent.T - 0.5 * torch.sum(cent * cent, dim=1)[None, :]
    idx = _top_alternatives(sc, n_alt)
    vals = torch.gather(sc, 1, idx)
    margin = vals[:, 0] - (vals[:, 1] if n_alt > 1 else 0.0)
    return margin, idx.to(torch.int16 if cent.shape[0] <= 32_767 else torch.int32)


def _row_stats_slab_device(ms: torch.Tensor, cent_rows: torch.Tensor):
    """Per-row ``‖x − µ_assigned‖²`` and centroid score ``x·µ`` of one slab
    (elementwise f32, no product of unpromised summation order)."""
    diff = ms - cent_rows
    return torch.sum(diff * diff, dim=1), torch.sum(ms * cent_rows, dim=1)


# Multiplicative widening covering the device f32 evaluation of the
# per-row distance in _row_stats_slab_device: the subtraction and squares
# round once each and the d-term sum carries at worst sequential
# accumulation error, so the computed d² satisfies
# d²_fl ≥ d²_true·(1 − (d+2)·2⁻²⁴); at d = 4096 that is ≤ 2.5e-4 relative
# on d², ≤ 1.25e-4 on the radius. 5e-4 covers it 4x. (_BOUND_SLACK is
# budgeted for query-side rounding and is not borrowed here.)
_DEV_RADIUS_SLACK = 1.0 + 5e-4


def prepare_clustered_device(
    matrix: torch.Tensor,
    tile_n: int = 4096,
    metric: str = "cosine",
    iters: int = 8,
    sample: int = 65_536,
    seed: int = 0,
    alternatives: int = 8,
    slab: int = 1 << 18,
    valid=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`prepare_clustered`'s contract for a corpus already on the
    device: every [N, d] operation (seeding, Lloyd's, assignment, radii)
    runs there, and the host sees only O(N) vectors and the [T, d]
    centroids. Radii are the device f32 distances widened by
    ``_DEV_RADIUS_SLACK``, then by the host path's slack. Implemented over
    :func:`prepare_clustered_stream` with slice/gather reads of the
    resident matrix."""
    m = matrix if matrix.dtype == torch.float32 else matrix.float()
    n = m.shape[0]

    def row_source(ids: np.ndarray) -> torch.Tensor:
        ids = np.asarray(ids)
        if len(ids) and ids[0] >= 0 and ids[0] + len(ids) <= n and (np.diff(ids) == 1).all():
            return m[int(ids[0]) : int(ids[0]) + len(ids)]  # contiguous ascending run
        return m.index_select(0, torch.from_numpy(np.maximum(ids, 0).astype(np.int64)).to(m.device))

    return prepare_clustered_stream(
        row_source, n, int(m.shape[1]), tile_n=tile_n, metric=metric, iters=iters,
        sample=sample, seed=seed, alternatives=alternatives, slab=slab, valid=valid,
    )


def prepare_clustered_stream(
    row_source,
    n: int,
    d: int,
    tile_n: int = 4096,
    metric: str = "cosine",
    iters: int = 8,
    sample: int = 65_536,
    seed: int = 0,
    alternatives: int = 8,
    slab: int = 1 << 18,
    valid=None,
    recon_err: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Streaming build: the corpus comes from ``row_source(ids: np.ndarray)
    → [len(ids), d] f32 device tensor``, so the fp32 corpus never needs to
    exist anywhere (a resident matrix, host slabs, a generator keyed by row
    id, or a reconstruction from compact replicas all serve). The source
    must be a pure function of ``ids`` and tolerate repeated ids; every row
    is read once per pass (assignment, centroids, radii).

    ``recon_err`` is a sound bound on ``‖x_true − x_returned‖₂`` for an
    approximate source: the published radius covers
    ``‖x_true − µ‖ ≤ ‖x̂ − µ‖ + ‖x_true − x̂‖``, so the tile bound stays a
    true upper bound on the exact stored rows. Exact sources pass 0.

    Same ``(order, centroids, radii)`` contract and slack budget as
    :func:`prepare_clustered_device`."""
    if valid is not None:
        keep = np.flatnonzero(np.asarray(valid, bool))
        if len(keep) == 0:
            return _empty_layout(tile_n, d)
        if len(keep) < n:
            sub_order, centroids, radii = prepare_clustered_stream(
                lambda ids: row_source(keep[ids]), len(keep), d, tile_n=tile_n, metric=metric,
                iters=iters, sample=sample, seed=seed, alternatives=alternatives, slab=slab,
                recon_err=recon_err,
            )
            return _lift_order(sub_order, keep), centroids, radii
    if n == 0:
        return _empty_layout(tile_n, d)
    require_fp32()
    t = -(-n // tile_n)
    rng = np.random.default_rng(seed)

    # -- seeding + Lloyd's on a sample (on the device) ----------------------
    s_idx = np.sort(rng.choice(n, size=min(sample, n), replace=False))
    s_rows = row_source(s_idx)
    first = int(rng.integers(len(s_idx)))
    cent = _lloyd_device(s_rows, _ff_init_device(s_rows, first, t), t, max(iters, 1))
    del s_rows

    def slabs():
        for lo in range(0, n, slab):
            yield lo, row_source(np.arange(lo, min(lo + slab, n)))

    # -- full assignment with alternatives (small fetches) -----------------
    n_alt = min(alternatives, t)
    top_alt = np.zeros((n, n_alt), dtype=np.int32)
    margin = np.zeros(n, dtype=np.float32)
    for lo, rows in slabs():
        mg, idx = _assign_slab_device(rows, cent, n_alt)
        top_alt[lo : lo + slab] = idx.cpu().numpy()
        margin[lo : lo + slab] = mg.cpu().numpy()
    members = _greedy_fill(top_alt, margin, t, tile_n)

    # -- final centroids over the actual (capacity-balanced) assignment ----
    asg = np.zeros(n, dtype=np.int32)
    for c, rows in enumerate(members):
        asg[rows] = c
    asg_t = torch.from_numpy(asg).to(cent.device)
    sums = np.zeros((t, d), np.float32)
    cnt = np.zeros(t, np.float32)
    for lo, rows in slabs():
        ps, pc = _one_hot_sums(rows, asg_t[lo : lo + slab], t)
        sums += ps.cpu().numpy()
        cnt += pc.cpu().numpy()
    centroids = np.where(cnt[:, None] > 0, sums / np.maximum(cnt, 1.0)[:, None], 0.0).astype(np.float32)
    cent_t = torch.from_numpy(centroids).to(cent.device)

    # -- per-row stats against the final centroids -------------------------
    d2 = np.zeros(n, np.float32)
    cscore = np.zeros(n, np.float32)
    for lo, rows in slabs():
        pd2, pcs = _row_stats_slab_device(rows, cent_t.index_select(0, asg_t[lo : lo + slab].long()))
        d2[lo : lo + slab] = pd2.cpu().numpy()
        cscore[lo : lo + slab] = pcs.cpu().numpy()

    # -- layout (the host path's interleave) + sound radii -----------------
    order = np.full(t * tile_n, -1, dtype=np.int32)
    radii = np.zeros(t, dtype=np.float32)
    recon = float(max(recon_err, 0.0))
    for c in range(t):
        rows = members[c]
        if len(rows) == 0:
            continue
        r_max = float(np.sqrt(np.float64(d2[rows].max())))
        rows = rows[np.argsort(-cscore[rows], kind="stable")]
        order[c * tile_n + _interleave(rows, tile_n)] = rows
        radii[c] = np.float32((r_max * _DEV_RADIUS_SLACK + recon) * _BOUND_SLACK + _BOUND_EPS)
    return order, centroids, radii


# ---------------------------------------------------------------------------
# Query: probe → union → certified scan over the union
# ---------------------------------------------------------------------------


def resolve_cluster_fetch(mode: str, device) -> str:
    """A ``cluster_fetch`` value → the mechanism for rows on ``device``:
    ``"auto"`` scans in place with K5 (``"dma"``) on a CUDA device and
    copies the union (``"gather"``) on the CPU, where both run plain
    PyTorch."""
    if mode != "auto":
        return mode
    return "dma" if torch.device(device).type == "cuda" else "gather"


def _sorted_union(top_tiles: torch.Tensor, t: int, budget: int) -> torch.Tensor:
    """The sorted distinct tile ids of ``top_tiles``, padded with ``t`` to
    ``budget`` entries (``jnp.unique(size=budget, fill_value=t)``),
    without a host sync."""
    v, _ = torch.sort(top_tiles.reshape(-1))
    first = torch.ones_like(v, dtype=torch.bool)
    first[1:] = v[1:] != v[:-1]
    pos = torch.where(first, torch.cumsum(first, 0) - 1, budget)  # repeats → a spare slot
    sel = torch.full((budget + 1,), t, dtype=v.dtype, device=v.device)
    sel.scatter_(0, pos, v)  # each real slot is written by exactly one entry
    return sel[:budget]


def dense_topk_compact_bf16r_clustered(
    queries: torch.Tensor,  # [B, d] f32
    m_bf16: torch.Tensor,  # [N, d] bf16, CLUSTERED layout (apply_cluster_order)
    e_l2: torch.Tensor,  # [N] f32
    a_l2: torch.Tensor,  # [N] f32
    r_i8: torch.Tensor,  # [N, d] int8 residual correction
    r_scale: torch.Tensor,  # [N] f32
    e2_l2: torch.Tensor,  # [N] f32
    valid_mask: torch.Tensor,  # [N] bool (holes False)
    k: int,
    centroids: torch.Tensor,  # [T, d] f32
    radii: torch.Tensor,  # [T] f32
    probe_tiles: int = 16,
    row_map: Optional[torch.Tensor] = None,  # [N] int32 = the build's order
    margin_tiles: int = 32,
    metric: str = "cosine",
    tile_n: int = 4096,
    t_top: int = 8,
    tags: Optional[Tuple[torch.Tensor, ...]] = None,
    return_stats: bool = False,
    fetch: str = "gather",
    return_bounds: bool = False,
    return_candidates: bool = False,
):
    """Cluster-pruned compact tier (bf16 + int8 residual, 3 B/element) →
    (scores [B, k], rows [B, k], set_certified [B] bool).

    Scans only the batch union of each query's ``probe_tiles`` best tiles
    by ``U_c = q·µ_c + ‖q‖·R_c``; the largest ``U`` over unscanned tiles
    joins the exclusion threshold, so ``set_certified`` keeps the
    full-corpus exact-set contract (a pruning miss fails the certificate).
    ``row_map`` maps returned rows (and candidates) back to original ids;
    every other per-row input is in the clustered layout. ``tags`` filter
    as in :func:`~trueno_rag_tpu_torch.ops.dense_tiered.dense_topk_compact_bf16r`.
    ``return_bounds`` appends ``(err [B, k], rhs [B])``,
    ``return_candidates`` the containment inputs ``(cand [B, W], thr [B])``
    (non-candidates: int32 max), and ``return_stats`` the number of
    scanned tiles (a 0-d tensor).

    ``t_top`` defaults to the kernel's 8: clustered corpora concentrate
    the top-k, and a tile holding more than ``t_top`` of it fails closed.
    Tile selection is exact and every candidate is rescored (no trim):
    the union's pad slots fill candidate columns with -inf, across which
    the approximate selection's count trick would always fail closed.

    ``fetch="dma"`` scans the selected tiles in place (K5,
    ``scan_select_v3_indirect``); ``"gather"`` copies them and scans the
    copy (K1). Both give the same results."""
    if fetch not in ("gather", "dma"):
        raise InvalidConfigError(f"unknown fetch mode {fetch!r}")
    q = _metric_queries(queries, metric)
    n, d = m_bf16.shape
    bsz = q.shape[0]
    tile = max(tile_n, SEL)
    if n % tile:
        raise InvalidConfigError("the clustered layout must be tile-aligned (use the build's order)")
    t = n // tile
    if centroids.shape[0] != t or radii.shape[0] != t:
        raise InvalidConfigError(f"need {t} centroids and radii, got {centroids.shape[0]}, {radii.shape[0]}")
    dev = q.device

    # -- certified per-tile upper bounds (one [B, T] product, TF32 off) ------
    # true q·x ≤ q·µ + ‖q‖R (Cauchy-Schwarz); fl(q·µ) ≥ q·µ − acc_eps·‖q‖‖µ‖,
    # so the accumulation term enters at full strength with the ‖µ‖ factor,
    # and the slack covers the rounding of these few operations
    require_fp32()
    qn = torch.linalg.vector_norm(q, dim=1)
    mu_n = torch.linalg.vector_norm(centroids, dim=1)
    s_c = q @ centroids.T  # [B, T]
    acc_eps = float(d) * 2.0**-23
    spread = qn[:, None] * radii[None, :]
    dot_err = acc_eps * qn[:, None] * mu_n[None, :]
    u = s_c + spread + dot_err
    u = u + (torch.abs(s_c) + spread + dot_err) * (_BOUND_SLACK - 1.0) + _BOUND_EPS
    tile_live = valid_mask.view(t, tile).any(dim=1)
    u = torch.where(tile_live[None, :], u, NEG_INF)

    # -- probe set: per-query top-p, batch union, static budget ----------
    p = min(probe_tiles, t)
    _, top_tiles = topk_desc(u, p)  # [B, p]; ties: lowest tile
    budget = min(t, bsz * p)
    sel = _sorted_union(top_tiles, t, budget)  # sorted, padded with t
    sel_ok = sel < t
    ids = torch.clamp(sel, max=t - 1)
    arange_t = torch.arange(t, device=dev)
    pos = torch.searchsorted(sel, arange_t)  # sel is sorted
    scanned = (pos < budget) & (sel[torch.clamp(pos, max=budget - 1)] == arange_t)
    unscanned_bound = torch.where(scanned[None, :], NEG_INF, u).amax(dim=1)  # [B]

    qb, u_q, v_q = _bf16_query_bounds(q)
    b_pad = max(8, -(-bsz // 8) * 8)
    qb_p, u_p, v_p = (_pad_to(x, b_pad).contiguous() for x in (qb, u_q, v_q))

    if fetch == "dma":
        # K5 scans the selected tiles in place; rows come out global
        outs = scan_select_v3_indirect(
            qb_p, m_bf16, e_l2, a_l2, valid_mask.to(torch.int32), u_p, v_p,
            sel.to(torch.int32), tile_n=tile, t_top=t_top, tags=_pad_tags(tags, n, b_pad),
        )
        cand_rows, cand_vals, threshold = _tile_candidates(
            outs, b_pad, k, margin_tiles, t_top, approx_select=False
        )
    else:
        # copy the union (contiguous tile copies) and scan the copy with K1

        def gather(x):
            return x.view(t, tile, *x.shape[1:])[ids].reshape(budget * tile, *x.shape[1:])

        valid_sel = (valid_mask.view(t, tile)[ids] & sel_ok[:, None]).reshape(-1)
        tags_sel = None if tags is None else (gather(tags[0]),) + tuple(tags[1:])
        outs = scan_select_v3(
            qb_p, gather(m_bf16), gather(e_l2), gather(a_l2), valid_sel.to(torch.int32), u_p, v_p,
            t_top=t_top, tags=_pad_tags(tags_sel, budget * tile, b_pad),
        )
        cand_rows, cand_vals, threshold = _tile_candidates(
            outs, b_pad, k, margin_tiles, t_top, approx_select=False
        )
        # positional (union-local) rows → clustered-layout global rows
        real = cand_rows < budget * tile
        safe = torch.clamp(cand_rows, 0, budget * tile - 1).long()
        glob = ids[safe // tile] * tile + safe % tile
        cand_rows = torch.where(real, glob.to(cand_rows.dtype), cand_rows)

    # pruned tiles join the exclusion threshold: certify only when the k-th
    # rescored lower bound beats what any unscanned tile could hold
    threshold = torch.maximum(threshold, _pad_to(unscanned_bound, b_pad, NEG_INF))
    out = _trim_rescore_verify_compact(
        cand_rows, cand_vals, threshold, q, m_bf16, e_l2, a_l2, valid_mask, n, bsz, b_pad, k,
        rescore_rows=None, residual=(r_i8, r_scale, e2_l2), tags=tags,
        return_bounds=return_bounds, return_candidates=return_candidates,
        approx_select=False,
    )
    scores, rows, certified = out[:3]
    if row_map is not None:
        safe_r = torch.clamp(rows, 0, n - 1).long()
        rows = torch.where(rows >= 0, row_map[safe_r].to(rows.dtype), rows)
    extra = tuple(out[3:])  # (err, rhs)? + (cand, thr)?
    if return_candidates and row_map is not None:
        # the containment threshold already holds the pruned-tile bound;
        # candidates are clustered-layout rows, mapped for the host patch
        cand_out, thr_out = extra[-2], extra[-1]
        live_c = (cand_out >= 0) & (cand_out < n)
        safe_c = torch.clamp(cand_out, 0, n - 1).long()
        cand_out = torch.where(live_c, row_map[safe_c].to(cand_out.dtype), np.iinfo(np.int32).max)
        extra = extra[:-2] + (cand_out, thr_out)
    if return_stats:
        return (scores, rows, certified, *extra, sel_ok.to(torch.int32).sum())
    return (scores, rows, certified, *extra)
