"""Rank fusion strategies — host implementation and config type.

Exact behavioral mirror of the reference's ``FusionStrategy``
(reference: fusion.rs:8-224): RRF (default, k=60), Linear, Convex
(delegates to Linear), DBSF, Union, Intersection, including the
normalizer edge cases (min-max of an all-equal list → all 1.0,
fusion.rs:183-202; z-score with σ=0 → all 0.0, fusion.rs:204-224).

This host path is the correctness oracle and the fallback for exotic id
types; the hot path is :func:`trueno_rag_tpu_torch.ops.fusion.fuse_topk`,
which applies identical math to padded candidate arrays on device.
Ordering here is deterministic — (score desc, id asc) — a total order
the reference does not guarantee (it uses an unstable sort); the device
path uses the same rule with integer rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

from trueno_rag_tpu_torch.errors import InvalidConfigError

ScoredList = Sequence[Tuple[Hashable, float]]


def _minmax(scores: List[float]) -> List[float]:
    if not scores:
        return []
    mn, mx = min(scores), max(scores)
    if mx == mn:
        return [1.0] * len(scores)
    return [(s - mn) / (mx - mn) for s in scores]


def _zscore(scores: List[float]) -> List[float]:
    if not scores:
        return []
    mean = sum(scores) / len(scores)
    var = sum((s - mean) ** 2 for s in scores) / len(scores)
    std = var**0.5
    if std == 0.0:
        return [0.0] * len(scores)
    return [(s - mean) / std for s in scores]


def _sorted_desc(acc: Dict[Hashable, float]) -> List[Tuple[Hashable, float]]:
    return sorted(acc.items(), key=lambda kv: (-kv[1], kv[0]))


@dataclass
class FusionStrategy:
    """Serializable fusion config + host ``fuse``.

    ``kind`` ∈ {rrf, linear, convex, dbsf, union, intersection}.
    Defaults to RRF(k=60) like the reference.
    """

    kind: str = "rrf"
    params: Dict[str, Any] = field(default_factory=lambda: {"k": 60.0})

    # -- constructors -------------------------------------------------------

    @classmethod
    def rrf(cls, k: float = 60.0) -> "FusionStrategy":
        return cls("rrf", {"k": k})

    @classmethod
    def linear(cls, dense_weight: float = 0.5) -> "FusionStrategy":
        return cls("linear", {"dense_weight": dense_weight})

    @classmethod
    def convex(cls, alpha: float = 0.5) -> "FusionStrategy":
        return cls("convex", {"alpha": alpha})

    @classmethod
    def dbsf(cls) -> "FusionStrategy":
        return cls("dbsf", {})

    @classmethod
    def union(cls) -> "FusionStrategy":
        return cls("union", {})

    @classmethod
    def intersection(cls) -> "FusionStrategy":
        return cls("intersection", {})

    # -- the single scalar parameter used by the device kernel --------------

    @property
    def device_param(self) -> float:
        if self.kind == "rrf":
            return float(self.params.get("k", 60.0))
        if self.kind == "linear":
            # honor the same 'alpha' fallback the host fuse() accepts —
            # the device kernel must fuse with the SAME weight or the
            # documented host/device parity silently breaks
            return float(
                self.params.get("dense_weight", self.params.get("alpha", 0.5))
            )
        if self.kind == "convex":
            return float(self.params.get("alpha", 0.5))
        return 0.0

    def __post_init__(self) -> None:
        if self.kind not in ("rrf", "linear", "convex", "dbsf", "union", "intersection"):
            raise InvalidConfigError(f"unknown fusion kind: {self.kind!r}")

    # -- host fusion ---------------------------------------------------------

    def fuse(self, dense: ScoredList, sparse: ScoredList) -> List[Tuple[Hashable, float]]:
        """Fuse two ranked (id, score) lists → fused ranked list.

        Exact reference semantics per variant; see module docstring.
        """
        if self.kind == "rrf":
            k = float(self.params.get("k", 60.0))
            acc: Dict[Hashable, float] = {}
            for lst in (dense, sparse):
                for rank, (cid, _score) in enumerate(lst):
                    acc[cid] = acc.get(cid, 0.0) + 1.0 / (k + rank + 1.0)
            return _sorted_desc(acc)

        if self.kind in ("linear", "convex"):
            w = float(
                self.params.get("dense_weight", self.params.get("alpha", 0.5))
            )
            nd = _minmax([s for _, s in dense])
            ns = _minmax([s for _, s in sparse])
            acc = {}
            for (cid, _), s in zip(dense, nd):
                acc[cid] = acc.get(cid, 0.0) + w * s
            for (cid, _), s in zip(sparse, ns):
                acc[cid] = acc.get(cid, 0.0) + (1.0 - w) * s
            return _sorted_desc(acc)

        if self.kind == "dbsf":
            zd = _zscore([s for _, s in dense])
            zs = _zscore([s for _, s in sparse])
            acc = {}
            for (cid, _), s in zip(dense, zd):
                acc[cid] = acc.get(cid, 0.0) + s
            for (cid, _), s in zip(sparse, zs):
                acc[cid] = acc.get(cid, 0.0) + s
            return _sorted_desc(acc)

        if self.kind == "union":
            # Dense entries keep (score, rank); sparse fills gaps at rank
            # offset |dense|; output ordered by rank, original scores.
            seen = {cid for cid, _ in dense}
            out = list(dense)
            out.extend((cid, s) for cid, s in sparse if cid not in seen)
            return out

        if self.kind == "intersection":
            sparse_map = dict(sparse)
            acc = {
                cid: (s + sparse_map[cid]) / 2.0
                for cid, s in dense
                if cid in sparse_map
            }
            return _sorted_desc(acc)

        raise InvalidConfigError(f"unknown fusion kind: {self.kind!r}")

    # -- N-way fusion ---------------------------------------------------------

    def resolve_weights(self, n: int,
                        weights: Optional[Sequence[float]] = None) -> List[float]:
        """Per-list weights for N-way Linear/Convex fusion.

        Priority: explicit ``weights`` argument > a ``weights`` entry in
        ``params`` > the two-list reference rule ``[w, 1-w]`` (with
        ``w`` = dense_weight/alpha) > uniform ``1/n``. RRF/DBSF/Union/
        Intersection are rank- or z-based and take weight 1.0 per list.
        """
        if weights is not None:
            if len(weights) != n:
                raise InvalidConfigError(
                    f"got {len(weights)} fusion weights for {n} lists"
                )
            return [float(x) for x in weights]
        if self.kind in ("linear", "convex"):
            stored = self.params.get("weights")
            if stored is not None:
                if len(stored) != n:
                    raise InvalidConfigError(
                        f"configured {len(stored)} fusion weights for {n} lists"
                    )
                return [float(x) for x in stored]
            w = float(self.params.get("dense_weight", self.params.get("alpha", 0.5)))
            if n == 2:
                return [w, 1.0 - w]
            return [1.0 / n] * n
        return [1.0] * n

    def fuse_many(self, lists: Sequence[ScoredList],
                  weights: Optional[Sequence[float]] = None
                  ) -> List[Tuple[Hashable, float]]:
        """Fuse N ranked (id, score) lists → one fused ranked list.

        Generalizes the reference's two-list ``fuse`` (fusion.rs:39-224)
        to any number of sources (dense + BM25 + learned-sparse + …);
        ``fuse_many([dense, sparse])`` is exactly ``fuse(dense, sparse)``
        for every variant. Semantics per variant:

        - rrf: score(id) = Σ over lists 1/(k + rank + 1)
        - linear/convex: per-list min-max normalize, weighted sum
          (see :meth:`resolve_weights`)
        - dbsf: per-list z-score, sum
        - union: lists in priority order; entries of list j are kept
          unless their id appeared in any EARLIER list; original scores
        - intersection: ids present in ALL lists; score = mean over lists
        """
        n = len(lists)
        if n == 0:
            return []

        if self.kind == "rrf":
            k = float(self.params.get("k", 60.0))
            acc: Dict[Hashable, float] = {}
            for lst in lists:
                for rank, (cid, _score) in enumerate(lst):
                    acc[cid] = acc.get(cid, 0.0) + 1.0 / (k + rank + 1.0)
            return _sorted_desc(acc)

        if self.kind in ("linear", "convex"):
            ws = self.resolve_weights(n, weights)
            acc = {}
            for lst, w in zip(lists, ws):
                norm = _minmax([s for _, s in lst])
                for (cid, _), s in zip(lst, norm):
                    acc[cid] = acc.get(cid, 0.0) + w * s
            return _sorted_desc(acc)

        if self.kind == "dbsf":
            acc = {}
            for lst in lists:
                z = _zscore([s for _, s in lst])
                for (cid, _), s in zip(lst, z):
                    acc[cid] = acc.get(cid, 0.0) + s
            return _sorted_desc(acc)

        if self.kind == "union":
            # Exclusion is vs EARLIER lists only (within-list duplicates
            # are kept, matching the two-list reference exactly).
            out: List[Tuple[Hashable, float]] = []
            seen_earlier: set = set()
            for lst in lists:
                out.extend((cid, s) for cid, s in lst if cid not in seen_earlier)
                seen_earlier |= {cid for cid, _ in lst}
            return out

        if self.kind == "intersection":
            maps = [dict(lst) for lst in lists[1:]]
            acc = {}
            for cid, s in lists[0]:
                if all(cid in m for m in maps):
                    acc[cid] = (s + sum(m[cid] for m in maps)) / float(n)
            return _sorted_desc(acc)

        raise InvalidConfigError(f"unknown fusion kind: {self.kind!r}")

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FusionStrategy":
        return cls(kind=d["kind"], params=dict(d.get("params", {})))
