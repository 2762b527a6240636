"""The comparison that decides ``correct``.

Each answer is a query's ranked list of (corpus row, score, chunk text).
Against the reference's float64 scores ``S [B, N]`` of the same queries:

- ``bad_answers``: queries with fewer than ``k`` results, a row twice, or
  a chunk whose id or text is not its row's (exact: limit 0);
- ``score_gap``: the widest gap between a score the program reports and
  the reference's score of the same row;
- ``rank_gap``: the widest gap between the reference's i-th best score
  and its score of the program's i-th row (0 when the program ranks as
  the reference does, small at near-ties, large for a missed row).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def readings(answers, scores_ref: torch.Tensor, ref_top: torch.Tensor, k: int, texts) -> dict:
    """``answers``: per query a list of ``(row, score, text)``;
    ``scores_ref [B, N]`` float64; ``ref_top [B, k]`` the reference's best
    scores (desc) → ``{"bad_answers", "score_gap", "rank_gap"}``."""
    b = len(answers)
    rows = np.full((b, k), -1, np.int64)
    got = np.zeros((b, k), np.float64)
    bad = 0
    for i, ans in enumerate(answers):
        r = [a[0] for a in ans[:k]]
        ok = (len(ans) == k and len(set(r)) == k
              and all(0 <= a[0] < len(texts) and a[2] == texts[a[0]] for a in ans))
        if not ok:
            bad += 1
            continue
        rows[i] = r
        got[i] = [a[1] for a in ans]
    live = torch.from_numpy(rows >= 0).to(scores_ref.device)
    if not bool(live.any()):
        return {"bad_answers": bad, "score_gap": math.inf, "rank_gap": math.inf}
    at = torch.gather(scores_ref, 1, torch.from_numpy(np.maximum(rows, 0)).to(scores_ref.device))
    got_t = torch.from_numpy(got).to(scores_ref.device)
    score_gap = torch.where(live, (got_t - at).abs(), 0.0).amax().item()
    rank_gap = torch.where(live, (ref_top[:, :k] - at).abs(), 0.0).amax().item()
    return {"bad_answers": bad, "score_gap": score_gap, "rank_gap": rank_gap}


def merge(parts) -> dict:
    """Readings of several batches → the worst of each."""
    out = {}
    for p in parts:
        for key, v in p.items():
            out[key] = v if key not in out else (out[key] + v if key == "bad_answers" else max(out[key], v))
    return out


def verdict(read: dict, limits: dict) -> bool:
    """True when every reading is within its limit (NaN never is)."""
    return all(read[name] <= limit for name, limit in limits.items())
