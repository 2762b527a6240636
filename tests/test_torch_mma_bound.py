"""The worst-case accumulation model of the tensor-core bf16 dot that the
certified scans share (``csrc/mma_bf16.cuh``, ``ops/kernels/mma_model.py``),
emulated in numpy: a 24-bit truncated alignment window per 16-product mma
slice, one final truncation, and round-to-nearest f32 adds of the slices.
On seeded random and crafted inputs (the card probe's kinds) its error
stays within the model's allowance, the crafted inputs reach a large part
of it, and the allowance stays within the dot's share of both certificate
budgets, read from the port's own bound functions so that a later change
of either budget breaks this test."""

import math

import numpy as np
import pytest
import torch

from trueno_rag_tpu_torch.ops import dense_tiered as dt
from trueno_rag_tpu_torch.ops import maxsim as pm
from trueno_rag_tpu_torch.ops.kernels import mma_model as mm

WIDTHS = [1, 8, 15, 16, 17, 33, 100, 128, 384]
ROUND_TRIP = 1e-12  # float64 rounding of reading a budget back through its slack and floor


def _dense_dot_budget(h: int) -> float:
    """acc_eps of ``_bf16_query_bounds`` per unit ‖q‖‖row‖: v_q of a
    bf16-exact unit query is acc_eps·SLACK + EPS."""
    q = torch.zeros(1, h, dtype=torch.float64)
    q[0, 0] = 1.0
    _, _, v = dt._bf16_query_bounds(q)
    return (v[0].item() - dt._BOUND_EPS) / dt._BOUND_SLACK


def _maxsim_dot_budget(h: int) -> float:
    """The dot's share of ``_scan16_fused_widths`` per unit C1·n_max: its
    width at Lq = 0 with C1 = n_max = 1 and every other term 0."""
    one, zero = torch.ones(1, dtype=torch.float64), torch.zeros(1, dtype=torch.float64)
    w = pm._scan16_fused_widths(zero, one, zero, zero, one, h, 0)
    return (w[0, 0].item() - pm._BOUND_EPS) / pm._BOUND_SLACK


def _ratio(q: np.ndarray, t: np.ndarray) -> float:
    """|model − exact| over the model's allowance for one dot."""
    p = q.astype(np.float64) * t.astype(np.float64)
    mass = math.fsum(np.abs(p))
    err = abs(float(mm.model_dot(q, t)) - math.fsum(p))
    return 0.0 if err == 0.0 else err / (mm.allowance(q.size) * mass)


@pytest.mark.parametrize("h", WIDTHS)
def test_model_error_within_allowance_within_both_budgets(h):
    dense, maxsim = _dense_dot_budget(h), _maxsim_dot_budget(h)
    assert dense == pytest.approx(h * 2.0**-23, rel=ROUND_TRIP)
    assert maxsim == pytest.approx(h * 2.0**-23, rel=ROUND_TRIP)
    assert mm.allowance(h) <= min(dense, maxsim) * (1.0 + ROUND_TRIP)

    q, t, _ = mm.crafted_pairs(h, 48, seed=h)
    rng = np.random.default_rng(1000 + h)
    crafted = [_ratio(q[i], t[i]) for i in range(len(q))]
    crossed = [_ratio(q[i], t[j]) for i, j in rng.integers(0, len(q), size=(48, 2))]
    unit = rng.standard_normal((32, 2, h))
    unit /= np.linalg.norm(unit, axis=2, keepdims=True)
    unit = torch.from_numpy(unit).to(torch.bfloat16).float().numpy()
    rand = [_ratio(a, b) for a, b in unit]
    worst = max(crafted + crossed + rand)
    assert worst <= 1.0, f"model error {worst} x its allowance at H = {h}"
    if h >= 2:  # the crafted rows reach a large part of the allowance, so a card that keeps fewer bits fails the probe
        assert max(crafted) >= 0.25, max(crafted)
    else:  # one product is exact
        assert worst == 0.0


def test_allowance_is_the_single_slice_bound_up_to_16_and_below_the_width_past_it():
    for h in range(1, 17):
        assert mm.allowance(h) == h * 2.0**-23
    for h in range(17, 1025):
        assert mm.allowance(h) <= (h - 0.5) * 2.0**-23


def test_crafted_pairs_are_bf16_exact_and_their_products_exact():
    q, t, kinds = mm.crafted_pairs(100, 12, seed=0)
    for x in (q, t):
        assert np.array_equal(torch.from_numpy(x).to(torch.bfloat16).float().numpy(), x)
    assert set(kinds) == set(mm.KINDS)
    p = q.astype(np.float64) * t.astype(np.float64)
    assert np.array_equal(p.astype(np.float32).astype(np.float64), p)


def test_model_slice_truncates_what_falls_out_of_the_window():
    one_ulp = 2.0**-23
    # 1 + 15 terms just under one ulp: each falls out of the 24-bit window
    p = np.array([1.0] + [one_ulp * (1 - 2.0**-8)] * 15)
    assert mm.model_slice(p) == 1.0
    # terms of exactly one ulp stay
    p = np.array([1.0] + [one_ulp] * 15)
    assert mm.model_slice(p) == 1.0 + 15 * one_ulp
