"""The worst-case accumulation model of the tensor-core bf16 dot that the
certified scans share (``csrc/mma_bf16.cuh``: K1, K5, K10a/b, K6, K11a/b),
in numpy: its allowance, an emulation, and the crafted inputs that hold a
card to it.

The model of one ``mma.sync`` slice of at most 16 exact products: every
term aligned to the largest one's exponent and truncated toward zero to a
24-bit window, the aligned terms summed exactly, the sum truncated once to
f32. The slices' results are added in ascending column order in f32 with
round-to-nearest. Its error on a dot of width H is at most
``allowance(H) · Σ|p|`` (the header derives it), which stays within the
``H·2⁻²³·‖q‖‖t‖`` that both certificates budget for the dot
(``dense_tiered._bf16_query_bounds``, ``maxsim._scan16_fused_widths``)."""

from __future__ import annotations

import math

import numpy as np

EPS23 = 2.0**-23
SLICE = 16  # products per mma.sync m16n8k16 slice
KINDS = ("half-ulp", "ulp", "sweep", "cancel", "spread", "random")


def allowance(h: int) -> float:
    """The model's bound on |dot − exact| per unit Σ|p| at width ``h``:
    ``(min(h,16) + (ceil(h/16) − 1)/2)·2⁻²³``."""
    return (min(h, SLICE) + (math.ceil(h / SLICE) - 1) / 2.0) * EPS23


def _exponent(x: float) -> int:
    """floor(log2|x|) of a nonzero float, exactly."""
    return math.frexp(x)[1] - 1


def _truncate(x: float, e: int) -> float:
    """``x`` truncated toward zero to a multiple of ``2^(e-23)``: a 24-bit
    window whose top bit has weight ``2^e`` (exact in float64)."""
    q = 2.0 ** (e - 23)
    return math.trunc(x / q) * q


def model_slice(p: np.ndarray) -> float:
    """One slice of at most 16 exact float64 products under the model."""
    big = float(np.abs(p).max()) if p.size else 0.0
    if big == 0.0:
        return 0.0
    e = _exponent(big)
    s = math.fsum(_truncate(float(x), e) for x in p)
    return 0.0 if s == 0.0 else _truncate(s, _exponent(s))


def model_dot(q: np.ndarray, t: np.ndarray) -> np.float32:
    """``q · t`` (bf16-exact float32 vectors) under the model: the slices'
    results added into an f32 sum from +0 in ascending column order."""
    p = q.astype(np.float64) * t.astype(np.float64)
    acc = np.float32(0.0)
    for lo in range(0, p.size, SLICE):
        acc = np.float32(acc + np.float32(model_slice(p[lo:lo + SLICE])))
    return acc


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round float64 values to bf16 (nearest even), returned as float32."""
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _mantissas(rng, shape) -> np.ndarray:
    """Random bf16 significands in [1, 2)."""
    return 1.0 + rng.integers(0, 128, size=shape) / 128.0


def crafted_products(kind: str, h: int, rng) -> np.ndarray:
    """One row of ``h`` float64 products, each a bf16 value, built to
    expose the accumulation: per 16-column slice one large term at a random
    column (of one binade and sign for the whole row, so that the slices'
    truncations add up) with, beside it,
    - ``half-ulp``: 15 terms just under half an ulp of it (2⁻²⁴·(2 − 2⁻⁷)
      times its binade);
    - ``ulp``: 15 terms just under one ulp of it;
    - ``sweep``: 15 terms of exactly 2⁻ᵏ of it, k drawn from 20..34 (the
      window a card keeps shows as the largest k that still counts);
    - ``cancel``: pairs of opposite sign that nearly cancel;
    - ``spread``: significands and signs at random over exponents -30..30;
    - ``random``: Gaussian values rounded to bf16."""
    out = np.zeros(h)
    e = int(rng.integers(-4, 5))
    sign = rng.choice([-1.0, 1.0])
    for lo in range(0, h, SLICE):
        w = min(SLICE, h - lo)
        if kind == "random":
            out[lo:lo + w] = rng.standard_normal(w)
            continue
        if kind == "spread":
            out[lo:lo + w] = _mantissas(rng, w) * 2.0 ** rng.integers(-30, 31, size=w) * rng.choice([-1.0, 1.0], w)
            continue
        if kind == "cancel":
            x = _mantissas(rng, w) * 2.0 ** rng.integers(-3, 4, size=w)
            sign = np.where(np.arange(w) % 2 == 0, 1.0, -1.0)
            nudge = 1.0 - (np.arange(w) % 2) * rng.integers(0, 3, size=w) / 128.0
            x[1::2] = x[0::2][: w // 2]
            out[lo:lo + w] = x * sign * nudge
            continue
        small = {
            "half-ulp": 2.0**-25 * (2.0 - 2.0**-7),
            "ulp": 2.0**-24 * (2.0 - 2.0**-7),
            "sweep": 2.0 ** -float(rng.integers(20, 35)),
        }[kind]
        vals = np.full(w, small * 2.0**e * sign)
        vals[int(rng.integers(0, w))] = (1.0 if kind == "sweep" else _mantissas(rng, 1)[0]) * 2.0**e * sign
        out[lo:lo + w] = vals
    return _bf16(out).astype(np.float64)


def crafted_pairs(h: int, n: int, seed: int, n_q: int = 0):
    """``n`` crafted rows of width ``h`` and ``n_q`` queries (``n`` when 0)
    as bf16-exact float32 arrays ``(q [n_q, h], t [n, h], kinds [n])``: row
    i paired with query ``i % n_q`` gives a crafted product row of kind
    ``KINDS[i % 6]`` (:func:`crafted_products`). Queries are ±2ᵃ per column
    (a in -4..4), so the products are exact and every other pairing of a
    query with a row is a valid dot too, with its exponents shuffled."""
    n_q = n_q or n
    rng = np.random.default_rng(seed)
    q = rng.choice([-1.0, 1.0], size=(n_q, h)) * 2.0 ** rng.integers(-4, 5, size=(n_q, h))
    kinds = np.array([KINDS[i % len(KINDS)] for i in range(n)])
    p = np.stack([crafted_products(k, h, rng) for k in kinds])
    return q.astype(np.float32), (p / q[np.arange(n) % n_q]).astype(np.float32), kinds
