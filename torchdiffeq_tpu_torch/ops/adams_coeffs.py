"""Adams-Bashforth / Adams-Moulton coefficients, generated exactly (a copy
of ``torchdiffeq_tpu/ops/adams_coeffs.py``, which needs no JAX but lives in
the JAX package; tests/test_torch_tables.py holds the two bit for bit).

The reference hard-codes integer coefficient tables to order 20
(torchdiffeq/_impl/fixed_adams.py:10-152).  We instead *derive* them from the
defining integrals with exact rational arithmetic at import time (orders up
to 12, the solver's max_order), which is both copy-free and provably
identical: the order-k Adams-Bashforth weights are

    b_j = integral_0^1 prod_{i != j} (u + i) / (j - i) du,   i, j in [0, k)

and Adams-Moulton uses nodes shifted by one (u + i - 1).  Verified against
the reference's tables in tests.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np

MIN_ORDER = 4
MAX_ORDER = 12
MAX_ITERS = 4  # corrector fixed-point iterations (reference fixed_adams.py:156)


def _poly_mul(p, q):
    out = [Fraction(0)] * (len(p) + len(q) - 1)
    for i, a in enumerate(p):
        for j, b in enumerate(q):
            out[i + j] += a * b
    return out


def _poly_integral_01(p):
    return sum(c / (i + 1) for i, c in enumerate(p))


def _adams_weights(order, shift):
    """Lagrange-basis integrals over [0, 1] with nodes at -(i + shift),
    i = 0..order-1.  shift=0 -> Bashforth (explicit), shift=-1 -> Moulton
    (implicit, first node at t1)."""
    weights = []
    for j in range(order):
        poly = [Fraction(1)]
        denom = Fraction(1)
        xj = Fraction(-(j + shift))
        for i in range(order):
            if i == j:
                continue
            xi = Fraction(-(i + shift))
            poly = _poly_mul(poly, [-xi, Fraction(1)])  # (u - xi)
            denom *= (xj - xi)
        weights.append(_poly_integral_01(poly) / denom)
    return weights


def bashforth_coefficients(order):
    """[b_0 .. b_{order-1}] multiplying [f(t0), f(t-1), ...] (newest first)."""
    return _adams_weights(order, shift=0)


def moulton_coefficients(order):
    """[m_0 .. m_{order-1}] multiplying [f(t1), f(t0), f(t-1), ...]."""
    return _adams_weights(order, shift=-1)


def _padded_table(maker, max_order):
    """(max_order + 1, max_order) float64 matrix; row k holds the order-k
    coefficients left-aligned, zero-padded."""
    table = np.zeros((max_order + 1, max_order), dtype=np.float64)
    for k in range(1, max_order + 1):
        coeffs = maker(k)
        table[k, :k] = [float(c) for c in coeffs]
    return table

# Row k of BASHFORTH[k] dotted with the newest-first f-history gives the
# order-k AB predictor increment / dt.  MOULTON[k][0] multiplies f(t1); the
# remaining entries multiply the history.
BASHFORTH = _padded_table(bashforth_coefficients, MAX_ORDER)
MOULTON = _padded_table(moulton_coefficients, MAX_ORDER + 1)
