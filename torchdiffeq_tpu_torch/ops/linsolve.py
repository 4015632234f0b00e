"""Dense linear solves of the implicit tiers' stage systems (counterpart of
``torchdiffeq_tpu/ops/linsolve.py``).

This is ``torch.linalg.solve`` and nothing else (its ``_ex`` form: LAPACK
on the CPU, cuSOLVER's LU on the card, in the state dtype).  The ``_ex``
form does not check the factorisation, which would read it back to the
host after every solve: as with ``jnp.linalg.solve``, a singular matrix
gives a step that is not finite, and the root solvers stop on it.  The
JAX package's module adds a float32 LU with float64 iterative refinement
because the TPU has no float64 LU; the H100 has one, so no refinement and
no TPU path are ported (ROADMAP, "Not to port").
"""
from __future__ import annotations

import torch


def solve(a, b):
    """``a^{-1} b`` for a square `a` (m, m) and a vector `b` (m,), or for a
    batch of them, (B, m, m) and (B, m): one batched LU (the per-sample
    route's stage solves, JAX's solve under vmap)."""
    return torch.linalg.solve_ex(a, b)[0]
