"""Solve statistics and error codes (counterpart of
``torchdiffeq_tpu/solvers/solution.py``).

The codes and their meaning are the JAX package's.  The host-loop solver
counts on the host, so the counters of one solve are Python ints; the
per-sample solves (``parallel/batched.py``) hold one counter per sample in
an int32 tensor.
"""
from __future__ import annotations

from typing import Any, NamedTuple

# Error codes (0 == success).
OK = 0
ERR_DT_UNDERFLOW = 1     # reference: `assert t0 + dt > t0` (rk_common.py:286)
ERR_NONFINITE_STATE = 2  # reference: `assert torch.isfinite(y0).all()` (rk_common.py:287)
ERR_MAX_NUM_STEPS = 3    # reference: `assert n_steps < max_num_steps` (rk_common.py:245)
ERR_IMPLICIT_NO_CONVERGENCE = 4  # reference: warning (rk_common.py:461-462)
ERR_SEGMENT_OVERFLOW = 5         # replay/dense recording buffer exhausted

ERROR_MESSAGES = {
    OK: "success",
    ERR_DT_UNDERFLOW: "underflow in dt",
    ERR_NONFINITE_STATE: "non-finite values in state `y`",
    ERR_MAX_NUM_STEPS: "max_num_steps exceeded",
    ERR_IMPLICIT_NO_CONVERGENCE: "implicit solve did not converge",
    ERR_SEGMENT_OVERFLOW: ("recording buffer exhausted — raise "
                           "max_segments (replay/dense capacity)"),
}


class Stats(NamedTuple):
    """Telemetry for one solve.  `nfe` counts vector-field evaluations
    (the reference tests' convention, tests/problems.py:41); `final_dt` is
    the controller's proposed next step at the end of an adaptive solve
    (0 for fixed-grid kinds)."""
    nfe: Any
    n_steps: Any
    n_accepted: Any
    n_rejected: Any
    error_code: Any
    final_dt: Any

    @staticmethod
    def make(nfe=0, n_steps=0, n_accepted=0, n_rejected=0, error_code=OK,
             final_dt=0.0):
        return Stats(nfe, n_steps, n_accepted, n_rejected, error_code,
                     final_dt)

    def raise_if_error(self):
        """Raise on a nonzero error code (the reference's asserts,
        rk_common.py:286-287).  For a single solve only."""
        code = int(self.error_code)
        if code != OK:
            raise RuntimeError(
                f"ODE solve failed: {ERROR_MESSAGES.get(code, code)} "
                f"(error_code={code}, after {int(self.n_steps)} steps)")
        return self


# The implicit tiers' work since the last `reset_implicit_counts` (what no
# `Stats` field holds): Broyden and Newton iterations, linear solves and
# Jacobians of the stage solves, their host reads, and the Adams
# corrector's steps, those of them that converged and its host reads.
IMPLICIT_COUNTS = dict(iterations=0, linear_solves=0, jacobians=0,
                       host_reads=0, corrector_steps=0,
                       corrector_converged=0)


def reset_implicit_counts():
    for k in IMPLICIT_COUNTS:
        IMPLICIT_COUNTS[k] = 0
