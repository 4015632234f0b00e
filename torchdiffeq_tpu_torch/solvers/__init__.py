"""Solver registry (counterpart of ``torchdiffeq_tpu/solvers/__init__.py``).

The whole explicit tier is here: the adaptive methods on the tableau-generic
host loop (`adaptive_rk.py`) and the fixed-grid methods on theirs
(`fixed_grid.py`; `rk4` also has the fused kernel route of `odeint`,
``options=dict(pallas=True, num_steps=N)``).  The Adams, implicit and SciPy
method names map to the ROADMAP item that ports them.
"""
from __future__ import annotations

from ..ops import tableaus as tb
from .fixed_grid import FIXED_STEP_METHODS

SOLVERS = {
    'dopri8': dict(kind='adaptive', tableau=tb.DOPRI8),
    'dopri5': dict(kind='adaptive', tableau=tb.DOPRI5),
    'tsit5': dict(kind='adaptive', tableau=tb.TSIT5),
    'tsit5_le': dict(kind='adaptive', tableau=tb.TSIT5_LE),
    'bosh3': dict(kind='adaptive', tableau=tb.BOSH3),
    'fehlberg2': dict(kind='adaptive', tableau=tb.FEHLBERG2),
    'adaptive_heun': dict(kind='adaptive', tableau=tb.ADAPTIVE_HEUN),
    **{m: dict(kind='fixed', method=FIXED_STEP_METHODS[m])
       for m in ('euler', 'midpoint', 'heun2', 'heun3', 'rk4')},
}

_A9 = 'ROADMAP A9 (implicit tiers)'
NOT_PORTED = {
    **{m: _A9 for m in ('explicit_adams', 'implicit_adams', 'fixed_adams',
                        'implicit_euler', 'implicit_midpoint', 'trapezoid',
                        'radauIIA3', 'gl4', 'radauIIA5', 'gl6', 'sdirk2',
                        'trbdf2', 'kvaerno3', 'kvaerno5', 'radau5a')},
    'scipy_solver': 'ROADMAP A10 (SciPy bridge)',
}
