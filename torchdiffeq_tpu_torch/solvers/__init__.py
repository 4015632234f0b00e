"""Solver registry (counterpart of ``torchdiffeq_tpu/solvers/__init__.py``).

The adaptive solver loop is tableau-generic, so the whole explicit adaptive tier
is here.  `rk4` exists only for the kernel route of `odeint`
(``options=dict(pallas=True, num_steps=N)``); its scan loop is ROADMAP A4.
Every other JAX method name maps to the ROADMAP item that ports it.
"""
from __future__ import annotations

from ..ops import tableaus as tb

SOLVERS = {
    'dopri8': dict(kind='adaptive', tableau=tb.DOPRI8),
    'dopri5': dict(kind='adaptive', tableau=tb.DOPRI5),
    'tsit5': dict(kind='adaptive', tableau=tb.TSIT5),
    'tsit5_le': dict(kind='adaptive', tableau=tb.TSIT5_LE),
    'bosh3': dict(kind='adaptive', tableau=tb.BOSH3),
    'fehlberg2': dict(kind='adaptive', tableau=tb.FEHLBERG2),
    'adaptive_heun': dict(kind='adaptive', tableau=tb.ADAPTIVE_HEUN),
    'rk4': dict(kind='fixed'),
}

_A4 = 'ROADMAP A4 (fixed-grid explicit tier)'
_A9 = 'ROADMAP A9 (implicit tiers)'
NOT_PORTED = {
    **{m: _A4 for m in ('euler', 'midpoint', 'heun2', 'heun3')},
    **{m: _A9 for m in ('explicit_adams', 'implicit_adams', 'fixed_adams',
                        'implicit_euler', 'implicit_midpoint', 'trapezoid',
                        'radauIIA3', 'gl4', 'radauIIA5', 'gl6', 'sdirk2',
                        'trbdf2', 'kvaerno3', 'kvaerno5', 'radau5a')},
    'scipy_solver': 'ROADMAP A10 (SciPy bridge)',
}
