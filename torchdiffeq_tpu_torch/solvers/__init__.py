"""Solver registry (counterpart of ``torchdiffeq_tpu/solvers/__init__.py``).

Every JAX method is here, with JAX's kinds: 'adaptive' (the
tableau-generic host loop, `adaptive_rk.py`; kvaerno3, kvaerno5 and
radau5a through its implicit step functions, `adaptive_implicit.py`),
'fixed' (`fixed_grid.py`; `rk4` also has the fused kernel route of
`odeint`, ``options=dict(pallas=True, num_steps=N)``), 'adams'
(`adams.py`), 'firk' and 'dirk' (`fixed_grid_implicit.py`), the last three
on the fixed-grid loop, and 'scipy' (`scipy_wrapper.py`, SciPy's
``solve_ivp`` on the host).
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
    'explicit_adams': dict(kind='adams', implicit=False),
    'implicit_adams': dict(kind='adams', implicit=True),
    'implicit_euler': dict(kind='firk', tableau=tb.IMPLICIT_EULER),
    'implicit_midpoint': dict(kind='firk', tableau=tb.IMPLICIT_MIDPOINT),
    'trapezoid': dict(kind='firk', tableau=tb.TRAPEZOID),
    'radauIIA3': dict(kind='firk', tableau=tb.RADAU_IIA_3),
    'gl4': dict(kind='firk', tableau=tb.GAUSS_LEGENDRE_4),
    'radauIIA5': dict(kind='firk', tableau=tb.RADAU_IIA_5),
    'gl6': dict(kind='firk', tableau=tb.GAUSS_LEGENDRE_6),
    'sdirk2': dict(kind='dirk', tableau=tb.SDIRK2),
    'trbdf2': dict(kind='dirk', tableau=tb.TRBDF2),
    'kvaerno3': dict(kind='adaptive', tableau=tb.KVAERNO3),
    'kvaerno5': dict(kind='adaptive', tableau=tb.KVAERNO5),
    'radau5a': dict(kind='adaptive', tableau=tb.RADAU5A),
    # the reference's alias
    'fixed_adams': dict(kind='adams', implicit=True),
    'scipy_solver': dict(kind='scipy'),
}

# differentiated through the fixed-grid loop by autograd (JAX
# DIRECT_DIFF_KINDS); the adaptive kind takes the continuous adjoint
DIRECT_DIFF_KINDS = frozenset({'fixed', 'adams', 'firk', 'dirk'})

def needs_jacobian(method):
    """Whether `method` solves stage systems, whose Newton iterations and
    implicit-function gradients take the field's Jacobian."""
    spec = SOLVERS[method]
    return spec['kind'] in ('firk', 'dirk') or (
        spec['kind'] == 'adaptive' and spec['tableau'].implicit)
