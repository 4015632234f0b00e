"""The port's tables equal the JAX package's, and the port never imports JAX."""
import subprocess
import sys
import os

import numpy as np
import pytest

import torchdiffeq_tpu.ops.tableaus as jtab
import torchdiffeq_tpu.solvers.solution as jsol
import torchdiffeq_tpu_torch.ops.tableaus as ttab
import torchdiffeq_tpu_torch.solvers.solution as tsol
from torchdiffeq_tpu_torch.solvers import SOLVERS
from torchdiffeq_tpu_torch.ops.kernels import PER_LANE_METHODS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXPLICIT = ['DOPRI5', 'DOPRI8', 'TSIT5', 'TSIT5_LE', 'BOSH3', 'FEHLBERG2',
            'ADAPTIVE_HEUN']
IMPLICIT = ['IMPLICIT_EULER', 'IMPLICIT_MIDPOINT', 'TRAPEZOID',
            'GAUSS_LEGENDRE_4', 'GAUSS_LEGENDRE_6', 'RADAU_IIA_3',
            'RADAU_IIA_5', 'SDIRK2', 'TRBDF2', 'KVAERNO3', 'KVAERNO5',
            'RADAU5A']


@pytest.mark.parametrize("name", EXPLICIT + IMPLICIT)
def test_tableau_equals_jax(name):
    """Bit-for-bit equal tables (exact comparison: they are the same
    published constants written the same way), with the same `implicit`
    and `sdirk` flags."""
    a, b = getattr(jtab, name), getattr(ttab, name)
    for field in ('alpha', 'beta', 'c_sol', 'c_error', 'c_mid'):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=f"{name}.{field}")
    assert a.order == b.order
    assert a.is_fsal == b.is_fsal
    assert a.n_stages == b.n_stages
    assert (a.implicit, a.sdirk) == (b.implicit, b.sdirk)
    assert b.implicit == (name in IMPLICIT)


def test_adams_coefficients_equal_jax():
    """The Bashforth and Moulton tables and the order and iteration limits,
    bit for bit."""
    import torchdiffeq_tpu.ops.adams_coeffs as jac
    import torchdiffeq_tpu_torch.ops.adams_coeffs as tac
    for name in ('BASHFORTH', 'MOULTON'):
        np.testing.assert_array_equal(getattr(jac, name), getattr(tac, name))
    assert (jac.MIN_ORDER, jac.MAX_ORDER, jac.MAX_ITERS) == \
        (tac.MIN_ORDER, tac.MAX_ORDER, tac.MAX_ITERS)


def test_tsit5_keeps_reference_weight_swap():
    """tsit5 keeps the reference's swapped weight pair; tsit5_le is the
    FSAL local-extrapolation variant (COVERAGE.md, "Known deviations")."""
    assert not ttab.TSIT5.is_fsal
    assert ttab.TSIT5_LE.is_fsal
    np.testing.assert_array_equal(ttab.TSIT5_LE.c_sol[:-1], ttab.TSIT5.beta[-1])


def test_error_codes_and_stats_fields_equal_jax():
    for name in ('OK', 'ERR_DT_UNDERFLOW', 'ERR_NONFINITE_STATE',
                 'ERR_MAX_NUM_STEPS', 'ERR_IMPLICIT_NO_CONVERGENCE',
                 'ERR_SEGMENT_OVERFLOW'):
        assert getattr(jsol, name) == getattr(tsol, name), name
    assert jsol.ERROR_MESSAGES == tsol.ERROR_MESSAGES
    assert jsol.Stats._fields == tsol.Stats._fields


@pytest.mark.parametrize("code", [1, 2, 3])
def test_raise_if_error_matches_jax(code):
    """A failed solve raises the JAX package's message; success passes."""
    ok = tsol.Stats.make(n_steps=4)
    assert ok.raise_if_error() is ok
    messages = []
    for sol in (jsol, tsol):
        with pytest.raises(RuntimeError) as info:
            sol.Stats.make(n_steps=6, error_code=code).raise_if_error()
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    assert tsol.ERROR_MESSAGES[code] in messages[1]


def test_registry_covers_every_jax_method():
    """Every JAX method name is ported, with JAX's kind."""
    from torchdiffeq_tpu.solvers import (SOLVERS as JAX_SOLVERS,
                                         DIRECT_DIFF_KINDS)
    from torchdiffeq_tpu_torch.solvers import DIRECT_DIFF_KINDS as TORCH_DDK
    assert set(JAX_SOLVERS) == set(SOLVERS)
    for m, spec in SOLVERS.items():
        jspec = JAX_SOLVERS[m]
        assert spec['kind'] == jspec['kind'], m
        if 'implicit' in spec:
            assert spec['implicit'] == jspec['implicit'], m
        if 'tableau' in spec:       # the table of the same name
            assert jspec['tableau'] is getattr(
                jtab, _tableau_name(spec['tableau'])), m
    assert TORCH_DDK == DIRECT_DIFF_KINDS
    for m in PER_LANE_METHODS:
        assert SOLVERS[m]['kind'] == 'adaptive'


def _tableau_name(tab):
    return next(n for n in EXPLICIT + IMPLICIT if getattr(ttab, n) is tab)


def test_import_leaves_jax_out():
    """`import torchdiffeq_tpu_torch` (its kernel module, the tracer, the
    event and dense-output modules, the Adams and implicit tiers, every
    example) never loads JAX, optax or the JAX package; checked in a fresh
    interpreter."""
    code = ("import sys; import torchdiffeq_tpu_torch, "
            "torchdiffeq_tpu_torch.ops.kernels, torchdiffeq_tpu_torch.models, "
            "torchdiffeq_tpu_torch.events, torchdiffeq_tpu_torch.dense, "
            "torchdiffeq_tpu_torch.ops._build, "
            "torchdiffeq_tpu_torch.ops.adams_coeffs, "
            "torchdiffeq_tpu_torch.ops.linsolve, "
            "torchdiffeq_tpu_torch.solvers.adams, "
            "torchdiffeq_tpu_torch.solvers.fixed_grid_implicit, "
            "torchdiffeq_tpu_torch.solvers.adaptive_implicit, "
            "torchdiffeq_tpu_torch.ops.traced, "
            "torchdiffeq_tpu_torch.examples._common, "
            "torchdiffeq_tpu_torch.examples._optim, "
            "torchdiffeq_tpu_torch.examples.ensemble, "
            "torchdiffeq_tpu_torch.examples.ode_demo, "
            "torchdiffeq_tpu_torch.examples.latent_ode, "
            "torchdiffeq_tpu_torch.examples.cnf, "
            "torchdiffeq_tpu_torch.examples.odenet_mnist, "
            "torchdiffeq_tpu_torch.examples.bouncing_ball, "
            "torchdiffeq_tpu_torch.examples.learn_physics, "
            "torchdiffeq_tpu_torch.examples.sharded_step; "
            "from torchdiffeq_tpu_torch.ops.kernels import "
            "dopri5_events_batched; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'optax' or m.startswith('optax.')"
            " or m.startswith('torchdiffeq_tpu.') or m == 'torchdiffeq_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
