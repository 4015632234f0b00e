"""The device mesh on torch.distributed (`parallel/sharding.py`, Parareal's
``mesh=``, ``parareal_demo --mesh`` and the sharded training step of
``examples/sharded_step.py``) against the JAX package's mesh, mirroring
tests/test_sharding.py (`test_sharded_training_step` against JAX's
one-device step, as the dry run compares) and
tests/test_parareal.py::test_mesh_execution_matches_vmap.

The port runs one process a rank: one module-wide launch of 4 CPU ranks
(subprocess Pythons on gloo, meeting on a FileStore under the test's
temporary directory, one thread each; `torch_sharding_ranks.py`) runs
every case and writes its results to files, which the tests below read.
JAX runs here, on a mesh of 4 of the 8 virtual CPU devices that
conftest.py makes, so the shard counts match; its references are computed
while the ranks run.  The ranks import no JAX.
Tolerances: values to 1e-12 of the largest (rtol 1e-10 for Parareal, as
JAX's own test), Stats counters exactly, gradients to 1e-9 of the largest
against JAX's shard_map + psum and to JAX's own 1e-5 against one
device.  The data-parallel solves whose decisions go beyond the error
norm (stage solves, Adams correctors, SciPy, an event function), each
decision made global: values to 1e-12 of the largest against the port's
one-device solve and JAX's, counters and stage iterations exact;
Parareal's mesh gradient to 1e-12 of the largest against mesh=None and to
1e-9 against JAX's.  The sharded training step: float64 losses and gradients to
1e-12 of the largest against JAX's one-device step (its shared
controller takes the one-device steps, so only the blocks' and shards'
summation order differs: 3.8e-16 measured), float32 to the dry run's own
bounds (`__graft_entry__.py:134-135`) against JAX and to 1e-5 against
the port's one-device step (the float32 step's rounding, 1.6e-7
measured), the tensor-parallel field alone to 1e-15.  The gradient
routes that run their backward over each rank's block (autograd through
the loop, the replay, forward_grad's jvp, event solves, the interpolated,
callable-norm and SciPy adjoints): every rank's gradient to 1e-12 of the
largest against the port's one-device gradient and against JAX's, but
the event solves' 1e-10 and SciPy's 1e-9 against JAX (`_JAX_GRAD_REL`),
counters exactly."""
import functools
import os
import pickle
import socket
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import torchdiffeq_tpu as tde
from torchdiffeq_tpu.models import (init_mlp, init_spiral_model, mlp_apply,
                                    spiral_field)
from torchdiffeq_tpu.parallel import (make_mesh as j_make_mesh,
                                      odeint_parareal as j_parareal,
                                      odeint_per_sample_with_stats as
                                      j_per_sample,
                                      shard_params as j_shard_params)
import torchdiffeq_tpu_torch as tt
from torchdiffeq_tpu_torch.examples import parareal_demo, sharded_step
from torchdiffeq_tpu_torch.models import MLPField
from torchdiffeq_tpu_torch.parallel import (data_parallel_odeint, make_mesh,
                                            odeint_parareal,
                                            sharded_independent_odeint,
                                            tensor_parallel_mlp)
from torch_sharding_ranks import (DP_DECISIONS, DP_GRAD, DP_TOLS,
                                  DP_TOLS_GRAD, EVENT_TOLS, PAR_A, PAR_W,
                                  SPIN_EVENT, SPIN_T, SPIN_W, TP_GRAD_KW,
                                  TP_GRAD_SIZES, TP_GRAD_T, TP_MESHES,
                                  TP_SIZES, TP_STEPS, relax_y0, tp_inputs,
                                  tp_key)

RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     'torch_sharding_ranks.py')
WORLD = 4
TIMEOUT = 180


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                        'MASTER_PORT')}
    env.update(OMP_NUM_THREADS='1', **extra)
    return env


class _Launch:
    """`world` rank processes of one suite; `results()` waits for them
    and returns each rank's results, in rank order."""

    def __init__(self, out, suite, world, torchrun_env=False):
        self.out, self.world, self._results = str(out), world, None
        port = None
        if torchrun_env:
            with socket.socket() as s:
                s.bind(('127.0.0.1', 0))
                port = s.getsockname()[1]
        self.procs = []
        for r in range(world):
            argv = [sys.executable, RANKS, self.out, suite, str(r),
                    str(world)]
            if torchrun_env:
                env = _env(RANK=str(r), WORLD_SIZE=str(world),
                           LOCAL_RANK=str(r), MASTER_ADDR='127.0.0.1',
                           MASTER_PORT=str(port))
            else:
                argv.append(os.path.join(self.out, 'store'))
                env = _env()
            self.procs.append(subprocess.Popen(
                argv, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT))

    def results(self):
        if self._results is None:
            logs = []
            for p in self.procs:
                try:
                    logs.append(p.communicate(timeout=TIMEOUT)[0].decode())
                except subprocess.TimeoutExpired:
                    self.close()
                    pytest.fail("the ranks did not finish in "
                                f"{TIMEOUT} s")
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r}:\n{log}"
            self._results = []
            for r in range(self.world):
                with open(os.path.join(self.out, f'rank{r}.pkl'), 'rb') as fh:
                    self._results.append(pickle.load(fh))
        return self._results

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _spiral_params(dtype):
    """`__graft_entry__`'s dry-run weights: the JAX package's
    `init_spiral_model(PRNGKey(0), 128)` in `dtype`."""
    return init_spiral_model(jax.random.PRNGKey(0), hidden=128,
                             dtype=dtype)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp('ranks')
    # the ranks import no JAX: the dry run's weights go to them in a file
    arrays = {}
    for name, dtype in (('float64', jnp.float64), ('float32', jnp.float32)):
        for i, layer in enumerate(_spiral_params(dtype)):
            for k, v in layer.items():
                arrays[f'{k}{i + 1}_{name}'] = np.asarray(v)
    np.savez(os.path.join(out, 'spiral_params.npz'), **arrays)
    np.savez(os.path.join(out, 'tp_depths.npz'), **{
        f"{'x'.join(map(str, sizes))}_{k}{i}": v
        for sizes in TP_SIZES
        for i, layer in enumerate(_tp_params(tuple(sizes)))
        for k, v in layer.items()})
    launch = _Launch(out, 'mesh', WORLD)
    # the JAX references of the mesh's global decisions and gradients,
    # while the ranks run
    for name, _, _ in DP_DECISIONS:
        _jax_decision(name)
    _jax_parareal_grads()
    for name, _, _ in DP_GRAD:
        _jax_grad_route(name)
    _jax_tp_fixed_grid()
    for sizes in TP_GRAD_SIZES:
        _jax_tp_grad(tuple(sizes))
    yield launch
    launch.close()


def _case(ranks, name):
    """Every rank's results of case `name`; a rank's error fails it."""
    out = [r[name] for r in ranks.results()]
    for r, res in enumerate(out):
        if 'error' in res:
            pytest.fail(f"rank {r}:\n{res['error']}")
    return out


def _rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _jmesh(axis_sizes):
    return j_make_mesh(axis_sizes, devices=jax.devices()[:WORLD])


def _counters(st):
    return [int(x) for x in st[:5]]


# ---- the JAX references first: the ranks run meanwhile ------------------------

W = np.array([[-0.5, 0.8], [-0.8, -0.5]])


@pytest.mark.parametrize("interpolated", [False, True])
def test_adjoint_grads_match_shard_map_and_single_device(ranks,
                                                         interpolated):
    """test_adjoint_grads_under_shard_map_match_single_device and
    test_interpolated_adjoint_under_shard_map: each rank's adjoint
    gradient of its block's loss, all-reduced, against JAX's per-shard
    gradients under shard_map summed by psum; and against one device at
    JAX's own tolerance.  The gradient through
    `sharded_independent_odeint`'s gather, all-reduced, is the same."""
    mesh = _jmesh({'data': WORLD})
    y0 = jnp.arange(1.0, 33.0).reshape(16, 2) / 16.0
    tgt = jnp.ones((16, 2)) * 0.3
    t = jnp.linspace(0., 1., 3)
    opts = dict(interpolated=True) if interpolated else None

    def local_loss(W_, y0_, tgt_):
        ys = tde.odeint_adjoint(lambda s, y, w: jnp.tanh(y) @ w.T, y0_, t,
                                rtol=1e-8, atol=1e-10, args=(W_,),
                                adjoint_options=opts)
        return jnp.sum((ys[-1] - tgt_) ** 2)

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P('data'), P('data')),
             out_specs=P(), check_vma=False)
    def grads_sharded(W_, y0_, tgt_):
        return jax.lax.psum(jax.grad(local_loss)(W_, y0_, tgt_), 'data')

    g_sh = np.asarray(jax.jit(grads_sharded)(jnp.asarray(W), y0, tgt))
    g_ref = np.asarray(jax.jit(jax.grad(local_loss))(jnp.asarray(W), y0,
                                                     tgt))
    name = 'interpolated' if interpolated else 'continuous'
    for res in _case(ranks, 'adjoint'):
        _rel(res[name], g_sh, 1e-9)
        np.testing.assert_allclose(res[name], g_ref, rtol=1e-5, atol=1e-8)
        if not interpolated:
            _rel(res['gathered'], res['continuous'], 1e-12)


def test_parareal_mesh_matches_jax(ranks):
    """test_mesh_execution_matches_vmap with 8 slices over 4 ranks: equal
    to JAX's mesh run at its rtol 1e-10, and to the port's one-device run
    exactly (every slice has its own controller either way); 6 slices do
    not divide, with JAX's message."""
    from test_parareal import _stiffish_field
    mesh = _jmesh({'time': WORLD})
    y0, t = jnp.array([1.0, 0.3]), jnp.linspace(0., 4., 9)
    ys_j = jax.jit(lambda y: j_parareal(
        _stiffish_field, y, t, rtol=1e-8, atol=1e-10, n_iters=3, mesh=mesh,
        axis='time'))(y0)
    with pytest.raises(ValueError) as err_j:
        j_parareal(_stiffish_field, y0, jnp.linspace(0., 4., 7), n_iters=3,
                   mesh=mesh, axis='time')
    for res in _case(ranks, 'parareal'):
        np.testing.assert_allclose(res['ys_m'], np.asarray(ys_j), rtol=1e-10,
                                   atol=1e-12)
        assert np.array_equal(res['ys_m'], res['ys_v'])
        assert res['indivisible'] == str(err_j.value)


@functools.lru_cache(maxsize=None)
def _jax_parareal_grads():
    """jax.grad of sum(ys**2) through JAX's mesh Parareal (8 slices over 4
    devices) in y0, W, the args scale a and t."""
    mesh = _jmesh({'time': WORLD})

    def loss(y0, W, a, tt_):
        ys = j_parareal(lambda s, y, W_, a_: a_ * (W_ @ y), y0, tt_,
                        rtol=1e-8, atol=1e-10, n_iters=3, mesh=mesh,
                        axis='time', args=(W, a))
        return jnp.sum(ys ** 2)

    g_j = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        jnp.array([1.0, 0.3]), jnp.asarray(PAR_W), jnp.asarray(PAR_A),
        jnp.linspace(0., 4., 9))
    return dict(zip(('y0', 'w', 'a', 't'), (np.asarray(g) for g in g_j)))


def test_parareal_mesh_gradients_match_jax(ranks):
    """Parareal's mesh under autograd, 8 slices over 4 ranks: the
    gradients of sum(ys**2) in y0, a Module's W, an args tensor and t are
    the same on every rank (the global gradient, counted once), within
    1e-12 of the largest of the port's mesh=None and within 1e-9 of JAX's
    jax.grad through its mesh Parareal on 4 devices; the mesh's forward
    under autograd is its forward without, bit for bit, and mesh=None's
    to 1e-12."""
    g_j = _jax_parareal_grads()
    out = [res['grads'] for res in _case(ranks, 'parareal')]
    for g in out:
        assert np.array_equal(g['mesh']['ys'], g['forward'])
        _rel(g['mesh']['ys'], g['one']['ys'], 1e-12)
        for key in ('y0', 'w', 'a', 't'):
            _rel(g['mesh'][key], g['one'][key], 1e-12)
            _rel(g['mesh'][key], g_j[key], 1e-9)
    for key in ('y0', 'w', 'a', 't'):
        _same_on_every_rank([g['mesh'][key] for g in out])


def test_event_times_on_a_sharded_batch(ranks):
    """test_event_solve_under_vmap_and_sharding: each rank's per-sample
    event solves of its block (the batched driver), gathered: the port's
    solve of the whole batch bit for bit (each sample its own controller
    and bisection), JAX's per-sample route and the JAX test's vmap of
    `odeint_event` to 1e-10 (the bisections' own resolution: the port's
    whole-batch solve is as far from them), and the closed form at the
    JAX test's tolerance."""
    y0_t = torch.linspace(1.5, 4.0, 8, dtype=torch.float64)[:, None]
    y0 = jnp.asarray(y0_t.numpy())          # the ranks' y0
    kw = dict(event_fn=lambda s, y: y[0] - 1.0, rtol=1e-8, atol=1e-10)

    def one(y0_):
        et, _ = tde.odeint_event(lambda s, y: -y, y0_, 0.0, **kw)
        return et

    ets = np.asarray(jax.jit(jax.vmap(one))(y0))
    (ets_ps, _), _ = jax.jit(lambda y: j_per_sample(
        lambda s, yy: -yy, y, jnp.array([0.0, 1.0]), **kw))(y0)
    with torch.no_grad():
        (et_t, ys_t), _ = tt.odeint_per_sample_with_stats(
            lambda s, y: -y, y0_t,
            torch.tensor([0.0, 1.0], dtype=torch.float64), **kw)
    for res in _case(ranks, 'events'):
        # the (B,) event times gathered on the batch, whole
        assert np.array_equal(res['et'], et_t.numpy())
        assert np.array_equal(res['ys'], ys_t.transpose(0, 1).numpy())
        _rel(res['et'], ets_ps, 1e-10)
        _rel(res['et'], ets, 1e-10)
        np.testing.assert_allclose(res['et'], np.log(np.asarray(y0[:, 0])),
                                   rtol=1e-6, atol=1e-8)


def test_sharded_independent_steps_match_jax_blocks(ranks):
    """test_shard_map_independent_controllers: blocks of 2 samples, k = 1
    on ranks 0-1 and 200 on ranks 2-3; the gathered values and each
    shard's Stats equal JAX's solve of that block, and the stiff blocks
    take more steps.  A batch of 6 does not divide."""
    ks = np.array([1.0] * 4 + [200.0] * 4)
    t = jnp.array([0.0, 1.0])
    solve = jax.jit(lambda y, k: tde.odeint_with_stats(
        lambda s, yy: -k[:, None] * yy, y, t, rtol=1e-6, atol=1e-8))
    blocks = [solve(jnp.ones((2, 1)), jnp.asarray(ks[2 * c:2 * c + 2]))
              for c in range(WORLD)]
    ys_j = np.concatenate([np.asarray(b[0]) for b in blocks], axis=1)
    st_j = [_counters(b[1]) for b in blocks]
    for res in _case(ranks, 'sharded'):
        _rel(res['ys'], ys_j, 1e-12)
        assert res['stats'] == st_j
        assert min(s[1] for s in st_j[2:]) > max(s[1] for s in st_j[:2])
        np.testing.assert_allclose(res['ys'][-1, :, 0], np.exp(-ks),
                                   rtol=1e-4, atol=1e-8)
        assert 'not divisible' in res['indivisible']


def test_data_parallel_matches_single_device(ranks):
    """test_data_parallel_solve_matches_single_device: one shared
    controller over the global batch, its norm all-reduced, equal to the
    single-device solve (JAX's and the port's) at 1e-12 with the counters
    exact; a dict state takes each leaf's global RMS, then the max; a
    user norm and an indivisible batch are refused.  Under autograd
    (plain odeint's continuous adjoint) every rank gets the global
    gradient of an args tensor, the single-device solve's."""
    t = jnp.linspace(0., 1., 4)
    y0 = jnp.arange(1.0, 17.0).reshape(16, 1)
    kw = dict(rtol=1e-8, atol=1e-10)
    ys_j, st_j = jax.jit(lambda y: tde.odeint_with_stats(
        lambda s, yy: -yy, y, t, **kw))(y0)
    y0d = {'p': y0 / 16.0, 'q': jnp.linspace(0.1, 2.0, 32).reshape(16, 2)}
    ysd_j, std_j = jax.jit(lambda y: tde.odeint_with_stats(
        lambda s, yy: {'p': -yy['p'], 'q': -3.0 * yy['q'] * yy['p']}, y, t,
        **kw))(y0d)
    for res in _case(ranks, 'data_parallel'):
        _rel(res['ys'], ys_j, 1e-12)
        assert res['st'] == _counters(st_j) == res['st1']
        _rel(res['ys'], res['ys1'], 1e-12)
        for k in ('p', 'q'):
            _rel(res['ysd'][k], ysd_j[k], 1e-12)
        assert res['std'] == _counters(std_j)
        assert 'norm' in res['user_norm']
        assert 'not divisible' in res['indivisible']
        g_dp, g_one = res['autograd']
        _rel(g_dp, g_one, 1e-12)
    assert len({res['autograd'][0] for res in _case(ranks,
                                                    'data_parallel')}) == 1


@pytest.mark.parametrize("method", ['tsit5', 'rk4'])
def test_data_parallel_explicit_routes_match_single_device(ranks, method):
    """The other routes data_parallel_odeint keeps, whose only decision
    is the error norm's (an explicit tableau) or none (a fixed grid):
    y' = -y**2 over the global batch, equal to the single-device solve
    (JAX's and the port's) at 1e-12 with the counters exact."""
    t = jnp.linspace(0., 1., 4)
    y0 = jnp.arange(1.0, 17.0).reshape(16, 1) / 16.0
    opts = dict(num_steps=8) if method == 'rk4' else None
    ys_j, st_j = jax.jit(lambda y: tde.odeint_with_stats(
        lambda s, yy: -yy * yy, y, t, rtol=1e-8, atol=1e-10, method=method,
        options=opts))(y0)
    for res in _case(ranks, 'data_parallel'):
        got = res['routes'][method]
        _rel(got['ys'], ys_j, 1e-12)
        _rel(got['ys'], got['ys1'], 1e-12)
        assert got['st'] == got['st1'] == _counters(st_j)


def _jrelax(s, y):
    """`torch_sharding_ranks.relax` in JAX."""
    k = jnp.exp(y[:, 2:])
    target = jnp.stack([jnp.cos(s), jnp.sin(s)])
    dy = -k * (y[:, :2] - target) - 0.5 * y[:, :2] ** 3
    return jnp.concatenate([dy, jnp.zeros_like(k)], axis=1)


@functools.lru_cache(maxsize=None)
def _jax_decision(name):
    """JAX's single-device solve of DP_DECISIONS' case `name`: ((event
    time or None), ys, counters).  SciPy's bridge (its callback closes
    over the problem) and a grid constructor that reads the state run
    outside jit, their field jitted."""
    _, k, kw = next(c for c in DP_DECISIONS if c[0] == name)
    kw = dict(DP_TOLS, **kw)
    event = 'event_fn' in kw
    if event:
        kw['event_fn'] = lambda s, y: y[0, 0] - 0.5
    t = jnp.array([0., 1.]) if event else jnp.linspace(0., 1., 3)
    if (kw.get('method') == 'scipy_solver'
            or 'grid_constructor' in kw.get('options', {})):
        run = lambda y: tde.odeint_with_stats(  # noqa: E731
            jax.jit(_jrelax), y, t, **kw)
    else:
        run = jax.jit(lambda y: tde.odeint_with_stats(_jrelax, y, t, **kw))
    out, st = run(jnp.asarray(relax_y0(k)))
    et, ys = out if event else (None, out)
    return (None if et is None else float(et)), np.asarray(ys), \
        _counters(st)


@pytest.mark.parametrize("name", [c[0] for c in DP_DECISIONS])
def test_data_parallel_local_decisions_match_single_device(ranks, name):
    """test_data_parallel_solve_matches_single_device for the solves that
    decide by more than the error norm -- the stage solves (Newton's and
    Broyden's), the Adams corrector, SciPy's controller, an event
    function, a grid constructor that reads the state -- each decision
    now read from the global state: on 4 ranks
    the values equal the port's single-device solve and JAX's to 1e-12 of
    max|y| (an event time to 1e-12), the counters exact and the same on
    every rank, and each rank's stage and corrector iterations
    (`IMPLICIT_COUNTS`) the single device's."""
    et_j, ys_j, st_j = _jax_decision(name)
    out = [res[name] for res in _case(ranks, 'decisions')]
    one = next(res for res in out if 'one' in res)
    _rel(one['one']['ys'], ys_j, 1e-12)
    assert one['one']['st'] == st_j
    for res in out:
        _rel(res['mesh']['ys'], one['one']['ys'], 1e-12)
        _rel(res['mesh']['ys'], ys_j, 1e-12)
        assert res['mesh']['st'] == st_j
        assert res['mesh']['counts'] == one['one']['counts']
        if et_j is not None:
            assert abs(res['mesh_et'] - one['one_et']) <= 1e-12
            assert abs(res['mesh_et'] - et_j) <= 1e-12
    _same_on_every_rank([res['mesh']['ys'] for res in out])


@pytest.mark.parametrize("name", ['kvaerno5', 'implicit_euler'])
def test_data_parallel_unequal_stiffness_takes_single_device_iterations(
        ranks, name):
    """Blocks of unequal stiffness (rate 1 on ranks 0-1, 500 for Newton's
    and 20 for Broyden's stage solves on ranks 2-3): the solve ends, every
    rank takes the single device's stage iterations, linear solves and
    Jacobians, and the stiff blocks' iterations set them all (more than
    the steps' stages alone)."""
    out = [res[name] for res in _case(ranks, 'decisions')]
    one = next(res for res in out if 'one' in res)['one']
    for res in out:
        assert res['mesh']['counts'] == one['counts']
        assert res['mesh']['st'][4] == 0
    assert one['counts']['iterations'] > one['st'][1]


# ---- the sharded training step of __graft_entry__.dryrun_multichip ----------

_T_STEP = 0.5           # the dry run's t = [0, 0.5]


@functools.lru_cache(maxsize=None)
def _jax_step(dtype, argnums=(0,)):
    """JAX's one-device step of the dry run at n=4 (hidden 128, batch 64)
    on its weights, y0 and target from numpy seeds 1 and 2: the loss, the
    gradients in `argnums` of (params, y0, t), and the forward counters."""
    params = _spiral_params(dtype)
    y0 = jnp.asarray(np.random.RandomState(1).randn(64, 2), dtype)
    tgt = jnp.asarray(np.random.RandomState(2).randn(64, 2), dtype)
    t = jnp.linspace(0.0, _T_STEP, 2, dtype=dtype)
    func = lambda tt_, yy, p: spiral_field(p, tt_, yy)  # noqa: E731

    def loss_fn(p, y, tt_):
        ys = tde.odeint_adjoint(func, y, tt_, rtol=1e-2, atol=1e-3,
                                method='dopri5', args=(p,))
        return jnp.mean((ys[-1] - tgt) ** 2)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn, argnums=argnums))(
        params, y0, t)
    _, st = jax.jit(lambda p, y: tde.odeint_with_stats(
        func, y, t, rtol=1e-2, atol=1e-3, method='dopri5', args=(p,)))(
            params, y0)
    g_params = [np.asarray(x) for layer in grads[0]
                for x in (layer['w'], layer['b'])]
    return float(loss), g_params, [np.asarray(g) for g in grads[1:]], \
        _counters(st)


def _flat(grads):
    return np.concatenate([np.asarray(g, np.float64).ravel() for g in grads])


def _same_on_every_rank(values):
    assert all(np.array_equal(v, values[0]) for v in values[1:])


def test_sharded_step_float64_matches_jax(ranks):
    """The dry run's step at n=4, {'data': 2, 'model': 2} (hidden 128 split
    over 'model', batch 64 over 'data'), in float64: the loss and the
    gathered gradients within 1e-12 of JAX's one-device value_and_grad in
    x64 (of max|g|), y0's and t's gradients the same on every rank and
    within 1e-12 of JAX's, the forward counters JAX's odeint_with_stats',
    and the forward and backward counters the port's one-device step's."""
    loss_j, g_j, (gy_j, gt_j), st_j = _jax_step(jnp.float64, (0, 1, 2))
    out = [res['float64'] for res in _case(ranks, 'step')]
    for res in out:
        sh, one = res['sharded'], res['single']
        assert abs(sh['loss'] - loss_j) <= 1e-12 * abs(loss_j)
        _rel(_flat(sh['grads']), _flat(g_j), 1e-12)
        _rel(sh['y0'], gy_j, 1e-12)
        _rel(sh['t'], gt_j, 1e-12)
        assert sh['st'] == st_j == one['st']
        assert sh['bwd'] == one['bwd'] and len(sh['bwd']) == 1
    for key in ('y0', 't'):
        _same_on_every_rank([res['sharded'][key] for res in out])
    _same_on_every_rank([_flat(res['sharded']['grads']) for res in out])


def test_sharded_step_float32_within_dryrun_bounds(ranks):
    """The same step in float32, as the dry run runs it: within
    `__graft_entry__.py:134-135`'s bounds (loss 1e-3, gradients 5e-2 of
    max|g|) of JAX's one-device float32 step, the comparison the dry run
    makes, and within 1e-5 of the port's own one-rank float32 step."""
    loss_j, g_j, _, _ = _jax_step(jnp.float32)
    for res in _case(ranks, 'step'):
        sh, one = res['float32']['sharded'], res['float32']['single']
        ld, gd = sharded_step.rel_diffs(
            sh['loss'], [torch.from_numpy(g) for g in sh['grads']], loss_j,
            [torch.from_numpy(np.array(g)) for g in g_j])
        assert ld < sharded_step.LOSS_REL and gd < sharded_step.GRAD_REL
        assert abs(sh['loss'] - one['loss']) <= 1e-5 * abs(one['loss'])
        _rel(_flat(sh['grads']), _flat(one['grads']), 1e-5)


@pytest.mark.parametrize("mesh", ['data4', 'data1'])
@pytest.mark.parametrize("norm", ['default', 'seminorm'])
def test_sharded_step_other_meshes(ranks, mesh, norm):
    """The step on {'data': 4, 'model': 1} and {'data': 1, 'model': 4}, with
    the default adjoint norm and 'seminorm', float64: the loss, the
    gathered gradients and y0's and t's within 1e-12 of the port's
    one-device step with the same norm, its forward and backward counters
    equal; with the default norm JAX's step within 1e-12 too."""
    ref = _jax_step(jnp.float64, (0, 1, 2)) if norm == 'default' else None
    for res in _case(ranks, 'step'):
        sh, one = (res[f'{mesh}_{norm}'][k] for k in ('sharded', 'single'))
        assert abs(sh['loss'] - one['loss']) <= 1e-12 * abs(one['loss'])
        for key in ('grads', 'y0', 't'):
            _rel(_flat(sh[key]), _flat(one[key]), 1e-12)
        assert sh['st'] == one['st'] and sh['bwd'] == one['bwd']
        if ref is not None:
            _rel(_flat(sh['grads']), _flat(ref[1]), 1e-12)
            assert sh['st'] == ref[3]


def _check_tp_vs_mlp(res):
    """`torch_sharding_ranks._tp_vs_mlp`: the split field's values and
    VJP within 1e-15 of the largest of the `MLPField`'s, and its
    `full_field()` the field exactly."""
    _rel(res['tp']['f'], res['mlp']['f'], 1e-15)
    for got, want in zip(res['tp']['grads'], res['mlp']['grads']):
        _rel(got, want, 1e-15)
    assert res['full_equal']


def test_tensor_parallel_field_matches_mlp(ranks):
    """`tensor_parallel_mlp` alone on each rank of {'data': 2, 'model': 2}:
    its values and its VJP in y and in the gathered parameters equal the
    `MLPField`'s within 1e-15 of the largest, float64; each rank holds
    only its shards (W1 (2, 64), W2 (64, 2), b1 (64,), b2 (2,) whole) and
    gathers back the whole field; and so does a field of two hidden
    layers, [2, 8, 8, 2], its last layer whole."""
    for res in _case(ranks, 'tensor_parallel'):
        _check_tp_vs_mlp(res)
        assert res['local_shapes'] == [(2, 64), (64, 2), (64,), (2,)]
        _check_tp_vs_mlp(res['deeper'])
        assert res['deeper']['local_shapes'] == [(2, 4), (4, 8), (8, 2),
                                                 (4,), (8,), (2,)]


@functools.lru_cache(maxsize=None)
def _tp_params(sizes):
    """The JAX package's `init_mlp(PRNGKey(len(sizes)), sizes)` in
    float64, as numpy, its zero biases replaced by 0.1 * randn from numpy
    seed len(sizes) (a zero bias would hide one added on every model
    rank)."""
    rng = np.random.RandomState(len(sizes))
    return [dict(w=np.asarray(layer['w']), b=0.1 * rng.randn(layer['b'].size))
            for layer in init_mlp(jax.random.PRNGKey(len(sizes)), list(sizes),
                                  dtype=jnp.float64)]


def _tp_local_shapes(sizes, n):
    """The shards of an MLP of `sizes` split over a model axis of `n`:
    Megatron's pairs, column- then row-split, an odd last layer whole; the
    weights, then the biases."""
    L = len(sizes) - 1
    ws, bs = [], []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        paired = i < L - L % 2
        ws.append((a, b // n) if paired and i % 2 == 0 else
                  (a // n, b) if paired else (a, b))
        bs.append((b // n,) if paired and i % 2 == 0 else (b,))
    return ws + bs


@pytest.mark.parametrize("sizes", TP_SIZES, ids=lambda s: 'x'.join(map(
    str, s)))
@pytest.mark.parametrize("shape", TP_MESHES, ids=lambda m: 'data%d' %
                         m['data'])
def test_tensor_parallel_mlp_any_depth_matches_jax(ranks, shape, sizes):
    """`tensor_parallel_mlp` with no hidden layer and with 1, 2 and 3 (the
    pairs' even and odd cases) on {'data': 2, 'model': 2} and {'data': 1,
    'model': 4}, float64: on every rank its values and its VJP in y and in
    the gathered parameters within 1e-15 of the largest of JAX's
    `mlp_apply` and `jax.vjp` on the same `init_mlp` parameters, and of
    the port's `MLPField`; each rank holds Megatron's shards, its
    `full_field()` is the field exactly, and the `shard_params` DTensors
    give the split field bit for bit."""
    params = _tp_params(tuple(sizes))
    y, ct, _ = tp_inputs()
    f_j, vjp = jax.vjp(lambda p, yy: mlp_apply(p, yy), params, y)
    g_p, g_y = vjp(ct)
    g_j = [np.asarray(g_y)] + [np.asarray(layer[k]) for k in ('w', 'b')
                               for layer in g_p]
    n = shape['model']
    for res in _case(ranks, 'tp_depths'):
        res = res[tp_key(shape, sizes)]
        _check_tp_vs_mlp(res)
        _rel(res['tp']['f'], np.asarray(f_j), 1e-15)
        for got, want in zip(res['tp']['grads'], g_j):
            _rel(got, want, 1e-15)
        assert res['local_shapes'] == _tp_local_shapes(sizes, n)
        assert res['dtensor_equal']


@functools.lru_cache(maxsize=None)
def _jax_tp_grad(sizes):
    """JAX's one-device gradients of `case_tp_depths`' loss sum(ys[-1]**2)
    (dopri5's adjoint) in the MLP's weights, biases and y0."""
    def loss(p, y0):
        ys = tde.odeint_adjoint(lambda s, y, pp: mlp_apply(pp, y), y0,
                                jnp.asarray(TP_GRAD_T), args=(p,),
                                **TP_GRAD_KW)
        return jnp.sum(ys[-1] ** 2)

    g_p, g_y = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        _tp_params(sizes), tp_inputs()[2])
    return [np.asarray(layer[k]) for k in ('w', 'b') for layer in g_p] + [
        np.asarray(g_y)]


@pytest.mark.parametrize("sizes", TP_GRAD_SIZES, ids=lambda s: 'x'.join(
    map(str, s)))
@pytest.mark.parametrize("shape", TP_MESHES, ids=lambda m: 'data%d' %
                         m['data'])
def test_tensor_parallel_mlp_any_depth_gradient_matches_jax(ranks, shape,
                                                            sizes):
    """The fields of two and three hidden layers split by
    `tensor_parallel_mlp`, their batch over 'data', through
    `data_parallel_odeint(odeint_adjoint)` (dopri5): every rank's
    gathered parameter gradients and y0's within 1e-12 of max|g| of JAX's
    one-device jax.grad, the same on every rank."""
    g_j = _jax_tp_grad(tuple(sizes))
    out = [res[tp_key(shape, sizes)]['grad']
           for res in _case(ranks, 'tp_depths')]
    for g in out:
        _rel(_flat(g), _flat(g_j), 1e-12)
    _same_on_every_rank([_flat(g) for g in out])


def test_data_parallel_refuses_implicit_adjoint_with_tensor_parallel_field(
        ranks):
    """The route still refused: an implicit adjoint method (kvaerno5) with
    a `tensor_parallel_mlp` field, whose theta_bar is another shard on
    each model rank, raises NotImplementedError on all 4 ranks, from the
    arguments alone, before any collective: the ranks' all-reduce after
    it completes."""
    for res in _case(ranks, 'tp_depths'):
        msg = res['refused']
        assert msg is not None and msg.startswith('data_parallel_odeint')
        assert 'tensor_parallel_mlp' in msg
        assert res['after'] == WORLD


def _jspin(s, y, W_, a):
    """`torch_sharding_ranks.Spin` in JAX, W and a as args."""
    return a * jnp.tanh(y) @ W_.T


def _jmax_rms(xs):
    return jnp.max(jnp.stack([jnp.sqrt(jnp.mean(jnp.abs(x) ** 2))
                              for x in xs]))


# each DP_GRAD route's JAX call: (entry, keywords).  JAX's SciPy adjoint
# raises under jax.grad (C26): the SciPy route's reference is JAX's dopri5
# adjoint, whose tableau SciPy's RK45 steps with its own controller
_JAX_ROUTES = {
    'fixed_grid': ('odeint', dict(method='rk4', options=dict(num_steps=8))),
    'replay_grad': ('odeint', dict(options=dict(replay_grad=True))),
    'forward_grad': ('odeint', dict(options=dict(forward_grad=True))),
    'interpolated': ('odeint_adjoint',
                     dict(adjoint_options=dict(interpolated=True))),
    'callable_norm': ('odeint_adjoint',
                      dict(adjoint_options=dict(norm=_jmax_rms))),
    'implicit_fixed_grid': ('odeint', dict(method='implicit_euler',
                                           options=dict(num_steps=8))),
    'event_solve': ('event_solve', {}),
    'scipy_adjoint': ('odeint_adjoint', {}),
    'adams': ('odeint', dict(method='implicit_adams',
                             options=dict(num_steps=8, max_order=4))),
    'implicit_euler_newton': ('odeint', dict(
        method='implicit_euler', options=dict(num_steps=8,
                                              root_solver='newton'))),
    'rk4_remat': ('odeint', dict(method='rk4',
                                 options=dict(num_steps=8, remat=True))),
    'event_time': ('odeint_event', {}),
    'replay_event': ('odeint_event', dict(options=dict(replay_grad=True))),
}
# the implicit and Adams adjoint methods: JAX's odeint_adjoint with the
# ranks' keywords
_JAX_ROUTES.update((name, ('odeint_adjoint', kw)) for name, _, kw in DP_GRAD
                   if kw.get('adjoint_method') not in (None, 'scipy_solver'))
# the bound of each route's gradient against JAX's, of max|g|: 1e-12, but
# the event solves' 1e-10 (the replay's own parity bound,
# tests/test_torch_replay.py, inside test_torch_adjoint.py's rtol 1e-9 for
# the event gradients; 1.1e-11 measured: the bisection to atol 1e-12 and
# the steps' last bits) and SciPy's RK45 against JAX's dopri5 adjoint,
# 1e-9 (9e-11 measured)
_JAX_GRAD_REL = dict(event_solve=1e-10, event_time=1e-10,
                     replay_event=1e-10, scipy_adjoint=1e-9)


@functools.lru_cache(maxsize=None)
def _jax_grad_route(name):
    """JAX's one-device gradients of `torch_sharding_ranks._spin_grads`'
    loss in (W, a, y0, t) for route `name` (forward_grad: the tangent of
    ys along all four)."""
    entry, kw = _JAX_ROUTES[name]
    kw = dict(DP_TOLS_GRAD, **kw)
    t = jnp.asarray(SPIN_T)
    if entry in ('event_solve', 'odeint_event'):
        kw.update(EVENT_TOLS, event_fn=lambda s, y: y[0, 0] - SPIN_EVENT)
        t = jnp.array([0.0, 1.0])
    xs = (jnp.asarray(SPIN_W), jnp.asarray(1.1),
          jnp.arange(1.0, 33.0).reshape(16, 2) / 16.0, t)

    def ys_of(W_, a, y0, tt_):
        if entry == 'odeint_event':
            return tde.odeint_event(_jspin, y0, tt_[0], args=(W_, a), **kw)
        fn = tde.odeint_adjoint if entry == 'odeint_adjoint' else tde.odeint
        out = fn(_jspin, y0, tt_, args=(W_, a), **kw)
        return out[1] if entry == 'event_solve' else out

    if name == 'forward_grad':
        return [np.asarray(jax.jit(lambda *a: jax.jvp(
            ys_of, a, tuple(jnp.ones_like(x) for x in a))[1])(*xs))]

    def loss(*args):
        out = ys_of(*args)
        if entry == 'odeint_event':
            return 3.0 * out[0] + jnp.sum(out[1][-1] ** 2)
        return jnp.sum(out ** 2)

    return [np.asarray(g) for g in
            jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*xs)]


def _check_grad_route(ranks, name):
    """Route `name` on 4 ranks: every rank's gradients (or forward-mode
    tangent) the same, within 1e-12 of max|g| of the port's one-device
    ones and within `_JAX_GRAD_REL` of JAX's; its forward and backward
    counters the one-device solve's."""
    out = [res['routes'][name] for res in _case(ranks, 'grad_routes')]
    one = next(res['one'] for res in out if 'one' in res)
    g_j = _jax_grad_route(name)
    for res in out:
        mesh = res['mesh']
        assert mesh['fwd'] == one['fwd'] and mesh['bwd'] == one['bwd']
        for got, want, ref in zip(mesh['grads'], one['grads'], g_j):
            _rel(got, want, 1e-12)
            if np.abs(ref).max() > 0:
                _rel(got, ref, _JAX_GRAD_REL.get(name, 1e-12))
            else:
                assert np.abs(got).max() == 0
    for i in range(len(one['grads'])):
        _same_on_every_rank([res['mesh']['grads'][i] for res in out])


@pytest.mark.parametrize("name", ['fixed_grid', 'replay_grad',
                                  'forward_grad', 'interpolated',
                                  'implicit_adjoint', 'callable_norm',
                                  'implicit_fixed_grid', 'event_solve',
                                  'adams_adjoint', 'scipy_adjoint'])
def test_data_parallel_refuses_gradient_routes(ranks, name):
    """The ten gradient routes data_parallel_odeint once refused, all taken
    now on 4 ranks: autograd through each rank's fixed-grid and implicit
    fixed-grid loop, the replay, forward_grad's jvp, an event solve's
    event-mode adjoint, the interpolated adjoint, a callable adjoint norm,
    the SciPy adjoint method, and an implicit (kvaerno5) and an Adams
    (implicit_adams) adjoint method, whose stage solves and corrector run
    over the augmented state on the backward's axis, give every rank the
    one-device gradient (`_check_grad_route`: Spin's parameter, an args
    scale, y0 and t)."""
    _check_grad_route(ranks, name)


@pytest.mark.parametrize("name", ['adams_adjoint', 'fixed_adams_adjoint'])
def test_data_parallel_adams_adjoint_corrector_takes_global_max(ranks, name):
    """An Adams adjoint method's backward on 4 ranks: its corrector tests
    read the global max over the data axis, the same number of max
    all-reduces on every rank (the dopri5 forward makes none).  The parity
    cases alone do not show it: on Spin each rank's own max happens to
    decide as the global one does."""
    counts = [res['routes'][name]['mesh']['maxes']
              for res in _case(ranks, 'grad_routes')]
    assert counts[0] > 0 and len(set(counts)) == 1


@pytest.mark.parametrize("name", ['adams', 'implicit_euler_newton',
                                  'rk4_remat', 'event_time',
                                  'replay_event', 'radau5a_adjoint',
                                  'implicit_euler_adjoint',
                                  'implicit_euler_newton_adjoint',
                                  'interpolated_implicit',
                                  'fixed_adams_adjoint'])
def test_data_parallel_gradient_routes_match_single_device(ranks, name):
    """The routes beside the ten, on 4 ranks (`_check_grad_route`): the
    `adams` kind through its loop (its corrector's test global), the
    implicit fixed grid with Newton's stage solves (Broyden's is
    implicit_fixed_grid), rk4 with remat, the event time's gradient
    through `odeint_event`'s reroute, by the event-mode adjoint and by the
    replay; and the implicit and Adams adjoint methods beside kvaerno5 and
    implicit_adams: radau5a's stacked stages, implicit_euler's Broyden and
    Newton stage solves (8 steps an interval), kvaerno5 under the
    interpolated adjoint (the augmented state without y) and
    fixed_adams."""
    _check_grad_route(ranks, name)


@functools.lru_cache(maxsize=None)
def _jax_tp_fixed_grid():
    """JAX's one-device `case_tp_fixed_grid`: the dry run's float64 field
    through rk4's loop, the loss and its gradients in the parameters, y0
    and t."""
    y0 = jnp.asarray(np.random.RandomState(1).randn(64, 2))
    tgt = jnp.asarray(np.random.RandomState(2).randn(64, 2))

    def loss(p, y, tt_):
        ys = tde.odeint(lambda s, yy, pp: spiral_field(pp, s, yy), y, tt_,
                        method='rk4', options=dict(num_steps=TP_STEPS),
                        args=(p,))
        return jnp.mean((ys[-1] - tgt) ** 2)

    value, (g_p, g_y, g_t) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2)))(_spiral_params(jnp.float64), y0,
                                  jnp.array([0.0, 0.5]))
    return float(value), [np.asarray(x) for layer in g_p
                          for x in (layer['w'], layer['b'])], \
        np.asarray(g_y), np.asarray(g_t)


def test_data_parallel_tensor_parallel_fixed_grid_matches_jax(ranks):
    """The dry run's field split by `tensor_parallel_mlp` on {'data': 2,
    'model': 2} through rk4's loop with remat (the recomputation's model
    all-reduces in the backward): every rank's loss and gathered
    gradients, y0's and t's within 1e-12 of max|g| of the port's
    one-device MLPField and of JAX's one-device step, the same on every
    rank."""
    loss_j, g_j, gy_j, gt_j = _jax_tp_fixed_grid()
    out = _case(ranks, 'tp_fixed_grid')
    for res in out:
        sh, one = res['sharded'], res['single']
        assert abs(sh['loss'] - one['loss']) <= 1e-12 * abs(one['loss'])
        assert abs(sh['loss'] - loss_j) <= 1e-12 * abs(loss_j)
        for key, ref in (('grads', g_j), ('y0', gy_j), ('t', gt_j)):
            _rel(_flat(sh[key]), _flat(one[key]), 1e-12)
            _rel(_flat(sh[key]), _flat(ref), 1e-12)
    for key in ('grads', 'y0', 't'):
        _same_on_every_rank([_flat(res['sharded'][key]) for res in out])


@pytest.mark.parametrize("name", ['scipy_adjoint', 'callable_norm'])
def test_data_parallel_pytree_gradient_routes_match_single_device(ranks,
                                                                  name):
    """A dict state through the routes whose backward gathers the state
    leaf by leaf on 4 ranks, SciPy's adjoint (the global backward, then
    each rank's rows) and a callable adjoint norm (one all-gather of every
    leaf a call): the gradients in an args scale and both leaves of y0
    within 1e-12 of max|g| of the port's one device, the same on every
    rank."""
    out = [res['pytree'][name] for res in _case(ranks, 'grad_routes')]
    for mesh, one in out:
        for got, want in zip(mesh, one):
            _rel(got, want, 1e-12)
    for i in range(3):
        _same_on_every_rank([mesh[i] for mesh, _ in out])


def test_data_parallel_closure_tensor_gets_its_share(ranks):
    """C25: a tensor the field captures in a closure, which no wrapper
    sees (neither an nn.Module's parameter nor in `args`), differentiated
    through the fixed grid on 4 ranks: each rank's gradient is its block's
    share, which differs from the one-device gradient, and the shares
    summed over the ranks are that gradient within 1e-12 of its
    largest."""
    for res in _case(ranks, 'grad_routes'):
        c25 = res['c25']
        _rel(c25['summed'], c25['one'], 1e-12)
        assert np.abs(c25['rank'] - c25['one']).max() > \
            0.01 * np.abs(c25['one']).max()


def test_data_parallel_implicit_forward_gradient_matches_single_device(
        ranks):
    """kvaerno5 forward, dopri5 backward (the continuous adjoint), at
    {'data': 4}: the forward's stage solves global, every rank's gradient
    of an args scale w is the port's one-device gradient within 1e-12,
    the same on every rank."""
    out = [res['implicit'] for res in _case(ranks, 'grad_routes')]
    for g_dp, g_one in out:
        _rel(g_dp, g_one, 1e-12)
    _same_on_every_rank([g[0] for g in out])


def test_data_parallel_closure_gradient_matches_jax(ranks):
    """A closure field whose W is given in `adjoint_params`, at
    {'data': 4}: every rank's d/dW is JAX's one-device gradient within
    1e-12 of its largest, the same on every rank."""
    mesh_free = jnp.arange(1.0, 33.0).reshape(16, 2) / 16.0
    tgt = jnp.ones((16, 2)) * 0.3
    t = jnp.linspace(0., 1., 3)

    def loss(W_):
        ys = tde.odeint_adjoint(lambda s, y: jnp.tanh(y) @ W_.T, mesh_free, t,
                                rtol=1e-8, atol=1e-10)
        return jnp.sum((ys[-1] - tgt) ** 2)

    g_j = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(W)))
    out = [res['closure'] for res in _case(ranks, 'grad_routes')]
    for g in out:
        _rel(g, g_j, 1e-12)
    _same_on_every_rank(out)


def test_make_mesh_shapes_and_coordinates(ranks):
    """test_make_mesh at 4 ranks: JAX's shapes (the -1 wildcard too) and
    its ValueError; each rank's coordinates are its place in the mesh's
    row-major layout, as JAX lays devices out; a mesh of ranks 0 and 1
    leaves the others off it."""
    j = _jmesh({'data': 2, 'model': 2})
    j_wild = _jmesh({'data': -1, 'model': 2})
    with pytest.raises(ValueError) as err_j:
        _jmesh({'data': 3})
    for r, res in enumerate(_case(ranks, 'mesh')):
        assert res['shape'] == dict(j.shape) == {'data': 2, 'model': 2}
        assert res['wild'] == dict(j_wild.shape)
        assert res['line'] == {'data': WORLD}
        where = np.argwhere(np.vectorize(lambda d: d.id)(j.devices) ==
                            jax.devices()[r].id)[0]
        assert res['coord'] == tuple(int(x) for x in where)
        assert res['line_coord'] == r
        assert res['sub_coord'] == (r if r < 2 else None)
        assert res['device'] == 'cpu'
        assert res['bad'] == str(err_j.value)


def test_shard_params_placements(ranks):
    """test_shard_params_annotation: the large 2-D leaf sharded by column
    over 'model' (JAX's P(None, 'model')), the bias and a leaf below
    min_size replicated; every full tensor equals its input."""
    mesh = _jmesh({'data': 2, 'model': 2})
    params = [dict(w=jnp.zeros((256, 128)), b=jnp.zeros((128,)),
                   v=jnp.zeros((8, 4)))]
    sh = j_shard_params(params, mesh, 'model', min_size=1024)
    assert sh[0]['w'].sharding.spec == P(None, 'model')
    assert sh[0]['b'].sharding.spec == P() == sh[0]['v'].sharding.spec
    for res in _case(ranks, 'shard_params'):
        assert res['w']['placements'] == ['R', 'S(1)']
        assert res['w']['local'] == (256, 64)
        for k in ('b', 'v'):
            assert res[k]['placements'] == ['R', 'R']
        assert all(res[k]['equal'] for k in ('w', 'b', 'v'))


def test_ranks_import_no_jax(ranks):
    """The port's ranks ran every case without JAX or the JAX package."""
    for res in ranks.results():
        assert res['jax_modules'] == []


# ---- parareal_demo --mesh at 2 ranks, and a world of one ----------------------

def test_parareal_demo_mesh_two_ranks(tmp_path):
    """`parareal_demo --mesh` launched as torchrun launches it (RANK,
    WORLD_SIZE, MASTER_ADDR/PORT: make_mesh's env:// route), 2 ranks: the
    one-device demo's result, on every rank."""
    launch = _Launch(tmp_path, 'demo', 2, torchrun_env=True)
    try:
        out = parareal_demo.main(['--device', 'cpu', '--slices', '8',
                                  '--iters', '3'])
        for res in _case(launch, 'demo'):
            assert np.array_equal(res['ys'], out['ys'].numpy())
            assert res['err'] == out['err'] < 1e-4
    finally:
        launch.close()


def test_gather_refuses_what_it_cannot_place():
    """A sharded result holding a 0-d tensor or an object that is not a
    tensor, a Stats or a container of them raises TypeError, rather than
    come back as this rank's block."""
    assert not dist.is_initialized()
    try:
        mesh = make_mesh({'data': 1}, device_type='cpu')
        y0 = torch.ones(2, 1, dtype=torch.float64)
        t = torch.linspace(0., 1., 3, dtype=torch.float64)
        for ret, what in ((lambda ys: ys[-1, 0, 0], '0-d tensor'),
                          (lambda ys: (ys, object()), 'object')):
            solve = sharded_independent_odeint(
                lambda f, y, tt_, **k: ret(tt.odeint(f, y, tt_, **k)), mesh)
            with pytest.raises(TypeError, match=what):
                solve(lambda s, y: -y, y0, t)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_sharded_step_world_of_one_in_process():
    """examples/sharded_step.py with no launch: a world of one process on
    {'data': 1, 'model': 1}, whose step equals the one-device step bit for
    bit (the tensor-parallel field is the MLPField's operations, and the
    collectives over one rank are the identity)."""
    assert not dist.is_initialized()
    try:
        out = sharded_step.main(['--device', 'cpu', '--dtype', 'float64',
                                 '--steps', '1'])
        assert out['mesh'].shape == {'data': 1, 'model': 1}
        assert out['loss_rel_diff'] == 0.0 and out['grad_rel_diff'] == 0.0
        assert torch.equal(out['loss'], out['ref_loss'])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_tensor_parallel_mlp_takes_shard_params_dtensors():
    """`tensor_parallel_mlp` from the JAX-layout parameters as
    `shard_params` places them (W1 sharded by column, the rest
    replicated) on a world of one: the `MLPField` bit for bit; and so is
    an MLP of one layer, replicated whole."""
    assert not dist.is_initialized()
    try:
        from torchdiffeq_tpu_torch.parallel import shard_params
        mesh = make_mesh({'data': 1, 'model': 1}, device_type='cpu')
        mlp = MLPField([2, 16, 2], power=3, dtype=torch.float64,
                       device='cpu',
                       generator=torch.Generator().manual_seed(0))
        layers = [dict(w=w.detach(), b=b.detach())
                  for w, b in zip(mlp.weights, mlp.biases)]
        tp = tensor_parallel_mlp(shard_params(layers, mesh, min_size=1),
                                 mesh, power=3)
        y = torch.randn(8, 2, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(1))
        zero = torch.zeros((), dtype=torch.float64)
        assert torch.equal(tp(zero, y), mlp(zero, y))
        one = MLPField([2, 2], power=3, dtype=torch.float64, device='cpu',
                       generator=torch.Generator().manual_seed(2))
        tp1 = tensor_parallel_mlp([dict(w=one.weights[0], b=one.biases[0])],
                                  mesh, power=3)
        assert torch.equal(tp1(zero, y), one(zero, y))
        assert [tuple(p.shape) for p in tp1.parameters()] == [(2, 2), (2,)]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_world_of_one_in_process(monkeypatch):
    """With no process group and no torchrun environment, make_mesh makes
    a world of one process (JAX's mesh of the one device): each wrapper
    and Parareal's mesh equal their unsharded solves bit for bit.  The
    default device type, CUDA, raises with no card rather than fall back
    to the CPU."""
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, 'is_available', lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh({'data': 1})
    assert not dist.is_initialized()
    try:
        mesh = make_mesh({'data': -1}, device_type='cpu')
        assert mesh.shape == {'data': 1} and mesh.coordinate('data') == 0
        y0 = torch.arange(1.0, 9.0, dtype=torch.float64).reshape(4, 2)
        t = torch.linspace(0., 1., 3, dtype=torch.float64)
        f = lambda s, y: -y * y[:, :1]  # noqa: E731
        ref, st = tt.odeint_with_stats(f, y0, t)
        ys, st_dp = data_parallel_odeint(tt.odeint_with_stats, mesh)(
            f, y0, t)
        assert torch.equal(ys, ref) and list(st_dp) == list(st)
        ys, st_sh = sharded_independent_odeint(tt.odeint_with_stats, mesh)(
            f, y0, t)
        assert torch.equal(ys, ref) and st_sh == (st,)
        tm = make_mesh({'time': 1}, device_type='cpu')
        tp = torch.linspace(0., 2., 5, dtype=torch.float64)
        assert torch.equal(
            odeint_parareal(lambda s, y: -y, y0[0], tp, n_iters=2, mesh=tm),
            odeint_parareal(lambda s, y: -y, y0[0], tp, n_iters=2))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
