"""The device mesh on torch.distributed (`parallel/sharding.py`, Parareal's
``mesh=`` and ``parareal_demo --mesh``) against the JAX package's mesh,
mirroring tests/test_sharding.py and
tests/test_parareal.py::test_mesh_execution_matches_vmap.

The port runs one process a rank: one module-wide launch of 4 CPU ranks
(subprocess Pythons on gloo, meeting on a FileStore under the test's
temporary directory, one thread each; `torch_sharding_ranks.py`) runs
every case and writes its results to files, which the tests below read.
JAX runs here, on a mesh of 4 of the 8 virtual CPU devices that
conftest.py makes, so the shard counts match.  The ranks import no JAX.
Tolerances: values to 1e-12 of the largest (rtol 1e-10 for Parareal, as
JAX's own test), Stats counters exactly, gradients to 1e-9 of the largest
against JAX's shard_map + psum and to JAX's own 1e-5 against one
device."""
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
from torchdiffeq_tpu.parallel import (make_mesh as j_make_mesh,
                                      odeint_parareal as j_parareal,
                                      odeint_per_sample_with_stats as
                                      j_per_sample,
                                      shard_params as j_shard_params)
import torchdiffeq_tpu_torch as tt
from torchdiffeq_tpu_torch.examples import parareal_demo
from torchdiffeq_tpu_torch.parallel import (data_parallel_odeint, make_mesh,
                                            odeint_parareal,
                                            sharded_independent_odeint)

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


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    launch = _Launch(tmp_path_factory.mktemp('ranks'), 'mesh', WORLD)
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
    not divide, with JAX's message; under autograd the mesh refuses."""
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
        assert 'forward-only' in res['autograd']


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
    user norm, an indivisible batch and autograd are refused."""
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
        assert 'forward-only' in res['autograd']


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


@pytest.mark.parametrize("name", ['kvaerno5', 'implicit_euler',
                                  'implicit_adams', 'scipy_solver',
                                  'event_fn'])
def test_data_parallel_refuses_local_decisions(ranks, name):
    """A solve that decides by more than the error norm -- a stage
    solve's Newton test, an Adams corrector's, SciPy's controller, an event
    function -- would see one rank's block, and the ranks would part ways:
    data_parallel_odeint raises NotImplementedError on every rank, before
    any collective."""
    for res in _case(ranks, 'data_parallel'):
        msg = res['refused'][name]
        assert msg is not None and 'one' in msg and 'block' in msg
        assert ('event function' in msg) == (name == 'event_fn')


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
