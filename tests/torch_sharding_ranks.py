"""The ranks of tests/test_torch_sharding.py: one process a rank, on the CPU
with gloo, each running every case of a suite and writing its results to
``OUT/rank<r>.pkl`` for the tests to read.  Imports no JAX.

    python tests/torch_sharding_ranks.py OUT SUITE RANK WORLD [STORE]

With STORE the ranks meet on a ``FileStore`` there; without it they take
torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), as
`parallel.make_mesh` does.  A case that raises records its traceback
under ``'error'``, so each test reports its own case.
"""
import os
import pickle
import sys
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torchdiffeq_tpu_torch as tt  # noqa: E402
from torchdiffeq_tpu_torch.parallel import (  # noqa: E402
    data_parallel_odeint, make_mesh, odeint_parareal,
    odeint_per_sample_with_stats, shard_params, sharded_independent_odeint,
    tensor_parallel_mlp)
from torchdiffeq_tpu_torch.parallel import sharding  # noqa: E402

F64 = torch.float64
OUT = None       # the launch's output directory (main)


def _np(x):
    return x.detach().cpu().numpy()


def _counters(st):
    return [int(x) for x in st[:5]]


def _raises(fn, kind):
    """The message of the `kind` exception `fn` raises, or None."""
    try:
        fn()
    except kind as err:
        return str(err)
    return None


def case_mesh(rank):
    m = make_mesh({'data': 2, 'model': 2}, device_type='cpu')
    wild = make_mesh({'data': -1, 'model': 2}, device_type='cpu')
    line = make_mesh({'data': 4}, device_type='cpu')
    sub = make_mesh({'data': 2}, devices=[0, 1], device_type='cpu')
    return dict(
        shape=m.shape, wild=wild.shape, line=line.shape,
        coord=(m.coordinate('data'), m.coordinate('model')),
        line_coord=line.coordinate('data'), sub_coord=sub.coordinate('data'),
        device=str(m.device),
        bad=_raises(lambda: make_mesh({'data': 3}, device_type='cpu'),
                    ValueError))


def _dp_problem():
    t = torch.linspace(0., 1., 4, dtype=F64)
    y0 = torch.arange(1.0, 17.0, dtype=F64).reshape(16, 1)
    return t, y0


# data_parallel_odeint's routes beyond dopri5
DP_ROUTES = [('tsit5', None), ('rk4', dict(num_steps=8))]


def relax(s, y):
    """Each row relaxes at its own rate exp(q), q its third entry (constant),
    toward (cos s, sin s), with a cubic damping: row-wise, so a block's
    Newton Jacobian is the global one's diagonal block."""
    k = torch.exp(y[:, 2:])
    target = torch.cat([torch.cos(s).reshape(1), torch.sin(s).reshape(1)])
    dy = -k * (y[:, :2] - target) - 0.5 * y[:, :2] ** 3
    return torch.cat([dy, torch.zeros_like(k)], dim=1)


def relax_y0(k):
    """16 rows: rate 1 on ranks 0-1's blocks and `k` on ranks 2-3's."""
    r = np.arange(16.0)
    q = np.where(r < 8, 0.0, np.log(k))
    return np.stack([1.0 + 0.05 * r, 0.5 - 0.02 * r, q], axis=1)


def state_grid(y, t):
    """A grid of 1 + 8 max|y[:, 0]| steps (rounded down) over [t0, t1]: a
    grid_constructor that reads the whole batch's state (numpy, so JAX's
    solve takes it too)."""
    n = 1 + int(8 * float(abs(y[:, 0]).max()))
    return np.linspace(float(t[0]), float(t[-1]), n + 1)


# the solves whose decisions beyond the error norm are made global: (name,
# the stiff blocks' rate, keywords).  Blocks of unequal stiffness: the
# Newton tiers at rate 500 against 1, Broyden's (from the identity) at 20;
# the Adams and event solves on a mild problem.  t = linspace(0, 1, 3)
# (an event solve's [0, 1]); rtol 1e-8, atol 1e-10 unless given (the
# adaptive stiff solves at 1e-6 and 1e-8, kvaerno3 at 1e-5 and 1e-7, to
# keep their steps to tens on the CPU)
_ADAMS = dict(num_steps=20, max_order=4)
_STIFF = dict(rtol=1e-6, atol=1e-8)
DP_TOLS = dict(rtol=1e-8, atol=1e-10)
DP_DECISIONS = [
    ('kvaerno5', 500.0, dict(method='kvaerno5', **_STIFF)),
    ('radau5a', 500.0, dict(method='radau5a', **_STIFF)),
    ('kvaerno3', 500.0, dict(method='kvaerno3', rtol=1e-5, atol=1e-7)),
    ('implicit_euler', 20.0, dict(method='implicit_euler',
                                  options=dict(num_steps=10))),
    ('implicit_euler_newton', 500.0, dict(
        method='implicit_euler', options=dict(num_steps=10,
                                              root_solver='newton'))),
    ('trbdf2', 20.0, dict(method='trbdf2', options=dict(num_steps=10))),
    ('gl4', 20.0, dict(method='gl4', options=dict(num_steps=10))),
    ('implicit_adams', 2.0, dict(method='implicit_adams', options=_ADAMS)),
    ('explicit_adams', 2.0, dict(method='explicit_adams', options=_ADAMS)),
    ('scipy_solver', 500.0, dict(method='scipy_solver',
                                 options=dict(solver='LSODA'), **_STIFF)),
    ('grid_constructor', 2.0, dict(method='rk4', options=dict(
        grid_constructor=lambda f, y, t: state_grid(y, t)))),
    # the bisection resolves the event time to atol: 1e-12 here, since at
    # 1e-10 JAX's and the port's single-device event times, whose steps
    # round apart, stop 3e-11 apart
    ('event_fn', 2.0, dict(event_fn=lambda s, y: y[0, 0] - 0.5,
                           atol=1e-12)),
]


def case_decisions(rank):
    """Every DP_DECISIONS solve through data_parallel_odeint on 4 ranks,
    with its `Stats` and `IMPLICIT_COUNTS`; the single-device solve of
    case i on rank i % 4 (the ranks share the CPU's time)."""
    from torchdiffeq_tpu_torch.solvers.solution import (
        IMPLICIT_COUNTS, reset_implicit_counts)
    mesh = make_mesh({'data': 4}, device_type='cpu')
    solve = data_parallel_odeint(tt.odeint_with_stats, mesh)
    out = {}
    for i, (name, k, kw) in enumerate(DP_DECISIONS):
        y0 = torch.from_numpy(relax_y0(k))
        t = torch.linspace(0., 1., 2 if 'event_fn' in kw else 3, dtype=F64)
        out[name] = {}
        runs = [('mesh', solve)]
        if i % 4 == rank:
            runs.append(('one', tt.odeint_with_stats))
        for which, run in runs:
            reset_implicit_counts()
            with torch.no_grad():
                ys, st = run(relax, y0, t, **dict(DP_TOLS, **kw))
            if 'event_fn' in kw:
                out[name][which + '_et'] = float(ys[0])
                ys = ys[1]
            out[name][which] = dict(ys=_np(ys), st=_counters(st),
                                    counts=dict(IMPLICIT_COUNTS))
    return out


def case_data_parallel(rank):
    mesh = make_mesh({'data': 4}, device_type='cpu')
    t, y0 = _dp_problem()
    kw = dict(rtol=1e-8, atol=1e-10)
    solve = data_parallel_odeint(tt.odeint_with_stats, mesh)
    ys, st = solve(lambda s, y: -y, y0, t, **kw)
    ys1, st1 = tt.odeint_with_stats(lambda s, y: -y, y0, t, **kw)
    # a pytree state: each leaf's global RMS, then the max
    fd = lambda s, y: {'p': -y['p'], 'q': -3.0 * y['q'] * y['p']}  # noqa
    y0d = {'p': y0 / 16.0, 'q': torch.linspace(0.1, 2.0, 32, dtype=F64)
           .reshape(16, 2)}
    ysd, std = solve(fd, y0d, t, **kw)
    # the other routes it keeps: another explicit tableau, a fixed grid
    routes = {}
    for method, opts in DP_ROUTES:
        kwm = dict(kw, method=method, options=opts)
        ysm, stm = solve(lambda s, y: -y * y, y0 / 16.0, t, **kwm)
        ysm1, stm1 = tt.odeint_with_stats(lambda s, y: -y * y, y0 / 16.0,
                                          t, **kwm)
        routes[method] = dict(ys=_np(ysm), st=_counters(stm), ys1=_np(ysm1),
                              st1=_counters(stm1))
    # under autograd (plain odeint, the continuous adjoint): the global
    # gradient of an args tensor on every rank, the one-device solve's
    grads = []
    for run in (solve, tt.odeint_with_stats):
        w = torch.tensor(1.0, dtype=F64, requires_grad=True)
        ysw, _ = run(lambda s, y, ww: -ww * y * y, y0 / 16.0, t, args=(w,),
                     **kw)
        (ysw[-1] ** 2).sum().backward()
        grads.append(float(w.grad))
    return dict(
        ys=_np(ys), st=_counters(st), ys1=_np(ys1), st1=_counters(st1),
        ysd={k: _np(v) for k, v in ysd.items()}, std=_counters(std),
        routes=routes,
        user_norm=_raises(lambda: solve(lambda s, y: -y, y0, t, options=dict(
            norm=lambda x: x.abs().max())), NotImplementedError),
        indivisible=_raises(lambda: solve(lambda s, y: -y, y0[:6], t),
                            ValueError),
        autograd=grads)


KS = np.array([1.0] * 4 + [200.0] * 4)


def case_sharded(rank):
    """JAX's easy/stiff problem: each block of 2 samples its own k."""
    mesh = make_mesh({'data': 4}, device_type='cpu')
    c = mesh.coordinate('data')
    kb = torch.tensor(KS[2 * c:2 * c + 2], dtype=F64)
    t = torch.tensor([0.0, 1.0], dtype=F64)
    solve = sharded_independent_odeint(tt.odeint_with_stats, mesh)
    ys, stats = solve(lambda s, y: -kb[:, None] * y,
                      torch.ones(8, 1, dtype=F64), t, rtol=1e-6, atol=1e-8)
    return dict(ys=_np(ys), stats=[_counters(s) for s in stats],
                indivisible=_raises(lambda: solve(
                    lambda s, y: -y, torch.ones(6, 1, dtype=F64), t),
                    ValueError))


W = np.array([[-0.5, 0.8], [-0.8, -0.5]])


def _grad_problem():
    y0 = torch.arange(1.0, 33.0, dtype=F64).reshape(16, 2) / 16.0
    tgt = torch.full((16, 2), 0.3, dtype=F64)
    return y0, tgt, torch.linspace(0., 1., 3, dtype=F64)


def _field(s, y, W_):
    return torch.tanh(y) @ W_.T


def case_adjoint(rank):
    """Per-shard adjoint gradients with an explicit all_reduce (JAX's
    shard_map + psum), the continuous and the interpolated adjoint; and
    the gradient through `sharded_independent_odeint`'s gather."""
    mesh = make_mesh({'data': 4}, device_type='cpu')
    c = mesh.coordinate('data')
    y0, tgt, t = _grad_problem()
    blk = slice(4 * c, 4 * c + 4)
    out = {}
    for name, opts in (('continuous', None),
                       ('interpolated', dict(interpolated=True))):
        Wt = torch.tensor(W, requires_grad=True)
        ys = tt.odeint_adjoint(_field, y0[blk], t, rtol=1e-8, atol=1e-10,
                               args=(Wt,), adjoint_options=opts)
        ((ys[-1] - tgt[blk]) ** 2).sum().backward()
        g = Wt.grad.clone()
        dist.all_reduce(g, group=mesh.group('data'))
        out[name] = _np(g)
    Wt = torch.tensor(W, requires_grad=True)
    solve = sharded_independent_odeint(
        lambda func, y, tt_, **kw: tt.odeint_adjoint(func, y, tt_, **kw),
        mesh)
    ys = solve(_field, y0, t, rtol=1e-8, atol=1e-10, args=(Wt,))
    ((ys[-1] - tgt) ** 2).sum().backward()
    g = Wt.grad.clone()
    dist.all_reduce(g, group=mesh.group('data'))
    out['gathered'] = _np(g)
    return out


def case_events(rank):
    """Per-sample event times on a sharded batch of 8."""
    mesh = make_mesh({'data': 4}, device_type='cpu')
    y0 = torch.linspace(1.5, 4.0, 8, dtype=F64)[:, None]

    def per_sample(func, y, t, **kw):
        (et, ys), _ = odeint_per_sample_with_stats(
            func, y, t, event_fn=lambda s, yy: yy[0] - 1.0, **kw)
        return et, ys.transpose(0, 1)     # (B,) and odeint's (2, B, 1)

    with torch.no_grad():
        et, ys = sharded_independent_odeint(per_sample, mesh)(
            lambda s, y: -y, y0, torch.tensor([0.0, 1.0], dtype=F64),
            rtol=1e-8, atol=1e-10)
    return dict(et=_np(et), ys=_np(ys))


def stiffish(s, y):
    """tests/test_parareal.py's `_stiffish_field`."""
    return torch.stack([-0.5 * y[0] + 2.0 * y[1], -2.0 * y[0] - 0.5 * y[1]])


class Stiffish(torch.nn.Module):
    """`stiffish` as ``a * (y @ W.T)``, W a parameter: W = [[-0.5, 2],
    [-2, -0.5]] and a = 1 give it back."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(PAR_W, dtype=F64))

    def forward(self, s, y, a):
        return a * (y @ self.w.T)


PAR_W = [[-0.5, 2.0], [-2.0, -0.5]]
PAR_A = 1.1


def case_parareal(rank):
    """8 slices over 4 ranks, against the one-device scheme; 6 slices do
    not divide.  Under autograd, the gradients of y0, the Module's W, an
    args tensor and t of sum(ys**2), on the mesh and with mesh=None, and
    the mesh's forward without autograd."""
    mesh = make_mesh({'time': 4}, device_type='cpu')
    y0 = torch.tensor([1.0, 0.3], dtype=F64)
    t = torch.linspace(0., 4., 9, dtype=F64)
    kw = dict(rtol=1e-8, atol=1e-10, n_iters=3)
    ys_m = odeint_parareal(stiffish, y0, t, mesh=mesh, axis='time', **kw)
    ys_v = odeint_parareal(stiffish, y0, t, **kw)
    with torch.no_grad():
        ys_f = odeint_parareal(Stiffish(), y0, t, mesh=mesh, axis='time',
                               args=(torch.tensor(PAR_A, dtype=F64),), **kw)
    grads = {'forward': _np(ys_f)}
    for name, m in (('mesh', mesh), ('one', None)):
        field = Stiffish()
        a = torch.tensor(PAR_A, dtype=F64, requires_grad=True)
        y0g = y0.clone().requires_grad_(True)
        tg = t.clone().requires_grad_(True)
        ys = odeint_parareal(field, y0g, tg, mesh=m, axis='time',
                             args=(a,), **kw)
        (ys ** 2).sum().backward()
        grads[name] = dict(ys=_np(ys), y0=_np(y0g.grad),
                           w=_np(field.w.grad), a=_np(a.grad),
                           t=_np(tg.grad))
    return dict(
        ys_m=_np(ys_m), ys_v=_np(ys_v), grads=grads,
        indivisible=_raises(lambda: odeint_parareal(
            stiffish, y0, torch.linspace(0., 4., 7, dtype=F64), mesh=mesh,
            axis='time', **kw), ValueError))


def case_shard_params(rank):
    mesh = make_mesh({'data': 2, 'model': 2}, device_type='cpu')
    rng = np.random.RandomState(0)
    params = [dict(w=torch.from_numpy(rng.randn(256, 128)),
                   b=torch.from_numpy(rng.randn(128)),
                   v=torch.from_numpy(rng.randn(8, 4)))]
    sh = shard_params(params, mesh, 'model', min_size=1024)
    return {k: dict(placements=[str(p) for p in d.placements],
                    local=tuple(d.to_local().shape),
                    equal=bool(torch.equal(d.full_tensor(), params[0][k])))
            for k, d in sh[0].items()}


class _BackwardStats:
    """While active, the `Stats` counters of every backward solve (each
    call of the adjoint's `_raw_odeint`)."""

    def __enter__(self):
        from torchdiffeq_tpu_torch import adjoint
        self.module, self.raw, self.counters = adjoint, adjoint._raw_odeint, []

        def recorded(*a, **k):
            ys, st = self.raw(*a, **k)
            self.counters.append(_counters(st))
            return ys, st
        adjoint._raw_odeint = recorded
        return self

    def __exit__(self, *exc):
        self.module._raw_odeint = self.raw


def _spiral_params(dtype):
    """The JAX package's `init_spiral_model(PRNGKey(0), 128)` in `dtype`,
    written by the test before the launch."""
    p = np.load(os.path.join(OUT, 'spiral_params.npz'))
    return [dict(w=p[f'w1_{dtype}'], b=p[f'b1_{dtype}']),
            dict(w=p[f'w2_{dtype}'], b=p[f'b2_{dtype}'])]


def _step(mesh, dtype, adjoint_options=None):
    """The dry run's step (hidden 128, batch 64, y0 and target from numpy
    seeds 1 and 2) sharded on `mesh`, and the one-device step of the same
    weights: loss, gradients (gathered, in JAX's [W1, b1, W2, b2] order),
    y0's and t's gradients, and forward and backward counters of each."""
    from torchdiffeq_tpu_torch.examples import sharded_step
    from torchdiffeq_tpu_torch.models import mlp_params_from_jax
    cfg = sharded_step.config(4)
    npd = np.dtype(dtype)
    y0 = torch.from_numpy(np.random.RandomState(1).randn(64, 2).astype(npd))
    tgt = torch.from_numpy(np.random.RandomState(2).randn(64, 2)
                           .astype(npd))
    kw = dict(rtol=cfg['rtol'], atol=cfg['atol'], lr=cfg['lr'],
              adjoint_options=adjoint_options)
    out = {}
    for name in ('sharded', 'single'):
        field = mlp_params_from_jax(_spiral_params(dtype), power=3,
                                    device='cpu')
        if name == 'sharded':
            field = tensor_parallel_mlp(field, mesh)
            solve = data_parallel_odeint(tt.odeint_adjoint, mesh)
            stats = data_parallel_odeint(tt.odeint_with_stats, mesh)
        else:
            solve, stats = tt.odeint_adjoint, tt.odeint_with_stats
        with torch.no_grad():
            _, st = stats(field, y0, cfg['t'], rtol=cfg['rtol'],
                          atol=cfg['atol'])
        yg = y0.clone().requires_grad_(True)
        tg = cfg['t'].clone().requires_grad_(True)
        with _BackwardStats() as bwd:
            loss, grads = sharded_step.train_step(field, solve, yg, tgt, tg,
                                                  **kw)
        if name == 'sharded':
            grads = field.gather(grads)
        w1, w2, b1, b2 = grads
        out[name] = dict(loss=float(loss),
                         grads=[_np(x) for x in (w1, b1, w2, b2)],
                         y0=_np(yg.grad), t=_np(tg.grad), st=_counters(st),
                         bwd=bwd.counters)
    return out


def case_step(rank):
    """The dry run's step at n=4 ({'data': 2, 'model': 2}) in float64 and
    float32, and on {'data': 4, 'model': 1} and {'data': 1, 'model': 4}
    with the default norm and 'seminorm' in float64."""
    out = {}
    mesh = make_mesh({'data': 2, 'model': 2}, device_type='cpu')
    for dtype in ('float64', 'float32'):
        out[dtype] = _step(mesh, dtype)
    for shape in ({'data': 4, 'model': 1}, {'data': 1, 'model': 4}):
        m = make_mesh(shape, device_type='cpu')
        for norm in ('default', 'seminorm'):
            out[f"data{shape['data']}_{norm}"] = _step(
                m, 'float64', None if norm == 'default' else dict(norm=norm))
    return out


def _tp_vs_mlp(field, mesh, y, ct):
    """`field` (an MLPField) split by `tensor_parallel_mlp` on `mesh` and
    whole: each one's values and VJP in y and the (gathered) parameters,
    the split field's local shapes and whether its `full_field()` is
    `field` exactly."""
    out = {}
    for name in ('tp', 'mlp'):
        f_ = tensor_parallel_mlp(field, mesh) if name == 'tp' else field
        yg = y.clone().requires_grad_(True)
        f = f_(torch.zeros((), dtype=F64), yg)
        params = list(f_.parameters())
        grads = torch.autograd.grad(f, [yg] + params, ct)
        if name == 'tp':
            grads = grads[:1] + tuple(f_.gather(grads[1:]))
            out['full_equal'] = all(
                torch.equal(a, b) for a, b in zip(
                    f_.full_field().parameters(), field.parameters()))
            out['local_shapes'] = [tuple(p.shape) for p in params]
        out[name] = dict(f=_np(f), grads=[_np(g) for g in grads])
    return out


def case_tensor_parallel(rank):
    """The tensor-parallel field alone on {'data': 2, 'model': 2}: its
    values and its VJP in y0 and the (gathered) parameters against the
    `MLPField`'s, float64, the dry run's field and one of two hidden
    layers."""
    from torchdiffeq_tpu_torch.models import mlp_params_from_jax
    mesh = make_mesh({'data': 2, 'model': 2}, device_type='cpu')
    rng = np.random.RandomState(3)
    y = torch.from_numpy(rng.randn(64, 2))
    ct = torch.from_numpy(rng.randn(64, 2))
    out = _tp_vs_mlp(mlp_params_from_jax(_spiral_params('float64'),
                                         power=3, device='cpu'), mesh, y, ct)
    deep = tt.models.MLPField([2, 8, 8, 2], device='cpu', dtype=F64,
                              generator=torch.Generator().manual_seed(4))
    out['deeper'] = _tp_vs_mlp(deep, mesh, y, ct)
    return out


# tensor_parallel_mlp at every depth: JAX's `init_mlp` weights of these
# sizes, with biases from numpy (init_mlp's are zeros, which would hide a
# bias added on every model rank), written by the test to
# OUT/tp_depths.npz; the two deeper ones also through the adjoint
TP_MESHES = ({'data': 2, 'model': 2}, {'data': 1, 'model': 4})
TP_SIZES = ([2, 2], [2, 16, 2], [2, 16, 16, 2], [2, 16, 16, 16, 2])
TP_GRAD_SIZES = TP_SIZES[2:]
TP_GRAD_KW = dict(rtol=1e-6, atol=1e-8)
TP_GRAD_T = [0.0, 0.5]


def tp_key(shape, sizes):
    return f"data{shape['data']}_" + 'x'.join(map(str, sizes))


def tp_inputs():
    """The field's inputs, y and a cotangent, and the adjoint solve's y0,
    (16, 2) each, from numpy seeds 5, 6 and 7 (16 rows: at 64 the
    unsplit `MLPField`'s VJP is already 1.06e-15 of its largest from
    JAX's, the batch sums' order, at the tests' 1e-15)."""
    return [np.random.RandomState(s).randn(16, 2) for s in (5, 6, 7)]


def _tp_layers(sizes):
    p = np.load(os.path.join(OUT, 'tp_depths.npz'))
    key = 'x'.join(map(str, sizes))
    return [dict(w=p[f'{key}_w{i}'], b=p[f'{key}_b{i}'])
            for i in range(len(sizes) - 1)]


def case_tp_depths(rank):
    """`tensor_parallel_mlp` of every TP_SIZES field on each TP_MESHES
    mesh: its values and VJP, local shapes and `full_field()`
    (`_tp_vs_mlp`), the `shard_params` DTensors' intake (its values bit
    for bit the split field's), and for TP_GRAD_SIZES the gradients of
    sum(ys[-1]**2) through `data_parallel_odeint(odeint_adjoint)` (dopri5)
    in the gathered parameters and y0.  Then a split field with kvaerno5
    as adjoint method raises on every rank before any collective, and the
    all-reduce after it completes."""
    from torchdiffeq_tpu_torch.models import mlp_params_from_jax
    y, ct, y0 = (torch.from_numpy(x) for x in tp_inputs())
    t = torch.tensor(TP_GRAD_T, dtype=F64)
    out = {}
    for shape in TP_MESHES:
        mesh = make_mesh(shape, device_type='cpu')
        for sizes in TP_SIZES:
            layers = _tp_layers(sizes)
            field = mlp_params_from_jax(layers, device='cpu')
            res = _tp_vs_mlp(field, mesh, y, ct)
            placed = shard_params(
                [{k: torch.from_numpy(v) for k, v in layer.items()}
                 for layer in layers], mesh, min_size=1)
            zero = torch.zeros((), dtype=F64)
            with torch.no_grad():
                res['dtensor_equal'] = torch.equal(
                    tensor_parallel_mlp(placed, mesh)(zero, y),
                    tensor_parallel_mlp(field, mesh)(zero, y))
            if sizes in TP_GRAD_SIZES:
                tp = tensor_parallel_mlp(field, mesh)
                yg = y0.clone().requires_grad_(True)
                ys = data_parallel_odeint(tt.odeint_adjoint, mesh)(
                    tp, yg, t, **TP_GRAD_KW)
                grads = torch.autograd.grad((ys[-1] ** 2).sum(),
                                            [*tp.parameters(), yg])
                res['grad'] = [_np(g) for g in tp.gather(grads[:-1])] + [
                    _np(grads[-1])]
            out[tp_key(shape, sizes)] = res
    mesh = make_mesh(TP_MESHES[0], device_type='cpu')
    tp = tensor_parallel_mlp(mlp_params_from_jax(_tp_layers(TP_SIZES[2]),
                                                 device='cpu'), mesh)
    out['refused'] = _raises(lambda: data_parallel_odeint(
        tt.odeint_adjoint, mesh)(tp, y0.clone().requires_grad_(True), t,
                                 adjoint_method='kvaerno5', **TP_GRAD_KW),
        NotImplementedError)
    after = torch.ones(1)
    dist.all_reduce(after)
    out['after'] = float(after)
    return out


class Spin(torch.nn.Module):
    """``y' = w * tanh(y) @ W.T``: W a parameter (SPIN_W), w an args
    scale; row-wise, so each rank's block is its own."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(SPIN_W, dtype=F64))

    def forward(self, s, y, a):
        return a * torch.tanh(y) @ self.w.T


SPIN_W = [[-0.5, 0.8], [-0.8, -0.5]]
SPIN_T = [0.0, 0.5, 1.0]
# a level y[0, 0] crosses near t = 0.2 (it starts at 0.0625); bisected to
# atol 1e-12 (C24: the event time is resolved to atol)
SPIN_EVENT = 0.08
EVENT_TOLS = dict(rtol=1e-8, atol=1e-12)


def spin_event(s, y):
    return y[0, 0] - SPIN_EVENT


def spin_y0():
    return torch.arange(1.0, 33.0, dtype=F64).reshape(16, 2) / 16.0


def max_rms(xs):
    """A callable adjoint norm: the largest RMS of its parts (vjp_t, y,
    adj_y and each theta_bar)."""
    return torch.stack([torch.sqrt(torch.mean(x.abs() ** 2))
                        for x in xs]).max()


def _event_solve(func, y0, t, **kw):
    """`odeint` of an event solve, its state: autograd takes the event-mode
    adjoint with the event time held fixed."""
    return tt.odeint_with_stats(func, y0, t, **kw)[0][1], None


def _event_time(func, y0, t, options=None, **kw):
    """`odeint_event` from t[0]: (event_t, the state's solution)."""
    return tt.odeint_event(func, y0, t[0], options=options, **kw), None


def _with_stats(func, y0, t, **kw):
    return tt.odeint_with_stats(func, y0, t, **kw)


def _adjoint(func, y0, t, **kw):
    return tt.odeint_adjoint(func, y0, t, **kw), None


# the gradient routes of data_parallel_odeint: (name, odeint_fn, keywords).
# The first ten were refused before the data axis's autograd Functions and
# the backward's augmented axis (implicit_adjoint and adams_adjoint); the
# Adams adjoint methods take 8 steps an interval, so that their corrector
# runs (a single step is the RK4 bootstrap)
_ADAMS_ADJ = dict(num_steps=8, max_order=4)
DP_GRAD = [
    ('fixed_grid', _with_stats, dict(method='rk4', options=dict(num_steps=8))),
    ('replay_grad', _with_stats, dict(options=dict(replay_grad=True))),
    ('forward_grad', _with_stats, dict(options=dict(forward_grad=True))),
    ('interpolated', _adjoint, dict(adjoint_options=dict(interpolated=True))),
    ('implicit_adjoint', _adjoint, dict(adjoint_method='kvaerno5')),
    ('callable_norm', _adjoint, dict(adjoint_options=dict(norm=max_rms))),
    ('implicit_fixed_grid', _with_stats,
     dict(method='implicit_euler', options=dict(num_steps=8))),
    ('event_solve', _event_solve, dict(event_fn=spin_event, **EVENT_TOLS)),
    ('adams_adjoint', _adjoint, dict(adjoint_method='implicit_adams',
                                     adjoint_options=_ADAMS_ADJ)),
    ('scipy_adjoint', _adjoint, dict(adjoint_method='scipy_solver',
                                     adjoint_options=dict(solver='RK45'))),
    # beyond the ten
    ('adams', _with_stats, dict(method='implicit_adams',
                                options=dict(num_steps=8, max_order=4))),
    ('implicit_euler_newton', _with_stats, dict(
        method='implicit_euler', options=dict(num_steps=8,
                                              root_solver='newton'))),
    ('rk4_remat', _with_stats,
     dict(method='rk4', options=dict(num_steps=8, remat=True))),
    ('event_time', _event_time, dict(event_fn=spin_event, **EVENT_TOLS)),
    ('replay_event', _event_time, dict(event_fn=spin_event,
                                       options=dict(replay_grad=True),
                                       **EVENT_TOLS)),
    # implicit and Adams adjoint methods beside kvaerno5 and implicit_adams:
    # radau5a's stacked stages, the fixed-grid implicit methods' Broyden and
    # Newton, the interpolated adjoint's state without y, fixed_adams
    ('radau5a_adjoint', _adjoint, dict(adjoint_method='radau5a')),
    ('implicit_euler_adjoint', _adjoint, dict(
        adjoint_method='implicit_euler', adjoint_options=dict(num_steps=8))),
    ('implicit_euler_newton_adjoint', _adjoint, dict(
        adjoint_method='implicit_euler',
        adjoint_options=dict(num_steps=8, root_solver='newton'))),
    ('interpolated_implicit', _adjoint, dict(
        adjoint_method='kvaerno5', adjoint_options=dict(interpolated=True))),
    ('fixed_adams_adjoint', _adjoint, dict(adjoint_method='fixed_adams',
                                           adjoint_options=_ADAMS_ADJ)),
]
DP_TOLS_GRAD = dict(rtol=1e-8, atol=1e-10)


class _Counters:
    """While active, the `Stats` counters of every forward solve (each
    call of odeint's `_odeint_impl` and of `adjoint_solve`) and every
    backward solve (`_BackwardStats`), and the number of the data axis's
    max all-reduces (`maxes`: the Adams corrector's global tests)."""

    def __enter__(self):
        from torchdiffeq_tpu_torch import adjoint
        self.saved = [(adjoint, 'adjoint_solve'),
                      (sys.modules['torchdiffeq_tpu_torch.odeint'],
                       '_odeint_impl')]
        self.fwd, self.bwd = [], _BackwardStats().__enter__()
        for module, name in self.saved:
            setattr(module, name, self._recording(getattr(module, name)))
        self.maxes, self._max = 0, sharding._DataAxis.max

        def counted(axis, x):
            self.maxes += 1
            return self._max(axis, x)
        sharding._DataAxis.max = counted
        return self

    def _recording(self, fn):
        def recorded(*a, **k):
            out, st = fn(*a, **k)
            self.fwd.append(_counters(st))
            return out, st
        recorded.original = fn
        return recorded

    def __exit__(self, *exc):
        for module, name in self.saved:
            setattr(module, name, getattr(module, name).original)
        sharding._DataAxis.max = self._max
        self.bwd.__exit__()


def _spin_grads(run, kw, forward_mode):
    """Through `run`: the gradients of the loss sum(ys**2) (an event
    solve's 3 event_t + sum(y_event**2)) in Spin's W, the args scale w, y0
    and t, or in forward mode (``torch.func.jvp``, W swapped in by
    ``functional_call``) the tangent of ys along all four at once; and the
    forward and backward counters."""
    field = Spin()
    kw = dict(DP_TOLS_GRAD, **kw)
    t = torch.tensor([0.0, 1.0] if 'event_fn' in kw else SPIN_T, dtype=F64)
    a = torch.tensor(1.1, dtype=F64)
    with _Counters() as c:
        if forward_mode:
            def ys_of(w, aa, y0, tt_):
                return run(lambda s, y, x: torch.func.functional_call(
                    field, {'w': w}, (s, y, x)), y0, tt_, args=(aa,), **kw)[0]

            inputs = (field.w.detach(), a, spin_y0(), t)
            _, tan = torch.func.jvp(ys_of, inputs,
                                    tuple(torch.ones_like(x) for x in inputs))
            grads = [_np(tan)]
        else:
            leaves = [field.w] + [x.clone().requires_grad_(True)
                                  for x in (a, spin_y0(), t)]
            out, _ = run(field, leaves[2], leaves[3], args=(leaves[1],), **kw)
            if isinstance(out, tuple):
                loss = 3.0 * out[0] + (out[1][-1] ** 2).sum()
            else:
                loss = (out ** 2).sum()
            loss.backward()
            grads = [np.zeros(tuple(x.shape)) if x.grad is None
                     else _np(x.grad) for x in leaves]
    return dict(grads=grads, fwd=c.fwd, bwd=c.bwd.counters, maxes=c.maxes)


def case_grad_routes(rank):
    """Every gradient route of DP_GRAD through data_parallel_odeint on 4
    ranks, and the single-device gradient of case i on rank i % 4.  A
    closure field whose W is given in `adjoint_params` gets the global
    d/dW on every rank; one whose W is not (C25) gets its block's share
    through the fixed grid."""
    mesh = make_mesh({'data': 4}, device_type='cpu')
    t = _dp_problem()[0]
    routes = {}
    for i, (name, fn, kw) in enumerate(DP_GRAD):
        runs = [('mesh', data_parallel_odeint(fn, mesh))]
        if i % 4 == rank:
            runs.append(('one', fn))
        routes[name] = {which: _spin_grads(run, kw, name == 'forward_grad')
                        for which, run in runs}
    # an implicit forward method under the continuous adjoint with an
    # explicit adjoint method: the global gradient, the one-device one's
    implicit = []
    for run in (data_parallel_odeint(tt.odeint_adjoint, mesh),
                tt.odeint_adjoint):
        w = torch.tensor(1.0, dtype=F64, requires_grad=True)
        ysw = run(lambda s, y, ww: ww * relax(s, y),
                  torch.from_numpy(relax_y0(2.0)), t, rtol=1e-8, atol=1e-10,
                  args=(w,), method='kvaerno5', adjoint_method='dopri5')
        (ysw[-1] ** 2).sum().backward()
        implicit.append(float(w.grad))
    y0c, tgt, tc = _grad_problem()
    Wt = torch.tensor(W, requires_grad=True)
    ys = data_parallel_odeint(tt.odeint_adjoint, mesh)(
        lambda s, y: torch.tanh(y) @ Wt.T, y0c, tc, rtol=1e-8, atol=1e-10,
        adjoint_params=(Wt,))
    ((ys[-1] - tgt) ** 2).sum().backward()
    # C25: a tensor the field captures, seen by no wrapper, through the
    # fixed grid: each rank's gradient is its block's share
    c25 = []
    for run in (data_parallel_odeint(tt.odeint, mesh), tt.odeint):
        Wc = torch.tensor(W, requires_grad=True)
        ysc = run(lambda s, y: torch.tanh(y) @ Wc.T, y0c, tc, method='rk4',
                  options=dict(num_steps=8))
        ((ysc[-1] - tgt) ** 2).sum().backward()
        c25.append(Wc.grad.clone())
    share = c25[0].clone()
    dist.all_reduce(share, group=mesh.group('data'))
    return dict(routes=routes, closure=_np(Wt.grad), implicit=implicit,
                c25=dict(rank=_np(c25[0]), summed=_np(share),
                         one=_np(c25[1])),
                pytree=_pytree_routes(mesh))


def _pytree_routes(mesh):
    """A dict state through the routes whose backward gathers it (SciPy's
    and a callable norm's): the gradients in an args scale and both
    leaves of y0, on the mesh and on one device."""
    t = torch.tensor(SPIN_T, dtype=F64)
    Wd = torch.tensor(SPIN_W, dtype=F64)

    def field(s, y, a):
        return {'p': a * torch.tanh(y['p']) @ Wd.T,
                'q': -a * y['q'] * y['p'][:, 0]}

    out = {}
    for name, kw in (('scipy_adjoint', dict(adjoint_method='scipy_solver',
                                            adjoint_options=dict(
                                                solver='RK45'))),
                     ('callable_norm', dict(adjoint_options=dict(
                         norm=max_rms)))):
        out[name] = []
        for run in (data_parallel_odeint(tt.odeint_adjoint, mesh),
                    tt.odeint_adjoint):
            a = torch.tensor(1.1, dtype=F64, requires_grad=True)
            y0 = {'p': spin_y0().requires_grad_(True),
                  'q': torch.linspace(0.5, 1.5, 16, dtype=F64)
                  .requires_grad_(True)}
            ys = run(field, y0, t, args=(a,), **dict(DP_TOLS_GRAD, **kw))
            ((ys['p'] ** 2).sum() + (ys['q'] ** 2).sum()).backward()
            out[name].append([_np(x.grad) for x in (a, y0['p'], y0['q'])])
    return out


def case_tp_fixed_grid(rank):
    """The dry run's field split by `tensor_parallel_mlp` on {'data': 2,
    'model': 2} (hidden 128, batch 64 from numpy seeds 1 and 2, float64),
    differentiated through rk4's loop with remat (each recomputed step
    issues its model all-reduces in the backward): the loss mean((ys[-1] -
    target)**2) and the gradients in the (gathered) parameters, y0 and t,
    on the mesh and for the one-device MLPField."""
    from torchdiffeq_tpu_torch.models import mlp_params_from_jax
    mesh = make_mesh({'data': 2, 'model': 2}, device_type='cpu')
    y0 = torch.from_numpy(np.random.RandomState(1).randn(64, 2))
    tgt = torch.from_numpy(np.random.RandomState(2).randn(64, 2))
    out = {}
    for name in ('sharded', 'single'):
        field = mlp_params_from_jax(_spiral_params('float64'), power=3,
                                    device='cpu')
        solve = tt.odeint
        if name == 'sharded':
            field = tensor_parallel_mlp(field, mesh)
            solve = data_parallel_odeint(tt.odeint, mesh)
        yg = y0.clone().requires_grad_(True)
        tg = torch.tensor([0.0, 0.5], dtype=F64, requires_grad=True)
        ys = solve(field, yg, tg, method='rk4',
                   options=dict(num_steps=TP_STEPS, remat=True))
        loss = ((ys[-1] - tgt) ** 2).mean()
        grads = torch.autograd.grad(loss, [*field.parameters(), yg, tg])
        params = list(grads[:-2])
        if name == 'sharded':
            params = field.gather(params)
        w1, w2, b1, b2 = params
        out[name] = dict(loss=float(loss.detach()),
                         grads=[_np(x) for x in (w1, b1, w2, b2)],
                         y0=_np(grads[-2]), t=_np(grads[-1]))
    return out


TP_STEPS = 8


def case_demo(rank):
    """examples/parareal_demo.py --mesh over the launch's ranks."""
    from torchdiffeq_tpu_torch.examples import parareal_demo
    out = parareal_demo.main(['--mesh', '--device', 'cpu', '--slices', '8',
                              '--iters', '3'])
    return dict(ys=_np(out['ys']), err=out['err'])


SUITES = {
    'mesh': [('mesh', case_mesh), ('data_parallel', case_data_parallel),
             ('decisions', case_decisions),
             ('sharded', case_sharded), ('adjoint', case_adjoint),
             ('events', case_events), ('parareal', case_parareal),
             ('shard_params', case_shard_params), ('step', case_step),
             ('tensor_parallel', case_tensor_parallel),
             ('tp_depths', case_tp_depths),
             ('grad_routes', case_grad_routes),
             ('tp_fixed_grid', case_tp_fixed_grid)],
    'demo': [('demo', case_demo)],
}


def main(out, suite, rank, world, store=None):
    global OUT
    OUT = out
    torch.set_num_threads(1)
    if store is not None:
        dist.init_process_group('gloo', store=dist.FileStore(store, world),
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=90))
    results = {}
    for name, case in SUITES[suite]:
        try:
            results[name] = case(rank)
        except Exception:
            results[name] = dict(error=traceback.format_exc())
    results['jax_modules'] = sorted(m for m in sys.modules
                                    if m == 'jax' or m.startswith('jax.')
                                    or m.startswith('torchdiffeq_tpu.'))
    with open(os.path.join(out, f'rank{rank}.pkl'), 'wb') as fh:
        pickle.dump(results, fh)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == '__main__':
    a = sys.argv[1:]
    main(a[0], a[1], int(a[2]), int(a[3]), a[4] if len(a) > 4 else None)
