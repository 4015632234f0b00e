"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need an NVIDIA GPU and nvcc; without a CUDA device every test skips.
On a GPU machine, which has no JAX, run them without the JAX test setup:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from torchdiffeq_tpu_torch import (odeint, odeint_with_stats,
                                   odeint_per_sample,
                                   odeint_per_sample_with_stats, odeint_event,
                                   odeint_dense)
from torchdiffeq_tpu_torch.models import (LinearEvent, MLPField,
                                          mlp_params_from_jax)
from torchdiffeq_tpu_torch.ops import fused_field, kernels, tableaus
from torchdiffeq_tpu_torch.ops.traced import PerSampleEvent, PerSampleField

pytestmark = pytest.mark.gpu

# float64: kernel and plain version differ only in the two small matrix
# products' summation order and tanh's last ULP: 1e-10 over a solve, step
# counts exactly equal.  float32: the same differences at float32's epsilon,
# which for adaptive solves move the step sizes (see chip_smoke.py).
F64 = 1e-10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(device, dtype, D=2, H=32, power=3, scale=0.5, seed=0):
    rng = np.random.RandomState(seed)
    npd = np.float32 if dtype == torch.float32 else np.float64
    params = [dict(w=(rng.randn(D, H) * scale).astype(npd),
                   b=(rng.randn(H) * 0.1).astype(npd)),
              dict(w=(rng.randn(H, D) * scale).astype(npd),
                   b=(rng.randn(D) * 0.1).astype(npd))]
    model = mlp_params_from_jax(params, power=power, device=device)
    model.requires_grad_(False)
    return model, rng


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("D,power", [(2, 3), (3, 1), (8, 2)])
@pytest.mark.parametrize("out_every", [None, 25])
def test_rk4_kernel_matches_plain(cuda, dtype, D, power, out_every):
    model, rng = _model(cuda, dtype, D=D, power=power)
    y0 = torch.from_numpy(rng.randn(1000, D)).to(cuda, dtype)  # ragged block
    before = kernels.launch_counts["rk4_integrate"]
    got = kernels.rk4_integrate(model, y0, 0.25, 0.01, 100,
                                out_every=out_every)
    want = kernels.rk4_integrate_ref(model, y0, 0.25, 0.01, 100,
                                     out_every=out_every)
    torch.cuda.synchronize()
    assert kernels.launch_counts["rk4_integrate"] == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    tol = F64 if dtype == torch.float64 else 1e-4
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


# batch sizes that select each group width of K-rk4 (H=32 lets L reach 32)
RK4_WIDTHS = [(1000, 32), (5000, 16), (9000, 8), (17000, 4), (40000, 1)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("D", range(1, 9))
@pytest.mark.parametrize("B,L", RK4_WIDTHS)
def test_rk4_kernel_every_group_width(cuda, dtype, D, B, L):
    """Each group width the host picks, at every state size with the
    powers 1-3, with and without out_every: within 1e-4 in float32 and
    1e-10 in float64 of the plain version (chip_smoke.py's F32_RK4 and
    F64_VALUES)."""
    assert kernels._rk4_group_width(B, 32) == L
    power, out_every = 1 + D % 3, (None if D % 2 else 10)
    model, rng = _model(cuda, dtype, D=D, power=power)
    y0 = torch.from_numpy(rng.randn(B, D)).to(cuda, dtype)
    got = kernels.rk4_integrate(model, y0, 0.25, 0.01, 40,
                                out_every=out_every)
    want = kernels.rk4_integrate_ref(model, y0, 0.25, 0.01, 40,
                                     out_every=out_every)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    tol = F64 if dtype == torch.float64 else 1e-4
    torch.testing.assert_close(got, want, rtol=0, atol=tol, equal_nan=True)


@pytest.mark.parametrize("method", ["dopri5", "tsit5", "bosh3", "fehlberg2",
                                    "adaptive_heun"])
def test_lanes_kernel_matches_plain_float64(cuda, method):
    """Per-lane counts exactly equal, values to 1e-10, on a problem with no
    fast-growing lanes (with weights at scale 0.5 some lanes of the y**3
    field amplify a 1e-16 difference to 1e-8 by t=1, at equal counts)."""
    model, rng = _model(cuda, torch.float64, scale=0.3)
    y0 = torch.from_numpy(rng.randn(2, 1000) * 0.8).to(cuda)
    ts = np.linspace(0.0, 1.0, 6)
    before = kernels.launch_counts["dopri5_integrate_batched"]
    got = kernels.dopri5_integrate_batched(model, y0, 0.0, 1.0, ts=ts,
                                           rtol=1e-7, atol=1e-9,
                                           method=method)
    want = kernels.dopri5_integrate_batched_ref(model, y0, 0.0, 1.0, ts=ts,
                                                rtol=1e-7, atol=1e-9,
                                                method=method)
    torch.cuda.synchronize()
    assert kernels.launch_counts["dopri5_integrate_batched"] == before + 1
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)   # n_steps
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)   # n_accepted
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=F64,
                               equal_nan=True)


def test_lanes_kernel_matches_plain_float32(cuda):
    """float32, on a problem with no blow-up: most lanes take the same
    steps; a one-ULP difference in a slope moves the embedded error
    estimate and can shift a lane by a few steps and its values by up to
    the solver's tolerance."""
    model, rng = _model(cuda, torch.float32, scale=0.3)
    y0 = torch.from_numpy(rng.randn(2, 4096) * 0.8).to(cuda, torch.float32)
    got = kernels.dopri5_integrate_batched(model, y0, 0.0, 1.0, rtol=1e-5,
                                           atol=1e-7)
    want = kernels.dopri5_integrate_batched_ref(model, y0, 0.0, 1.0,
                                                rtol=1e-5, atol=1e-7)
    dsteps = (got[2] - want[2]).abs()
    assert float((dsteps == 0).float().mean()) >= 0.75
    assert float((dsteps <= 2).float().mean()) >= 0.99
    assert int(dsteps.max()) <= 5
    # up to 2e-3 measured (2 of 8192 values, |y| ~ 3) on an H100
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=5e-3)


def test_lanes_kernel_options_and_nan_poisoning(cuda):
    """first_step and controller options; lanes that run out of max_steps
    give NaN rows where the plain version does.  This problem (the y**3
    field at weight scale 1.5, rtol=1e-9) puts a lane's error ratio within
    rounding of 1 on some step, so another summation order of the hidden
    units can flip that accept (it did at the host's width for B=512, 32
    lanes a trajectory, on an H100): it is held at one lane a trajectory,
    the order it was written for.  The widths are held with these options
    in test_lanes_kernel_every_group_width."""
    model, rng = _model(cuda, torch.float64, scale=1.5)
    y0 = torch.from_numpy(rng.randn(2, 512) * 2).to(cuda)
    kw = dict(ts=np.linspace(0.0, 2.0, 5), rtol=1e-9, atol=1e-11,
              max_steps=40, first_step=1e-3, safety=0.8, ifactor=4.0,
              dfactor=0.3, group=1)
    got = kernels.dopri5_integrate_batched(model, y0, 0.0, 2.0, **kw)
    kw.pop("group")
    want = kernels.dopri5_integrate_batched_ref(model, y0, 0.0, 2.0, **kw)
    _assert_lanes_equal(got, want)
    assert bool(torch.isnan(got[0]).any())   # some lanes ran out


def test_kernel_routes_launch_and_match(cuda):
    """The public routes reach the kernels: odeint's rk4 route and
    odeint_per_sample's kernel route."""
    model, rng = _model(cuda, torch.float64, H=64, scale=0.1)
    y0 = torch.from_numpy(rng.randn(1024, 2)).to(cuda)
    t = torch.linspace(0.0, 1.0, 5, dtype=torch.float64)
    kernels.reset_launch_counts()
    ys = odeint(model, y0, t, method="rk4",
                options=dict(pallas=True, num_steps=200))
    ys_ps, st = odeint_per_sample_with_stats(model, y0, t, rtol=1e-7,
                                             atol=1e-9,
                                             options=dict(pallas=True))
    assert kernels.launch_counts == {"rk4_integrate": 1,
                                     "dopri5_integrate_batched": 1,
                                     "dopri5_events_batched": 0,
                                     "fused_stage_step": 0}
    want = kernels.rk4_integrate_ref(model, y0, 0.0, 1.0 / 200, 200,
                                     out_every=50)
    torch.testing.assert_close(ys, want, rtol=0, atol=F64)
    ys_r, acc_r, stp_r = kernels.dopri5_integrate_batched_ref(
        model, y0.T.contiguous(), 0.0, 1.0, ts=t.numpy(), rtol=1e-7,
        atol=1e-9)
    torch.testing.assert_close(ys_ps, ys_r.permute(2, 0, 1), rtol=0, atol=F64)
    torch.testing.assert_close(st.n_steps, stp_r[0], rtol=0, atol=0)


def test_main_path_cuda_matches_cpu_float64(cuda):
    model, rng = _model(cuda, torch.float64, H=64, scale=0.1)
    model_cpu, _ = _model("cpu", torch.float64, H=64, scale=0.1)
    y0 = rng.randn(256, 2)
    t = torch.linspace(0.0, 1.0, 10, dtype=torch.float64)
    ys, st = odeint_with_stats(model, torch.from_numpy(y0).to(cuda), t)
    ys_c, st_c = odeint_with_stats(model_cpu, torch.from_numpy(y0), t)
    assert list(st[:5]) == list(st_c[:5])
    torch.testing.assert_close(ys.cpu(), ys_c, rtol=0, atol=F64)


def test_cuda_refuses_what_the_kernels_cannot_run(cuda):
    """No quiet fallback to the plain version on a CUDA tensor.  K-rk4
    takes the MLPField family alone; the per-lane route traces any other
    field into a kernel instance (since the traced instances) and raises on
    an operation outside the traced set, naming it."""
    model, rng = _model(cuda, torch.float32)
    y0 = torch.from_numpy(rng.randn(64, 2)).to(cuda, torch.float32)
    with pytest.raises(TypeError, match="MLPField"):
        kernels.rk4_integrate(lambda t, y: -y, y0, 0.0, 0.1, 3)
    with pytest.raises(TypeError, match="aten.softplus"):
        odeint_per_sample_with_stats(
            lambda t, y: torch.nn.functional.softplus(y), y0,
            torch.linspace(0.0, 1.0, 3), options=dict(pallas=True))
    elu = MLPField([2, 8, 2], activation=torch.nn.functional.elu,
                   device=cuda).requires_grad_(False)
    with pytest.raises(TypeError, match="activation"):
        kernels.dopri5_integrate_batched(elu, y0.T.contiguous(), 0.0, 1.0)
    with pytest.raises(TypeError, match="aten.elu"):
        odeint_per_sample_with_stats(elu, y0, torch.linspace(0.0, 1.0, 3),
                                     options=dict(pallas=True))
    kernels.reset_launch_counts()
    with torch.no_grad():
        ys, st = odeint_per_sample_with_stats(lambda t, y: -y, y0,
                                              torch.linspace(0.0, 1.0, 3),
                                              options=dict(pallas=True))
    assert kernels.traced_launch_counts["dopri5_integrate_batched"] == 1
    torch.testing.assert_close(ys[:, -1], y0 * float(np.exp(-1.0)),
                               rtol=1e-5, atol=1e-5)
    # dopri8 runs (the shared-memory instance; in float32 its step sizes
    # follow its error estimate's rounding, so values agree to 1e-2 here,
    # 9e-4 measured); the only bound is a group's shared memory
    got = kernels.dopri5_integrate_batched(model, y0.T.contiguous(), 0.0,
                                           1.0, method="dopri8")
    want = kernels.dopri5_integrate_batched_ref(model, y0.T.contiguous(),
                                                0.0, 1.0, method="dopri8")
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-2)
    huge = MLPField([64, 16384, 64], device=cuda).requires_grad_(False)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.dopri5_integrate_batched(
            huge, torch.zeros(64, 8, device=cuda), 0.0, 1.0)
    deep = MLPField([2, 8, 8, 2], power=3, device=cuda).requires_grad_(False)
    with pytest.raises(ValueError, match="one hidden layer"):
        kernels.rk4_integrate(deep, y0, 0.0, 0.1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.rk4_integrate(model, y0.T, 0.0, 0.1, 3)


# ---- K-events ---------------------------------------------------------------

def _lane_event(device, dtype, y_lanes, cut=1.0, K=2):
    """A threshold on y[0] at its median and a time cut-off that ends every
    lane that does not reach it (K=2); with K=3 also a combination of the
    components that starts negative on some lanes."""
    D = y_lanes.shape[0]
    W = np.zeros((K, D))
    W[0, 0] = 1.0
    c = np.zeros(K)
    c[1] = 1.0
    b = np.zeros(K)
    b[0], b[1] = -float(y_lanes[0].double().median()), -cut
    if K == 3:
        W[2] = 0.5
        b[2] = 3.0
    event = LinearEvent(W, time_coef=c, bias=b, dtype=dtype,
                        device=device).requires_grad_(False)
    sign0 = torch.sign(event(torch.zeros((), dtype=dtype, device=device),
                             y_lanes.T)).T.contiguous()
    return event, sign0


@pytest.mark.parametrize("method", ["dopri5", "bosh3"])
@pytest.mark.parametrize("D,power,K", [(2, 3, 2), (3, 1, 3), (8, 2, 2)])
def test_events_kernel_matches_plain_float64(cuda, method, D, power, K):
    """Every lane fires (the cut-off ends the rest): per-lane found, step
    and accept counts exactly equal, event times and states to 1e-10."""
    model, rng = _model(cuda, torch.float64, D=D, power=power, scale=0.3)
    y0 = torch.from_numpy(rng.randn(D, 1000) * 0.8).to(cuda)
    event, sign0 = _lane_event(cuda, torch.float64, y0, K=K)
    kw = dict(rtol=1e-7, atol=1e-9, method=method, ev_params=(sign0,))
    before = kernels.launch_counts["dopri5_events_batched"]
    got = kernels.dopri5_events_batched(model, y0, 0.0, event, **kw)
    want = kernels.dopri5_events_batched_ref(model, y0, 0.0, event, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts["dopri5_events_batched"] == before + 1
    for g, w in zip(got[2:], want[2:]):          # found, n_acc, n_steps
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert bool(want[2].all())
    at_cut = (want[0] - 1.0).abs() < 1e-9
    assert 0 < int(at_cut.sum()) < 1000
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=F64)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=F64)


def test_events_kernel_matches_plain_float32(cuda):
    """float32, time included: most lanes keep their counts; a one-ULP
    difference in a slope can shift a lane by a few steps, and its event
    time by the state's float32 agreement over its rate of change."""
    model, rng = _model(cuda, torch.float32, scale=0.3)
    y0 = torch.from_numpy(rng.randn(2, 4096) * 0.8).to(cuda, torch.float32)
    event, sign0 = _lane_event(cuda, torch.float32, y0)
    kw = dict(rtol=1e-5, atol=1e-7, ev_params=(sign0,))
    got = kernels.dopri5_events_batched(model, y0, 0.0, event, **kw)
    want = kernels.dopri5_events_batched_ref(model, y0, 0.0, event, **kw)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    dsteps = (got[4] - want[4]).abs()
    assert float((dsteps == 0).float().mean()) >= 0.75
    assert int(dsteps.max()) <= 5
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-3)


def test_events_kernel_lanes_that_do_not_fire(cuda):
    """max_steps runs out before some lanes fire: the same lanes in both,
    NaN event times there, and equal counts.  Their last state sits at the
    end of their last step, whose time carries the last-bit differences of
    the step sizes (1e-8 measured on an H100), so it is held to 1e-6."""
    model, rng = _model(cuda, torch.float64, scale=0.3)
    y0 = torch.from_numpy(rng.randn(2, 1000) * 0.8).to(cuda)
    event, sign0 = _lane_event(cuda, torch.float64, y0)
    kw = dict(rtol=1e-7, atol=1e-9, max_steps=3, ev_params=(sign0,))
    got = kernels.dopri5_events_batched(model, y0, 0.0, event, **kw)
    want = kernels.dopri5_events_batched_ref(model, y0, 0.0, event, **kw)
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    found = want[2][0].bool()
    assert 0 < int(found.sum()) < 1000
    assert bool(torch.isnan(got[0][0, ~found]).all())
    torch.testing.assert_close(got[0][:, found], want[0][:, found], rtol=0,
                               atol=F64)
    torch.testing.assert_close(got[1][:, found], want[1][:, found], rtol=0,
                               atol=F64)
    torch.testing.assert_close(got[1][:, ~found], want[1][:, ~found],
                               rtol=0, atol=1e-6)


def test_per_sample_event_route_launches_the_kernel(cuda):
    model, rng = _model(cuda, torch.float64, H=64, scale=0.1)
    y0 = torch.from_numpy(rng.randn(1024, 2)).to(cuda)
    event, sign0 = _lane_event(cuda, torch.float64, y0.T)
    kernels.reset_launch_counts()
    (et, ys2), st = odeint_per_sample_with_stats(
        model, y0, torch.tensor([0.0, 1.0], dtype=torch.float64),
        event_fn=event, rtol=1e-7, atol=1e-9,
        options=dict(pallas=True, max_num_steps=500))
    assert kernels.launch_counts["dopri5_events_batched"] == 1
    want = kernels.dopri5_events_batched_ref(
        model, y0.T.contiguous(), 0.0, event, rtol=1e-7, atol=1e-9,
        max_steps=500, ev_params=(sign0,))
    torch.testing.assert_close(et, want[0][0], rtol=0, atol=F64)
    torch.testing.assert_close(ys2[:, 1], want[1].T, rtol=0, atol=F64)
    torch.testing.assert_close(st.n_steps, want[4][0], rtol=0, atol=0)
    assert int(st.error_code.max()) == 0


def test_event_kernel_refuses_what_it_cannot_run(cuda):
    model, rng = _model(cuda, torch.float32)
    y0 = torch.from_numpy(rng.randn(2, 64)).to(cuda, torch.float32)
    event, sign0 = _lane_event(cuda, torch.float32, y0)
    with pytest.raises(TypeError, match="LinearEvent"):
        kernels.dopri5_events_batched(model, y0, 0.0,
                                      lambda tv, yv: yv[:1] - 0.5)
    with pytest.raises(TypeError, match="MLPField"):
        kernels.dopri5_events_batched(lambda tv, yv: -yv, y0, 0.0, event,
                                      ev_params=(sign0,))
    # the per-sample route traces any other event function (and the field
    # with it) and raises on an operation outside the traced set
    with pytest.raises(TypeError, match="aten.erf"):
        odeint_per_sample_with_stats(
            model, y0.T.contiguous(), torch.tensor([0.0, 1.0]),
            event_fn=lambda t, y: torch.erf(y[0]) - 0.5,
            options=dict(pallas=True))
    kernels.reset_launch_counts()
    with torch.no_grad():
        (et, _), st = odeint_per_sample_with_stats(
            model, y0.T.contiguous(), torch.tensor([0.0, 1.0]),
            event_fn=lambda t, y: y[0] - 0.5, options=dict(pallas=True))
    assert kernels.traced_launch_counts["dopri5_events_batched"] == 1
    assert et.shape == (64,)


def test_event_and_dense_paths_cuda_match_cpu_float64(cuda):
    """odeint_event (one controller for the batch) and odeint_dense on CUDA
    against the same calls on the CPU: counters equal, times and values to
    1e-10."""
    model, rng = _model(cuda, torch.float64, H=64, scale=0.1)
    model_cpu, _ = _model("cpu", torch.float64, H=64, scale=0.1)
    y0 = rng.randn(256, 2)
    thr = float(y0[:, 0].mean()) - 0.02

    def ev(t, y):
        return torch.stack([y[:, 0].mean() - thr, t - 0.9])

    kw = dict(event_fn=ev, rtol=1e-7, atol=1e-9)
    (et, ys2), st = odeint_with_stats(model, torch.from_numpy(y0).to(cuda),
                                      torch.tensor([0.0, 1.0]), **kw)
    (et_c, ys2_c), st_c = odeint_with_stats(model_cpu, torch.from_numpy(y0),
                                            torch.tensor([0.0, 1.0]), **kw)
    assert list(st[:5]) == list(st_c[:5])
    assert et.is_cuda and abs(float(et) - float(et_c)) <= F64
    torch.testing.assert_close(ys2.cpu(), ys2_c, rtol=0, atol=F64)
    et_e, sol = odeint_event(model, torch.from_numpy(y0).to(cuda), 0.0,
                             event_fn=ev, rtol=1e-7, atol=1e-9)
    assert float(et_e) == float(et) and torch.equal(sol, ys2)
    t = torch.linspace(0.0, 1.0, 7, dtype=torch.float64)
    sol, st_d = odeint_dense(model, torch.from_numpy(y0).to(cuda), 0.0, 1.0,
                             _return_stats=True)
    sol_c, st_dc = odeint_dense(model_cpu, torch.from_numpy(y0), 0.0, 1.0,
                                _return_stats=True)
    assert list(st_d[:5]) == list(st_dc[:5])
    torch.testing.assert_close(sol(t).cpu(), sol_c(t), rtol=0, atol=F64)
    torch.testing.assert_close(sol.derivative(t).cpu(), sol_c.derivative(t),
                               rtol=0, atol=F64)
    ev_d, _ = sol.find_event(ev, tol=1e-12)
    ev_dc, _ = sol_c.find_event(ev, tol=1e-12)
    assert abs(float(ev_d) - float(ev_dc)) <= F64


# ---- lane groups: K-dopri5 and K-events at every width ------------------------

GROUP_WIDTHS = [1, 2, 4, 8, 16, 32]


def _assert_lanes_equal(got, want, tol=F64):
    """K-dopri5 outputs: per-lane steps and accepts exactly equal, values to
    `tol` (NaN where the plain version has NaN)."""
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)   # n_steps
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)   # n_accepted
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=tol,
                               equal_nan=True)


def _assert_events_equal(got, want, far_tol=1e-6, tol=F64):
    """K-events outputs: per-lane found, accepts and steps exactly equal;
    event times and states to 1e-10 where the event fired; elsewhere the
    last state sits at the end of the last step, whose time carries the
    last-bit differences of the step sizes, so it is held to `far_tol`
    (as in test_events_kernel_lanes_that_do_not_fire)."""
    for g, w in zip(got[2:], want[2:]):          # found, n_acc, n_steps
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    found = want[2][0].bool()
    assert bool(torch.isnan(got[0][0, ~found]).all())
    torch.testing.assert_close(got[0][:, found], want[0][:, found], rtol=0,
                               atol=tol)
    torch.testing.assert_close(got[1][:, found], want[1][:, found], rtol=0,
                               atol=tol)
    torch.testing.assert_close(got[1][:, ~found], want[1][:, ~found],
                               rtol=0, atol=far_tol)


# controller options with which about half the lanes run out of steps
LANE_OPTIONS = dict(max_steps=10, first_step=1e-3, safety=0.8, ifactor=4.0,
                    dfactor=0.3)


@pytest.mark.parametrize("L", GROUP_WIDTHS)
@pytest.mark.parametrize("D,power", [(2, 3), (3, 1)])
@pytest.mark.parametrize("options", [{}, LANE_OPTIONS],
                         ids=["defaults", "options"])
def test_lanes_kernel_every_group_width(cuda, L, D, power, options):
    """Each group width against the plain version in float64, a ragged
    batch of 1000, with the default controller and with other options
    (first_step, safety, ifactor, dfactor, and a max_steps that leaves NaN
    rows): the width changes only the summation order of the hidden units,
    so counts stay exactly equal."""
    model, rng = _model(cuda, torch.float64, D=D, power=power, scale=0.3)
    y0 = torch.from_numpy(rng.randn(D, 1000) * 0.8).to(cuda)
    kw = dict(ts=np.linspace(0.0, 1.0, 6), rtol=1e-7, atol=1e-9, **options)
    before = kernels.launch_counts["dopri5_integrate_batched"]
    got = kernels.dopri5_integrate_batched(model, y0, 0.0, 1.0, group=L,
                                           **kw)
    want = kernels.dopri5_integrate_batched_ref(model, y0, 0.0, 1.0, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts["dopri5_integrate_batched"] == before + 1
    _assert_lanes_equal(got, want)
    assert bool(torch.isnan(want[0]).any()) == bool(options)


@pytest.mark.parametrize("L", GROUP_WIDTHS)
@pytest.mark.parametrize("D,power,K", [(2, 3, 2), (3, 1, 3)])
def test_events_kernel_every_group_width(cuda, L, D, power, K):
    model, rng = _model(cuda, torch.float64, D=D, power=power, scale=0.3)
    y0 = torch.from_numpy(rng.randn(D, 1000) * 0.8).to(cuda)
    event, sign0 = _lane_event(cuda, torch.float64, y0, K=K)
    kw = dict(rtol=1e-7, atol=1e-9, ev_params=(sign0,))
    got = kernels.dopri5_events_batched(model, y0, 0.0, event, group=L, **kw)
    want = kernels.dopri5_events_batched_ref(model, y0, 0.0, event, **kw)
    torch.cuda.synchronize()
    assert bool(want[2].all())
    _assert_events_equal(got, want)


# ---- C22: the order-2 methods' step-size power ------------------------------

@pytest.mark.parametrize("method", ["fehlberg2", "adaptive_heun"])
def test_order2_lane_kernels_equal_plain_bit_for_bit(cuda, method):
    """fehlberg2 and adaptive_heun in float64: the initial step's and the
    controller's x**(1/2) is the square root in the hand-written K-dopri5
    and K-events instances, as PyTorch computes the plain versions' power
    by 0.5.  On a field with no sum to reorder (D=1, H=1, power 1: each
    product single, tanh the same libdevice call) every output, count and
    NaN equals the plain version's bit for bit, with the default
    controller and with a max_steps (the plain version's median step
    count) that leaves half the lanes NaN."""
    model, rng = _model(cuda, torch.float64, D=1, H=1, power=1, scale=1.0)
    y0 = torch.from_numpy(rng.randn(1, 1000)).to(cuda)
    kw = dict(ts=np.linspace(0.0, 1.0, 6), rtol=1e-5, atol=1e-7,
              method=method)
    full = kernels.dopri5_integrate_batched_ref(model, y0, 0.0, 1.0, **kw)
    median = int(full[2].double().median())
    event, sign0 = _lane_event(cuda, torch.float64, y0)
    ekw = dict(rtol=1e-5, atol=1e-7, method=method, ev_params=(sign0,))
    for max_steps in (10_000, median):
        got = kernels.dopri5_integrate_batched(model, y0, 0.0, 1.0,
                                               max_steps=max_steps, **kw)
        want = kernels.dopri5_integrate_batched_ref(
            model, y0, 0.0, 1.0, max_steps=max_steps, **kw)
        got_e = kernels.dopri5_events_batched(model, y0, 0.0, event,
                                              max_steps=max_steps, **ekw)
        want_e = kernels.dopri5_events_batched_ref(
            model, y0, 0.0, event, max_steps=max_steps, **ekw)
        torch.cuda.synchronize()
        for g, w in zip((*got, *got_e), (*want, *want_e)):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        assert (bool(torch.isnan(want[0]).any())
                == (max_steps == median))


# ---- dopri8 and D > 8: the shared-memory instances --------------------------

# (D, power, scale, method, value tolerance): dopri8's 14 stages at D=2, a
# 12-row state with the 7-stage dopri5 and with dopri8.  dopri8 starts from
# first_step=0.2 on fields with no flat lanes: its embedded error estimate
# is otherwise rounding noise on nearly linear steps, and the next step
# follows that noise (tests/test_torch_kernels.py, WIDE).  The kernel and
# the plain version then take the same steps, but each step's size carries
# the estimate's rounding, so values agree to 1e-6 for dopri8 at D=2 (up to
# 1.4e-7 measured on the CPU between two summation orders of the hidden
# units) and to 1e-9 at D=12 (1.1e-10), and to 1e-10 for dopri5.  A lane
# that max_steps stops before its event keeps the state at the end of its
# last step, whose time carries those step sizes' differences: at D=2 with
# dopri8 up to 4.2e-5 measured on an H100, held to 1e-4; else to 1e-6.
WIDE_CASES = [(2, 1, 0.5, "dopri8", 1e-6), (12, 1, 0.3, "dopri5", F64),
              (12, 1, 0.3, "dopri8", 1e-9)]


def _far_tol(D, method):
    return 1e-4 if (D, method) == (2, "dopri8") else 1e-6


def _wide_kw(method):
    return dict(rtol=1e-7, atol=1e-9, method=method,
                first_step=0.2 if method == "dopri8" else None)


@pytest.mark.parametrize("L", GROUP_WIDTHS)
@pytest.mark.parametrize("D,power,scale,method,tol", WIDE_CASES)
def test_lanes_kernel_dopri8_and_wide_state(cuda, L, D, power, scale, method,
                                            tol):
    """K-dopri5's shared-memory instance at every group width against the
    plain version in float64: per-lane steps and accepts exactly equal, and
    rows past max_steps NaN in both.  Each output row of a field evaluation
    is summed by one lane over the hidden units in order, so every width
    gives the bits of L=1."""
    model, rng = _model(cuda, torch.float64, D=D, power=power, scale=scale)
    y0 = torch.from_numpy(rng.randn(D, 1000) * 0.8).to(cuda)
    kw = dict(ts=np.linspace(0.0, 1.0, 6), **_wide_kw(method))
    before = kernels.launch_counts["dopri5_integrate_batched"]
    got = kernels.dopri5_integrate_batched(model, y0, 0.0, 1.0, group=L,
                                           **kw)
    want = kernels.dopri5_integrate_batched_ref(model, y0, 0.0, 1.0, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts["dopri5_integrate_batched"] == before + 1
    _assert_lanes_equal(got, want, tol)
    one = kernels.dopri5_integrate_batched(model, y0, 0.0, 1.0, group=1,
                                           **kw)
    assert all(torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
               for a, b in zip(got, one))
    kw["max_steps"] = 3
    got = kernels.dopri5_integrate_batched(model, y0, 0.0, 1.0, group=L,
                                           **kw)
    want = kernels.dopri5_integrate_batched_ref(model, y0, 0.0, 1.0, **kw)
    _assert_lanes_equal(got, want, tol)
    assert bool(torch.isnan(want[0]).any())


@pytest.mark.parametrize("L", GROUP_WIDTHS)
@pytest.mark.parametrize("D,power,scale,method,tol", WIDE_CASES)
def test_events_kernel_dopri8_and_wide_state(cuda, L, D, power, scale, method,
                                             tol):
    """K-events' shared-memory instance at every group width against the
    plain version in float64: found, steps and accepts exactly equal, and
    with max_steps=3 the same lanes left unfired."""
    model, rng = _model(cuda, torch.float64, D=D, power=power, scale=scale)
    y0 = torch.from_numpy(rng.randn(D, 1000) * 0.8).to(cuda)
    event, sign0 = _lane_event(cuda, torch.float64, y0, K=3)
    kw = dict(ev_params=(sign0,), **_wide_kw(method))
    got = kernels.dopri5_events_batched(model, y0, 0.0, event, group=L, **kw)
    want = kernels.dopri5_events_batched_ref(model, y0, 0.0, event, **kw)
    torch.cuda.synchronize()
    assert bool(want[2].all())
    _assert_events_equal(got, want, far_tol=_far_tol(D, method), tol=tol)
    got = kernels.dopri5_events_batched(model, y0, 0.0, event, group=L,
                                        max_steps=3, **kw)
    want = kernels.dopri5_events_batched_ref(model, y0, 0.0, event,
                                             max_steps=3, **kw)
    assert not bool(want[2].all())
    _assert_events_equal(got, want, far_tol=_far_tol(D, method), tol=tol)


@pytest.mark.parametrize("event", [False, True])
def test_per_sample_routes_run_dopri8_and_wide_state(cuda, event):
    """odeint_per_sample(method='dopri8', options=dict(pallas=True)), with
    and without event_fn, at D=2 and D=12: the kernel runs and its counts
    equal the plain version's."""
    for D, power, scale, _, tol in WIDE_CASES[::2]:
        model, rng = _model(cuda, torch.float64, D=D, power=power,
                            scale=scale)
        y0 = torch.from_numpy(rng.randn(512, D) * 0.8).to(cuda)
        kernels.reset_launch_counts()
        kw = dict(rtol=1e-7, atol=1e-9, method="dopri8",
                  options=dict(pallas=True, max_num_steps=500,
                               first_step=0.2))
        if event:
            ev, sign0 = _lane_event(cuda, torch.float64, y0.T)
            (et, ys2), st = odeint_per_sample_with_stats(
                model, y0, torch.tensor([0.0, 1.0], dtype=torch.float64),
                event_fn=ev, **kw)
            want = kernels.dopri5_events_batched_ref(
                model, y0.T.contiguous(), 0.0, ev, rtol=1e-7, atol=1e-9,
                method="dopri8", max_steps=500, first_step=0.2,
                ev_params=(sign0,))
            assert kernels.launch_counts["dopri5_events_batched"] == 1
            torch.testing.assert_close(et, want[0][0], rtol=0, atol=tol)
            torch.testing.assert_close(st.n_steps, want[4][0], rtol=0,
                                       atol=0)
        else:
            t = torch.linspace(0.0, 1.0, 5, dtype=torch.float64)
            ys, st = odeint_per_sample_with_stats(model, y0, t, **kw)
            want = kernels.dopri5_integrate_batched_ref(
                model, y0.T.contiguous(), 0.0, 1.0, ts=t.numpy(), rtol=1e-7,
                atol=1e-9, method="dopri8", max_steps=500, first_step=0.2)
            assert kernels.launch_counts["dopri5_integrate_batched"] == 1
            torch.testing.assert_close(ys, want[0].permute(2, 0, 1), rtol=0,
                                       atol=tol)
            torch.testing.assert_close(st.n_steps, want[2][0], rtol=0,
                                       atol=0)


# ---- float64 counts near accept boundaries (ROADMAP C7) ----------------------

# Problems whose lanes' error ratios come within rounding of 1: the y**3
# field at weight scale 0.5 on 4096 lanes, with dopri5 at rtol=1e-12 (the
# error estimate's rounding is about 1e-4 of the tolerance there, and a lane
# takes 50-300 steps) and with dopri8 at rtol=1e-10 (its estimate is
# rounding noise on nearly linear steps).  Each sums the field's hidden
# units in another order than the plain version's products; the share of
# lanes whose steps or accepts differ is held to C7_SHARE_BOUND.  Measured
# on an H100 ("NVIDIA H100 80GB HBM3, 700.00 W"): dopri5 0.46-0.66% of the
# lanes in K-dopri5 and 0.32-0.49% in K-events over the widths; dopri8
# 12.5% and 10.1% at every width (its shared-memory instance gives the same
# bits at each).  On the CPU, two summation orders of the plain version
# flip 0.49% and 14.5%.  The bounds are about twice the measured shares.
C7_CASES = {"dopri5": (1e-12, 1e-14), "dopri8": (1e-10, 1e-12)}
C7_SHARE_BOUND = {"dopri5": 0.015, "dopri8": 0.25}


@pytest.mark.parametrize("L", GROUP_WIDTHS)
@pytest.mark.parametrize("method", sorted(C7_CASES))
def test_float64_counts_near_accept_boundaries(cuda, L, method):
    """Per-lane counts are exact only away from accept boundaries: a lane
    whose error ratio lands within rounding of 1 on some step flips that
    accept when the hidden units are summed in another order, at every
    width, L=1 included.  Bounds the share of such lanes in K-dopri5 and
    K-events at each L."""
    model, rng = _model(cuda, torch.float64, scale=0.5)
    y0 = torch.from_numpy(rng.randn(2, 4096) * 0.8).to(cuda)
    rtol, atol = C7_CASES[method]
    control = dict(rtol=rtol, atol=atol, method=method, max_steps=400)
    got = kernels.dopri5_integrate_batched(model, y0, 0.0, 1.0, group=L,
                                           ts=np.linspace(0.0, 1.0, 5),
                                           **control)
    want = kernels.dopri5_integrate_batched_ref(
        model, y0, 0.0, 1.0, ts=np.linspace(0.0, 1.0, 5), **control)
    lanes = float(((got[1] != want[1]) | (got[2] != want[2])).float().mean())
    event, sign0 = _lane_event(cuda, torch.float64, y0)
    got = kernels.dopri5_events_batched(model, y0, 0.0, event, group=L,
                                        ev_params=(sign0,), **control)
    want = kernels.dopri5_events_batched_ref(model, y0, 0.0, event,
                                             ev_params=(sign0,), **control)
    flips = (got[2] != want[2]) | (got[3] != want[3]) | (got[4] != want[4])
    events = float(flips.float().mean())
    print(f"C7 {method} L={L}: K-dopri5 {lanes:.5f}, K-events {events:.5f} "
          "of the lanes differ")
    assert lanes <= C7_SHARE_BOUND[method]
    assert events <= C7_SHARE_BOUND[method]


# A batch whose trajectories need very different step counts, interleaved
# at random so that the groups of one warp leave their loops at different
# steps.  The field f(y) = tanh(y W1) W2 with W2 = W1^T (W1 W1^T)^-1 (w R),
# R a quarter turn, is the rotation w R y near the origin: trajectories of
# amplitude 0.3 oscillate (110-250 dopri5 steps on [0, 3]), and of
# amplitude 1e-20 barely move (3 steps from first_step=1).  A threshold
# event on y[0] at 0.5 fires at step 1 on the trajectories that start just
# short of it and move towards it, later on some oscillating ones, and
# never on the smallest (they run out of max_steps).  The rotation keeps
# rounding differences from growing, so float64 counts match the plain
# version's exactly (checked at every width on the CPU with the kernel's
# summation order).  A whole-warp shuffle left in the loop hangs or returns
# garbage here.
DIV_THR, DIV_CUT, DIV_T1, DIV_MAX_STEPS = 0.5, 1e6, 3.0, 300
DIV_OMEGA = 10.0


def _divergent_batch(device, B, seed=0):
    rng = np.random.RandomState(seed)
    H = 32
    w1 = rng.randn(2, H)
    turn = np.array([[0.0, 1.0], [-1.0, 0.0]]) * DIV_OMEGA
    params = [dict(w=w1, b=np.zeros(H)),
              dict(w=w1.T @ np.linalg.inv(w1 @ w1.T) @ turn, b=np.zeros(2))]
    model = mlp_params_from_jax(params, power=1, device="cpu")
    model.requires_grad_(False)
    kind = rng.randint(0, 3, B)   # 0 oscillates, 1 barely moves, 2 fires
    y0 = np.where(kind == 1, rng.randn(2, B) * 1e-20, rng.randn(2, B) * 0.3)
    for _ in range(2):   # start just short of the threshold, moving to it
        f0 = model(0.0, torch.from_numpy(y0.T)).numpy().T
        y0[0] = np.where(kind == 2, DIV_THR - 1e-3 * np.sign(f0[0]), y0[0])
    event = LinearEvent([[1.0, 0.0], [0.0, 0.0]], time_coef=[0.0, 1.0],
                        bias=[-DIV_THR, -DIV_CUT], dtype=torch.float64,
                        device=device).requires_grad_(False)
    y0 = torch.from_numpy(y0).to(device)
    sign0 = torch.sign(event.lanes(torch.zeros_like(y0[:1]), y0))
    return model.to(device), y0, event, sign0, kind


DIV_LANES = dict(ts=np.linspace(0.0, DIV_T1, 4), rtol=1e-7, atol=1e-9,
                 first_step=1.0)
DIV_EVENTS = dict(rtol=1e-7, atol=1e-9, max_steps=DIV_MAX_STEPS)


@pytest.mark.parametrize("L", GROUP_WIDTHS)
def test_groups_of_a_warp_finish_at_different_steps(cuda, L):
    model, y0, event, sign0, kind = _divergent_batch(cuda, 1000)
    got = kernels.dopri5_integrate_batched(model, y0, 0.0, DIV_T1, group=L,
                                           **DIV_LANES)
    want = kernels.dopri5_integrate_batched_ref(model, y0, 0.0, DIV_T1,
                                                **DIV_LANES)
    steps = want[2][0].cpu().numpy()
    assert (steps[kind == 1] <= 3).all() and steps[kind != 1].min() >= 100
    _assert_lanes_equal(got, want)

    ekw = dict(DIV_EVENTS, ev_params=(sign0,))
    got = kernels.dopri5_events_batched(model, y0, 0.0, event, group=L,
                                        **ekw)
    want = kernels.dopri5_events_batched_ref(model, y0, 0.0, event, **ekw)
    found, steps = (w[0].cpu().numpy() for w in (want[2], want[4]))
    assert found[kind == 2].all() and (steps[kind == 2] == 1).mean() >= 0.9
    assert not found[kind == 1].any()
    assert (steps[kind == 1] == DIV_MAX_STEPS).all()
    _assert_events_equal(got, want)


@pytest.mark.parametrize("B", [1, 33, 1000])
def test_per_trajectory_kernels_ragged_batches(cuda, B):
    """Batches that fill no whole block or warp, at the host's width."""
    model, rng = _model(cuda, torch.float64, scale=0.3)
    y0 = torch.from_numpy(rng.randn(2, B) * 0.8).to(cuda)
    kw = dict(ts=np.linspace(0.0, 1.0, 4), rtol=1e-7, atol=1e-9)
    _assert_lanes_equal(
        kernels.dopri5_integrate_batched(model, y0, 0.0, 1.0, **kw),
        kernels.dopri5_integrate_batched_ref(model, y0, 0.0, 1.0, **kw))
    event, sign0 = _lane_event(cuda, torch.float64, y0)
    ekw = dict(rtol=1e-7, atol=1e-9, ev_params=(sign0,))
    _assert_events_equal(
        kernels.dopri5_events_batched(model, y0, 0.0, event, **ekw),
        kernels.dopri5_events_batched_ref(model, y0, 0.0, event, **ekw))


@pytest.mark.parametrize("L", [1, 4, 32])
def test_a_trajectory_does_not_depend_on_its_neighbours(cuda, L):
    """The same trajectory alone and inside a permuted batch (other
    neighbours in its warp and block, other step counts around it) gives
    the same bits in float64, from both kernels."""
    model, y0, event, sign0, _ = _divergent_batch(cuda, 1000)
    perm = torch.from_numpy(np.random.RandomState(1).permutation(1000)).to(cuda)
    kw = dict(DIV_LANES, group=L)
    base = kernels.dopri5_integrate_batched(model, y0, 0.0, DIV_T1, **kw)
    moved = kernels.dopri5_integrate_batched(
        model, y0[:, perm].contiguous(), 0.0, DIV_T1, **kw)
    _assert_same_bits(base, moved, perm)
    for j in (0, 1, 2, 500, 999):
        _assert_same_bits(base, kernels.dopri5_integrate_batched(
            model, y0[:, j:j + 1].contiguous(), 0.0, DIV_T1, **kw), [j])
    ekw = dict(DIV_EVENTS, group=L)
    base = kernels.dopri5_events_batched(model, y0, 0.0, event,
                                         ev_params=(sign0,), **ekw)
    moved = kernels.dopri5_events_batched(
        model, y0[:, perm].contiguous(), 0.0, event,
        ev_params=(sign0[:, perm].contiguous(),), **ekw)
    _assert_same_bits(base, moved, perm)
    for j in (0, 1, 2, 500, 999):
        _assert_same_bits(base, kernels.dopri5_events_batched(
            model, y0[:, j:j + 1].contiguous(), 0.0, event,
            ev_params=(sign0[:, j:j + 1].contiguous(),), **ekw), [j])


def _assert_same_bits(batch, part, lanes):
    """Each output of `part` equals the `lanes` of the same output of
    `batch` bit for bit (NaN where NaN)."""
    for a, b in zip(batch, part):
        a = a[..., lanes]
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def test_c_entry_points_refuse_a_bad_group(cuda):
    """The launchers return cudaErrorInvalidValue (1) for a group width
    that is not a power of two from 1 to 32, or a block size that is not a
    multiple of it up to 128, and launch nothing."""
    from torchdiffeq_tpu_torch.ops import _build
    lib = _build.library()
    null = None
    for group, threads in ((0, 128), (3, 128), (64, 128), (32, 16),
                           (4, 129), (8, 256)):
        if threads == 128:
            assert lib.tdt_rk4(0, 8, 2, 32, 1, null, null, null, null, null,
                               0.1, 1, 0, group, null, null) == 1
        assert lib.tdt_dopri5_lanes(
            0, 8, 2, 32, 1, null, null, 1, 0.0, 1.0, 1e-6, 1e-8, 0.9, 10.0,
            0.2, 0.0, 0, 10, null, 6, 5, 1, null, null, null, null, group,
            threads, null, null, null, null) == 1
        assert lib.tdt_dopri5_events(
            0, 8, 2, 32, 1, null, 0.0, 1e-6, 1e-8, 0.9, 10.0, 0.2, 0.0, 0,
            10, null, 6, 5, 1, null, null, null, null, 1, null, null, null,
            null, 40, group, threads, null, null, null, null, null,
            null) == 1


# K-rk4 built with each group's own shuffle mask (tdt::group_mask), as
# K-dopri5 and K-events run their groups, and the groups past the batch
# returning instead of running row B-1: its butterfly must give the same
# bits as K-rk4's whole-warp one, which the adaptive kernels' comparisons
# with their plain versions cannot show.
_GROUP_MASK_EDITS = [
    ("  if ((gid & ~31) / L >= B) return;\n  const int lane = gid & (L - 1);\n"
     "  const bool live = gid / L < B;\n",
     "  if (gid / L >= B) return;\n  const int lane = gid & (L - 1);\n"
     "  const bool live = true;\n"),
    ("lane, L,\n                                   0xffffffffu};",
     "lane, L,\n                                   tdt::group_mask(L)};"),
]


@pytest.fixture(scope="module")
def group_mask_rk4(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    import ctypes
    import shutil
    import subprocess
    from torchdiffeq_tpu_torch.ops import _build
    out = tmp_path_factory.mktemp("group_mask")
    text = (_build.CSRC / "rk4.cu").read_text()
    for old, new in _GROUP_MASK_EDITS:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    (out / "rk4.cu").write_text(text)
    shutil.copy(_build.CSRC / "mlp_field.cuh", out)
    so = out / "rk4_group_mask.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(out / "rk4.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.tdt_rk4.argtypes = _build._SIGNATURES["tdt_rk4"]
    lib.tdt_rk4.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B", [1, 33, 1000])
def test_rk4_group_mask_leaves_its_bits_unchanged(cuda, group_mask_rk4,
                                                  dtype, B):
    """K-rk4 at every group width, ragged batches included, gives the same
    bits with each group's own shuffle mask as with the whole warp's."""
    import ctypes
    from torchdiffeq_tpu_torch.ops import _build
    model, rng = _model(cuda, dtype, D=3, power=3)
    y0 = torch.from_numpy(rng.randn(B, 3)).to(cuda, dtype)
    ws = [p.detach().contiguous() for p in (*model.weights, *model.biases)]
    w1, w2, b1, b2 = ws
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for L in GROUP_WIDTHS:
        outs = []
        for lib in (_build.library(), group_mask_rk4):
            out = y0.new_empty((5, B, 3))
            assert lib.tdt_rk4(0 if dtype == torch.float32 else 1, B, 3, 32,
                               3, ptr(y0), ptr(w1), ptr(b1), ptr(w2), ptr(b2),
                               0.01, 40, 10, L, ptr(out), stream) == 0
            outs.append(out)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1]), L


# ---- K-fused ----------------------------------------------------------------

# Each output is held to `fused_field.kernel_bounds` (the reasons stand
# beside KERNEL_F32_SLOPE there).  Where y1_err is rounding noise its bound
# is wider than the value, so at the bench's width the error estimate is
# also held by its median (as in chip_smoke.py): in float32 at dt=0.75,
# where it is truncation, the bound must be at most a tenth of the median
# |y1_err|; in bfloat16 at dt=1e-4, where no stage input flips, the median
# |kernel - plain| must be at most a tenth of it.
TRUNC_DT = 0.75
ERR_MEDIAN_SHARE = 0.1


def _fused_inputs(device, dtype, B, D, H, seed=0, scale=0.1):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(D, H) * scale, rng.randn(H) * 0.1,
              rng.randn(H, D) * scale, rng.randn(D) * 0.1, rng.randn(B, D)]
    w1, b1, w2, b2, y0 = (torch.from_numpy(a.astype(np.float32)).to(device)
                          .to(dtype) for a in arrays)
    params = (w1, b1, w2, b2)
    return params, y0, fused_field.mlp_field(0.0, y0, *params)


def _assert_fused_close(got, want, dt, tab, w2):
    bounds = fused_field.kernel_bounds(want, w2, dt, tab)
    for name, g, w, bound in zip(("y1", "f1", "err", "dmid"), got, want,
                                 bounds):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        d = (g.float() - w.float()).abs()
        assert bool((d <= bound).all()), (name, float(d.max()))
    return bounds


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("method", ["dopri5", "bosh3", "tsit5", "fehlberg2",
                                    "adaptive_heun"])
@pytest.mark.parametrize("D,H", [(32, 128), (64, 256), (128, 384)])
def test_fused_kernel_matches_plain(cuda, dtype, method, D, H):
    """FSAL and non-FSAL tableaus, every kernel width but the bench's, and a
    batch of 1000 rows: not a multiple of the kernel's 32-row tile."""
    params, y0, f0 = _fused_inputs(cuda, dtype, 1000, D, H)
    tab = getattr(tableaus, method.upper())
    before = kernels.launch_counts["fused_stage_step"]
    got = fused_field.fused_stage_step(fused_field.mlp_field, params, y0, f0,
                                       0.25, 1e-3, tab)
    want = fused_field.fused_stage_step_ref(fused_field.mlp_field, params, y0,
                                            f0, 0.25, 1e-3, tab)
    torch.cuda.synchronize()
    assert kernels.launch_counts["fused_stage_step"] == before + 1
    _assert_fused_close(got, want, 1e-3, tab, params[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernel_at_the_bench_width(cuda, dtype):
    """D=256, H=1024 at the bench's weight scale, a ragged batch, a negative
    step and a float64 error output (summed in float32 and cast, as in
    JAX); the error estimate is also held by its median (above)."""
    params, y0, f0 = _fused_inputs(cuda, dtype, 300, 256, 1024, seed=1,
                                   scale=0.05)
    step, step_ref = fused_field.fused_stage_step, fused_field.fused_stage_step_ref
    kw = dict(error_dtype=torch.float64)
    got = step(fused_field.mlp_field, params, y0, f0, 1.0, -1e-4,
               tableaus.DOPRI5, **kw)
    want = step_ref(fused_field.mlp_field, params, y0, f0, 1.0, -1e-4,
                    tableaus.DOPRI5, **kw)
    assert got[2].dtype == torch.float64 and got[3].dtype == torch.float32
    _assert_fused_close(got, want, -1e-4, tableaus.DOPRI5, params[2])
    if dtype == torch.bfloat16:
        median_err = float(want[2].abs().median())
        assert median_err > 0
        assert float((got[2] - want[2]).abs().median()) \
            <= ERR_MEDIAN_SHARE * median_err
    else:
        got = step(fused_field.mlp_field, params, y0, f0, 1.0, TRUNC_DT,
                   tableaus.DOPRI5)
        want = step_ref(fused_field.mlp_field, params, y0, f0, 1.0, TRUNC_DT,
                        tableaus.DOPRI5)
        bounds = _assert_fused_close(got, want, TRUNC_DT, tableaus.DOPRI5,
                                     params[2])
        assert bounds[2] <= ERR_MEDIAN_SHARE * float(want[2].abs().median())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", fused_field.KERNEL_D)
@pytest.mark.parametrize("H", [128, 1024])
@pytest.mark.parametrize("method", ["dopri5", "adaptive_heun"])
def test_fused_kernel_every_width(cuda, dtype, D, H, method):
    """Every width the kernel is built for (D=32 is one wgmma M tile of 64
    with half its rows discarded), one chunk and eight, an FSAL and a
    non-FSAL tableau, a ragged batch, each held to kernel_bounds; in
    float32 also at dt=0.75, where the non-FSAL (second-order) error
    estimate is truncation and its bound at most a tenth of its median.
    The weights are at the bench's scale (0.05): at dt=0.75 a slope's
    rounding difference moves the later stage inputs, and the field's
    gain must keep that within the bound."""
    params, y0, f0 = _fused_inputs(cuda, dtype, 1000, D, H, scale=0.05)
    tab = getattr(tableaus, method.upper())
    step, step_ref = fused_field.fused_stage_step, fused_field.fused_stage_step_ref
    for dt in ((1e-3, TRUNC_DT) if dtype == torch.float32 else (1e-3,)):
        got = step(fused_field.mlp_field, params, y0, f0, 0.25, dt, tab)
        want = step_ref(fused_field.mlp_field, params, y0, f0, 0.25, dt, tab)
        bounds = _assert_fused_close(got, want, dt, tab, params[2])
        if dt == TRUNC_DT and not tab.is_fsal:
            assert bounds[2] <= ERR_MEDIAN_SHARE * float(
                want[2].abs().median())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", fused_field.KERNEL_D)
def test_fused_plan_is_the_kernels(cuda, dtype, D):
    """The host's launch plan (`fused_plan`) mirrors the one the kernel was
    built with (`tdt_fused_plan`)."""
    import ctypes
    from torchdiffeq_tpu_torch.ops import _build
    out = (ctypes.c_int * 6)()
    lib = _build.library()
    assert lib.tdt_fused_plan(0 if dtype == torch.float32 else 1, D,
                              ctypes.cast(out, ctypes.c_void_p)) == 0
    plan = fused_field.fused_plan(dtype, D, 1024, 4096)
    assert list(out) == [plan[k] for k in ("w1_tile_rows", "w2_tile_rows",
                                           "ring", "threads", "cluster",
                                           "shared_bytes")]


def test_fused_kernel_refuses_what_it_cannot_run(cuda):
    params, y0, f0 = _fused_inputs(cuda, torch.float32, 64, 32, 128)
    step = fused_field.fused_stage_step
    with pytest.raises(TypeError, match="mlp_field"):
        step(lambda t, y, *p: -y, params, y0, f0, 0.0, 0.1, tableaus.DOPRI5)
    with pytest.raises(ValueError, match="at most 7 stages"):
        step(fused_field.mlp_field, params, y0, f0, 0.0, 0.1, tableaus.DOPRI8)
    with pytest.raises(TypeError, match="bfloat16"):
        step(fused_field.mlp_field, tuple(p.double() for p in params),
             y0.double(), f0.double(), 0.0, 0.1, tableaus.DOPRI5)
    with pytest.raises(ValueError, match="match the state"):
        step(fused_field.mlp_field, params, y0.bfloat16(), f0.bfloat16(), 0.0,
             0.1, tableaus.DOPRI5)
    p48, y48, f48 = _fused_inputs(cuda, torch.float32, 64, 48, 128)
    with pytest.raises(ValueError, match="D in"):
        step(fused_field.mlp_field, p48, y48, f48, 0.0, 0.1, tableaus.DOPRI5)


# ---- the continuous adjoint on the card ----------------------------------------

def _train_grads(device, dtype, B, H=64, T=10):
    """The gradients of bench.py's training loss (spiral field, dopri5,
    rtol=1e-7, atol=1e-9, weights and data from RandomState(0)) through
    odeint_adjoint, and the forward counters."""
    from torchdiffeq_tpu_torch import odeint_adjoint
    rng = np.random.RandomState(0)
    npd = np.float32 if dtype == torch.float32 else np.float64
    w1 = (rng.randn(2, H) * 0.1).astype(np.float32).astype(npd)
    w2 = (rng.randn(H, 2) * 0.1).astype(np.float32).astype(npd)
    y0 = rng.randn(B, 2).astype(np.float32).astype(npd)
    target = rng.randn(B, 2).astype(np.float32).astype(npd)
    model = mlp_params_from_jax([dict(w=w1, b=np.zeros(H, npd)),
                                 dict(w=w2, b=np.zeros(2, npd))], power=3,
                                device=device)
    y0, target = (torch.from_numpy(a).to(device) for a in (y0, target))
    t = torch.linspace(0.0, 1.0, T, dtype=torch.float64)
    ys = odeint_adjoint(model, y0, t, rtol=1e-7, atol=1e-9, method="dopri5")
    ((ys - target[None]) ** 2).mean().backward()
    with torch.no_grad():
        _, st = odeint_with_stats(model, y0, t, rtol=1e-7, atol=1e-9)
    return [p.grad.double().cpu() for p in model.parameters()], list(st[:5])


@pytest.mark.parametrize("B", [64, 1024])
def test_training_step_gradients_cuda_match_cpu(cuda, B):
    """The training step's parameter gradients on the card against the CPU
    in float64: forward counters equal, gradients to 1e-9 of max|g| (the
    products' summation order and tanh's last ULP over two solves); in
    float32 to 1e-5 of max|g| (float32 moves both solves' step sizes: 3.4e-7
    measured between float32 and float64 on the CPU at B=1024)."""
    want, st_cpu = _train_grads("cpu", torch.float64, B)
    got, st = _train_grads(cuda, torch.float64, B)
    assert st == st_cpu
    got32, _ = _train_grads(cuda, torch.float32, B)
    for g, g32, w in zip(got, got32, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-9 * scale
        assert float((g32 - w).abs().max()) <= 1e-5 * scale


# ---- the fixed-grid tier, the controllers, 16-bit states, remat ----------

FIXED = ["euler", "midpoint", "heun2", "heun3", "rk4"]


def _spiral_problem(device, dtype, B=256, H=64, seed=0):
    model, rng = _model(device, dtype, D=2, H=H, power=3, scale=0.3,
                        seed=seed)
    y0 = torch.from_numpy(rng.randn(B, 2)).to(device, dtype)
    t = torch.linspace(0.0, 1.0, 10, dtype=torch.float64)
    return model, y0, t


@pytest.mark.parametrize("interp", ["linear", "cubic"])
@pytest.mark.parametrize("method", FIXED)
def test_fixed_grid_cuda_matches_cpu(cuda, method, interp):
    """Each fixed method on the card against the CPU in float64: Stats
    equal, values to 1e-10 (the products' summation order and tanh's last
    ULP over 36 steps; chip_smoke.py's F64_FIXED)."""
    out = {}
    for dev in ("cpu", cuda):
        model, y0, t = _spiral_problem(dev, torch.float64)
        with torch.no_grad():
            ys, st = odeint_with_stats(model, y0, t, method=method,
                                       options=dict(num_steps=36,
                                                    interp=interp))
        out[str(dev)] = ys.cpu(), list(st[:5])
    (ys_c, st_c), (ys_g, st_g) = out["cpu"], out[str(cuda)]
    assert st_g == st_c
    torch.testing.assert_close(ys_g, ys_c, rtol=0, atol=F64)


@pytest.mark.parametrize("options", [dict(controller="pi"),
                                     dict(controller="pid", dcoeff=0.2)])
def test_controllers_cuda_counts_match_cpu(cuda, options):
    """PI and PID on the card: float64 counters exactly the CPU's."""
    stats = []
    for dev in ("cpu", cuda):
        model, y0, t = _spiral_problem(dev, torch.float64)
        with torch.no_grad():
            _, st = odeint_with_stats(model, y0, t, rtol=1e-7, atol=1e-9,
                                      options=options)
        stats.append(list(st[:5]))
    assert stats[0] == stats[1]


def test_bfloat16_with_error_dtype_on_cuda(cuda):
    """A bfloat16 state and field with float32 error control on the card:
    bfloat16 out, at most three times the float32 solve's steps, and
    within 3% of the float32 values (chip_smoke.py's BF16_STEPS and
    BF16_VALUES, with their reasons)."""
    model, y0, t = _spiral_problem(cuda, torch.float32)
    model16 = _spiral_problem(cuda, torch.float32)[0].to(torch.bfloat16)
    with torch.no_grad():
        ys32, st32 = odeint_with_stats(model, y0, t, rtol=1e-3, atol=1e-5)
        ys16, st16 = odeint_with_stats(
            model16, y0.bfloat16(), t, rtol=1e-3, atol=1e-5,
            options=dict(error_dtype=torch.float32))
    assert ys16.dtype == torch.bfloat16 and st16.error_code == 0
    assert st16.n_steps <= 3 * st32.n_steps
    err = (ys16.float() - ys32).abs().max() / ys32.abs().max()
    assert float(err) < 3e-2


def test_remat_on_cuda_same_gradients_less_memory(cuda):
    """remat=True on the card: the same gradients (recomputation repeats
    the same kernels), and a lower peak of allocated memory."""
    grads, peaks = [], []
    for remat in (False, True):
        model, y0, t = _spiral_problem(cuda, torch.float32, B=4096)
        model.requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ys = odeint(model, y0, t, method="rk4",
                    options=dict(num_steps=36, remat=remat))
        (ys ** 2).mean().backward()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert peaks[1] < peaks[0], peaks


# ---- the Adams and implicit tiers ----------------------------------------

IMPLICIT_FIXED = ["explicit_adams", "implicit_adams", "fixed_adams",
                  "implicit_euler", "implicit_midpoint", "trapezoid",
                  "radauIIA3", "gl4", "radauIIA5", "gl6", "sdirk2", "trbdf2"]
STIFF = ["kvaerno3", "kvaerno5", "radau5a"]


@pytest.mark.parametrize("method", IMPLICIT_FIXED + STIFF)
def test_implicit_tiers_cuda_match_cpu(cuda, method):
    """Every Adams and implicit method on the card against the CPU in
    float64 on the spiral field (B=32): Stats equal (error code 0), values
    to 1e-10 (the products' summation order, tanh's last ULP and the LU's
    pivoting rounding, within the stage tolerance's reach)."""
    opts = {} if method in STIFF else dict(num_steps=18)
    out = {}
    for dev in ("cpu", cuda):
        model, y0, t = _spiral_problem(dev, torch.float64, B=32)
        with torch.no_grad():
            ys, st = odeint_with_stats(model, y0, t, rtol=1e-7, atol=1e-9,
                                       method=method, options=opts)
        out[str(dev)] = ys.cpu(), list(st[:5])
    (ys_c, st_c), (ys_g, st_g) = out["cpu"], out[str(cuda)]
    assert st_g == st_c and st_g[4] == 0
    torch.testing.assert_close(ys_g, ys_c, rtol=0, atol=F64)


def _implicit_grads(device, method, options, adjoint=False):
    from torchdiffeq_tpu_torch import odeint_adjoint
    model, y0, t = _spiral_problem(device, torch.float64, B=32)
    model.requires_grad_(True)
    y0.requires_grad_(True)
    solve = odeint_adjoint if adjoint else odeint
    ys = solve(model, y0, t, rtol=1e-7, atol=1e-9, method=method,
               options=options)
    (ys ** 2).mean().backward()
    return [g.cpu() for g in [y0.grad] + [p.grad for p in model.parameters()]]


@pytest.mark.parametrize("method,options,adjoint", [
    ("gl4", dict(num_steps=18), False),
    ("trbdf2", dict(num_steps=18, root_solver="newton"), False),
    ("kvaerno5", None, True),
])
def test_implicit_gradients_cuda_match_cpu(cuda, method, options, adjoint):
    """Gradients of mean(ys**2) to y0 and the parameters in float64, card
    against CPU: the IFT of every stage solve through the loop (one FIRK
    method with Broyden, one DIRK with Newton) and an implicit
    odeint_adjoint (kvaerno5 forward and backward, its stage Jacobians
    reverse over reverse), each within 1e-9 of max|g|."""
    want = _implicit_grads("cpu", method, options, adjoint)
    got = _implicit_grads(cuda, method, options, adjoint)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-9 * float(w.abs().max())


def test_implicit_nonconvergence_error_code_on_both_devices(cuda):
    """A stiff field at two steps and one Broyden iteration: error code 4
    on the card and on the CPU, with the same values; the converging call
    error code 0."""
    out = []
    for dev in ("cpu", cuda):
        y0 = torch.zeros(1, dtype=torch.float64, device=dev)
        t = torch.linspace(0.0, 1.0, 2, dtype=torch.float64)
        f = lambda s, y: -1e4 * (y - torch.cos(10 * s))
        ys, st = odeint_with_stats(f, y0, t, method="implicit_midpoint",
                                   options=dict(num_steps=2, max_iters=1))
        _, st_ok = odeint_with_stats(f, y0, t, method="implicit_euler",
                                     options=dict(num_steps=200))
        out.append((ys.cpu(), st.error_code, st_ok.error_code))
    assert out[0][1] == out[1][1] == 4 and out[0][2] == out[1][2] == 0
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=F64)


# ---- the conv ODE-Net field, the gradient modes, the SciPy bridge ----------

def _conv_problem(device, dtype, B=4, dim=8, hw=6):
    """A conv field from seed-made HWIO weights (as bench.py's
    `make_shared_conv`), its NHWC state and the output times."""
    from torchdiffeq_tpu_torch.models import conv_params_from_jax
    rng = np.random.RandomState(3)

    def conv():
        return dict(w=rng.randn(3, 3, dim + 1, dim)
                    * np.sqrt(2.0 / (9 * (dim + 1))),
                    b=rng.randn(dim) * 0.1)

    params = dict(conv1=conv(), conv2=conv())
    model = conv_params_from_jax(params, device=device).to(dtype)
    y0 = torch.from_numpy(0.3 * rng.randn(B, hw, hw, dim)).to(device, dtype)
    return model, y0, torch.tensor([0.0, 0.5, 1.0], dtype=torch.float64)


@pytest.mark.parametrize("dim", [8, 64])
def test_conv_field_cuda_matches_cpu(cuda, dim):
    """The conv field (cuDNN's convolutions, the NHWC state through a
    channels-last view) on the card against the CPU: float64 to 1e-12 of
    max|f| (the convolutions' and reductions' summation order), float32
    with TF32 off to 1e-5 (float32's rounding, amplified by the last
    GroupNorm's division by the group's spread)."""
    torch.backends.cudnn.allow_tf32 = False
    want = None
    for dtype in (torch.float64, torch.float32):
        out = {}
        for dev in ("cpu", cuda):
            model, y0, _ = _conv_problem(dev, dtype, dim=dim)
            with torch.no_grad():
                out[str(dev)] = model(torch.tensor(0.37), y0).double().cpu()
        if want is None:
            want = out["cpu"]
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        assert float((out[str(cuda)] - want).abs().max()) \
            <= tol * float(want.abs().max())


def test_conv_solve_and_adjoint_cuda_match_cpu(cuda):
    """dopri5 at rtol=atol=1e-3 on the conv field in float64, card against
    CPU: Stats equal, values to 1e-10; `odeint_adjoint`'s gradients to the
    weights and y0 within 1e-9 of max|g|."""
    from torchdiffeq_tpu_torch import odeint_adjoint
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for dev in ("cpu", cuda):
        model, y0, t = _conv_problem(dev, torch.float64)
        with torch.no_grad():
            ys, st = odeint_with_stats(model, y0, t, rtol=1e-3, atol=1e-3)
        y0.requires_grad_(True)
        ys2 = odeint_adjoint(model, y0, t, rtol=1e-3, atol=1e-3)
        (ys2[-1] ** 2).mean().backward()
        out[str(dev)] = (ys.cpu(), list(st[:5]),
                         [g.cpu() for g in [y0.grad] +
                          [p.grad for p in model.parameters()]])
    (ys_c, st_c, g_c), (ys_g, st_g, g_g) = out["cpu"], out[str(cuda)]
    assert st_g == st_c and st_g[4] == 0
    torch.testing.assert_close(ys_g, ys_c, rtol=0, atol=F64)
    scale = max(float(g.abs().max()) for g in g_c)
    for a, b in zip(g_g, g_c):
        assert float((a - b).abs().max()) <= 1e-9 * scale


def _mode_grads(device, mode):
    """Gradients of mean(ys**2) to y0 and the parameters in float64 on the
    spiral field (B=64) by one gradient mode; forward_grad's as the jvp of
    the same loss in a seed-made direction of y0."""
    from torchdiffeq_tpu_torch import odeint_adjoint
    model, y0, t = _spiral_problem(device, torch.float64, B=64)
    kw = dict(rtol=1e-7, atol=1e-9)
    if mode == "forward_grad":
        v = torch.from_numpy(np.random.RandomState(5).randn(64, 2)).to(device)
        _, tan = torch.func.jvp(lambda y: (odeint(
            model, y, t, options=dict(forward_grad=True), **kw) ** 2).mean(),
            (y0,), (v,))
        return [tan.cpu()]
    model.requires_grad_(True)
    y0.requires_grad_(True)
    if mode == "interpolated":
        ys = odeint_adjoint(model, y0, t, adjoint_options=dict(
            interpolated=True), **kw)
    else:
        ys = odeint(model, y0, t, options=dict(replay_grad=True), **kw)
    (ys ** 2).mean().backward()
    return [g.cpu() for g in [y0.grad] + [p.grad for p in model.parameters()]]


@pytest.mark.parametrize("mode", ["interpolated", "replay_grad",
                                  "forward_grad"])
def test_gradient_modes_cuda_match_cpu(cuda, mode):
    """The interpolated adjoint, the replay and forward_grad's jvp on the
    card against the CPU in float64: within 1e-9 of max|g| (the products'
    summation order and tanh's last ULP over the solves)."""
    want = _mode_grads("cpu", mode)
    got = _mode_grads(cuda, mode)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-9 * float(w.abs().max())


def test_scipy_solver_device_round_trip(cuda):
    """The SciPy bridge from a CUDA state: the field runs on the card,
    SciPy on the host, and the result comes back on the card in the
    state's dtype, equal to the CPU call's to 1e-12 of max|y| (the same
    solve on evaluations that differ in their last bits)."""
    out = {}
    for dev in ("cpu", cuda):
        model, y0, t = _spiral_problem(dev, torch.float64, B=16)
        with torch.no_grad():
            ys, st = odeint_with_stats(model, y0, t, method="scipy_solver",
                                       rtol=1e-8, atol=1e-10)
        assert ys.device == y0.device and ys.dtype == torch.float64
        out[str(dev)] = ys.cpu(), int(st.nfe)
    (ys_c, n_c), (ys_g, n_g) = out["cpu"], out[str(cuda)]
    assert n_g == n_c
    assert float((ys_g - ys_c).abs().max()) <= 1e-12 * float(
        ys_c.abs().max())


# ---- the per-sample batched driver (off the kernel route) --------------------

def _osc(t, y, om):
    return torch.stack([y[1], -om ** 2 * y[0] - 0.1 * y[1]])


def _ensemble(device, B=64):
    rng = np.random.RandomState(0)
    om = torch.from_numpy(np.exp(rng.uniform(0.0, np.log(60.0), B))).to(
        device)
    y0 = torch.stack([torch.ones(B, dtype=torch.float64),
                      torch.zeros(B, dtype=torch.float64)], 1).to(device)
    return y0, om


@pytest.mark.parametrize("event", [False, True])
def test_per_sample_driver_cuda_matches_cpu(cuda, event):
    """The batched driver (a per-sample field with per-sample args, and
    its per-sample events) on the card against the CPU in float64: the
    same steps for every sample, values within 1e-10 of max|y|."""
    out = {}
    for dev in ("cpu", cuda):
        y0, om = _ensemble(dev)
        kw = dict(args=(om,), args_axes=(-1,), rtol=1e-7, atol=1e-9)
        with torch.no_grad():
            if event:
                (et, ys), st = odeint_per_sample_with_stats(
                    _osc, y0, torch.tensor([0.0, 2.0], dtype=torch.float64),
                    event_fn=lambda t, y: y[0], **kw)
                ys = torch.cat([et[:, None], ys.reshape(len(et), -1)], 1)
            else:
                ys, st = odeint_per_sample_with_stats(
                    _osc, y0, torch.linspace(0.0, 1.0, 5,
                                             dtype=torch.float64), **kw)
        assert ys.device == y0.device
        out[str(dev)] = ys.cpu(), [x.cpu() for x in st]
    (ys_c, st_c), (ys_g, st_g) = out["cpu"], out[str(cuda)]
    for a, b in zip(st_g[:5], st_c[:5]):
        assert torch.equal(a, b)
    assert float((ys_g - ys_c).abs().max()) <= F64 * float(ys_c.abs().max())


def _per_sample_grads(device):
    model, rng = _model(device, torch.float64, H=16, scale=0.3)
    model.requires_grad_(True)

    class Field(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.mlp = model

        def forward(self, t, y, lam):
            return self.mlp(t, y) - lam * y

    y0 = torch.from_numpy(rng.randn(8, 2)).to(device).requires_grad_(True)
    lam = torch.linspace(0.1, 0.5, 8, dtype=torch.float64,
                         device=device).requires_grad_(True)
    ys = odeint_per_sample(Field(), y0, torch.linspace(0.0, 1.0, 4),
                           args=(lam,), args_axes=(0,), rtol=1e-8,
                           atol=1e-10)
    (ys ** 2).mean().backward()
    return [g.cpu() for g in [y0.grad, lam.grad]
            + [p.grad for p in model.parameters()]]


def _per_sample_event_grads(device):
    """Gradients through the oscillators' per-sample first zeros: to y0
    and to each sample's frequency."""
    y0, om = _ensemble(device, B=8)
    y0.requires_grad_(True)
    om.requires_grad_(True)
    (_, ys2), _ = odeint_per_sample_with_stats(
        _osc, y0, torch.tensor([0.0, 2.0], dtype=torch.float64),
        args=(om,), args_axes=(0,), event_fn=lambda t, y: y[0],
        rtol=1e-8, atol=1e-10)
    (ys2[:, 1] ** 2).sum().backward()
    return [y0.grad.cpu(), om.grad.cpu()]


@pytest.mark.parametrize("event", [False, True])
def test_per_sample_gradient_cuda_matches_cpu(cuda, event):
    """The continuous adjoint of every sample (a vmapped augmented field),
    and through every sample's own event, on the card against the CPU in
    float64: within 1e-9 of max|g|."""
    grads = _per_sample_event_grads if event else _per_sample_grads
    want = grads("cpu")
    got = grads(cuda)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-9 * float(w.abs().max())


def test_per_sample_kernel_route_refuses_other_fields(cuda):
    """pallas=True on CUDA takes the per-lane kernel for an MLPField with
    no args (the hand-written instance) and for any field in the traced op
    set (a traced instance: the oscillators with a frequency per sample,
    which raised here before the traced instances); a field outside the set
    raises, names the operation and the batched driver, which then takes it
    when pallas=True is dropped."""
    y0, om = _ensemble(cuda, B=16)
    t = torch.linspace(0.0, 1.0, 3, dtype=torch.float64)
    kernels.reset_launch_counts()
    with torch.no_grad():
        odeint_per_sample_with_stats(_osc, y0, t, args=(om,),
                                     args_axes=(-1,),
                                     options=dict(pallas=True))
    assert kernels.traced_launch_counts["dopri5_integrate_batched"] == 1
    with pytest.raises(TypeError, match="aten.sinh.*drop pallas=True"):
        odeint_per_sample_with_stats(lambda tt, y, w: torch.sinh(w * y), y0,
                                     t, args=(om,), args_axes=(-1,),
                                     options=dict(pallas=True))
    kernels.reset_launch_counts()
    with torch.no_grad():
        ys, st = odeint_per_sample_with_stats(_osc, y0, t, args=(om,),
                                              args_axes=(-1,))
    assert ys.is_cuda and int(st.error_code.max()) == 0
    assert sum(kernels.launch_counts.values()) == 0


# ---- the traced instances of K-dopri5 and K-events ---------------------------

def _shared_w(device, dtype):
    return torch.tensor([[0.3, -1.2], [1.1, 0.2]], dtype=dtype, device=device)


def _traced_fields(device, dtype):
    """(name, per-sample field, args, args_axes) of the traced cases: the
    ensemble's oscillators (a per-lane arg), a field with a shared matrix
    and a per-lane rate (@, tanh, sum), and one that reads its time (the
    stage times) with a closed-over constant."""
    c = torch.tensor(0.7, dtype=dtype, device=device)
    return [
        ("oscillators", _osc, ("om",), (-1,)),
        ("shared_matrix", lambda t, y, W, k: torch.tanh(y @ W) * k
         - 0.1 * y * torch.sum(y * y), ("W", "k"), (None, -1)),
        ("time", lambda t, y, k: torch.stack(
            [y[1] * torch.cos(t) * c, -k * torch.sin(y[0]) - 0.2 * y[1]]),
         ("k",), (-1,)),
    ]


def _traced_args(names, device, dtype, B):
    rng = np.random.RandomState(3)
    vals = dict(om=np.exp(rng.uniform(0.0, np.log(20.0), B)),
                k=rng.uniform(0.5, 2.0, B))
    return tuple(_shared_w(device, dtype) if n == "W" else
                 torch.from_numpy(vals[n]).to(device, dtype) for n in names)


def _traced_flips(got, want, n_counts):
    """The share of lanes whose counts differ, and a mask of the others."""
    same = torch.ones_like(got[-1][0], dtype=torch.bool)
    for g, w in zip(got[-n_counts:], want[-n_counts:]):
        same &= (g[0] == w[0])
    return 1.0 - float(same.float().mean()), same


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", [0, 1, 2])
@pytest.mark.parametrize("method", ["dopri5", "tsit5", "bosh3", "fehlberg2",
                                    "adaptive_heun", "dopri8"])
def test_traced_lanes_match_plain(cuda, dtype, case, method):
    """K-dopri5's traced instance against its plain version on the same
    CUDA tensors, for every explicit method (each compiles its tableau into
    the instance).  float64: the same operations in the traced graph's order
    but for the sums' order and libm's last bit, so counts equal away from
    accept boundaries (at most 1% of lanes flip, C7) and values within F64
    on the others; float32 within the bounds of the hand-written instance's
    float32 test (test_lanes_kernel_matches_plain_float32)."""
    name, func, names, axes = _traced_fields(cuda, dtype)[case]
    B = 2048
    rng = np.random.RandomState(case)
    y0 = torch.from_numpy(rng.randn(2, B) * 0.8).to(cuda, dtype)
    field = PerSampleField(func, _traced_args(names, cuda, dtype, B), axes)
    kw = dict(ts=np.linspace(0.0, 1.0, 5), rtol=1e-6, atol=1e-8,
              method=method)
    before = kernels.traced_launch_counts["dopri5_integrate_batched"]
    with torch.no_grad():
        got = kernels.dopri5_integrate_batched(field, y0, 0.0, 1.0, **kw)
        want = kernels.dopri5_integrate_batched_ref(field, y0, 0.0, 1.0,
                                                    **kw)
    torch.cuda.synchronize()
    assert kernels.traced_launch_counts["dopri5_integrate_batched"] \
        == before + 1
    # the second-order methods' fastest lanes run out of max_steps before
    # t=1 here: both versions emit NaN in the rows those lanes never reached
    if dtype == torch.float64:
        flips, same = _traced_flips(got, want, 2)
        assert flips <= 0.01, (name, flips)
        torch.testing.assert_close(got[0][..., same], want[0][..., same],
                                   rtol=0, atol=F64, equal_nan=True)
    else:
        dsteps = (got[2] - want[2]).abs()
        assert float((dsteps == 0).float().mean()) >= 0.75, name
        assert int(dsteps.max()) <= 5, name
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=5e-3,
                                   equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("method", ["dopri5", "fehlberg2"])
def test_traced_events_match_plain(cuda, dtype, K, method):
    """K-events' traced instance (the oscillators' field, an event of K
    outputs sign-combined inside its functor: the first zero of x, and with
    K=2 a cut-off at t=0.4) against its plain version, with dopri5 and with
    fehlberg2 (a tableau without FSAL, its y1 from c_sol and one more
    evaluation a step): float64 found and
    counts equal but for C7's flips (at most 1%), event times within F64 on
    the others; float32 event times within 1e-3 (chip_smoke.py's
    F32_EVENT_T) and steps within 5."""
    B = 2048
    y0_b, om = _ensemble(cuda, B)
    y0_b, om = y0_b.to(dtype), om.to(dtype)
    y0 = y0_b.T.contiguous()
    ev_fn = (lambda t, y: y[0]) if K == 1 else \
        (lambda t, y: torch.stack([y[0], (0.4 - t).to(y.dtype)]))
    field, event = PerSampleField(_osc, (om,), (-1,)), PerSampleEvent(ev_fn)
    t0 = torch.zeros((), dtype=dtype, device=cuda)
    sign0 = torch.sign(torch.func.vmap(
        lambda yy: torch.atleast_1d(ev_fn(t0, yy)))(y0_b)).T.contiguous()
    kw = dict(rtol=1e-6, atol=1e-8, ev_params=(sign0,), method=method)
    with torch.no_grad():
        got = kernels.dopri5_events_batched(field, y0, 0.0, event, **kw)
        want = kernels.dopri5_events_batched_ref(field, y0, 0.0, event, **kw)
    torch.cuda.synchronize()
    assert bool(want[2].all())
    if dtype == torch.float64:
        flips, same = _traced_flips(got, want, 3)
        assert flips <= 0.01, flips
        torch.testing.assert_close(got[0][..., same], want[0][..., same],
                                   rtol=0, atol=F64)
    else:
        assert float((got[0] - want[0]).abs().max()) <= 1e-3
        assert int((got[4] - want[4]).abs().max()) <= 5


def test_traced_per_sample_route_matches_the_driver(cuda):
    """The ensemble example's two kernel calls on the card launch the traced
    instances and agree with the batched driver as the example asserts
    (values within 1e-2, event times within 5% of pi/(2 omega))."""
    from torchdiffeq_tpu_torch.examples import ensemble
    kernels.reset_launch_counts()
    out = ensemble.main(["--batch", "256"])
    assert kernels.traced_launch_counts == {"dopri5_integrate_batched": 1,
                                            "dopri5_events_batched": 1}
    assert out["err"] < 1e-2 and out["rel"] < 0.05


# ---- the 16-bit instances of K-dopri5 and K-events ---------------------------

# a 16-bit error estimate and step size are coarse, so a last-bit difference
# (the products' summation order, tanhf) flips an accept on some lanes (C7),
# whose counts then differ, or moves a step size by a unit, after which the
# lane takes other steps of the same count.  Two bounds, as chip_smoke.py's
# phase 15 (f): the share of lanes whose counts differ (LANE16_FLIP_SHARE),
# and the distance of every lane whose counts are equal, in units in the
# last place of max|y| of its dtype (LANE16_ULPS: 32 bfloat16 units are 256
# float16 ones); both from the largest readings on an H100 (PERF.md §6):
# 1.76% with other counts, the others within 157.88 float16 units
# (D=12) here and 13.0 bfloat16 units in chip_smoke.py's phase 15 (f).
LANE16_FLIP_SHARE = 0.025
LANE16_ULPS = {torch.bfloat16: 32, torch.float16: 256}


def _flips_and_ulps(vals, want_vals, counts, want_counts, dtype):
    """(the share of lanes whose counts differ from the plain version's,
    the largest distance over the other lanes in units in the last place
    of max|y|, how many of them lie more than 2 units away)."""
    same = None
    for g, w in zip(counts, want_counts):
        e = (g.cpu() == w).reshape(-1)
        same = e if same is None else same & e
    dist = torch.zeros(same.shape[0], dtype=torch.float64)
    for g, w in zip(vals, want_vals):
        g, w = g.cpu().double(), w.double()
        ok = torch.isfinite(w)
        assert torch.equal(torch.isfinite(g)[..., same], ok[..., same])
        if not bool(ok.any()):
            continue
        unit = 2.0 ** (np.floor(np.log2(float(w[ok].abs().max())))
                       - (7 if dtype == torch.bfloat16 else 10))
        d = torch.where(ok, (g - w).abs(), torch.zeros_like(w)) / unit
        dist = torch.maximum(dist, d.reshape(-1, same.shape[0]).amax(0))
    kept = dist[same]
    return (1.0 - float(same.float().mean()),
            float(kept.max()) if kept.numel() else 0.0,
            int((kept > 2).sum()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D,power,method", [(2, 3, 'dopri5'), (3, 1, 'bosh3'),
                                            (12, 2, 'dopri5'),
                                            (2, 3, 'dopri8')])
@pytest.mark.parametrize("events", [False, True])
def test_lanes_16bit_kernels_match_plain(cuda, dtype, D, power, method,
                                         events):
    """The bfloat16 and float16 instances (register and shared-memory)
    against their plain versions on the CPU, the rounding the CPU tests
    hold to JAX's kernel.  A first step is given: float16's Hairer initial
    step squares f / (atol + rtol |y|), which overflows on some of these
    lanes (in JAX's kernel as here) and leaves them at dt = 0."""
    model, rng = _model(cuda, torch.float32, D=D, power=power, scale=0.3)
    model = model.to(dtype)
    model_c = _model("cpu", torch.float32, D=D, power=power,
                     scale=0.3)[0].to(dtype)
    B = 512
    y0 = torch.from_numpy(rng.randn(D, B)).to(dtype)
    kw = dict(rtol=1e-2, atol=1e-2, method=method, first_step=0.05)
    if events:
        w = [[1.0] + [0.0] * (D - 1)]
        ev = LinearEvent(w, time_coef=[0.0], bias=[-0.3], dtype=dtype,
                         device=cuda).requires_grad_(False)
        ev_c = LinearEvent(w, time_coef=[0.0], bias=[-0.3], dtype=dtype,
                           device="cpu").requires_grad_(False)
        s0 = torch.sign(ev_c.lanes(torch.zeros(1, B, dtype=dtype), y0))
        got = kernels.dopri5_events_batched(
            model, y0.to(cuda), 0.0, ev, ev_params=(s0.to(cuda),),
            max_steps=500, **kw)
        want = kernels.dopri5_events_batched_ref(
            model_c, y0, 0.0, ev_c, ev_params=(s0,), max_steps=500, **kw)
        vals, counts = (0, 1), (2, 3, 4)
    else:
        kw['ts'] = np.linspace(0.0, 4.0, 5)
        got = kernels.dopri5_integrate_batched(model, y0.to(cuda), 0.0, 4.0,
                                               **kw)
        want = kernels.dopri5_integrate_batched_ref(model_c, y0, 0.0, 4.0,
                                                    **kw)
        vals, counts = (0,), (1, 2)
    assert got[0].dtype == dtype
    share, ulps, far = _flips_and_ulps(
        [got[i] for i in vals], [want[i] for i in vals],
        [got[i] for i in counts], [want[i] for i in counts], dtype)
    print(f"16-bit {dtype} D={D} {method} events={events}: lanes with other "
          f"counts {share:.4f}, the others within {ulps:.2f} ULPs of max|y| "
          f"({far} of {B} past 2)")   # shown with -s
    assert share <= LANE16_FLIP_SHARE and ulps <= LANE16_ULPS[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_per_sample_route_launches_16bit_kernels(cuda, dtype):
    """`odeint_per_sample(..., options=dict(pallas=True))` with a 16-bit
    MLPField launches K-dopri5 and K-events once each."""
    model, rng = _model(cuda, torch.float32, scale=0.3)
    model = model.to(dtype)
    y0 = torch.from_numpy(rng.randn(256, 2)).to(dtype).to(cuda)
    ev = LinearEvent([[1.0, 0.0]], bias=[-0.3], dtype=dtype, device=cuda)
    kernels.reset_launch_counts()
    with torch.no_grad():
        ys, st = odeint_per_sample_with_stats(
            model, y0, torch.linspace(0.0, 2.0, 3), rtol=1e-2, atol=1e-2,
            options=dict(pallas=True))
        (et, _), st_e = odeint_per_sample_with_stats(
            model, y0, torch.tensor([0.0, 5.0]), rtol=1e-2, atol=1e-2,
            event_fn=ev, options=dict(pallas=True, max_num_steps=300))
    assert kernels.launch_counts["dopri5_integrate_batched"] == 1
    assert kernels.launch_counts["dopri5_events_batched"] == 1
    assert ys.dtype == dtype and ys.is_cuda and et.dtype == dtype
    assert int(st.error_code.max()) == 0


# ---- the per-sample stiff, implicit and Adams tiers --------------------------

def _relax_i(t, y, lam):
    return -lam * (y - t) + 1.0


@pytest.mark.parametrize("method,options", [
    ('kvaerno5', None), ('radau5a', None), ('kvaerno3', None),
    ('implicit_adams', dict(num_steps=40)), ('gl4', dict(num_steps=20)),
    ('trbdf2', dict(num_steps=20, root_solver='newton'))])
def test_per_sample_implicit_tiers_cuda_match_cpu(cuda, method, options):
    """Each sample's own controller, Newton or Broyden solves and Adams
    order, on the card against the CPU in float64: Stats equal, values
    within 1e-10 of max|y| (NaN where a sample's corrector diverged, on
    both)."""
    out = {}
    for dev in ("cpu", cuda):
        lam = torch.from_numpy(np.logspace(0.0, 3.0, 16)).to(dev)
        y0 = torch.linspace(0.5, 1.5, 16, dtype=torch.float64).to(dev)[:, None]
        with torch.no_grad():
            ys, st = odeint_per_sample_with_stats(
                _relax_i, y0, torch.linspace(0.0, 1.0, 3), args=(lam,),
                args_axes=(0,), method=method, options=options, rtol=1e-6,
                atol=1e-8)
        out[str(dev)] = ys.cpu(), [x.cpu() for x in st]
    (ys_c, st_c), (ys_g, st_g) = out["cpu"], out[str(cuda)]
    for a, b in zip(st_g[:5], st_c[:5]):
        assert torch.equal(a, b)
    fin = torch.isfinite(ys_c)
    assert torch.equal(torch.isfinite(ys_g), fin)
    assert float((ys_g - ys_c)[fin].abs().max()) <= F64 * float(
        ys_c[fin].abs().max())


def test_per_sample_stiff_gradient_cuda_matches_cpu(cuda):
    """kvaerno5's continuous adjoint per sample (the backward's Newton
    steps per sample too), card against CPU in float64: 1e-9 of max|g|."""
    grads = {}
    for dev in ("cpu", cuda):
        lam = torch.from_numpy(np.logspace(0.0, 1.0, 8)).to(dev)
        lam.requires_grad_(True)
        y0 = torch.linspace(0.5, 1.5, 8, dtype=torch.float64).to(
            dev)[:, None].requires_grad_(True)
        ys = odeint_per_sample(_relax_i, y0, torch.linspace(0.0, 1.0, 3),
                               args=(lam,), args_axes=(0,),
                               method='kvaerno5', rtol=1e-6, atol=1e-8)
        (ys ** 2).sum().backward()
        grads[str(dev)] = [y0.grad.cpu(), lam.grad.cpu()]
    for g, w in zip(grads[str(cuda)], grads["cpu"]):
        assert float((g - w).abs().max()) <= 1e-9 * float(w.abs().max())


# ---- the 16-bit traced instances and complex states -----------------------

def _scalars(t, y, om):
    """A field whose scalar operands are not exact in a 16-bit dtype, and a
    cube (tests/test_torch_traced_16bit.py)."""
    return torch.stack([y[1], -om ** 2 * y[0] - 0.3 * y[1]
                        - 0.1 * y[0] ** 3])


# A traced 16-bit instance and its plain version run the same operations in
# the same order, each rounded to the state dtype, and every reading on an
# H100 was bit for bit (PERF.md §6, PR 13).  So, as chip_smoke.py's phase
# 18 (b), each lane is held to TRACED16_ULPS units in the last place of each
# component's own magnitude in that lane (an output's largest |y| over the
# output times; an event time or state its own), and at most
# TRACED16_FLIP_LANES lanes may take other counts.  A unit set by max|y| over
# the whole output would leave x (|x| <= 1 beside |v| up to omega ~ 20) and
# most event times unchecked.
TRACED16_ULPS, TRACED16_FLIP_LANES = 2, 2


def _traced16_flips_and_ulps(vals, want_vals, counts, want_counts, dtype):
    """(the number of lanes whose counts differ from the plain version's,
    the largest distance over the other lanes in units in the last place
    of each component's own magnitude in that lane, never below the
    dtype's subnormal spacing)."""
    same = None
    for g, w in zip(counts, want_counts):
        e = (g.cpu() == w).reshape(-1)
        same = e if same is None else same & e
    mant = 7 if dtype == torch.bfloat16 else 10
    least = torch.finfo(dtype).tiny * 2.0 ** -mant
    dist = torch.zeros(same.shape[0], dtype=torch.float64)
    for g, w in zip(vals, want_vals):
        g, w = g.cpu().double(), w.double()
        ok = torch.isfinite(w)
        assert torch.equal(torch.isfinite(g)[..., same], ok[..., same])
        mag = torch.where(ok, w.abs(), torch.zeros_like(w))
        if mag.dim() == 3:
            mag = mag.amax(0, keepdim=True)
        unit = torch.exp2(torch.floor(torch.log2(mag.clamp_min(least)))
                          - mant).clamp_min(least)
        d = torch.where(ok, (g - w).abs(), torch.zeros_like(w)) / unit
        dist = torch.maximum(dist, d.reshape(-1, same.shape[0]).amax(0))
    kept = dist[same]
    return int((~same).sum()), float(kept.max()) if kept.numel() else 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("func", [_osc, _scalars])
@pytest.mark.parametrize("events", [False, True])
def test_traced_16bit_instances_match_plain(cuda, dtype, func, events):
    """The bfloat16 and float16 traced instances of K-dopri5 and K-events
    against their plain versions (the traced graph run op by op in the
    state dtype) on the same CUDA tensors: at most TRACED16_FLIP_LANES lanes
    with other counts, the others within TRACED16_ULPS of each component's
    own magnitude in the lane.  omega in [1, 20] (bfloat16) and in
    [0.3, 1.2] (float16, whose Hairer step overflows past about 1.5 at
    these tolerances and stalls a lane in both versions)."""
    B = 2048
    rng = np.random.RandomState(7)
    hi = (0.0, np.log(20.0)) if dtype == torch.bfloat16 else (
        np.log(0.3), np.log(1.2))
    om = torch.from_numpy(np.exp(rng.uniform(*hi, B))).to(cuda, dtype)
    y0 = torch.stack([torch.ones(B), torch.zeros(B)]).to(cuda, dtype)
    field = PerSampleField(func, (om,), (-1,))
    kw = dict(rtol=1e-2, atol=1e-2)
    before = dict(kernels.traced_launch_counts)
    with torch.no_grad():
        if events:
            event = PerSampleEvent(lambda t, y: y[0])
            sign0 = torch.ones(1, B, dtype=dtype, device=cuda)
            kw.update(ev_params=(sign0,), max_steps=2000)
            got = kernels.dopri5_events_batched(field, y0, 0.0, event, **kw)
            want = kernels.dopri5_events_batched_ref(field, y0, 0.0, event,
                                                     **kw)
            vals, counts, name = (0, 1), (2, 3, 4), "dopri5_events_batched"
        else:
            kw['ts'] = np.linspace(0.0, 2.0, 5)
            got = kernels.dopri5_integrate_batched(field, y0, 0.0, 2.0, **kw)
            want = kernels.dopri5_integrate_batched_ref(field, y0, 0.0, 2.0,
                                                        **kw)
            vals, counts, name = (0,), (1, 2), "dopri5_integrate_batched"
    torch.cuda.synchronize()
    assert kernels.traced_launch_counts[name] == before[name] + 1
    assert got[0].dtype == dtype
    flips, ulps = _traced16_flips_and_ulps(
        [got[i] for i in vals], [want[i].cpu() for i in vals],
        [got[i] for i in counts], [want[i].cpu() for i in counts], dtype)
    print(f"traced 16-bit {dtype} {func.__name__} events={events}: lanes "
          f"with other counts {flips}, the others within {ulps:.2f} ULPs "
          f"of their own magnitude")   # shown with -s
    assert flips <= TRACED16_FLIP_LANES and ulps <= TRACED16_ULPS


def test_complex_states_cuda_match_cpu(cuda):
    """A complex128 state on the card against the CPU: dopri5 and kvaerno5
    (its stage systems on the stacked real view) with Stats equal and
    values within F64, and the adjoint's gradients (torch's convention on
    both) within 1e-9 of max|g|."""
    rng = np.random.RandomState(2)
    y0 = rng.randn(4, 3) + 1j * rng.randn(4, 3)
    w = rng.uniform(0.5, 2.0, 3)

    def f(t, y, ww):
        return 1j * ww * y - 0.1 * y * y.abs() ** 2 + 0.05 * torch.conj(y) * t

    out = {}
    for dev in ("cpu", cuda):
        yy = torch.from_numpy(y0).to(dev).requires_grad_(True)
        ww = torch.from_numpy(w).to(dev).requires_grad_(True)
        t = torch.linspace(0.0, 1.0, 4, dtype=torch.float64)
        ys, st = odeint_with_stats(f, yy.detach(), t, args=(ww.detach(),),
                                   method='kvaerno5', rtol=1e-8, atol=1e-10)
        from torchdiffeq_tpu_torch import odeint_adjoint
        ys2 = odeint_adjoint(f, yy, t, args=(ww,), rtol=1e-8, atol=1e-10)
        (ys2[-1].abs() ** 2).sum().backward()
        out[str(dev)] = (ys.cpu(), [int(x) for x in st[:5]], ys2.detach().cpu(),
                         yy.grad.cpu(), ww.grad.cpu())
    c, g = out["cpu"], out[str(cuda)]
    assert g[1] == c[1]
    for i in (0, 2, 3, 4):
        assert float((g[i] - c[i]).abs().max()) <= 1e-9 * max(
            1.0, float(c[i].abs().max()))


def _parareal_grads(device):
    """Parareal (float64, 4 slices, n_iters 3) on a small spiral MLP field
    with 16 trajectories as one state: (ys, deltas, gradients of
    sum(ys[-1]**2) in y0, the parameters and t)."""
    from torchdiffeq_tpu_torch.parallel import odeint_parareal_with_info
    model, rng = _model(device, torch.float64, H=16, scale=0.3)
    model.requires_grad_(True)
    y0 = torch.from_numpy(rng.randn(16, 2) * 0.8).to(device).requires_grad_()
    t = torch.linspace(0.0, 1.0, 5, dtype=torch.float64, requires_grad=True)
    ys, deltas = odeint_parareal_with_info(model, y0, t, rtol=1e-8,
                                           atol=1e-10, n_iters=3)
    (ys[-1] ** 2).sum().backward()
    return ys.detach(), deltas.detach(), [y0.grad, *(p.grad for p in
                                            model.parameters()), t.grad]


def test_parareal_cuda_matches_cpu(cuda):
    """odeint_parareal on the card against the CPU, float64: values and
    correction norms to 1e-10 of their max, gradients in y0, the module's
    parameters and t to 1e-9 of max|g| (chip_smoke.py's GRAD_F64_REL)."""
    ys_g, d_g, g_g = _parareal_grads(cuda)
    ys_c, d_c, g_c = _parareal_grads("cpu")
    assert ys_g.is_cuda and d_g.is_cuda and d_g.shape == (3,)
    torch.testing.assert_close(ys_g.cpu(), ys_c, rtol=0,
                               atol=F64 * float(ys_c.abs().max()))
    torch.testing.assert_close(d_g.cpu(), d_c, rtol=0,
                               atol=F64 * float(ys_c.abs().max()))
    for a, b in zip(g_g, g_c):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-9 * float(b.abs().max()))


def test_span_driver_cuda_matches_cpu(cuda):
    """The per-sample-span driver (Parareal's fine sweep) on the card:
    each lane over its own (t0, t1), float64, counters equal to the
    CPU's, values to 1e-10."""
    from torchdiffeq_tpu_torch.parallel.batched import (
        odeint_spans_with_stats)
    model, rng = _model(cuda, torch.float64)
    y0 = rng.randn(6, 2)
    grid = np.linspace(0.0, 3.0, 7)
    spans = np.stack([grid[:-1], grid[1:]], 1)
    runs = []
    for device in (cuda, "cpu"):
        m, _ = _model(device, torch.float64)
        with torch.no_grad():
            runs.append(odeint_spans_with_stats(
                m, torch.from_numpy(y0).to(device), torch.from_numpy(spans),
                rtol=1e-8, atol=1e-10))
    (ys_g, st_g), (ys_c, st_c) = runs
    for a, b in zip(st_g[:5], st_c[:5]):
        assert torch.equal(a.cpu(), b)
    torch.testing.assert_close(ys_g.cpu(), ys_c, rtol=0, atol=F64)


def _training_run(device):
    """The three training entry points on a small spiral loss (float64):
    make_sgd_step under scan_steps, fit, make_optax_step with Adam."""
    from types import SimpleNamespace
    from torchdiffeq_tpu_torch import odeint_adjoint, training
    from torchdiffeq_tpu_torch.models.neural_ode import mlp_apply
    model, rng = _model(device, torch.float64, H=16, scale=0.3)
    params = tuple(p.detach().clone() for p in (
        model.weights[0], model.biases[0], model.weights[1],
        model.biases[1]))
    y0 = torch.from_numpy(rng.randn(8, 2) * 0.8).to(device)
    target = torch.from_numpy(rng.randn(8, 2)).to(device)
    t = torch.linspace(0.0, 1.0, 4, dtype=torch.float64)

    def loss_fn(p, _batch):
        field = lambda tt, yy, q: mlp_apply(   # noqa: E731
            SimpleNamespace(weights=q[0::2], biases=q[1::2]), yy ** 3)
        ys = odeint_adjoint(field, y0, t, rtol=1e-8, atol=1e-10, args=(p,))
        return ((ys[-1] - target) ** 2).mean()

    step = training.make_sgd_step(loss_fn, lr=1e-2)
    p_scan, l_scan = training.scan_steps(step, params, length=3)
    p_fit, l_fit = training.fit(step, params, num_steps=3,
                                steps_per_dispatch=2)
    init, astep = training.make_optax_step(loss_fn, training.adam(1e-2))
    (p_adam, _), l_adam = training.scan_steps(astep, init(params), length=3)
    return [l_scan, torch.from_numpy(l_fit), l_adam, *p_scan, *p_fit,
            *p_adam]


def test_training_loops_cuda_match_cpu(cuda):
    """make_sgd_step/scan_steps, fit and make_optax_step on the card
    against the CPU, float64: losses and parameters to 1e-9 of their max
    (GRAD_F64_REL: three adjoint gradients apart by rounding)."""
    got, want = _training_run(cuda), _training_run("cpu")
    assert got[0].is_cuda and got[3].is_cuda
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-9 * float(b.abs().max()))


def _pytree_and_closure(device):
    """A nested-dict state through dopri5 and kvaerno5, and a closure
    field's d/dw under kvaerno5's adjoint, float64, on `device`."""
    y0 = {'a': torch.tensor([1.0, 0.4], dtype=torch.float64, device=device),
          'b': {'c': torch.tensor([[1.0, 2.0]], dtype=torch.float64,
                                  device=device)}}
    f = lambda s, y: {'a': -y['a'], 'b': {'c': -y['b']['c'] * y['a'][0]}}  # noqa
    t = torch.linspace(0.0, 1.0, 3, dtype=torch.float64)
    out = []
    for method in ('dopri5', 'kvaerno5'):
        ys, st = odeint_with_stats(f, y0, t, method=method, rtol=1e-9,
                                   atol=1e-11)
        out += [ys['a'], ys['b']['c'], list(st[:5])]
    from torchdiffeq_tpu_torch import odeint_adjoint
    w = torch.tensor(0.7, dtype=torch.float64, device=device,
                     requires_grad=True)
    ys = odeint_adjoint(lambda s, y: -w * y * y, y0['a'], t,
                        method='kvaerno5', adjoint_params=(w,))
    ys[-1].sum().backward()
    return out + [w.grad]


def test_pytree_state_and_closure_adjoint_cuda_match_cpu(cuda):
    """C19 and C20 on the card: a nested-dict state (its structure back,
    counters equal to the CPU's) and an implicit adjoint through a closure
    field, values and the gradient to 1e-10 of their max."""
    got, want = _pytree_and_closure(cuda), _pytree_and_closure("cpu")
    assert got[0].is_cuda and got[1].shape == (3, 1, 2)
    for a, b in zip(got, want):
        if isinstance(b, list):
            assert a == b
        else:
            torch.testing.assert_close(a.cpu(), b, rtol=0,
                                       atol=F64 * float(b.abs().max()))


def test_sharded_step_world_of_one_nccl(cuda):
    """examples/sharded_step.py as a world of one on NCCL, mesh {'data': 1,
    'model': 1}: the JAX dry run's step through data_parallel_odeint and
    the tensor-parallel field equals the unsharded step on the card bit
    for bit (chip_smoke.py phase 21 (a)), in float64 and float32."""
    import torch.distributed as dist
    from torchdiffeq_tpu_torch.examples import sharded_step
    if dist.is_initialized():
        pytest.skip("a process group is already set up in this process")
    try:
        for dtype in ('float64', 'float32'):
            out = sharded_step.main(['--dtype', dtype, '--steps', '1'])
            assert dist.get_backend() == 'nccl' and out['loss'].is_cuda
            assert torch.equal(out['loss'], out['ref_loss'])
            assert all(torch.equal(a, b) for a, b in
                       zip(out['grads'], out['ref_grads']))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_mesh_world_of_one_nccl(cuda):
    """make_mesh's world of one on NCCL: data_parallel_odeint,
    sharded_independent_odeint and Parareal's mesh equal their unsharded
    solves on the card bit for bit (chip_smoke.py phase 20 (a))."""
    import torch.distributed as dist
    from torchdiffeq_tpu_torch.parallel import (
        data_parallel_odeint, make_mesh, odeint_parareal,
        sharded_independent_odeint)
    if dist.is_initialized():
        pytest.skip("a process group is already set up in this process")
    try:
        mesh = make_mesh({'data': 1})
        assert dist.get_backend() == 'nccl' and mesh.device.type == 'cuda'
        model, rng = _model(cuda, torch.float64)
        y0 = torch.from_numpy(rng.randn(16, 2)).to(cuda)
        t = torch.linspace(0.0, 1.0, 4, dtype=torch.float64)
        ref, st = odeint_with_stats(model, y0, t)
        ys, st_dp = data_parallel_odeint(odeint_with_stats, mesh)(model, y0,
                                                                 t)
        assert torch.equal(ys, ref) and list(st_dp) == list(st)
        ys, sts = sharded_independent_odeint(odeint_with_stats, mesh)(
            model, y0, t)
        assert torch.equal(ys, ref) and sts == (st,)
        tm = make_mesh({'time': 1})
        assert torch.equal(
            odeint_parareal(model, y0[:4], t, n_iters=2, mesh=tm),
            odeint_parareal(model, y0[:4], t, n_iters=2))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
