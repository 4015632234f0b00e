"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need an NVIDIA GPU and nvcc; without a CUDA device every test skips.
On a GPU machine, which has no JAX, run them without the JAX test setup:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from torchdiffeq_tpu_torch import (odeint, odeint_with_stats,
                                   odeint_per_sample_with_stats, odeint_event,
                                   odeint_dense)
from torchdiffeq_tpu_torch.models import (LinearEvent, MLPField,
                                          mlp_params_from_jax)
from torchdiffeq_tpu_torch.ops import kernels

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
    give NaN rows where the plain version does."""
    model, rng = _model(cuda, torch.float64, scale=1.5)
    y0 = torch.from_numpy(rng.randn(2, 512) * 2).to(cuda)
    kw = dict(ts=np.linspace(0.0, 2.0, 5), rtol=1e-9, atol=1e-11,
              max_steps=40, first_step=1e-3, safety=0.8, ifactor=4.0,
              dfactor=0.3)
    got = kernels.dopri5_integrate_batched(model, y0, 0.0, 2.0, **kw)
    want = kernels.dopri5_integrate_batched_ref(model, y0, 0.0, 2.0, **kw)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=F64,
                               equal_nan=True)
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
                                     "dopri5_events_batched": 0}
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
    """No quiet fallback to the plain version on a CUDA tensor."""
    model, rng = _model(cuda, torch.float32)
    y0 = torch.from_numpy(rng.randn(64, 2)).to(cuda, torch.float32)
    with pytest.raises(TypeError, match="MLPField"):
        kernels.rk4_integrate(lambda t, y: -y, y0, 0.0, 0.1, 3)
    with pytest.raises(TypeError, match="MLPField"):
        odeint_per_sample_with_stats(lambda t, y: -y, y0,
                                     torch.linspace(0.0, 1.0, 3),
                                     options=dict(pallas=True))
    with pytest.raises(ValueError, match="stages"):
        kernels.dopri5_integrate_batched(model, y0.T.contiguous(), 0.0, 1.0,
                                         method="dopri8")
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
    with pytest.raises(TypeError, match="LinearEvent"):
        odeint_per_sample_with_stats(
            model, y0.T.contiguous(), torch.tensor([0.0, 1.0]),
            event_fn=lambda t, y: y[0] - 0.5, options=dict(pallas=True))


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
