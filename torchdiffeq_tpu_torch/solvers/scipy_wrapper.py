"""The SciPy ``solve_ivp`` bridge (counterpart of
``torchdiffeq_tpu/solvers/scipy_wrapper.py``; reference
torchdiffeq/_impl/scipy_wrapper.py).

The solve runs on the host in float64: each field evaluation copies the
state to the field's device and dtype and the slope back, as JAX's
`pure_callback` and the reference's numpy round trip do.  The result is
detached, in the state's dtype and on its device; its `Stats` count SciPy's
evaluations (``nfev``) and nothing else.  Useful for stiff problems through
LSODA, BDF or Radau.
"""
from __future__ import annotations

import numpy as np
import torch

from .solution import Stats


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def integrate_scipy(prob):
    """The solve of a normalised problem through ``scipy.integrate.
    solve_ivp`` (JAX `integrate_scipy`): (ys (T, *y0.shape), Stats)."""
    from scipy.integrate import solve_ivp
    from ..odeint import _warn_unused

    opts = dict(prob.options)
    _warn_unused('scipy solver', opts,
                 {'solver', 'min_step', 'max_step', 'dtype', 'norm',
                  'grid_points', 'eps'})
    solver = opts.get('solver', 'LSODA')
    min_step = opts.get('min_step', 0)
    max_step = opts.get('max_step', float('inf'))

    y0 = prob.y0.detach()
    shape, dtype, device = y0.shape, y0.dtype, y0.device
    t = np.asarray(prob.t, dtype=np.float64)

    # solve_ivp takes a per-component atol but only a scalar rtol
    rtol, atol = _host(prob.rtol), _host(prob.atol)
    if rtol.ndim > 0 and rtol.size > 1:
        raise ValueError(
            "scipy_solver requires a scalar rtol (scipy.solve_ivp does not "
            "support per-component rtol); per-leaf atol is supported.")
    rtol = float(rtol.reshape(()))
    atol = float(atol.reshape(())) if atol.size == 1 \
        else np.asarray(atol, dtype=np.float64).reshape(-1)

    func = prob.func

    def np_func(tt, y):
        with torch.no_grad():
            f = func(torch.tensor(tt, dtype=dtype),
                     torch.from_numpy(y).to(device=device,
                                            dtype=dtype).reshape(shape))
        return f.detach().to('cpu', torch.float64).numpy().reshape(-1)

    if t.size == 1:
        return y0[None].clone(), Stats.make(nfe=0)
    kwargs = {}
    if min_step != 0:
        kwargs['min_step'] = min_step
    if max_step != float('inf'):
        kwargs['max_step'] = max_step
    y0_np = y0.to('cpu', torch.float64).numpy().reshape(-1)
    sol = solve_ivp(np_func, t_span=[t.min(), t.max()], y0=y0_np, t_eval=t,
                    method=solver, rtol=rtol, atol=atol, **kwargs)
    ys = torch.from_numpy(np.ascontiguousarray(sol.y.T)).to(dtype)
    return (ys.reshape((t.size,) + tuple(shape)).to(device),
            Stats.make(nfe=int(sol.nfev)))
