"""Parallel-in-time integration (Parareal) on one device or over a mesh
of ranks (counterpart of ``torchdiffeq_tpu/parallel/parareal.py``).

The classic Parareal scheme (Lions, Maday & Turinici, C. R. Acad. Sci.
2001; Gander & Vandewalle 2007), as the JAX package runs it on one device:

* the output grid's T-1 intervals are the time slices;
* the FINE propagator (an adaptive solve at the requested tolerances)
  runs on every slice at once: one batched solve of the S = T-1 slices,
  each from its own start to its own end with its own controller
  (`batched.odeint_spans_with_stats`, the port's ``jax.vmap(fine)``);
* the cheap COARSE propagator (``coarse_method`` with
  ``coarse_num_steps`` fixed steps a slice) runs sequentially and
  propagates the corrections;
* after iteration k, slices 1..k are exactly the sequential fine solution
  (finite termination), so ``n_iters = T-1`` reproduces the
  slice-restarted sequential chain.

As in JAX, the initial coarse sweep's outputs are both the first iterate
and the coarse values the first correction needs, and each correction
sweep emits the next iteration's coarse values, so the coarse propagator
runs once a slice an iteration.  Gradients reach y0, the tensors in
`args`, an ``nn.Module`` field's parameters and `t`: the fine sweep through
each slice's continuous adjoint, the coarse sweeps by autograd through
their fixed-grid loops.

With ``mesh=`` (a `sharding.Mesh` of ranks, `sharding.make_mesh`) each
rank fine-solves its contiguous block of slices with its own controllers
and the slice ends are gathered over ``mesh[axis]`` (JAX's ``shard_map``
of the fine sweep, parareal.py:111-126); the coarse sweep runs replicated
on every rank.  Every slice has its own controller either way, so the
result is the one-device one.  The mesh path is forward-only: under
autograd it raises `NotImplementedError` (`sharding` module docstring).
"""
from __future__ import annotations

import torch
from torch import nn

from ..misc import (flatten_state, is_tree_state, needs_autograd,
                    ravel_leaves, tree_leaves)
from .batched import odeint_spans_with_stats
from .sharding import _all_gather_blocks, _axis


class _FlatField(nn.Module):
    """``func(t, unravel(y), *args)`` on the flat state, its output
    flattened (JAX `_flat_problem`'s `flat_func`).  A module: the user's
    field, when it is an ``nn.Module``, is its submodule, so that the
    adjoint finds its parameters."""

    def __init__(self, func, unravel):
        super().__init__()
        self.func = func
        self.unravel = unravel

    def forward(self, t, y, *args):
        out = self.func(t, self.unravel(y), *args)
        if is_tree_state(out):
            return ravel_leaves(out)
        return out.reshape(-1)


def _flat_problem(func, y0):
    """Ravel the state once: (flat field, y0 flat (n,), unravel), the
    unravel keeping leading axes and each leaf's dtype (JAX's
    ``ravel_pytree``)."""
    if is_tree_state(y0):
        y0_flat, unravel = flatten_state(y0)
    elif isinstance(y0, torch.Tensor):
        y0_flat, shape = y0.reshape(-1), tuple(y0.shape)

        def unravel(flat):
            return flat.reshape(tuple(flat.shape[:-1]) + shape)
    else:
        raise TypeError("y0 must be a torch.Tensor or a pytree of tensors")
    return _FlatField(func, unravel), y0_flat, unravel


def odeint_parareal(func, y0, t, *, rtol=1e-7, atol=1e-9, method=None,
                    options=None, coarse_method='rk4', coarse_num_steps=2,
                    n_iters=4, mesh=None, axis='time', args=()):
    """Solve ``dy/dt = func(t, y, *args)`` at the times `t` with Parareal.

    The T-1 output intervals are integrated at once by the fine propagator
    (``method`` at rtol/atol, default dopri5, one batched solve of the
    slices) and stitched by `n_iters` sequential coarse corrections
    (``coarse_method`` with ``coarse_num_steps`` fixed steps a slice).
    `y0` is a tensor or a pytree of tensors; `t` is strictly monotonic.
    ``mesh`` (a `sharding.Mesh`) shards the slices over ``mesh[axis]``,
    whose size must divide the T-1 slices; every rank calls with the same
    inputs, on its device, and gets the whole result (module
    docstring).

    Returns ``ys`` like `odeint`.  Use `odeint_parareal_with_info` for the
    per-iteration correction norms.
    """
    ys, _ = odeint_parareal_with_info(
        func, y0, t, rtol=rtol, atol=atol, method=method, options=options,
        coarse_method=coarse_method, coarse_num_steps=coarse_num_steps,
        n_iters=n_iters, mesh=mesh, axis=axis, args=args)
    return ys


def odeint_parareal_with_info(func, y0, t, *, rtol=1e-7, atol=1e-9,
                              method=None, options=None, coarse_method='rk4',
                              coarse_num_steps=2, n_iters=4, mesh=None,
                              axis='time', args=()):
    """`odeint_parareal` returning ``(ys, deltas)``, ``deltas[k]`` the max
    norm of iteration k's correction, a (n_iters,) tensor on the state's
    device (monotone decrease is the convergence signal; exactly zero once
    converged)."""
    from ..odeint import odeint

    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(t, dtype=torch.float64)
    T = t.shape[0]
    if T < 2:
        raise ValueError("parareal needs at least 2 output times")
    S = T - 1
    n_iters = int(n_iters)
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    args = tuple(args)
    mine = slice(None)            # the slices this process fine-solves
    if mesh is not None:
        group, n_shards, coord = _axis(mesh, axis)
        if S % n_shards != 0:
            raise ValueError(
                f"the mesh axis '{axis}' size ({n_shards}) must divide "
                f"the T-1={S} time slices")
        from ..adjoint import _tensors_in
        if needs_autograd(func, *tree_leaves(y0), t, *_tensors_in(args)):
            raise NotImplementedError(
                "odeint_parareal(mesh=...) is forward-only: mesh=None "
                "differentiates the one-device scheme")
        per = S // n_shards
        mine = slice(coord * per, (coord + 1) * per)
    flat_func, y0_flat, unravel = _flat_problem(func, y0)
    fine_opts = dict(options) if options else {}
    coarse_opts = dict(num_steps=int(coarse_num_steps))
    spans = torch.stack([t[:-1], t[1:]], dim=1)      # (S, 2)

    def fine_all(U_heads):
        ys, _ = odeint_spans_with_stats(
            flat_func, U_heads[mine], spans[mine], rtol=rtol, atol=atol,
            method=method, options=fine_opts, args=args)
        ends = ys[:, -1]
        return ends if mesh is None else _all_gather_blocks(ends, group, 0)

    def coarse(s, u):
        return odeint(flat_func, u, t[s:s + 2], method=coarse_method,
                      options=coarse_opts, args=args)[-1]

    # the initial coarse sweep: its outputs are the first iterate and the
    # coarse values over it
    U = [y0_flat]
    for s in range(S):
        U.append(coarse(s, U[-1]))
    G = U[1:]

    deltas = []
    for _ in range(n_iters):
        F = fine_all(torch.stack(U[:-1]))     # every slice at once
        U_new, G_new = [y0_flat], []
        for s in range(S):
            g = coarse(s, U_new[-1])
            U_new.append(g + (F[s] - G[s]))
            G_new.append(g)
        deltas.append((torch.stack(U_new) - torch.stack(U)).abs().max())
        U, G = U_new, G_new
    return unravel(torch.stack(U)), torch.stack(deltas)
