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
result is the one-device one.

Under autograd every rank calls with the same global inputs and receives
the global gradient, counted once, as under
`sharding.data_parallel_odeint`.  The coarse sweeps are replicated, so
their backward is the same on every rank; the fine sweep is one autograd
Function (`_MeshFineSweep`), whose backward hands every rank the global
fine cotangents: each rank takes the vector-Jacobian product of its own
slices (their continuous adjoints, with no collective), then one
all-gather brings every rank's slice heads' and spans' (that is, `t`'s)
cotangent blocks, and one all-reduce sums the cotangents of the field's
parameters and `args` tensors over the ranks.  Two collectives a fine
sweep, whatever the slices' step counts, so the ranks never part ways.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch import nn

from ..misc import (flatten_state, is_tree_state, needs_autograd,
                    ravel_leaves, real_part, tree_leaves)
from .batched import odeint_spans_with_stats
from .sharding import _DataGather, _axis


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


class _MeshFineSweep(torch.autograd.Function):
    """``(U_heads (S, n), spans (S, 2), *params) -> ends (S, n)``: the
    mesh's fine sweep under autograd (module docstring).  The forward
    solves this rank's slices (`fine(U_mine, spans_mine)`, recording their
    continuous adjoints on the real parameters) and gathers the slice ends
    over `group`; the backward returns the global cotangents of the heads,
    the spans and `params` on every rank."""

    @staticmethod
    def forward(ctx, fine, mine, group, U_heads, spans, *params):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            u = U_heads.detach()[mine].requires_grad_(need[3])
            sp = spans.detach()[mine].requires_grad_(need[4])
            ends = fine(u, sp)
        ctx.mine, ctx.group, ctx.graph = mine, group, (ends, u, sp, params)
        parts = [torch.empty_like(ends) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, ends.detach().contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        ends, u, sp, params = ctx.graph
        ctx.graph = None
        xs = (u, sp, *params)
        got = iter(torch.autograd.grad(
            ends, [x for x in xs if x.requires_grad], g[ctx.mine],
            allow_unused=True))
        grads = [None] * len(xs)
        for i, x in enumerate(xs):
            if x.requires_grad:
                v = next(got)
                grads[i] = torch.zeros_like(x) if v is None else v
        world = dist.get_world_size(ctx.group)
        # the collectives run on the state's device (a card's, for NCCL);
        # the times and an args tensor may lie on the CPU
        dev = u.device
        # every rank's heads' and spans' cotangent blocks, one all-gather
        gu, gsp = (torch.zeros_like(x) if v is None else v
                   for v, x in zip(grads[:2], (u, sp)))
        wide = torch.promote_types(gu.dtype, gsp.dtype)
        blocks = torch.cat([gu.to(wide), gsp.to(dev, wide)], dim=1)
        parts = [torch.empty_like(blocks) for _ in range(world)]
        dist.all_gather(parts, blocks, group=ctx.group)
        full = torch.cat(parts)
        n = gu.shape[1]
        if grads[0] is not None:
            grads[0] = full[:, :n].to(gu.dtype)
        if grads[1] is not None:
            grads[1] = real_part(full[:, n:]).to(sp.device, sp.dtype)
        # the parameters' cotangents summed over the ranks, one all-reduce
        live = [i for i in range(2, len(xs)) if grads[i] is not None]
        if live:
            wide = functools.reduce(torch.promote_types,
                                    [grads[i].dtype for i in live],
                                    torch.float64)
            flat = torch.cat([grads[i].reshape(-1).to(dev, wide)
                              for i in live])
            dist.all_reduce(flat, group=ctx.group)
            for i, part in zip(live, torch.split(
                    flat, [grads[i].numel() for i in live])):
                x = xs[i]
                part = part if x.is_complex() else real_part(part)
                grads[i] = part.reshape(x.shape).to(x.device, x.dtype)
        return (None, None, None, *grads)


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
    grad = False
    if mesh is not None:
        group, n_shards, coord = _axis(mesh, axis)
        if S % n_shards != 0:
            raise ValueError(
                f"the mesh axis '{axis}' size ({n_shards}) must divide "
                f"the T-1={S} time slices")
        from ..adjoint import _tensors_in
        grad = needs_autograd(func, *tree_leaves(y0), t, *_tensors_in(args))
        per = S // n_shards
        mine = slice(coord * per, (coord + 1) * per)
    flat_func, y0_flat, unravel = _flat_problem(func, y0)
    fine_opts = dict(options) if options else {}
    coarse_opts = dict(num_steps=int(coarse_num_steps))
    spans = torch.stack([t[:-1], t[1:]], dim=1)      # (S, 2)

    def fine(U_mine, spans_mine):
        ys, _ = odeint_spans_with_stats(
            flat_func, U_mine, spans_mine, rtol=rtol, atol=atol,
            method=method, options=fine_opts, args=args)
        return ys[:, -1]

    def fine_all(U_heads):
        if mesh is None:
            return fine(U_heads, spans)
        if grad:
            from ..adjoint import _adjoint_params
            module_params, arg_tensors = _adjoint_params(flat_func, args,
                                                         None)
            return _MeshFineSweep.apply(fine, mine, group, U_heads, spans,
                                        *module_params, *arg_tensors)
        return _DataGather.apply(fine(U_heads[mine], spans[mine]), group, 0)

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
