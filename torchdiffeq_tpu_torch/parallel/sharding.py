"""Device-mesh parallelism for ODE solves on ``torch.distributed``
(counterpart of ``torchdiffeq_tpu/parallel/sharding.py``).

The JAX package is single-controller SPMD: one call over a `Mesh` of
devices returns the whole result, and XLA inserts the collectives.  The
port runs PyTorch's own idiom instead: **one process a rank, one device a
rank** (a ``torchrun --nproc_per_node=N`` launch, as DDP runs), keeping
JAX's contract: every rank calls the same function with the same
**global** inputs and gets the same **global** result back.  Why not one
process driving a list of devices, as JAX's single controller does: the
port's solvers are host loops (one device read a step), so one process
would run every card's controller in turn on one host thread, and NCCL
wants one process a device; one process a rank gives each card its own.

* `make_mesh` builds a ``torch.distributed.device_mesh.DeviceMesh`` with
  named axes over the ranks (the default process group if one is
  initialised, else torchrun's environment, else a world of one process,
  which is what JAX's `make_mesh` gives on a one-device host) and returns
  a thin `Mesh`: ``shape`` is JAX's dict, ``group(axis)``,
  ``coordinate(axis)`` and ``device`` give the rest.  ``'cuda'`` (NCCL)
  is the default; ``'cpu'`` (gloo) only when asked for.
* `sharded_independent_odeint`: each rank solves its contiguous block of
  `y0`'s rows with its own controller, and the blocks are gathered (JAX's
  ``shard_map`` block for block).
* `data_parallel_odeint`: one shared controller over the global batch
  (docs/SHARDING.md §1): each rank solves its rows, and every decision
  that reads the state reads its global value, so every rank takes the
  single-device solve's steps, stage-solve and corrector iterations and
  `Stats` (below).  It takes every registry method and event functions.
  Under autograd it gives global gradients (below).
* `shard_params`: large 2-D leaves as DTensors sharded by column over the
  model axis, the rest replicated.
* `tensor_parallel_mlp`: an `MLPField` of one hidden layer split over the
  model axis as JAX's dryrun places it (`__graft_entry__.py:73-74`): each
  rank holds W1's columns, b1's entries and W2's rows for its coordinate,
  b2 replicated, and computes the MLP with Megatron's pair of autograd
  Functions: the input enters through "copy" (forward identity, backward
  all-reduce over the model axis) and the partial product ``h @ W2_rows``
  leaves through "reduce" (forward all-reduce, backward identity), then b2
  is added.  One model all-reduce a forward evaluation and one a backward
  evaluation; on a model axis of one it is the `MLPField` bit for bit.

Global decisions.  JAX's `data_parallel_odeint` is sharding-transparent:
XLA makes every reduction over the batch global.  The port's ranks each
run the solver's host loop on their block, so each decision that reads
the state must read the global value, or the ranks part ways (on NCCL a
rank still stepping would wait for ever in the next collective).  The
reductions reach the solvers by one mechanism: `data_parallel_odeint`
sets the context variable `misc.DATA_AXIS` to a `_DataAxis` (this rank's
coordinate, and ``sum``, ``max``, ``gather`` and ``block`` over the axis)
around its call of `odeint_fn`, and every solver that decides by the
state reads it (`misc.data_axis()`; None off the mesh, where each solver
takes its own arithmetic bit for bit).  Per site:

* the error norm (``options['norm']``, which `select_initial_step` reads
  too): each leaf's mean of squares all-reduced, one all-reduce a call;
* Newton's stage solves (`fixed_grid_implicit._iterate`, the fixed-grid
  implicit methods with ``root_solver='newton'`` and the ESDIRK and FIRK
  steps of kvaerno3, kvaerno5 and radau5a): the residual's global 2-norm,
  each rank's sum of squares all-reduced with its bail-out flag, one
  all-reduce an iteration; the Jacobian and the linear solve stay the
  block's (a row-wise field's Jacobian is block-diagonal);
* Broyden's stage solves (the fixed-grid implicit default): the rank-1
  update couples the blocks, so the residuals are gathered (one
  all-gather an iteration) and the matrix, its solve and the norm are
  global, computed alike on every rank;
* the implicit Adams corrector's test (`adams._has_converged`): the max
  norm's global max, one all-reduce an iteration;
* an event function (every step's sign and every bisection point) and a
  ``grid_constructor``: called on the state gathered over the axis, one
  all-gather a call;
* SciPy (``scipy_solver``): its controller and LSODA's and BDF's
  finite-difference Jacobians read the whole flat state, so every rank
  runs the single-device SciPy solve of the global `y0` and returns its
  result, which is the global one.

A shared controller's event time is the same on every rank and comes
back as it is (a 0-d tensor).  The per-sample lanes of the batched driver
(`solvers/batched_rk.py`) keep their own decisions.

Gradients.  JAX runs one controller, so every rank calls with the same
global inputs and computes the loss from the same gathered global result.
The two wrappers differ in what a rank then receives.

* Under `sharded_independent_odeint` each rank's gradients are its own
  block's contribution (the gather's backward hands each rank the
  cotangent of its rows), as DDP's are before its all-reduce: the caller
  ``all_reduce``s them (SUM) over the axis for the global gradient, the
  port of JAX's ``shard_map`` + ``psum``.
* Under `data_parallel_odeint` every rank receives the global gradient,
  the one-device step's, counted once, and the caller all-reduces
  nothing; a parameter of a `tensor_parallel_mlp` receives the global
  gradient of its own shard.

Why that is more than autograd: a continuous-adjoint backward must take the
same steps on every rank, or a rank still stepping waits for ever in a
collective, and its error control reads vjp_t and the parameter
accumulator theta_bar, sums over the batch of which each rank's block
holds a share.  Summing the shares where the norm reads them would not
do: the controller scales each entry by ``atol + rtol * |entry|`` before
the norm sees it, and a share's scale is not the sum's (at 4 CPU ranks
that took 22 backward steps where the one-device solve takes 20).  So the
adjoint's forward keeps the data axis it ran under, and its backward
(`adjoint._backward_pass`) sums the rates of vjp_t and theta_bar over the
axis at every evaluation of the augmented field (one all-reduce of 1 + P
values, P the parameters' size), as XLA's partitioning sums them in JAX,
and the output times' effects once, so that every rank carries the
global vjp_t and theta_bar and takes the one-device solve's steps; y and
adj_y stay each rank's block under the global state norm, and a sharded
field's parameter term is its ``param_norm`` (a `tensor_parallel_mlp`'s:
one model all-reduce a norm call).  The time and parameter gradients then
come out global, and the backward of y0's rows all-gathers every rank's
cotangent block, so that every rank's y0 gradient is the whole one.

Taken under autograd: the continuous adjoint with an explicit adaptive or
fixed-grid adjoint method, through `odeint_adjoint` (default norm or
``'seminorm'``) and through plain `odeint` with an explicit adaptive
method, after any adaptive forward method (kvaerno3, kvaerno5 and
radau5a too, with an explicit ``adjoint_method``), for parameters of an
``nn.Module`` field, tensors in `args`, and closure tensors given in
``adjoint_params``.  Refused with `NotImplementedError`, from the
arguments alone, on every rank and before any collective: autograd
through a fixed-grid, Adams or implicit fixed-grid solve (autograd
differentiates its loop, which would give each rank its share),
gradients through an event solve, ``replay_grad`` and ``forward_grad``,
the interpolated adjoint, an implicit, Adams or SciPy adjoint method
(their stage systems over the augmented state couple the ranks through
theta_bar's global sum), and a callable adjoint norm (it would see one
rank's block).  Parareal's ``mesh=`` gives every rank the global gradient
too (`parareal` module docstring).
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..misc import (DATA_AXIS, is_tree_state, needs_autograd, tree_leaves,
                    tree_map)
from ..solvers import DIRECT_DIFF_KINDS, SOLVERS
from ..solvers.solution import Stats


class Mesh(NamedTuple):
    """A named mesh of ranks: ``shape`` {axis: size} in axis order (JAX's
    ``Mesh.shape``), the ``DeviceMesh`` and this rank's device."""
    shape: dict
    device_mesh: object
    device: torch.device

    def group(self, axis):
        """The process group of this rank's line along `axis`."""
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis):
        """This rank's index along `axis`, or None off the mesh."""
        coord = self.device_mesh.get_coordinate()
        if coord is None:
            return None
        return coord[list(self.shape).index(axis)]


def _init_world(device_type):
    """The default process group: an initialised one as it is, else
    torchrun's environment (``env://``), else a world of one process on a
    ``FileStore`` in a temporary directory."""
    if dist.is_initialized():
        return
    backend = 'nccl' if device_type == 'cuda' else 'gloo'
    if 'RANK' in os.environ and 'WORLD_SIZE' in os.environ:
        dist.init_process_group(backend, init_method='env://')
        return
    tmp = tempfile.mkdtemp(prefix='tde_mesh_')
    atexit.register(shutil.rmtree, tmp, True)
    dist.init_process_group(backend, rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(tmp, 'store'),
                                                 1))


def _rank_device(device_type):
    if device_type == 'cpu':
        return torch.device('cpu')
    local = int(os.environ.get('LOCAL_RANK',
                               dist.get_rank() % torch.cuda.device_count()))
    torch.cuda.set_device(local)
    return torch.device('cuda', local)


def make_mesh(axis_sizes: dict, devices=None, device_type='cuda') -> Mesh:
    """A `Mesh` from {'axis': size} (JAX `make_mesh`).  The sizes multiply
    to the number of ranks in `devices` (a list of global ranks; None: all
    of them), with -1 for one wildcard axis.  ``device_type='cuda'`` puts
    each rank on its own card with NCCL and raises without one (no fallback
    to the CPU); ``'cpu'`` runs the ranks on the CPU with gloo.  Every rank
    of the world calls it."""
    if device_type not in ('cuda', 'cpu'):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh(device_type='cuda'): no CUDA device is available; "
            "pass device_type='cpu' for a mesh of CPU ranks on gloo")
    _init_world(device_type)
    devices = (list(range(dist.get_world_size())) if devices is None
               else [int(r) for r in devices])
    names = tuple(axis_sizes)
    sizes = [int(s) for s in axis_sizes.values()]
    n = len(devices)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    from torch.distributed.device_mesh import DeviceMesh
    # the rank's card is set before the mesh, so that its communicator
    # starts there
    device = _rank_device(device_type)
    device_mesh = DeviceMesh(device_type,
                             torch.tensor(devices).reshape(sizes),
                             mesh_dim_names=names)
    return Mesh(dict(zip(names, sizes)), device_mesh, device)


def _axis(mesh, axis):
    """(group, size, this rank's coordinate) of `axis`."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh (make_mesh), got "
                        f"{type(mesh).__name__}")
    return mesh.group(axis), mesh.shape[axis], mesh.coordinate(axis)


def _block(y0, n, c, axis, device, group=None):
    """This rank's contiguous block of the leading batch axis of every leaf
    of `y0`, on its device.  With `group` (`data_parallel_odeint` under
    autograd) each leaf's backward gathers every rank's block cotangent
    over it (`_Rows`), so that each rank's gradient is the whole batch's;
    without, a rank's gradient is its own block's."""
    B = tree_leaves(y0)[0].shape[0]
    if B % n:
        raise ValueError(f"the batch ({B}) is not divisible by the mesh "
                         f"axis '{axis}' size ({n})")
    b = B // n
    if group is None:
        return tree_map(lambda x: x[c * b:(c + 1) * b].to(device), y0)
    return tree_map(lambda x: _Rows.apply(x, c * b, b, group, device), y0)


class _Rows(torch.autograd.Function):
    """Rows ``start:start + b`` of `x` on `device`; the backward gathers
    every rank's cotangent of its rows over `group`, in rank order: the
    whole batch's gradient, when each rank's rows are its own block's and
    its cotangent that block's whole (the loss is computed on every rank
    from the gathered result)."""

    @staticmethod
    def forward(ctx, x, start, b, group, device):
        ctx.group, ctx.device = group, x.device
        return x[start:start + b].to(device, copy=True)

    @staticmethod
    def backward(ctx, g):
        parts = [torch.empty_like(g)
                 for _ in range(dist.get_world_size(ctx.group))]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts).to(ctx.device), None, None, None, None


class _AllGather(torch.autograd.Function):
    """The blocks of every rank along `dim`, in rank order; the backward
    hands each rank the cotangent of its own block."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.rank = dim, dist.get_rank(group)
        ctx.size = x.shape[dim]
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def _all_gather_blocks(x, group, dim):
    """Every rank's block `x` of one tensor, concatenated along `dim`."""
    return _AllGather.apply(x, group, dim)


def _per_shard(obj, group):
    """Every rank's `obj` (a `Stats` of one shard's solve), in rank order,
    its tensors on the CPU."""
    obj = tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x,
                   tuple(obj))
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return tuple(Stats(*o) for o in out)


def _gather_out(out, group, shards):
    """The global result from this rank's, in odeint's layout: a tensor of
    two or more dimensions gathered along axis 1 (the batch axis of (T, B,
    ...), JAX's ``out_specs=P(None, axis)``), a 1-D one along axis 0 (a
    per-sample (B,) vector, such as event times); a `Stats` as every
    shard's, in rank order, with `shards`, else (one shared controller) as
    it is, and so is a 0-d tensor (an event time, the same on every
    rank); containers and None through.  Anything else (a 0-d tensor of
    per-shard solves, a `DenseSolution`) cannot be placed and raises
    `TypeError`."""
    if isinstance(out, Stats):
        return _per_shard(out, group) if shards else out
    if isinstance(out, torch.Tensor):
        if out.dim() == 0 and not shards:
            return out
        if out.dim() == 0:
            raise TypeError(
                "a 0-d tensor in the result of a sharded solve cannot be "
                "placed on the batch: odeint_fn must return odeint's layout "
                "(T, B, ...), (B,) vectors or Stats")
        return _all_gather_blocks(out, group, 1 if out.dim() >= 2 else 0)
    if isinstance(out, dict):
        return type(out)((k, _gather_out(v, group, shards))
                         for k, v in out.items())
    if isinstance(out, (tuple, list)):
        vals = [_gather_out(v, group, shards) for v in out]
        return type(out)(*vals) if hasattr(out, '_fields') else type(out)(vals)
    if out is None:
        return out
    raise TypeError(
        f"a {type(out).__name__} in the result of a sharded solve cannot be "
        "gathered: odeint_fn must return tensors in odeint's layout (T, B, "
        "...) or (B,), Stats, or containers of them")


def sharded_independent_odeint(odeint_fn, mesh: Mesh, axis: str = 'data'):
    """Wrap an odeint-like ``odeint_fn(func, y0, t, **kwargs)`` so that each
    rank solves its contiguous block of the leading batch axis of `y0` (by
    its coordinate on `axis`) on its device with its own controller, a
    stiff sample slowing only its own block (JAX `shard_map`, block for
    block: each block's steps are those of its own solve).  `odeint_fn`
    returns odeint's layout: its tensors of two or more dimensions are
    gathered along axis 1, to (T, B, ...), its 1-D ones (per-sample
    vectors, such as event times) along axis 0; a `Stats` comes back as
    every shard's, in shard order (`_gather_out`; a per-sample solve's (B,
    T, ...) is transposed by its `odeint_fn`).  A batch that the axis size
    does not divide raises `ValueError`.  Gradients: each rank's are its
    block's (module docstring)."""
    def solve(func, y0, t, **kwargs):
        group, n, c = _axis(mesh, axis)
        local = odeint_fn(func, _block(y0, n, c, axis, mesh.device), t,
                          **kwargs)
        return _gather_out(local, group, shards=True)

    return solve


def _global_norm(group, n):
    """The RMS norm over the global batch (the max of per-leaf ones for a
    pytree, as `misc.mixed_norm`): each rank's mean of squares per leaf,
    summed over `group` and divided by its `n` shards.  The shards are
    equal blocks, so this is the global mean of squares; with one shard it
    is `misc.rms_norm` bit for bit."""
    def norm(x):
        leaves = tree_leaves(x)
        ms = torch.stack([torch.mean(leaf.abs() ** 2) for leaf in leaves])
        dist.all_reduce(ms, group=group)
        rms = torch.sqrt(ms / n)
        return rms.max() if is_tree_state(x) else rms[0]
    return norm


class _DataAxis:
    """The data axis of a `data_parallel_odeint` solve as its solvers see
    it (`misc.DATA_AXIS`, module docstring): this rank's coordinate `c`
    among `n` equal blocks, and the collectives that make a decision
    global."""

    def __init__(self, group, n, c):
        self.group, self.n, self.c = group, n, c

    def sum(self, x):
        """`x` summed over the axis (one all-reduce)."""
        return _all_reduce(x, self.group)

    def max(self, x):
        """The elementwise max of `x` over the axis (one all-reduce)."""
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def gather(self, x, dim=0):
        """Every rank's `x` (one shape on all) concatenated along `dim`,
        in rank order (one all-gather)."""
        parts = [torch.empty_like(x) for _ in range(self.n)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim)

    def block(self, x, dim=0):
        """This rank's block of `x` along `dim`: the inverse of
        `gather`."""
        b = x.shape[dim] // self.n
        return x.narrow(dim, self.c * b, b)


def _explicit(method):
    """Whether `method` is an explicit adaptive or a fixed-grid one, whose
    backward solve decides by its norm alone; a name the registry does
    not know passes, for the solve to reject."""
    spec = SOLVERS.get(method)
    return spec is None or spec['kind'] == 'fixed' or (
        spec['kind'] == 'adaptive' and not spec['tableau'].implicit)


def _refuse_gradient_routes(method, options, kwargs, grad):
    """The gradient routes `data_parallel_odeint` does not take, refused
    from the arguments alone (module docstring): `grad` says whether
    autograd would record through the solve."""
    for key in ('replay_grad', 'forward_grad'):
        if options.get(key):
            raise NotImplementedError(
                f"data_parallel_odeint: {key} differentiates the solve's "
                "own steps on each rank, which would give each rank its "
                "block's share of the gradient; use the continuous adjoint "
                "(odeint_adjoint, or odeint with an adaptive method)")
    if not grad:
        return
    if SOLVERS.get(method, {}).get('kind') in DIRECT_DIFF_KINDS:
        raise NotImplementedError(
            "data_parallel_odeint: gradients through a fixed-grid, Adams or "
            "implicit fixed-grid solve come from autograd through its loop, "
            "which would give each rank its block's share; use an adaptive "
            "method under the continuous adjoint")
    if kwargs.get('event_fn') is not None:
        raise NotImplementedError(
            "data_parallel_odeint: gradients through an event solve are "
            "not taken under the mesh (the event-mode adjoint and the event "
            "time's reroute would each see one rank's block); solve it "
            "under torch.no_grad()")
    adj = dict(kwargs.get('adjoint_options') or {})
    if adj.get('interpolated'):
        raise NotImplementedError(
            "data_parallel_odeint: the interpolated adjoint is not taken "
            "under the mesh; drop adjoint_options['interpolated']")
    if callable(adj.get('norm')):
        raise NotImplementedError(
            "data_parallel_odeint: a callable adjoint norm would see one "
            "rank's block of y and adj_y; use the default norm or "
            "'seminorm'")
    adjoint_method = kwargs.get('adjoint_method') or method
    if not _explicit(adjoint_method):
        raise NotImplementedError(
            f"data_parallel_odeint: adjoint method {adjoint_method!r} solves "
            "stage systems, corrects or calls SciPy over the augmented "
            "state, whose vjp_t and theta_bar are sums over every rank's "
            "block; use an explicit adaptive adjoint method")


def data_parallel_odeint(odeint_fn, mesh: Mesh, axis: str = 'data'):
    """Wrap an odeint-like ``odeint_fn(func, y0, t, **kwargs)`` as one
    shared controller over the global batch (JAX `data_parallel_odeint`,
    docs/SHARDING.md §1): each rank solves its block of `y0`'s leading
    axis, and every decision that reads the state reads its global value
    (module docstring): the error norm (``options['norm']``) is the global
    RMS, and the stage solves, the Adams corrector, an ``event_fn`` and a
    ``grid_constructor`` reduce over `axis` through `misc.DATA_AXIS`, so
    that every rank takes the single-device solve's steps and iterations
    and its `Stats`.  ``method='scipy_solver'`` runs SciPy on the global
    state on every rank, whose result is the global one.  The result is
    gathered as `sharded_independent_odeint`'s, the `Stats` and an event
    time the same on every rank and returned as they are.  A user
    ``options['norm']`` raises `NotImplementedError` (it would see one
    block).  Under autograd every rank receives the global gradients, the
    one-device solve's; the gradient routes it does not take raise
    `NotImplementedError` (module docstring)."""
    def solve(func, y0, t, **kwargs):
        group, n, c = _axis(mesh, axis)
        method = kwargs.get('method') or 'dopri5'
        options = dict(kwargs.get('options') or {})
        if 'norm' in options:
            raise NotImplementedError(
                "data_parallel_odeint: a user options['norm'] would see one "
                "rank's block of the batch; the wrapper sets the norm to "
                "the global RMS itself (drop options['norm'], or use "
                "sharded_independent_odeint for per-block controllers)")
        from ..adjoint import _tensors_in
        if kwargs.get('adjoint_params') is not None:
            kwargs['adjoint_params'] = tuple(kwargs['adjoint_params'])
        grad = needs_autograd(func, *tree_leaves(y0), t,
                              *_tensors_in(kwargs.get('args', ())),
                              *(kwargs.get('adjoint_params') or ()))
        _refuse_gradient_routes(method, options, kwargs, grad)
        if SOLVERS.get(method, {}).get('kind') == 'scipy':
            # SciPy's controller reads the whole flat state: the global
            # solve, the same on every rank
            return odeint_fn(func, tree_map(lambda x: x.to(mesh.device), y0),
                             t, **kwargs)
        if (kwargs.get('options') is None and 'adjoint_method' in kwargs
                and kwargs.get('adjoint_options') is None):
            # the norm set below is no user option: the backward's options
            # are none, as one device infers them
            kwargs['adjoint_options'] = {}
        data = _DataAxis(group, n, c)
        options['norm'] = _global_norm(group, n)
        grid_constructor = options.get('grid_constructor')
        if grid_constructor is not None:
            options['grid_constructor'] = lambda f, y, tt: grid_constructor(
                f, tree_map(data.gather, y), tt)
        event_fn = kwargs.get('event_fn')
        if event_fn is not None:
            kwargs['event_fn'] = lambda tt, y: event_fn(
                tt, tree_map(data.gather, y))
        token = DATA_AXIS.set(data)
        try:
            local = odeint_fn(func, _block(y0, n, c, axis, mesh.device,
                                           group if grad else None), t,
                              **dict(kwargs, options=options))
        finally:
            DATA_AXIS.reset(token)
        return _gather_out(local, group, shards=False)

    return solve


def shard_params(params, mesh: Mesh, axis: str = 'model', min_size=2 ** 14):
    """Every leaf of `params` as a ``torch.distributed.tensor`` DTensor on
    the mesh (JAX `shard_params`): a 2-D leaf of at least `min_size`
    elements whose last dimension the `axis` size divides is sharded by
    column over `axis` (``Shard(1)``), every other leaf replicated.  The
    leaves are the same on every rank (rank 0's are distributed)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    names = list(mesh.shape)

    def place(leaf):
        placements = [Replicate()] * len(names)
        if (leaf.dim() == 2 and leaf.numel() >= min_size
                and leaf.shape[-1] % mesh.shape[axis] == 0):
            placements[names.index(axis)] = Shard(1)
        return distribute_tensor(leaf.detach().to(mesh.device),
                                 mesh.device_mesh, placements)

    return tree_map(place, params)


def _all_reduce(x, group):
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


class _ModelCopy(torch.autograd.Function):
    """Megatron's "copy" into a model-parallel region: the identity, whose
    backward all-reduces the cotangent over `group` (each rank holds the
    part that flowed through its shard).  Under ``torch.func.vmap`` (the
    adjoint's batched field call) it acts on the whole batched tensor."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _ModelCopy.apply(x, group), in_dims[0]


class _ModelReduce(torch.autograd.Function):
    """Megatron's "reduce" out of a model-parallel region: the all-reduce
    (SUM) over `group` of each rank's partial product, whose backward is
    the identity; under ``torch.func.vmap`` one all-reduce of the whole
    batched tensor."""

    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _ModelReduce.apply(x, group), in_dims[0]


class TensorParallelMLP(torch.nn.Module):
    """``f(t, y) = tanh(y**power @ W1 + b1) @ W2 + b2`` with its hidden
    units split over a mesh axis (module docstring; built by
    `tensor_parallel_mlp`).  Its Parameters are this rank's shards, in the
    `MLPField`'s order (weights, then biases): ``w1`` (in, H/n) columns,
    ``w2`` (H/n, out) rows, ``b1`` (H/n,), and ``b2`` (out,) whole.
    Operations and dtype promotion are `mlp_apply`'s, and the adjoint's
    augmented state is laid out as the `MLPField`'s, so on an axis of one
    it is the `MLPField` bit for bit."""

    def __init__(self, w1, w2, b1, b2, *, power, activation, group, size):
        super().__init__()
        self.w1, self.w2, self.b1, self.b2 = (
            torch.nn.Parameter(x) for x in (w1, w2, b1, b2))
        self.power, self.activation = power, activation
        self.group, self.size = group, size

    def forward(self, t, y):
        x = _ModelCopy.apply(y ** self.power if self.power != 1 else y,
                             self.group)
        dt = torch.promote_types(x.dtype, self.w1.dtype)
        x = self.activation(x.to(dt) @ self.w1.to(dt) + self.b1.to(dt))
        dt = torch.promote_types(x.dtype, self.w2.dtype)
        x = _ModelReduce.apply(x.to(dt) @ self.w2.to(dt), self.group)
        return x + self.b2.to(dt)

    def param_norm(self, th, params):
        """The adjoint's parameter term (`adjoint._make_adjoint_norm`): the
        max over leaves of each theta_bar leaf's RMS over its global
        extent, `params` the tensors they belong to.  The means of squares
        of this module's sharded leaves are summed over the axis in one
        all-reduce and divided by its size, as `_global_norm` does (equal
        shards); on an axis of one this is `misc.mixed_norm` bit for bit."""
        sharded = {id(p) for p in (self.w1, self.w2, self.b1)}
        split = ([], [])
        for x, p in zip(th, params):
            split[id(p) in sharded].append(torch.mean(x.abs() ** 2))
        ms = [torch.stack(m) for m in split if m]
        if split[1]:
            dist.all_reduce(ms[-1], group=self.group)
            ms[-1] = ms[-1] / self.size
        # a max, so the leaves' order does not change its value
        return torch.sqrt(torch.cat(ms)).max()

    def gather(self, leaves=None):
        """`leaves` shaped as this module's parameters and in their order
        (default: the parameters; their ``.grad`` for the gradients)
        gathered over the axis: the full ``[W1, W2, b1, b2]``, the order of
        an `MLPField`'s ``parameters()``."""
        leaves = list(self.parameters()) if leaves is None else list(leaves)
        out = []
        for x, dim in zip(leaves, (1, 0, 0, None)):
            if dim is None:
                out.append(x.detach().clone())
                continue
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x.detach().contiguous(), group=self.group)
            out.append(torch.cat(parts, dim))
        return out

    def full_field(self):
        """The whole field as an `MLPField` on this rank's device, its
        parameters gathered over the axis."""
        from ..models.neural_ode import MLPField
        w1, w2, b1, b2 = self.gather()
        field = MLPField([w1.shape[0], w1.shape[1], w2.shape[1]],
                         power=self.power, dtype=w1.dtype, device=w1.device,
                         generator=torch.Generator(),  # overwritten below
                         activation=self.activation)
        with torch.no_grad():
            for p, x in zip((*field.weights, *field.biases),
                            (w1, w2, b1, b2)):
                p.copy_(x)
        return field


def tensor_parallel_mlp(field, mesh: Mesh, axis: str = 'model', *,
                        power=None, activation=None):
    """`field` with its hidden units split over the mesh axis `axis` (the
    port of ``jax.device_put(params, p_specs)`` and XLA's partitioning of
    the spiral field in `__graft_entry__.py`'s dryrun): a
    `TensorParallelMLP` holding this rank's shards, W1 column-split
    (``P(None, axis)``), b1 split (``P(axis)``), W2 row-split
    (``P(axis, None)``), b2 replicated, on the rank's device.

    `field` is an `MLPField` of one hidden layer, or its JAX-layout
    parameters ``[{'w', 'b'}, {'w', 'b'}]`` (tensors, or the DTensors of
    `shard_params`: a leaf already placed as wanted gives its
    ``to_local()``, any other its ``full_tensor()``'s block), with
    `power` (default 1) and `activation` (default tanh).  Every rank of
    the axis calls it with the same values.  Another depth raises
    `NotImplementedError`; a hidden width the axis size does not divide,
    `ValueError`."""
    from ..models.neural_ode import MLPField
    if isinstance(field, MLPField):
        layers = [dict(w=w, b=b) for w, b in zip(field.weights,
                                                 field.biases)]
        power, activation = field.power, field.activation
    else:
        layers = list(field)
        power = 1 if power is None else power
        activation = torch.tanh if activation is None else activation
    if len(layers) != 2:
        raise NotImplementedError(
            f"tensor_parallel_mlp: an MLP of {len(layers)} layers; only one "
            "hidden layer (two weight matrices) is split so far")
    group, n, c = _axis(mesh, axis)
    H = layers[0]['w'].shape[1]
    if H % n:
        raise ValueError(f"the hidden width ({H}) is not divisible by the "
                         f"mesh axis '{axis}' size ({n})")
    from torch.distributed.tensor import DTensor, Replicate, Shard
    names = list(mesh.shape)

    def local(leaf, dim):
        if isinstance(leaf, DTensor):
            want = [Replicate()] * len(names)
            if dim is not None:
                want[names.index(axis)] = Shard(dim)
            if list(leaf.placements) == want:
                return leaf.to_local().detach().clone().to(mesh.device)
            leaf = leaf.full_tensor()
        leaf = leaf.detach()
        if dim is not None:
            h = leaf.shape[dim] // n
            leaf = leaf.narrow(dim, c * h, h)
        return leaf.clone().to(mesh.device)

    return TensorParallelMLP(
        local(layers[0]['w'], 1), local(layers[1]['w'], 0),
        local(layers[0]['b'], 0), local(layers[1]['b'], None),
        power=power, activation=activation, group=group, size=n)


__all__ = ['Mesh', 'make_mesh', 'data_parallel_odeint',
           'sharded_independent_odeint', 'shard_params',
           'tensor_parallel_mlp', 'TensorParallelMLP']
