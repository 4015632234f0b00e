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
  Under autograd it gives global gradients on every route but an
  implicit or Adams adjoint method with a `tensor_parallel_mlp` field
  (below).
* `shard_params`: large 2-D leaves as DTensors sharded by column over the
  model axis, the rest replicated.
* `tensor_parallel_mlp`: an `MLPField` of any depth split over the model
  axis in Megatron's pairs, as JAX's dryrun places one hidden layer
  (`__graft_entry__.py:73-74`): layer 2k's W by column and b by entry,
  layer 2k+1's W by row and b replicated, an odd last layer replicated
  whole (JAX's `shard_params` leaves it whole under `min_size`).  Each
  pair is computed with Megatron's pair of autograd Functions: the input
  enters through "copy" (forward identity, backward all-reduce over the
  model axis) and the partial product ``h @ W_rows`` leaves through
  "reduce" (forward all-reduce, backward identity), then the bias is
  added.  One model all-reduce a pair a forward evaluation and one a
  backward evaluation; on a model axis of one it is the `MLPField` bit
  for bit.

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
  block's (a row-wise field's Jacobian is block-diagonal).  In an
  implicit adjoint method's backward (below) the replicated rows' increment
  takes one all-reduce more an iteration;
* Broyden's stage solves (the fixed-grid implicit default): the rank-1
  update couples the blocks, so the residuals are gathered (one
  all-gather an iteration) and the matrix, its solve and the norm are
  global, computed alike on every rank;
* the implicit Adams corrector's test (`adams._has_converged`): the max
  norm's global max, one all-reduce an iteration (the backward's
  replicated entries are equal on every rank, so their max is their
  value);
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

The continuous adjoint (explicit adaptive or fixed-grid adjoint method,
default norm or ``'seminorm'``) is more than autograd: a
continuous-adjoint backward must take the same steps on every rank, or a
rank still stepping waits for ever in a collective, and its error control
reads vjp_t and the parameter accumulator theta_bar, sums over the batch
of which each rank's block holds a share.  Summing the shares where the
norm reads them would not do: the controller scales each entry by ``atol
+ rtol * |entry|`` before the norm sees it, and a share's scale is not
the sum's (at 4 CPU ranks that took 22 backward steps where the
one-device solve takes 20).  So the adjoint's forward keeps the data axis
it ran under, and its backward (`adjoint._backward_pass`) sums the rates
of vjp_t and theta_bar over the axis at every evaluation of the augmented
field (one all-reduce of 1 + P values, P the parameters' size), as XLA's
partitioning sums them in JAX, and the output times' effects once, so
that every rank carries the global vjp_t and theta_bar and takes the
one-device solve's steps; y and adj_y stay each rank's block under the
global state norm, and a sharded field's parameter term is its
``param_norm`` (a `tensor_parallel_mlp`'s: one model all-reduce a norm
call).  The time and parameter gradients then come out global, and the
backward of y0's rows all-gathers every rank's cotangent block, so that
every rank's y0 gradient is the whole one.

Where a replicated value and a block meet (every other gradient route).
Autograd differentiates each rank's own loop, whose backward gives each
rank its block's share of every replicated input's gradient, and a
replicated value computed from the blocks must see every block.  The
port takes Megatron's pair, as `_ModelCopy` and `_ModelReduce` work on
the model axis, onto the data axis, three autograd Functions with a
forward-mode rule and a ``torch.func.vmap`` rule each:

* `_DataCopy`, a replicated value read by a block: the identity, whose
  backward all-reduces (SUM) the cotangents, forward mode the identity;
* `_DataReduce`, a block's shares summed into a replicated value: the
  all-reduce, whose backward is the identity and whose forward mode
  all-reduces the tangents (the error norm's means, so that
  ``forward_grad``'s step sizes carry the global tangent: a plain
  all-reduce of a tensor inside ``torch.func.jvp`` drops it);
* `_DataGather`, a block gathered into a replicated whole: the
  all-gather, whose backward hands each rank its block's cotangent and
  whose forward mode all-gathers the tangents (the results, an event
  function's state).

`_DataAxis.sum` and `gather` take them only when a graph or a tangent is
live, and their plain collectives otherwise, bit for bit with the
forward before them.  The replicated inputs of a solve a rank
differentiates through its own loop (`odeint`'s fixed-grid, Adams and
implicit fixed-grid routes and ``replay_grad``: `odeint._block_inputs`)
pass through ONE `_DataCopy` at its entry: an ``nn.Module`` field's
parameters (swapped in by ``torch.func.functional_call``), the tensors in
`args` and a tensor `t`, with y0's rows passed through it, so that the
backward's data collectives form one chain -- the copy's all-reduce of
the concatenated cotangents, then the rows' all-gather, which waits for
it -- and no two autograd threads can issue them in another order on
another rank (NCCL would hang).  Per route:

* autograd through each rank's loop: the implicit stage solves'
  implicit-function backward (`_IFT`) solves with the block's own
  Jacobian (a row-wise field's stage Jacobian is block-diagonal;
  Broyden's global matrix is the forward's alone);
* ``replay_grad``: the recording runs under the global norm, the replay
  is the loop's autograd; an event's Newton correction reads the event
  function through `_DataGather`, and each block reads the event time
  (and the bisection point whose derivative the correction takes)
  through `_DataCopy`;
* an event solve under autograd (the event-mode adjoint) and the event
  time's reroute (`events._ImplicitFnGradientRerouting`): the event
  function gathers the state through `_DataGather`, and the reroute's
  two inner products over the state, the blocks' shares, are summed over
  the axis before the replicated shares are added, each counted once;
* the interpolated adjoint: its reduced backward sums vjp_t's and
  theta_bar's rates as the standard one does, on the forward's global
  steps;
* a callable adjoint norm sees the global augmented state: y and adj_y
  gathered (one all-gather a call), vjp_t and theta_bar global already;
* a SciPy adjoint method: as the forward SciPy route, every rank runs
  the one-device backward on the gathered ys and cotangents and keeps its
  rows of adj_y.

An implicit or Adams adjoint method (kvaerno3, kvaerno5, radau5a, the
fixed-grid implicit methods, the Adams kind) runs its stage solves and
corrector over the augmented state ``[vjp_t | y | adj_y | theta_bar]``,
whose y and adj_y are this rank's block and whose vjp_t and theta_bar are
replicated, global sums.  The augmented field never reads vjp_t or
theta_bar, and it is row-wise in the batch, so the stage Jacobian of any
stage system over this state (one stage, or a FIRK's stacked stages) is
block-triangular when each stage's rows are ordered (block, replicated):
the blocks' rows block-diagonal over the ranks, the replicated rows the
identity on their own columns and, on the blocks' columns, a sum over
every rank.  So `_backward_pass` sets `misc.DATA_AXIS` around each
reverse solve to an `_AugmentedAxis`, which knows which entries of a
stage vector are the block and which replicated, and:

* Newton solves the block rows rank by rank, then takes the replicated
  increment as ``-f_rep - sum_ranks J_rep,blk s_blk``, one all-reduce of
  the ranks' shares, the same on every rank; its Jacobian is taken of
  the rank's unsummed augmented field (no collective inside
  ``torch.func``), whose replicated rows are this rank's share; the
  residual's norm all-reduces the blocks' sums of squares with the
  bail-out flag and adds the replicated part after.  Two all-reduces an
  iteration beside the field's own;
* Broyden gathers its residual as the blocks rank-major, then the
  replicated entries once (one all-gather an iteration): a permutation of
  the single device's vector, so the iterates from the identity are
  unchanged, and the matrix, its solve and its norm are global;
* the Adams corrector's test takes its global max (one all-reduce an
  iteration).

Explicit adjoint methods keep the backward above, collective for
collective.

Refused with `NotImplementedError`, from the arguments alone, on every
rank and before any collective (`adjoint.adjoint_solve`): an implicit or
Adams adjoint method with a field whose parameters are sharded over a
model axis (a ``param_norm``: a `tensor_parallel_mlp`), whose theta_bar is
another shard on each model rank, so that Newton's norm and the
corrector's max would have to reduce over the model axis too.  A tensor
that a closure field captures, which no wrapper sees, gets its rank's
share on the routes that differentiate a rank's loop (C25): give it in
`args`, or to `odeint_adjoint` in ``adjoint_params``.  Parareal's
``mesh=`` gives every rank the global gradient too (`parareal` module
docstring).
"""
from __future__ import annotations

import atexit
import functools
import os
import shutil
import tempfile
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..adjoint import _replace_tensors, _tensors_in
from ..misc import (DATA_AXIS, carries_derivative, is_tree_state,
                    needs_autograd, tree_leaves, tree_map)
from ..solvers import SOLVERS, needs_jacobian
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
    from the gathered result).  Forward mode takes the tangent's rows."""

    @staticmethod
    def forward(x, start, b, group, device):
        return x[start:start + b].to(device, copy=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.start, ctx.b, ctx.group, ctx.out_device = inputs
        ctx.device = x.device

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, 0).to(ctx.device), None, None, None, None

    @staticmethod
    def jvp(ctx, x_t, *_):
        return x_t[ctx.start:ctx.start + ctx.b].to(ctx.out_device, copy=True)

    @staticmethod
    def vmap(info, in_dims, x, start, b, group, device):
        x = x.movedim(in_dims[0], 0)
        return x[:, start:start + b].to(device, copy=True), 0


def _gather(x, group, dim):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


class _DataCopy(torch.autograd.Function):
    """Megatron's "copy" on the data axis (module docstring): the identity
    on every tensor of `xs`, whose backward all-reduces (SUM) the
    cotangents of the replicated ones over `group` -- each rank's is its
    block's share -- in ONE all-reduce of their concatenation on `device`;
    the first `n_blocks` of `xs` are blocks of the batch (y0's rows), whose
    cotangents pass through, so that the backward of their rows (`_Rows`)
    waits for this one.  Forward mode is the identity."""

    @staticmethod
    def forward(group, device, n_blocks, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.device, ctx.n_blocks = inputs[:3]

    @staticmethod
    def backward(ctx, *gs):
        blocks, rep = gs[:ctx.n_blocks], gs[ctx.n_blocks:]
        if rep:
            dt = functools.reduce(torch.promote_types, [g.dtype for g in rep])
            flat = torch.cat([g.reshape(-1).to(ctx.device, dt) for g in rep])
            dist.all_reduce(flat, group=ctx.group)
            rep = [part.view(g.shape).to(g.device, g.dtype) for part, g in
                   zip(torch.split(flat, [g.numel() for g in rep]), rep)]
        return (None, None, None, *blocks, *rep)

    @staticmethod
    def jvp(ctx, *tangents):
        return tuple(tangents[3:])

    @staticmethod
    def vmap(info, in_dims, group, device, n_blocks, *xs):
        return (_DataCopy.apply(group, device, n_blocks, *xs),
                tuple(in_dims[3:]))


class _DataReduce(torch.autograd.Function):
    """Megatron's "reduce" on the data axis: the all-reduce (SUM) of each
    rank's share of a replicated value, whose backward is the identity
    (the value's cotangent is already whole on every rank) and whose
    forward-mode derivative all-reduces the tangents."""

    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def jvp(ctx, x_t, group_t):
        # through the Function again: a tangent may be a torch.func
        # wrapper, which a collective cannot read
        return _DataReduce.apply(x_t, ctx.group)

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _DataReduce.apply(x, group), in_dims[0]


class _DataGather(torch.autograd.Function):
    """Every rank's block of one tensor along `dim`, in rank order (one
    all-gather); the backward hands each rank the cotangent of its own
    block, and forward mode all-gathers the tangents."""

    @staticmethod
    def forward(x, group, dim):
        return _gather(x, group, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.group, ctx.dim = inputs
        ctx.rank, ctx.size = dist.get_rank(ctx.group), x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None

    @staticmethod
    def jvp(ctx, x_t, group_t, dim_t):
        return _DataGather.apply(x_t, ctx.group, ctx.dim)

    @staticmethod
    def vmap(info, in_dims, x, group, dim):
        if in_dims[0] is None:
            return _DataGather.apply(x, group, dim), None
        x = x.movedim(in_dims[0], 0)
        return _DataGather.apply(x, group, dim + 1 if dim >= 0 else dim), 0


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
        return _DataGather.apply(out, group, 1 if out.dim() >= 2 else 0)
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


def _global_norm(data):
    """The RMS norm over the global batch (the max of per-leaf ones for a
    pytree, as `misc.mixed_norm`): each rank's mean of squares per leaf,
    summed over the data axis (`_DataAxis.sum`, which carries
    ``forward_grad``'s tangents) and divided by its `n` shards.  The shards
    are equal blocks, so this is the global mean of squares; with one
    shard it is `misc.rms_norm` bit for bit."""
    def norm(x):
        leaves = tree_leaves(x)
        ms = torch.stack([torch.mean(leaf.abs() ** 2) for leaf in leaves])
        rms = torch.sqrt(data.sum(ms) / data.n)
        return rms.max() if is_tree_state(x) else rms[0]
    return norm


class _Swapped:
    """An ``nn.Module`` field called with `params` in place of its own
    (``torch.func.functional_call``); its other attributes (a field's
    callbacks) are the module's."""

    def __init__(self, module, params):
        self.module, self.params = module, params

    def __call__(self, *args, **kwargs):
        return torch.func.functional_call(self.module, self.params, args,
                                          kwargs)

    def __getattr__(self, name):
        return getattr(self.module, name)


class _DataAxis:
    """The data axis of a `data_parallel_odeint` solve as its solvers see
    it (`misc.DATA_AXIS`, module docstring): this rank's coordinate `c`
    among `n` equal blocks on `device`, the collectives that make a
    decision global, and the autograd Functions where a replicated value
    and a block meet.  `sum` and `gather` take their Function only when
    `x` carries a graph or a tangent, and their plain collective
    otherwise."""

    def __init__(self, group, n, c, device):
        self.group, self.n, self.c, self.device = group, n, c, device

    def sum(self, x):
        """`x` summed over the axis (one all-reduce; `_DataReduce`)."""
        if carries_derivative(x):
            return _DataReduce.apply(x, self.group)
        return _all_reduce(x, self.group)

    def max(self, x):
        """The elementwise max of `x` over the axis (one all-reduce), a
        decision: no derivative."""
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def gather(self, x, dim=0):
        """Every rank's `x` (one shape on all) concatenated along `dim`,
        in rank order (one all-gather; `_DataGather`)."""
        if carries_derivative(x):
            return _DataGather.apply(x, self.group, dim)
        return _gather(x, self.group, dim)

    def block(self, x, dim=0):
        """This rank's block of `x` along `dim`: the inverse of
        `gather`."""
        b = x.shape[dim] // self.n
        return x.narrow(dim, self.c * b, b)

    def parts(self, m, device):
        """The layout of a stage vector of `m` entries: None, every entry
        this rank's block (`_AugmentedAxis` says otherwise)."""
        return None

    def augmented(self, period, lo, hi):
        """This axis as an implicit or Adams adjoint method's backward
        sees the augmented state (`_AugmentedAxis`)."""
        return _AugmentedAxis(self, period, lo, hi)

    def copy(self, x):
        """A replicated tensor `x` as this rank's block reads it
        (`_DataCopy`)."""
        if not carries_derivative(x):
            return x
        return _DataCopy.apply(self.group, self.device, 0, x)[0]

    def copy_inputs(self, func, y0, t, args):
        """The inputs of a solve that autograd differentiates through this
        rank's loop, every replicated one through ONE `_DataCopy` (module
        docstring): the parameters of an ``nn.Module`` `func` that require
        grad (swapped in by ``torch.func.functional_call``), and the
        tensors in `args` and a tensor `t` that carry a derivative; y0's
        leaves, this rank's rows, pass through it.  Returns (func, y0, t,
        args)."""
        named = ([(k, p) for k, p in func.named_parameters()
                  if p.requires_grad]
                 if isinstance(func, torch.nn.Module) else [])
        blocks = [x for x in tree_leaves(y0) if carries_derivative(x)]
        seen, rep = {id(x) for x in blocks}, []
        for x in ([p for _, p in named] + _tensors_in(args)
                  + ([t] if isinstance(t, torch.Tensor) else [])):
            if carries_derivative(x) and id(x) not in seen:
                seen.add(id(x))
                rep.append(x)
        if not rep:
            return func, y0, t, args
        out = _DataCopy.apply(self.group, self.device, len(blocks), *blocks,
                              *rep)
        subs = {id(x): o for x, o in zip(blocks + rep, out)}
        if named:
            func = _Swapped(func, {k: subs[id(p)] for k, p in named})
        return (func, tree_map(lambda x: subs.get(id(x), x), y0),
                subs.get(id(t), t), _replace_tensors(args, subs))

    @staticmethod
    def check_adjoint_method(adjoint_method, func):
        """The gradient route `data_parallel_odeint` does not take, refused
        from the arguments alone before any collective (module docstring):
        an implicit or Adams adjoint method with a field whose parameters
        are sharded over a model axis (a ``param_norm``: a
        `tensor_parallel_mlp`), whose theta_bar is another shard on each
        model rank."""
        spec = SOLVERS.get(adjoint_method)
        if (spec is not None and (spec['kind'] == 'adams'
                                  or needs_jacobian(adjoint_method))
                and getattr(func, 'param_norm', None) is not None):
            raise NotImplementedError(
                f"data_parallel_odeint: adjoint method {adjoint_method!r} "
                "with a field whose parameters are sharded over a model "
                "axis (tensor_parallel_mlp): its theta_bar differs from "
                "model rank to model rank, so the stage solves' norm and "
                "the corrector's max would have to reduce over the model "
                "axis too; use an explicit adaptive, fixed-grid or SciPy "
                "adjoint method")


class _AugmentedAxis(_DataAxis):
    """The data axis as an implicit or Adams adjoint method's backward sees
    it (`adjoint._backward_pass`, module docstring): the augmented state
    ``[vjp_t | y | adj_y | theta_bar]``, `period` entries, holds this
    rank's block of the batch at ``[lo, hi)`` (y and adj_y; adj_y alone
    under the interpolated adjoint) and replicated values elsewhere
    (vjp_t and theta_bar, global sums, the same on every rank).  A stage
    vector is such states end to end: a FIRK's stacked stages, a complex
    state's real and imaginary parts.  While `local` (a stage Jacobian,
    `local_jacobian`) `sum` is the identity: the augmented field is then
    this rank's own, its replicated rows this rank's share."""

    def __init__(self, data, period, lo, hi):
        super().__init__(data.group, data.n, data.c, data.device)
        self.period, self.lo, self.hi = period, lo, hi
        self.local = False
        self._parts = {}

    def sum(self, x):
        return x if self.local else super().sum(x)

    def parts(self, m, device):
        """(block, replicated) index tensors of a stage vector of `m`
        entries on `device`."""
        key = (m, str(device))
        if key not in self._parts:
            if m % self.period:
                raise ValueError(f"a stage vector of {m} entries is not "
                                 f"augmented states of {self.period}")
            mask = torch.zeros(self.period, dtype=torch.bool)
            mask[self.lo:self.hi] = True
            mask = mask.repeat(m // self.period)
            self._parts[key] = tuple(torch.nonzero(w).reshape(-1).to(device)
                                     for w in (mask, ~mask))
        return self._parts[key]

    def local_jacobian(self, jacobian):
        """`jacobian(fn, x)` taken of this rank's unsummed augmented field:
        no collective inside ``torch.func``'s transforms."""
        def local(fn, x):
            self.local = True
            try:
                return jacobian(fn, x)
            finally:
                self.local = False
        return local


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
    one-device solve's; the gradient route it does not take raises
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
        if kwargs.get('adjoint_params') is not None:
            kwargs['adjoint_params'] = tuple(kwargs['adjoint_params'])
        grad = needs_autograd(func, *tree_leaves(y0), t,
                              *_tensors_in(kwargs.get('args', ())),
                              *(kwargs.get('adjoint_params') or ()))
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
        data = _DataAxis(group, n, c, mesh.device)
        options['norm'] = _global_norm(data)
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
    """``f(t, y) = mlp(y**power)`` with its layers split over a mesh axis
    in Megatron's pairs (module docstring; built by `tensor_parallel_mlp`).
    Its Parameters are this rank's shards in the `MLPField`'s order
    (``weights``, then ``biases``): layer 2k's W by column and b by entry,
    layer 2k+1's W by row and b whole, and an odd last layer whole.
    `split` holds each layer's ``(W's dim, b's dim)`` of the split (None:
    whole).  Operations and dtype promotion are `mlp_apply`'s, and the
    adjoint's augmented state is laid out as the `MLPField`'s, so on an
    axis of one it is the `MLPField` bit for bit."""

    def __init__(self, weights, biases, split, *, power, activation, group,
                 size):
        super().__init__()
        self.weights = torch.nn.ParameterList(weights)
        self.biases = torch.nn.ParameterList(biases)
        self.split = list(split)
        self.power, self.activation = power, activation
        self.group, self.size = group, size

    def forward(self, t, y):
        x = y ** self.power if self.power != 1 else y
        n = len(self.weights)
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            kind = self.split[i][0]
            if kind == 1:          # column-split: enter the model region
                x = _ModelCopy.apply(x, self.group)
            dt = torch.promote_types(x.dtype, w.dtype)
            if kind == 0:          # row-split: leave it, then the bias
                x = _ModelReduce.apply(x.to(dt) @ w.to(dt), self.group)
                x = x + b.to(dt)
            else:
                x = x.to(dt) @ w.to(dt) + b.to(dt)
            if i != n - 1:
                x = self.activation(x)
        return x

    def _dims(self):
        """The split dim of each parameter, in `parameters()`' order."""
        return [d for d, _ in self.split] + [d for _, d in self.split]

    def param_norm(self, th, params):
        """The adjoint's parameter term (`adjoint._make_adjoint_norm`): the
        max over leaves of each theta_bar leaf's RMS over its global
        extent, `params` the tensors they belong to.  The means of squares
        of this module's sharded leaves are summed over the axis in one
        all-reduce and divided by its size, as `_global_norm` does (equal
        shards); on an axis of one this is `misc.mixed_norm` bit for bit."""
        sharded = {id(p) for p, d in zip(self.parameters(), self._dims())
                   if d is not None}
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
        gathered over the axis: the full weights, then biases, the order of
        an `MLPField`'s ``parameters()``."""
        leaves = list(self.parameters()) if leaves is None else list(leaves)
        out = []
        for x, dim in zip(leaves, self._dims()):
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
        full = self.gather()
        ws = full[:len(self.weights)]
        field = MLPField([ws[0].shape[0]] + [w.shape[1] for w in ws],
                         power=self.power, dtype=ws[0].dtype,
                         device=ws[0].device,
                         generator=torch.Generator(),  # overwritten below
                         activation=self.activation)
        with torch.no_grad():
            for p, x in zip(field.parameters(), full):
                p.copy_(x)
        return field


def tensor_parallel_mlp(field, mesh: Mesh, axis: str = 'model', *,
                        power=None, activation=None):
    """`field` with its layers split over the mesh axis `axis` in
    Megatron's pairs (the port of ``jax.device_put(params, p_specs)`` and
    XLA's partitioning of an MLP field, `__graft_entry__.py`'s dryrun and
    JAX's `shard_params`): a `TensorParallelMLP` holding this rank's
    shards on its device.  Layer 2k is split by column (W ``P(None,
    axis)``, b ``P(axis)``) and entered through "copy"; layer 2k+1 by row
    (W ``P(axis, None)``), left through "reduce", its bias replicated and
    added after; an odd last layer stays replicated, computed whole on
    every rank from the replicated input, as JAX's `shard_params` leaves a
    leaf under its `min_size` (the spiral's output layer at any hidden
    width below 8192).  A network of one layer is replicated whole.

    `field` is an `MLPField`, or its JAX-layout parameters ``[{'w', 'b'},
    ...]`` (tensors, or the DTensors of `shard_params`: a leaf already
    placed as wanted gives its ``to_local()``, any other its
    ``full_tensor()``'s block), with `power` (default 1) and `activation`
    (default tanh).  Every rank of the axis calls it with the same values.
    A width split that the axis size does not divide raises
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
    group, n, c = _axis(mesh, axis)
    # (W's dim, b's dim) of each layer's split: column then row in pairs,
    # an odd last layer whole
    paired = len(layers) - len(layers) % 2
    split = ([(1, 0), (0, None)] * (paired // 2)
             + [(None, None)] * (len(layers) - paired))
    for i in range(0, paired, 2):
        H = layers[i]['w'].shape[1]
        if H % n:
            raise ValueError(f"the hidden width ({H}) of layer {i + 1} is "
                             f"not divisible by the mesh axis '{axis}' size "
                             f"({n})")
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
        [local(layer['w'], dw) for layer, (dw, _) in zip(layers, split)],
        [local(layer['b'], db) for layer, (_, db) in zip(layers, split)],
        split, power=power, activation=activation, group=group, size=n)


__all__ = ['Mesh', 'make_mesh', 'data_parallel_odeint',
           'sharded_independent_odeint', 'shard_params',
           'tensor_parallel_mlp', 'TensorParallelMLP']
