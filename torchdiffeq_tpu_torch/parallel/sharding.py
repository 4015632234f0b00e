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
  (docs/SHARDING.md §1): each rank solves its rows, and the error norm is
  the global one, its sums all-reduced over the axis, so every rank takes
  the same steps as the single-device solve.  Only the error norm is made
  global, so it takes the solves whose every decision is that norm's: the
  explicit adaptive and fixed-grid methods, with no event function.  A
  Newton or corrector convergence test, or an event function, would see
  one rank's block, and the ranks would part ways (on NCCL a rank still
  stepping would wait in the norm's all-reduce for ever): those raise.
* `shard_params`: large 2-D leaves as DTensors sharded by column over the
  model axis, the rest replicated.

Gradients.  Under `sharded_independent_odeint` each rank's gradients are
its own block's contribution (the gather's backward hands each rank the
cotangent of its rows), as DDP's are before its all-reduce: ``all_reduce``
them (SUM) over the axis for the global gradient, the port of JAX's
``shard_map`` + ``psum``.  `data_parallel_odeint` and Parareal's mesh are
forward-only and raise under autograd: a backward solve's norm would mix
each rank's own parameter term into the shared controller, and the ranks
would part ways.
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

from ..misc import is_tree_state, needs_autograd, tree_leaves, tree_map
from ..solvers import SOLVERS
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


def _block(y0, n, c, axis, device):
    """This rank's contiguous block of the leading batch axis of every leaf
    of `y0`, on its device."""
    B = tree_leaves(y0)[0].shape[0]
    if B % n:
        raise ValueError(f"the batch ({B}) is not divisible by the mesh "
                         f"axis '{axis}' size ({n})")
    b = B // n
    return tree_map(lambda x: x[c * b:(c + 1) * b].to(device), y0)


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
    it is; containers and None through.  Anything else (a 0-d tensor, a
    `DenseSolution`) cannot be placed and raises `TypeError`."""
    if isinstance(out, Stats):
        return _per_shard(out, group) if shards else out
    if isinstance(out, torch.Tensor):
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


def data_parallel_odeint(odeint_fn, mesh: Mesh, axis: str = 'data'):
    """Wrap an odeint-like ``odeint_fn(func, y0, t, **kwargs)`` as one
    shared controller over the global batch (JAX `data_parallel_odeint`,
    docs/SHARDING.md §1): each rank solves its block of `y0`'s leading
    axis, its error norm (``options['norm']``, which `select_initial_step`
    reads too) the global RMS all-reduced over `axis`, so that every rank
    takes the single-device solve's steps and its `Stats`.  The result is
    gathered as `sharded_independent_odeint`'s, the `Stats` the same on
    every rank and returned as it is.  Only the norm is global, so
    ``method`` must be an explicit adaptive or fixed-grid one, and an
    ``event_fn`` is refused: a stage solve's Newton test, an Adams
    corrector's, SciPy's controller or an event function would see one
    block (module docstring).  Those raise `NotImplementedError`, and so do
    a user ``options['norm']`` (it too would see one block) and a call
    under autograd."""
    def solve(func, y0, t, **kwargs):
        group, n, c = _axis(mesh, axis)
        method = kwargs.get('method') or 'dopri5'
        spec = SOLVERS.get(method)
        if spec is not None and not (spec['kind'] == 'fixed' or (
                spec['kind'] == 'adaptive'
                and not spec['tableau'].implicit)):
            raise NotImplementedError(
                f"data_parallel_odeint: method {method!r} makes decisions "
                "other than the error norm's (a stage solve's or corrector's "
                "convergence, SciPy's controller), which would see one "
                "rank's block; use an explicit adaptive or fixed-grid "
                "method, or sharded_independent_odeint for per-block "
                "controllers")
        if kwargs.get('event_fn') is not None:
            raise NotImplementedError(
                "data_parallel_odeint: an event function would see one "
                "rank's block of the batch, and the ranks would stop at "
                "different steps; use sharded_independent_odeint with a "
                "per-sample event solve")
        options = dict(kwargs.get('options') or {})
        if 'norm' in options:
            raise NotImplementedError(
                "data_parallel_odeint: a user options['norm'] would see one "
                "rank's block of the batch; the wrapper sets the norm to "
                "the global RMS itself (drop options['norm'], or use "
                "sharded_independent_odeint for per-block controllers)")
        from ..adjoint import _tensors_in
        if needs_autograd(func, *tree_leaves(y0), t,
                          *_tensors_in(kwargs.get('args', ()))):
            raise NotImplementedError(
                "data_parallel_odeint is forward-only: for gradients solve "
                "each block with sharded_independent_odeint (or per rank) "
                "and all_reduce the gradients over the axis")
        options['norm'] = _global_norm(group, n)
        local = odeint_fn(func, _block(y0, n, c, axis, mesh.device), t,
                          **dict(kwargs, options=options))
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


__all__ = ['Mesh', 'make_mesh', 'data_parallel_odeint',
           'sharded_independent_odeint', 'shard_params']
