"""Input checks, time handling, perturbation and callbacks (counterpart of
``torchdiffeq_tpu/misc.py``).

What this port carries of the JAX `check_inputs`: a single-tensor state,
kept in its own shape, or a pytree of tensors (dicts, tuples, lists and
namedtuples, nested; the port's own small flattener, `tree_flatten`, with
JAX's leaf order), flattened to one 1-D tensor with an `unravel` that
restores the structure and each leaf's dtype (JAX's ``ravel_pytree``,
``ravel_state=True``, misc.py:250-270); float16, bfloat16, float32,
float64, complex64 and complex128 states; scalar or per-leaf tolerances;
the RMS norm, the max of per-leaf RMS norms (`mixed_norm`) for a pytree, or
a user norm; forward and reversed time (integration always runs over ``t_sign * t`` with the field
conjugated by the sign), with ``time_direction`` to force the reverse;
``step_t``/``jump_t`` and a ``grid_constructor`` mapped into the internal
frame; the time dtype, the event function of an event solve, and the
``callback_*`` attributes of the field (fired on the host per executed
step, with the user's time frame and state structure).  Time stays float64
on the host, as in the reference (rk_common.py:180-182), so the JAX
package's double-word time and its arithmetic ``nextafter`` are not
needed.  A complex64 or complex128 state keeps its timelike values (times,
steps, tolerances) in its real dtype (`real_dtype`), as in JAX.
`lane_jacobian` is the implicit tiers' Jacobian of a stage residual, each
sample's own.
"""
from __future__ import annotations

import contextvars
import enum
import warnings
from collections import OrderedDict
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

# numpy scalar types of the state dtypes: host-side time and coefficient
# arithmetic is done in them, so it rounds exactly as the JAX package's
# device arithmetic in the state dtype does.  numpy has no bfloat16
# (`scalar_type` makes 0-d tensors for it); the kernels take float32 and
# float64 alone (`np_dtype`).
_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}
_SCALAR_TYPES = {**_NP_DTYPES, torch.float16: np.float16}
STATE_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64,
                torch.complex64, torch.complex128)


def np_dtype(torch_dtype):
    """The numpy scalar type of a float32/float64 torch dtype: the dtypes
    the CUDA kernels and their plain versions take."""
    try:
        return _NP_DTYPES[torch_dtype]
    except KeyError:
        raise NotImplementedError(
            f"state dtype {torch_dtype}: the kernels take float32 and "
            "float64 states") from None


def check_state_dtype(torch_dtype):
    """Refuse a state dtype the solvers do not take (JAX's `check_inputs`
    takes floating and complex leaves, misc.py:243-247)."""
    if torch_dtype not in STATE_DTYPES:
        raise NotImplementedError(
            f"state dtype {torch_dtype}: the port takes float16, bfloat16, "
            "float32, float64, complex64 and complex128 states")


def real_dtype(torch_dtype):
    """The real dtype of a state dtype: timelike values (times, steps,
    tolerances, the error ratio) of a complex state live in it (JAX
    `real_dtype`, misc.py:105-112; reference ``y0.abs().dtype``,
    rk_common.py:63)."""
    return torch_dtype.to_real() if torch_dtype.is_complex else torch_dtype


def time_effect(f, g):
    """The effect on a real loss of moving a time at which the state's
    slope is `f` and its cotangent is `g`, summed over all but the leading
    axis.

    For a complex state z = x + iy, torch's gradient of a real loss L is
    g = dL/dx + i dL/dy (the conjugate Wirtinger convention; `jax.grad`
    gives its conjugate, dL/dx - i dL/dy).  Moving the time moves z by f, so
    dL/dt = sum(dL/dx Re f + dL/dy Im f) = Re sum(conj(g) f); Re sum(g f)
    would flip the sign of the dL/dy terms.  JAX forms sum(f g_jax) =
    sum(conj(g) f), complex, carries it in the augmented state's vjp_t and
    keeps its real part only at the end (`_time_grad_cast`, adjoint.py:43-
    48).  This returns the same complex sum, so that |vjp_t|, which the
    adjoint norm reads, and with it every backward step, is JAX's; the
    caller takes the real part (`real_part`).  A real state takes the
    plain sum."""
    prod = (g.conj() * f) if g.is_complex() else g.to(f.dtype) * f
    return prod.reshape(prod.shape[0], -1).sum(1)


def real_part(x):
    """`x` as its real part: a time or real parameter's gradient carried in
    a complex augmented state, whose imaginary part is 0 (JAX
    `_time_grad_cast`, adjoint.py:43-48)."""
    return x.real if x.is_complex() else x


def _bf16_scalar(x):
    """A bfloat16 host scalar.  numpy has no bfloat16, so it is a 0-d CPU
    tensor, whose arithmetic with another rounds to bfloat16 as the JAX
    package's device arithmetic does."""
    return torch.tensor(float(x), dtype=torch.bfloat16)


def scalar_type(torch_dtype):
    """A callable that rounds a number to a host scalar of `torch_dtype`
    (float16 to float64, bfloat16 included; a complex dtype's real one),
    for timelike and ``coefficient * dt`` arithmetic in that dtype: numpy's
    scalar type, or `_bf16_scalar`.  ``float(sd(c) * dt)`` is then JAX's weakly typed
    ``float(c) * dt``: c rounded to the dtype, then the product rounded."""
    if torch_dtype == torch.bfloat16:
        return _bf16_scalar
    check_state_dtype(torch_dtype)
    return _SCALAR_TYPES[real_dtype(torch_dtype)]


def coef(c, torch_dtype):
    """The Python float `c` rounded to `torch_dtype`: JAX's weakly typed
    ``c * x`` for a tensor `x` of that dtype is ``coef(c, x.dtype) * x``
    (torch would multiply by `c` rounded to float32 for a 16-bit `x`)."""
    return float(scalar_type(torch_dtype)(c))


def smax(a, b):
    """``jnp.maximum`` of two scalars of one dtype (numpy scalars, or 0-d
    tensors: bfloat16 host scalars, or ``forward_grad``'s times and norms,
    whose derivatives it keeps): NaN propagates."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.maximum(torch.as_tensor(a), torch.as_tensor(b))
    return np.maximum(a, b)


def smin(a, b):
    """``jnp.minimum`` of two host scalars, as `smax`."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.minimum(torch.as_tensor(a), torch.as_tensor(b))
    return np.minimum(a, b)


class Perturb(enum.Enum):
    """Direction to perturb the evaluation time of the vector field
    (reference misc.py:168-171): ``NEXT``/``PREV`` move ``t`` to the
    next/previous representable float, so that fields with jump
    discontinuities are evaluated on the correct side."""
    NONE = 0
    PREV = 1
    NEXT = 2


def needs_autograd(func, *tensors):
    """Whether autograd would have to record a graph through a solve of
    `func`: grad mode is on and one of `tensors` (or a parameter of an
    ``nn.Module`` field) requires grad."""
    if not torch.is_grad_enabled():
        return False
    if isinstance(func, torch.nn.Module):
        tensors = tensors + tuple(func.parameters())
    return any(isinstance(x, torch.Tensor) and x.requires_grad
               for x in tensors)


# The data axis of the `parallel.data_parallel_odeint` solve in progress
# (`parallel.sharding._DataAxis`; the `sharding` module docstring): each
# rank holds one block of the batch, and a decision that reads the state
# reduces over the axis through it.  None off the mesh, where every solver
# takes its own arithmetic.
DATA_AXIS = contextvars.ContextVar('data_axis', default=None)


def data_axis():
    """The data axis of the solve in progress (`DATA_AXIS`), or None."""
    return DATA_AXIS.get()


def nan_sign(x):
    """`jnp.sign`: -1, 0 or 1, and NaN at NaN.  ``torch.sign`` gives 0 at
    NaN, which would make an event value that turns NaN look like no sign
    change where the JAX package sees one (and vice versa)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def rms_norm(x):
    """RMS norm over all elements (reference ``_rms_norm``, misc.py:22-23)."""
    return torch.sqrt(torch.mean(x.abs() ** 2))


def linf_norm(x):
    """The max norm (JAX `linf_norm`, misc.py:133-134)."""
    return x.abs().max()


def zero_norm(x):
    """A norm that is always 0, in float64 on `x`'s device (JAX
    `zero_norm`, misc.py:137-138): every step is accepted."""
    return x.new_zeros((), dtype=torch.float64)


def mixed_norm(tensors):
    """Max over per-leaf RMS norms of a pytree of tensors (reference
    ``_mixed_norm``, misc.py:30-33; JAX misc.py:147).  A 0-d tensor of the
    default float dtype for an empty one."""
    tensors = tree_leaves(tensors)
    if not tensors:
        return torch.zeros(())
    return torch.max(torch.stack([rms_norm(x) for x in tensors]))


_LEAF = 'leaf'     # a treedef's leaf node


def _flatten(tree, leaves):
    """The treedef of `tree`, its leaves appended to `leaves` in the order
    of ``jax.tree_util``: a dict's values by sorted key (an OrderedDict's
    in its own order), a tuple's, list's or namedtuple's in order, None no
    leaf, anything else one leaf."""
    if isinstance(tree, dict):
        keys = (list(tree) if isinstance(tree, OrderedDict)
                else sorted(tree))
        return (type(tree), tuple(keys),
                tuple(_flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, (tuple, list)):
        return (type(tree), None, tuple(_flatten(x, leaves) for x in tree))
    if tree is None:
        return (None, None, ())
    leaves.append(tree)
    return _LEAF


def tree_flatten(tree):
    """(leaves, treedef) of a pytree state (`_flatten`): the port's own
    small counterpart of ``jax.tree_util.tree_flatten`` on the containers
    a state is made of."""
    leaves = []
    return leaves, _flatten(tree, leaves)


def tree_unflatten(treedef, leaves):
    """The pytree of `treedef` with `leaves` in flattening order."""
    it = iter(leaves)

    def build(node):
        if node is _LEAF:
            return next(it)
        kind, keys, children = node
        if kind is None:
            return None
        values = [build(c) for c in children]
        if keys is not None:
            return kind(zip(keys, values))
        if hasattr(kind, '_fields'):          # a namedtuple
            return kind(*values)
        return kind(values)

    return build(treedef)


def tree_leaves(tree):
    """The leaves of `tree` in flattening order; one tensor is its own."""
    return tree_flatten(tree)[0]


def tree_map(fn, tree):
    """`tree` with `fn` applied to every leaf."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


def is_tree_state(y):
    """Whether `y` is a container state (a dict, tuple, list or
    namedtuple, nested or not), which the solvers ravel, and not one
    tensor, which they keep in its shape."""
    return isinstance(y, (tuple, list, dict))


def ravel_leaves(tree):
    """The leaves of a pytree (a field's output) as one 1-D tensor, their
    dtypes promoted to one (JAX ``ravel_pytree(f)[0]``)."""
    return torch.cat([x.reshape(-1) for x in tree_leaves(tree)])


def flatten_state(y):
    """A pytree state as one 1-D tensor and the `unravel` that restores it
    from any tensor of that layout (the leaves' dtypes promoted to one).
    JAX's ``ravel_pytree``: leaves in `tree_flatten` order, and `unravel`
    gives each leaf back in its own dtype (a real leaf of a complex state
    its real part)."""
    leaves, treedef = tree_flatten(y)
    if not leaves or not all(isinstance(x, torch.Tensor) for x in leaves):
        raise TypeError("a pytree state must hold one or more tensors, and "
                        "only tensors")
    dtype = leaves[0].dtype
    for x in leaves[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    shapes = [x.shape for x in leaves]
    sizes = [x.numel() for x in leaves]
    dtypes = [x.dtype for x in leaves]

    def unravel(flat):
        """The pytree from a tensor of the flat layout, with any leading
        axes kept on each leaf (a (T, n) solution gives (T, *shape)
        leaves).  A flat tensor in the raveled dtype gives each leaf its
        own dtype back; one a solver promoted (a fixed grid's float64
        stages of a float32 state) keeps the promoted dtype."""
        lead = tuple(flat.shape[:-1])
        own = flat.dtype == dtype
        out = []
        for part, shape, d in zip(torch.split(flat, sizes, dim=-1), shapes,
                                  dtypes):
            if part.is_complex() and not d.is_complex:
                part = part.real
            out.append((part.to(d) if own else part).reshape(
                lead + tuple(shape)))
        return tree_unflatten(treedef, out)

    flat = torch.cat([x.reshape(-1).to(dtype) for x in leaves])
    return flat, unravel


def time_sign(t):
    """+1 for increasing output times (or fewer than two), -1 for
    decreasing (JAX `time_sign`, misc.py:418)."""
    t_np = host_times(t)
    return 1.0 if t_np.shape[0] < 2 or t_np[-1] >= t_np[0] else -1.0


def carries_derivative(x):
    """Whether tensor `x` carries a reverse-mode graph or a forward-mode
    tangent (a ``torch.autograd.forward_ad`` dual, or a tensor inside a
    ``torch.func`` transform)."""
    return (x.requires_grad
            or torch._C._functorch.is_functorch_wrapped_tensor(x)
            or torch.autograd.forward_ad.unpack_dual(x).tangent is not None)


def tcast(t, dtype):
    """A time scalar in `dtype` (its real dtype for a complex one): a host
    scalar rounded by `scalar_type`, or
    a tensor time (one that carries a tangent, `adaptive_rk`'s
    ``forward_grad``) cast with its derivative."""
    if isinstance(t, torch.Tensor):
        return t.to(real_dtype(dtype))
    return scalar_type(dtype)(t)


def tval(t):
    """A time scalar as an operand of tensor arithmetic: a Python float, or
    the tensor itself, whose derivative then flows into the result."""
    return t if isinstance(t, torch.Tensor) else float(t)


def _nextafter(t, up):
    """``torch.nextafter`` one ULP up or down, with a derivative of 1 to `t`
    when it carries one (reference ``_StitchGradient``, misc.py:348-357;
    JAX `_nextafter`'s custom JVP): ``t + (n - t)`` is `n` exactly, since
    the difference of adjacent floats is exact."""
    td = t.detach()
    n = torch.nextafter(td, td + 1 if up else td - 1)
    return t + (n - td) if carries_derivative(t) else n


def nextafter_down(t):
    """The float just below `t` in its own dtype (JAX `nextafter_down`,
    misc.py:101): a tensor (the gradient stitched as `_nextafter`), a numpy
    scalar, or a Python float (float64)."""
    if isinstance(t, torch.Tensor):
        return _nextafter(t, False)
    if isinstance(t, float):
        t = np.float64(t)
    return np.nextafter(t, type(t)(-np.inf))


class _NoHostReads(torch.overrides.TorchFunctionMode):
    """Raises when a tensor is read to the host inside `lane_jacobian`: were it
    to depend on the input, autodiff would take it as a constant and return
    a Jacobian without its terms.  torch.func wraps every tensor made
    inside the transform, so a read of the time raises too."""
    _READS = (torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.numpy,
              torch.Tensor.__float__, torch.Tensor.__int__,
              torch.Tensor.__bool__, torch.Tensor.__index__)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (func in self._READS and args
                and torch._C._functorch.is_functorch_wrapped_tensor(args[0])):
            raise RuntimeError(f"{func.__name__} of a tensor inside the "
                               "field")
        return func(*args, **(kwargs or {}))


def autograd_lane_jacobian(fn, x):
    """`lane_jacobian` by ``torch.autograd.grad``, for a function that
    differentiates itself with autograd, which torch.func cannot transform
    (an implicit adjoint's augmented field whose parameters the field
    captures in a closure, where ``torch.func.functional_call`` cannot swap
    them in): every row, one basis cotangent put in every sample, in one
    batched backward (``is_grads_batched``).  The same matrix."""
    with torch.enable_grad():
        xd = x.detach().requires_grad_(True)
        out = fn(xd)
        m = out.shape[-1]
        basis = torch.eye(m, dtype=out.dtype, device=out.device)
        (g,) = torch.autograd.grad(
            out, xd, basis[:, None, :].expand((m,) + tuple(out.shape)),
            is_grads_batched=True, allow_unused=True)
    if g is None:
        return x.new_zeros(x.shape[:1] + (m, x.shape[-1]))
    return g.transpose(0, 1).detach()


def stage_jacobian(func):
    """The Jacobian route of `func`'s stage solves: the field's own
    ``lane_jacobian`` attribute (seen through `PerturbedFunc`; the implicit
    adjoint sets `autograd_lane_jacobian` there), else `lane_jacobian`."""
    return getattr(getattr(func, 'base_func', func), 'lane_jacobian',
                   lane_jacobian)


def lane_jacobian(fn, x):
    """The Jacobian of every sample of a batched ``fn: (B, m) -> (B, m)``
    whose row b depends on row b of `x` alone: (B, m, m).  Row i of every
    sample's matrix is the vjp of the cotangent e_i put in every sample,
    so one vmapped pullback gives all of them: reverse mode in block form
    (JAX takes ``jax.jacfwd`` of the flat residual, under vmap per sample:
    the same matrices to rounding, and reverse mode costs torch.func less
    host time a call).  The field inside `fn` must be one that torch.func
    can transform: tensor operations on the state and the time, with no
    host read of a tensor (``.item()``, ``float()``, ``bool()``; a branch
    on the time is ``torch.where``) and no in-place update of a tensor it
    captures.  One that is not raises here, naming that requirement,
    instead of giving a Jacobian with terms missing (such a field may
    name its own route, `stage_jacobian`)."""
    try:
        with _NoHostReads():
            out, pullback = torch.func.vjp(fn, x)
            m = out.shape[-1]
            basis = torch.eye(m, dtype=out.dtype, device=out.device)
            rows = torch.func.vmap(
                lambda e: pullback(e.expand_as(out))[0])(basis)
            return rows.transpose(0, 1)
    except RuntimeError as err:
        raise RuntimeError(
            "the implicit solvers take the field's Jacobian in reverse mode "
            "with torch.func, as torch.func.jacrev does (Newton's method, "
            "and the implicit-function gradient of a stage solve), which "
            f"cannot transform this field: {err}.  The "
            "field must use tensor operations on the state and the time, "
            "with no .item(), .tolist(), float(), bool() or numpy of a "
            "tensor (branch with torch.where), and no in-place update of a "
            "tensor it captures") from err


# the callback attributes of a field (reference misc.py:313-343) and the
# ones each solver kind fires (reference `valid_callbacks`,
# solvers.py:24-26,81-83, rk_common.py:207-211; JAX misc.py:28-42)
CALLBACK_NAMES = ('callback_step', 'callback_accept_step',
                  'callback_reject_step')
_VALID_CALLBACKS = {
    'adaptive': set(CALLBACK_NAMES),
    **{kind: {'callback_step'} for kind in ('fixed', 'adams', 'firk', 'dirk')},
}


def solver_callbacks(func, method, solvers, t_sign, unravel):
    """The callbacks of `func` the solver of `method` fires, each wrapped
    by `_user_frame_callback` (JAX misc.py:360-395): per executed step, in
    the user's frame; one the solver kind does not fire is warned about and
    dropped (the `_adjoint` ones are read from `func` by the adjoint).
    Returns {name: fire}."""
    fired = {name for name in CALLBACK_NAMES
             if getattr(func, name, None) is not None}
    invalid = fired - _VALID_CALLBACKS.get(solvers[method].get('kind'), set())
    if invalid:
        warnings.warn("Solver '{}' does not support callbacks {}".format(
            method, sorted(invalid)))
    return {name: _user_frame_callback(getattr(func, name), t_sign, unravel)
            for name in sorted(fired - invalid)}


def _user_frame_callback(cb, t_sign, unravel):
    """A callback of the internal frame that hands `cb` the user's time (a
    0-d float64 CPU tensor, negated back for reversed time), the state in
    the user's structure and the step size (a 0-d float64 CPU tensor), as
    JAX's `fire` does (misc.py:360-380)."""
    def fire(t0, y0, dt):
        cb(torch.tensor(t_sign * float(t0), dtype=torch.float64),
           y0 if unravel is None else unravel(y0),
           torch.tensor(float(dt), dtype=torch.float64))
    return fire


class PerturbedFunc:
    """Wraps a vector field with `perturb` support and the time sign
    (``_PerturbFunc``, reference misc.py:174-197): the evaluation time is
    cast to the state's real dtype (a complex time cut to its real part, JAX
    misc.py:446-451), optionally nudged by one ULP with
    ``torch.nextafter``, then mapped back to the user's time frame.  The
    field gets its time as a 0-d CPU tensor, which mixes with state on any
    device.  `check_inputs` sets the callbacks the solver fires as its
    attributes."""

    def __init__(self, base_func, t_sign=1.0):
        self.base_func = base_func
        self.t_sign = t_sign

    def __call__(self, t, y, perturb=Perturb.NONE):
        if not isinstance(perturb, Perturb):
            raise TypeError("perturb argument must be of type Perturb enum")
        dtype = real_dtype(y.dtype)
        if isinstance(t, torch.Tensor):
            t = (t.real if t.is_complex() else t).to(dtype)
        else:
            t = torch.as_tensor(t, dtype=dtype)
        if perturb is not Perturb.NONE:
            t = _nextafter(t, perturb is Perturb.NEXT)
        if self.t_sign < 0:
            return -self.base_func(-t, y)
        return self.base_func(t, y)


class NormalisedProblem(NamedTuple):
    func: Callable        # PerturbedFunc in the internal (increasing) frame
    y0: torch.Tensor      # the state, or a pytree state flattened to 1-D
    t: np.ndarray         # (T,) increasing host times, float64
    rtol: Any             # float, or a per-element tensor (per leaf)
    atol: Any
    method: str
    options: dict
    event_fn: Any         # combined event fn of internal time, or None
    t_sign: float         # +1/-1: t_internal = t_sign * t_user
    norm: Callable
    unravel: Any = None   # flat -> the user's pytree; None for one tensor


def _leaf_tol(name, tol, state, leaves, like):
    """A scalar tolerance as a float; a per-leaf one as one per-element
    tensor in the state's dtype and device (JAX `_tree_tol`,
    misc.py:155-172): a flat sequence in the leaves' order of the `state`
    (JAX's form), or a tree of the state's own structure."""
    if is_tree_state(tol):
        tol, treedef = tree_flatten(tol)
        flat = treedef[0] in (tuple, list) and all(
            c is _LEAF for c in treedef[2])
        if not flat and treedef != tree_flatten(state)[1]:
            raise ValueError(f"per-leaf {name} given as a tree must have "
                             "the state's structure")
    elif _is_scalar(tol):
        return float(tol)
    tol = list(tol)
    if len(tol) != len(leaves):
        raise ValueError(
            f"If using per-leaf {name} it must have the same length as the "
            f"state pytree leaves ({len(leaves)}), got {len(tol)}.")
    return torch.cat([torch.full((x.numel(),), float(v), dtype=like.dtype,
                                 device=like.device)
                      for v, x in zip(tol, leaves)])


def host_times(t):
    """Output times as a 1-D float64 numpy array (one device read; by
    `tolist`, which reads a tensor inside a ``torch.func`` transform too)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to('cpu', torch.float64).tolist()
    t = np.asarray(t, dtype=np.float64)
    if t.ndim != 1:
        raise ValueError("t must be one dimensional")
    return t


def _check_monotonic(t_np):
    """Strict monotonicity (reference `_check_timelike`, misc.py:376-383)."""
    if t_np.shape[0] > 1:
        diff = np.diff(t_np)
        if not (np.all(diff > 0) or np.all(diff < 0)):
            raise ValueError("t must be strictly increasing or decreasing")


def _is_scalar(x):
    return np.ndim(x) == 0


def time_tensor(t, y):
    """Time for an event function: a 0-d float64 tensor on `y`'s device (the
    JAX package hands event functions its float64 time)."""
    if isinstance(t, torch.Tensor):
        return t
    return torch.full((), float(t), dtype=torch.float64, device=y.device)


def check_inputs(func, y0, t, rtol, atol, method, options, event_fn, solvers,
                 args=(), time_direction='auto'):
    """Normalise user inputs to solver form (the JAX ``check_inputs``,
    torchdiffeq_tpu/misc.py:212-402, on the parts this slice carries).

    A pytree state is flattened to one 1-D tensor; the field then sees the
    pytree and its output is flattened (JAX's ``ravel_state=True``).  With
    `event_fn`, `t` must hold two times, and the problem's event function
    takes the internal time: it hands the user's function the user's time
    (negated back when time is reversed) and the user's state, and combines
    its outputs through `events.combine_event_functions`.
    ``time_direction='reverse'`` integrates backwards whatever the order of
    `t` (the adjoint's backward solves).
    """
    from .events import combine_event_functions  # events imports this module

    if event_fn is not None and host_times(t).shape[0] != 2:
        raise ValueError("We require len(t) == 2 when in event handling "
                         f"mode, but got len(t)={host_times(t).shape[0]}.")
    unravel = None
    state = y0
    if is_tree_state(y0):
        leaves = tree_leaves(y0)
        y0, unravel = flatten_state(y0)
    elif isinstance(y0, torch.Tensor):
        leaves = (y0,)
    else:
        raise TypeError("y0 must be a torch.Tensor or a pytree (dict, "
                        "tuple, list or namedtuple) of tensors")
    for leaf in leaves:
        if not (leaf.is_floating_point() or leaf.is_complex()):
            raise TypeError(f"y0 must be floating point, got {leaf.dtype}")
    check_state_dtype(y0.dtype)
    rtol = _leaf_tol('rtol', rtol, state, leaves, y0)
    atol = _leaf_tol('atol', atol, state, leaves, y0)

    options = {} if options is None else dict(options)
    if method is None:
        method = 'dopri5'
    if method not in solvers:
        raise ValueError('Invalid method "{}". Must be one of {}'.format(
            method, '{"' + '", "'.join(solvers.keys()) + '"}.'))

    user_norm = options.pop('norm', None)
    if user_norm is None:
        norm = rms_norm if unravel is None else (
            lambda x: mixed_norm(unravel(x)))
    else:
        norm = user_norm if unravel is None else (
            lambda x: user_norm(unravel(x)))

    tdt = options.pop('dtype', None)
    if tdt is not None and tdt not in (torch.float64, np.float64):
        raise NotImplementedError(
            f"time dtype {tdt}: the port keeps time in float64 (the JAX "
            "package's float32 double-word time is not ported, ROADMAP "
            "'Not to port')")

    t_np = host_times(t)
    _check_monotonic(t_np)
    t_sign = -1.0 if time_direction == 'reverse' else time_sign(t_np)
    t_np = t_sign * t_np
    for name in ('step_t', 'jump_t'):
        tv = options.get(name)
        if tv is not None:
            if isinstance(tv, torch.Tensor):
                tv = tv.detach().cpu()
            options[name] = t_sign * np.atleast_1d(
                np.asarray(tv, dtype=np.float64))
    grid_constructor = options.get('grid_constructor')
    if grid_constructor is not None:
        def internal_grid(f, yy, tt):
            """The user's grid of user times, for the internal frame: `tt`
            a float64 tensor of internal times, `yy` the solver's state."""
            grid = grid_constructor(f, yy if unravel is None else unravel(yy),
                                    t_sign * tt)
            if not isinstance(grid, torch.Tensor):
                grid = torch.as_tensor(np.asarray(grid, dtype=np.float64))
            return t_sign * grid.to('cpu', torch.float64)
        options['grid_constructor'] = internal_grid

    if args:
        base_func = lambda tt, yy: func(tt, yy, *args)
    else:
        base_func = func
    if unravel is not None:
        user_func = base_func
        base_func = lambda tt, yy: ravel_leaves(user_func(tt, unravel(yy)))

    flat_event_fn = None
    if event_fn is not None:
        def flat_event_fn(tt, yy):
            tt = time_tensor(tt, yy)
            return event_fn(-tt if t_sign < 0 else tt,
                            yy if unravel is None else unravel(yy))
        flat_event_fn = combine_event_functions(flat_event_fn, t_np[0], y0)

    wrapped = PerturbedFunc(base_func, t_sign)
    for name, fire in solver_callbacks(func, method, solvers, t_sign,
                                       unravel).items():
        setattr(wrapped, name, fire)

    return NormalisedProblem(
        func=wrapped, y0=y0, t=t_np,
        rtol=rtol, atol=atol, method=method, options=options,
        event_fn=flat_event_fn, t_sign=t_sign, norm=norm, unravel=unravel)
