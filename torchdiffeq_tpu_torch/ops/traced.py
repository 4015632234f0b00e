"""Traced fields for the per-lane CUDA kernels, K-dopri5 and K-events.

The TPU kernels take any traceable ``field(t, y, *params)``: Pallas traces
the JAX field into the kernel (``torchdiffeq_tpu/ops/pallas_kernels.py:336``
and ``:580``).  A CUDA kernel cannot run a Python callable, so this module
traces the per-sample field once with ``torch.fx`` (`make_fx`, a graph of
ATen operations on one sample's values) and emits it as a C++ functor of
straight-line code, which ``csrc/traced_field.cuh`` instantiates in the
lane templates of ``csrc/dopri5_lanes.cuh`` and ``csrc/dopri5_events.cuh``.
``ops/_build.traced_library`` compiles the instance at first use, keyed by
the hash of its source.

The traced op set is the one the Pallas kernels name for their fields
(``pallas_kernels.py:10-12``, "elementwise math, jnp.dot/@, reductions"):

* constant indexing and slicing of the state, ``torch.stack`` and
  ``torch.cat``, and the views between them (unsqueeze, squeeze, view,
  reshape, expand, transpose);
* ``+ - * /``, unary minus, the reciprocal and powers;
* ``sin cos exp log tanh sqrt abs minimum maximum where`` and the
  comparisons that feed ``where``;
* ``@`` of a lane's vector by a shared matrix, and ``sum`` (and ``min``,
  ``max``) over a lane's vector;
* constants (``zeros_like``, ``ones_like``, ``full``, tensors the field
  closes over).

Each operation is emitted in the graph's order, rounded to the state dtype
as PyTorch rounds it: a power by 2 or 3 is a product, as PyTorch's kernel
computes it (``x*x``, ``x*x*x``), a scalar over a tensor is a reciprocal
times the scalar, as ``Tensor.__rtruediv__`` computes it, and the build's
``--fmad=false`` keeps every ``a*b+c`` two roundings.  A sum or a matrix
product adds its terms in order; PyTorch's reductions and BLAS may add them
in another, which is the one difference from the plain version besides a
library function's last bit.

Arguments are per-lane (``args_axes=-1``: one value, or one small vector, a
lane, read lanes-major like the state, (P, B)) or shared (read whole by
every lane).  Anything outside the set -- another ATen operation, a dtype
conversion, data-dependent control flow -- raises ``TypeError`` naming it.

The traced instances take float32, float64, bfloat16 and float16 states.
A 16-bit instance computes on ``tdt::Lo`` (``csrc/mlp_field.cuh``): each
operation in float, rounded once to the state dtype, as the TPU kernel's
arithmetic in that dtype (``pallas_kernels.py:336-361``) and PyTorch's
16-bit operations round it; the sum of a matrix product or of ``sum``
accumulates in float and rounds once, as the hand-written 16-bit instances
do.  Where the two frameworks round differently the instance follows JAX:
a Python float operand is rounded to the state dtype first (JAX's weakly
typed scalar; PyTorch would keep ``0.1 * y`` a float32 product rounded
once), and a power by 3 is two rounded products (JAX's integer power).  Its
plain version (`PerSampleField` and `PerSampleEvent` on a 16-bit state)
runs the same traced graph with PyTorch, op by op in the state dtype, with
the same two rules (`_InStateDtype`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..misc import coef

# the kernels' C type of each state dtype a traced instance takes
_C_TYPES = {torch.float32: 'float', torch.float64: 'double',
            torch.bfloat16: 'tdt::bf16', torch.float16: 'tdt::f16'}
# the 16-bit state dtypes, whose instances compute on tdt::Lo
LOW_DTYPES = (torch.bfloat16, torch.float16)
# a field of more emitted values than this is no longer "small"
MAX_VALUES = 1 << 14


class PerSampleField:
    """A per-sample field ``func(t, y_i, *args_i)`` with its args, each
    shared (axis None) or per-lane (axis -1), as the kernel route of
    ``parallel.odeint_per_sample`` hands it to the per-lane kernels.

    Called on the lane layout, ``field(t (1, B), y (D, B))``, it is the
    plain versions' field (``torch.func.vmap`` over the samples; a 16-bit
    state runs the traced graph op by op in its dtype, `_InStateDtype`); on
    the card the kernels trace `func` (`field_source`)."""

    def __init__(self, func, args=(), axes=None):
        self.func = func
        self.args = tuple(args)
        self.axes = (None,) * len(self.args) if axes is None else tuple(axes)
        if len(self.axes) != len(self.args) or any(
                a not in (None, -1) for a in self.axes):
            raise ValueError("a per-lane field's args_axes are None or -1, "
                             f"one an arg, got {self.axes}")
        dims = tuple(None if a is None else -1 for a in self.axes)
        self._lanes = torch.func.vmap(func, in_dims=(0, 1) + dims, out_dims=1)

    def __call__(self, tv, yv):
        if yv.dtype in LOW_DTYPES:
            samples = [tv[0, 0], yv[:, 0]] + [
                a if ax is None else a[..., 0]
                for a, ax in zip(self.args, self.axes)]
            dims = tuple(None if a is None else -1 for a in self.axes)
            return torch.func.vmap(_in_state_dtype(self.func, samples),
                                   in_dims=(0, 1) + dims, out_dims=1)(
                                       tv[0], yv, *self.args)
        return self._lanes(tv[0], yv, *self.args)


class PerSampleEvent:
    """A per-sample event function ``event_fn(t, y_i)`` whose outputs are
    sign-combined per lane, ``min_k(e_k * sign0_k)`` with sign0 (K, B) (the
    kernels' event layout, JAX `_pallas_per_sample_event`'s ``ev``)."""

    def __init__(self, event_fn):
        self.event_fn = event_fn

    def _fn(self, tv, yv):
        """The per-sample event function: itself, or on a 16-bit state its
        traced graph op by op in that dtype (`_InStateDtype`)."""
        if yv.dtype in LOW_DTYPES:
            return _in_state_dtype(self.event_fn, [tv[0, 0], yv[:, 0]])
        return self.event_fn

    def values(self, tv, yv):
        """Every output of every lane, (K, B), before the sign-combine."""
        fn = self._fn(tv, yv)
        return torch.func.vmap(lambda tt, yy: torch.atleast_1d(fn(tt, yy)),
                               in_dims=(0, 1), out_dims=1)(tv[0], yv)

    def __call__(self, tv, yv, sign0):
        fn = self._fn(tv, yv)
        one = lambda tt, yy, s_i: torch.min(
            torch.atleast_1d(fn(tt, yy)) * s_i)
        return torch.func.vmap(one, in_dims=(0, 1, 1), out_dims=0)(
            tv[0], yv, sign0)[None]


def _name(func):
    return getattr(func, '__qualname__', None) or type(func).__name__


def _refuse(what, func):
    raise TypeError(
        f"the per-lane CUDA kernels cannot translate {what} (in "
        f"{_name(func)}): a traced field takes constant indexing, stack/cat, "
        "+ - * / and powers, sin cos exp log tanh sqrt abs minimum maximum "
        "where, @ by a shared matrix and sum; drop pallas=True for the "
        "batched driver, which takes any field")


def _trace(func, inputs):
    """The ATen graph of ``func(*inputs)`` on one sample (real tensors: the
    values a field closes over stay the tensors it holds)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    try:
        with torch.no_grad():
            return make_fx(func)(*inputs)
    except Exception as exc:  # noqa: BLE001 -- named in the refusal
        _refuse(f"what torch.fx could not trace ({type(exc).__name__}: "
                f"{str(exc).splitlines()[0][:200]}; data-dependent control "
                "flow cannot be traced)", func)


class _InStateDtype(torch.fx.Interpreter):
    """A traced graph run by PyTorch op by op in its 16-bit dtype, as the
    emitted functor computes it and as JAX's arithmetic in that dtype
    rounds: a Python float operand rounded to the dtype first (JAX's weakly
    typed scalar), and an int power by rounded products (`_int_pow`).
    Every other operation is PyTorch's own, which computes a 16-bit
    operation in float and rounds once (a sum and a matrix product
    accumulate in float)."""

    def __init__(self, gm, dtype):
        super().__init__(gm)
        self.dtype = dtype

    def call_function(self, target, args, kwargs):
        packet = getattr(target, '_overloadpacket', None)
        if (packet is torch.ops.aten.pow
                and target._overloadname == 'Tensor_Scalar'
                and type(args[1]) is int and args[1] != 0):
            return _int_pow(args[0], args[1], torch.mul, torch.reciprocal)

        def rnd(a):
            return coef(a, self.dtype) if type(a) is float else a
        return super().call_function(
            target, tuple(rnd(a) for a in args),
            {k: rnd(v) for k, v in kwargs.items()})


def _in_state_dtype(func, samples):
    """`func` on one sample, run as `_InStateDtype` runs its graph: traced
    once on `samples` (its inputs for one sample, the state's dtype 16-bit)
    and kept for the next call with the same function and shapes."""
    key = ('plain', _func_key(func), tuple(
        (tuple(x.shape), x.dtype, x.device) for x in samples))
    gm = _cached(key, lambda: _trace(func, samples))
    dtype = samples[1].dtype
    return lambda *xs: _InStateDtype(gm, dtype).run(*xs)


def _lit(x, dtype=None):
    """A Python number as a literal of the state type (PyTorch casts a
    scalar operand to the tensor's dtype the same way); for a 16-bit
    `dtype`, the number rounded to it first, as JAX's weakly typed scalar
    is (`_InStateDtype`)."""
    if isinstance(x, bool):
        return 'true' if x else 'false'
    x = coef(x, dtype) if dtype in LOW_DTYPES else float(x)
    if math.isnan(x):
        return 'T(NAN)'
    if math.isinf(x):
        return 'T(INFINITY)' if x > 0 else 'T(-INFINITY)'
    return f'T({x!r})'


class _Emitter:
    """Straight-line C++ for one traced graph: every value is a numpy object
    array of C expressions (a state element, a load of an arg, or the name
    of an emitted ``const T vN``), so shapes, broadcasting and indexing are
    numpy's, and each element of an operation's result is one statement."""

    def __init__(self, func, dtype, prefix):
        self.func = func
        self.dtype = dtype
        self.prefix = prefix
        self.lines = []
        self.ops = 0          # arithmetic operations an evaluation runs
        self.shared = []      # the shared tensors, in the buffer's order
        self.n_shared = 0     # elements of the shared buffer so far

    def let(self, expr, kind='T', ops=1):
        name = f"{self.prefix}{len(self.lines)}"
        self.lines.append(f"    const {kind} {name} = {expr};")
        self.ops += ops
        if len(self.lines) > MAX_VALUES:
            _refuse(f"a field of more than {MAX_VALUES} values", self.func)
        return name

    def shared_tensor(self, x):
        """A tensor every lane reads whole: its elements are loads from the
        shared buffer."""
        if x.dtype != self.dtype:
            _refuse(f"a {x.dtype} tensor in a {self.dtype} field", self.func)
        off = self.n_shared
        self.shared.append(x)
        self.n_shared += x.numel()
        idx = np.arange(x.numel()).reshape(tuple(x.shape))
        return np.vectorize(lambda i: f"s[{off + i}]", otypes=[object])(idx) \
            if x.numel() else np.empty(tuple(x.shape), dtype=object), 'T'


def _arr(v):
    return v if isinstance(v, np.ndarray) else np.asarray(v, dtype=object)


def _elementwise(em, fmt, vals, kind='T', ops=1):
    """One statement an element of the broadcast of `vals`."""
    arrs = np.broadcast_arrays(*[_arr(a) for a, _ in vals])
    out = np.empty(arrs[0].shape, dtype=object)
    for idx in np.ndindex(out.shape):
        out[idx] = em.let(fmt.format(*[a[idx] for a in arrs]), kind, ops)
    return out, kind


def _chain(em, terms, op):
    """`terms` combined in order: ``((t0 op t1) op t2) ...``, or by
    tdt::nmin / tdt::nmax; a 16-bit sum in float, rounded once."""
    if len(terms) < 2:
        return terms[0]
    low_sum = op == '+' and em.dtype in LOW_DTYPES
    if low_sum:
        terms = [f"tdt::acc({x})" for x in terms]
    acc = terms[0]
    for x in terms[1:]:
        acc = f"({acc} {op} {x})" if op in '+*' else f"{op}({acc}, {x})"
    return em.let(f"T({acc})" if low_sum else acc, 'T', len(terms) - 1)


def _reduce(em, val, dims, keepdim, op):
    arr, _ = val
    nd = arr.ndim
    dims = list(range(nd)) if dims is None or dims == [] else \
        sorted(d % nd for d in dims)
    keep = [d for d in range(nd) if d not in dims]
    moved = np.transpose(arr, keep + dims)
    lead = moved.shape[:len(keep)]
    flat = moved.reshape(lead + (-1,))
    out = np.empty(lead, dtype=object)
    for idx in np.ndindex(lead):
        out[idx] = _chain(em, list(flat[idx]), op)
    if keepdim:
        out = out.reshape([1 if d in dims else arr.shape[d]
                           for d in range(nd)])
    return out, 'T'


def _matmul(em, a, b):
    """``a @ b`` for 1-D and 2-D operands: each output element the ordered
    sum of its products (2 operations a term)."""
    A, B = _arr(a[0]), _arr(b[0])
    va, vb = A.ndim == 1, B.ndim == 1
    A2 = A[None, :] if va else A
    B2 = B[:, None] if vb else B
    if A2.ndim != 2 or B2.ndim != 2 or A2.shape[1] != B2.shape[0]:
        _refuse(f"a matrix product of shapes {A.shape} and {B.shape}", em.func)
    out = np.empty((A2.shape[0], B2.shape[1]), dtype=object)
    # a 16-bit product's terms and sum in float, rounded once
    low = em.dtype in LOW_DTYPES
    for i in range(A2.shape[0]):
        for j in range(B2.shape[1]):
            terms = [f"tdt::acc({A2[i, k]}) * tdt::acc({B2[k, j]})" if low
                     else f"{A2[i, k]} * {B2[k, j]}"
                     for k in range(A2.shape[1])]
            acc = f"({terms[0]})"
            for term in terms[1:]:
                acc = f"({acc} + {term})"
            out[i, j] = em.let(f"T({acc})" if low else acc, 'T',
                               2 * len(terms) - 1)
    if va:
        out = out[0]
    if vb:
        out = out[..., 0]
    return out, 'T'


def _int_pow(x, n, mul, recip):
    """``x ** n`` for an int `n` != 0 as JAX's ``lax.integer_pow`` forms it:
    binary exponentiation by rounded products, then a reciprocal for a
    negative `n`."""
    m, acc = abs(n), None
    while m > 0:
        if m & 1:
            acc = x if acc is None else mul(acc, x)
        m >>= 1
        if m > 0:
            x = mul(x, x)
    return recip(acc) if n < 0 else acc


def _pow_scalar(em, x, e):
    """``x ** e`` as PyTorch's kernel computes it (a product for 2 and 3,
    the square root for 0.5, a reciprocal for -1 and -2).  In a 16-bit
    dtype, as JAX computes it: an int power by rounded products
    (`_int_pow`), any other one `dpow` rounded once."""
    if em.dtype in LOW_DTYPES and e != 0.5:
        if isinstance(e, int) and e != 0:
            return _elementwise(em, _int_pow(
                "{0}", e, lambda a, b: f"({a} * {b})",
                lambda a: f"T(1) / {a}"), [x])
        if not isinstance(e, int):
            return _elementwise(em, "tdt::dpow<T>({0}, %s)" % _lit(
                e, em.dtype), [x])
    forms = {2.0: "{0} * {0}", 3.0: "{0} * {0} * {0}", 0.5: "tdt::dsqrt<T>({0})",
             -0.5: "T(1) / tdt::dsqrt<T>({0})", -1.0: "T(1) / {0}",
             -2.0: "T(1) / ({0} * {0})", 1.0: "{0}"}
    e = float(e)
    if e == 0.0:
        return np.full(x[0].shape, 'T(1)', dtype=object), 'T'
    fmt = forms.get(e, "tdt::dpow<T>({0}, %s)" % _lit(e, em.dtype))
    return _elementwise(em, fmt, [x])


_BINARY = {'add': '{0} + {1}', 'sub': '{0} - {1}', 'mul': '{0} * {1}',
           'div': '{0} / {1}', 'minimum': 'tdt::nmin({0}, {1})',
           'maximum': 'tdt::nmax({0}, {1})'}
_COMPARE = {'gt': '>', 'lt': '<', 'ge': '>=', 'le': '<=', 'eq': '==',
            'ne': '!='}
_UNARY = {'neg': '-{0}', 'reciprocal': 'T(1) / {0}',
          'sin': 'tdt::tsin<T>({0})', 'cos': 'tdt::tcos<T>({0})',
          'exp': 'tdt::texp<T>({0})', 'log': 'tdt::tlog<T>({0})',
          'tanh': 'tdt::dtanh<T>({0})', 'sqrt': 'tdt::dsqrt<T>({0})',
          'abs': 'tdt::dabs<T>({0})'}
_IDENTITY = {'clone', 'alias', 'detach', 'lift_fresh_copy', 'contiguous'}
_VIEWS = {'view', 'reshape', '_unsafe_view'}


def _emit_node(em, node, env):
    """The value of one call_function node of the traced graph."""
    target = node.target
    packet = getattr(target, '_overloadpacket', None)
    name = getattr(packet, '__name__', str(target))
    overload = getattr(target, '_overloadname', '')
    qual = f"aten.{name}.{overload}" if packet is not None else str(target)

    def val(a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (bool, int, float)):
            return np.asarray(_lit(a, em.dtype), dtype=object), \
                'bool' if isinstance(a, bool) else 'T'
        _refuse(f"{qual} with an argument {a!r}", em.func)

    args, kw = node.args, dict(node.kwargs)
    meta = node.meta.get('val')
    if isinstance(meta, torch.Tensor) and meta.dtype not in (em.dtype,
                                                             torch.bool):
        _refuse(f"{qual}, which computes in {meta.dtype} (the state is "
                f"{em.dtype})", em.func)
    for placement in ('device', 'pin_memory', 'layout', 'memory_format'):
        kw.pop(placement, None)

    if name in _IDENTITY:
        return val(args[0])
    if name == '_to_copy':
        if kw.get('dtype', em.dtype) != em.dtype:
            _refuse(f"{qual} to {kw.get('dtype')}", em.func)
        return val(args[0])
    if name in ('add', 'sub') and (kw.get('alpha', 1) != 1 or len(args) > 2):
        _refuse(f"{qual} with alpha", em.func)
    if name == 'div' and kw.get('rounding_mode') is not None:
        _refuse(f"{qual} with rounding_mode", em.func)
    if name in _BINARY and overload in ('Tensor', 'Scalar', 'default'):
        return _elementwise(em, _BINARY[name], [val(args[0]), val(args[1])])
    if name == 'rsub':
        if kw.get('alpha', 1) != 1:
            _refuse(f"{qual} with alpha", em.func)
        return _elementwise(em, '{1} - {0}', [val(args[0]), val(args[1])])
    if name in _COMPARE:
        return _elementwise(em, '{0} %s {1}' % _COMPARE[name],
                            [val(args[0]), val(args[1])], 'bool')
    if name == 'where' and overload in ('self', 'ScalarOther', 'ScalarSelf',
                                        'Scalar'):
        return _elementwise(em, '{0} ? {1} : {2}',
                            [val(args[0]), val(args[1]), val(args[2])])
    if name in _UNARY and overload == 'default':
        return _elementwise(em, _UNARY[name], [val(args[0])])
    if name == 'pow' and overload == 'Tensor_Scalar':
        return _pow_scalar(em, val(args[0]), args[1])
    if name == 'pow' and overload in ('Tensor_Tensor', 'Scalar'):
        return _elementwise(em, 'tdt::dpow<T>({0}, {1})',
                            [val(args[0]), val(args[1])])
    # shapes
    if name == 'select':
        arr, kind = val(args[0])
        return np.take(arr, args[2], axis=args[1]), kind
    if name == 'slice':
        arr, kind = val(args[0])
        dim = args[1] if len(args) > 1 else 0
        start = args[2] if len(args) > 2 else None
        end = args[3] if len(args) > 3 else None
        step = args[4] if len(args) > 4 else 1
        index = [slice(None)] * arr.ndim
        index[dim] = slice(start, end, step)
        return arr[tuple(index)], kind
    if name == 'unsqueeze':
        arr, kind = val(args[0])
        return np.expand_dims(arr, args[1] % (arr.ndim + 1)), kind
    if name in ('squeeze', 'squeeze_'):
        arr, kind = val(args[0])
        if len(args) == 1:
            return np.squeeze(arr), kind
        dims = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
        dims = tuple(d % max(arr.ndim, 1) for d in dims
                     if arr.ndim and arr.shape[d] == 1)
        return (np.squeeze(arr, axis=dims) if dims else arr), kind
    if name in _VIEWS:
        arr, kind = val(args[0])
        return arr.reshape(tuple(args[1])), kind
    if name == 'expand':
        arr, kind = val(args[0])
        size = list(args[1])
        lead = len(size) - arr.ndim
        size = [arr.shape[i - lead] if s == -1 else s
                for i, s in enumerate(size)]
        return np.broadcast_to(arr, size), kind
    if name == 't':
        arr, kind = val(args[0])
        return arr.T, kind
    if name == 'transpose':
        arr, kind = val(args[0])
        return np.swapaxes(arr, args[1], args[2]), kind
    if name == 'permute':
        arr, kind = val(args[0])
        return np.transpose(arr, args[1]), kind
    if name in ('stack', 'cat'):
        parts = [val(a) for a in args[0]]
        dim = args[1] if len(args) > 1 else kw.get('dim', 0)
        kinds = {k for _, k in parts}
        if len(kinds) != 1:
            _refuse(f"{qual} of bool and float values", em.func)
        join = np.stack if name == 'stack' else np.concatenate
        return join([p for p, _ in parts], axis=dim), kinds.pop()
    # products and reductions
    if name in ('mm', 'mv', 'dot', 'matmul'):
        return _matmul(em, val(args[0]), val(args[1]))
    if name == 'sum' and kw.get('dtype') in (None, em.dtype):
        dims = args[1] if len(args) > 1 else kw.get('dim')
        keep = args[2] if len(args) > 2 else kw.get('keepdim', False)
        return _reduce(em, val(args[0]), dims, keep, '+')
    if name in ('amin', 'amax', 'min', 'max') and overload in (
            'default', ''):
        dims = args[1] if len(args) > 1 else kw.get('dim')
        keep = args[2] if len(args) > 2 else kw.get('keepdim', False)
        op = 'tdt::nmin' if name in ('amin', 'min') else 'tdt::nmax'
        return _reduce(em, val(args[0]), dims, keep, op)
    # constants
    if name in ('zeros_like', 'ones_like', 'full_like'):
        arr, _ = val(args[0])
        fill = {'zeros_like': 0.0, 'ones_like': 1.0}.get(
            name, args[1] if len(args) > 1 else None)
        return np.full(arr.shape, _lit(fill, em.dtype), dtype=object), 'T'
    if name in ('zeros', 'ones', 'full', 'scalar_tensor'):
        size = () if name == 'scalar_tensor' else tuple(args[0])
        fill = {'zeros': 0.0, 'ones': 1.0}.get(name)
        if fill is None:
            fill = args[0] if name == 'scalar_tensor' else args[1]
        return np.full(size, _lit(fill, em.dtype), dtype=object), 'T'
    _refuse(qual, em.func)


def _inputs(em, graph, module, placeholders):
    """The values of the graph's placeholders and constants."""
    env = {}
    ph = [n for n in graph.nodes if n.op == 'placeholder']
    for node, value in zip(ph, placeholders):
        env[node] = value
    for node in graph.nodes:
        if node.op == 'get_attr':
            const = getattr(module, node.target)
            if not isinstance(const, torch.Tensor):
                _refuse(f"the constant {node.target!r}", em.func)
            env[node] = em.shared_tensor(const.detach())
    return env


def _run(em, gm, env):
    out = None
    for node in gm.graph.nodes:
        if node.op == 'call_function':
            arr, kind = _emit_node(em, node, env)
            # numpy hands an indexed element back as the element itself
            env[node] = (arr if isinstance(arr, np.ndarray)
                         else np.asarray(arr, dtype=object), kind)
        elif node.op == 'output':
            out = node.args[0]
            if isinstance(out, (list, tuple)):
                if len(out) != 1:
                    _refuse("a field that returns several tensors", em.func)
                out = out[0]
            out = env[out] if isinstance(out, torch.fx.Node) else None
        elif node.op not in ('placeholder', 'get_attr'):
            _refuse(f"the graph node {node.op} {node.target}", em.func)
    if out is None or out[1] != 'T':
        _refuse("a field whose value is not a tensor of the state dtype",
                em.func)
    return out[0]


def _materialised(em, arr):
    """`arr`'s elements as emitted names (an output may alias the input)."""
    return [x if x.startswith(em.prefix) else em.let(x, 'T', 0)
            for x in np.asarray(arr, dtype=object).reshape(-1)]


class TracedSource:
    """One traced instance: its C++ source, what it reads at a launch and
    what an evaluation costs.

    Attributes:
        source: the translation unit (``csrc/traced_field.cuh`` included).
        lane_args: the per-lane args, each (..., B), in the (P, B) rows the
            functor reads.
        shared: the field's shared tensors (args and constants), in its
            buffer's order; ``ev_shared`` the event's.
        field_ops, event_ops: arithmetic operations of one evaluation.
        K: the event's outputs (0 without one).
    """

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def lane_buffer(self, B, dtype, device):
        """The per-lane args as the (P, B) rows the functor reads."""
        if not self.lane_args:
            return None
        return torch.cat([a.detach().reshape(-1, B) for a in self.lane_args]
                         ).to(device=device, dtype=dtype).contiguous()

    @staticmethod
    def buffer(tensors, dtype, device):
        """Shared tensors flattened into one buffer, in order."""
        if not tensors:
            return None
        return torch.cat([t.detach().reshape(-1) for t in tensors]).to(
            device=device, dtype=dtype).contiguous()


def _field_functor(field, y_sample, dtype):
    """(struct source, the constants it closes over, ops) of the traced
    field; its shared buffer holds its shared args, then the constants."""
    D = y_sample.shape[0]
    em = _Emitter(field.func, dtype, 'v')
    t = torch.zeros((), dtype=dtype, device=y_sample.device)
    inputs, placeholders = [t, y_sample], [
        (np.asarray('t', dtype=object), 'T'),
        (np.asarray([f"y[{d}]" for d in range(D)], dtype=object), 'T')]
    n_lane = 0
    for arg, axis in zip(field.args, field.axes):
        if not isinstance(arg, torch.Tensor):
            arg = torch.as_tensor(arg, dtype=dtype, device=y_sample.device)
        if axis is None:
            inputs.append(arg)
            placeholders.append(None)   # filled below, in the buffer's order
            continue
        sample = arg[..., 0]
        idx = np.arange(n_lane, n_lane + sample.numel()).reshape(
            tuple(sample.shape))
        placeholders.append((np.vectorize(lambda i: f"a[{i}]", otypes=[object])(
            idx) if sample.numel() else np.empty(sample.shape, dtype=object),
            'T'))
        inputs.append(sample)
        n_lane += sample.numel()
        if arg.dtype != dtype:
            _refuse(f"a {arg.dtype} per-lane arg in a {dtype} field",
                    field.func)
    for i, (arg, axis) in enumerate(zip(field.args, field.axes)):
        if axis is None:
            placeholders[2 + i] = em.shared_tensor(inputs[2 + i])
    n_args = len(em.shared)
    gm = _trace(field.func, inputs)
    env = _inputs(em, gm.graph, gm, placeholders)
    out = _run(em, gm, env)
    if out.shape != (D,):
        _refuse(f"a field value of shape {out.shape} for a state of "
                f"shape ({D},)", field.func)
    names = _materialised(em, out)
    load = (f"#pragma unroll\n    for (int p = 0; p < {n_lane}; ++p) "
            "a[p] = lane[(size_t)p * B + b];" if n_lane else "(void)lane;")
    src = f"""struct Field {{
  const T* __restrict__ s;
  T a[{max(n_lane, 1)}];
  __device__ __forceinline__ Field(const T* lane, const T* shared, int b, int B)
      : s(shared) {{
    {load}
    (void)b; (void)B;
  }}
  __device__ __forceinline__ void operator()(T t, const T (&y)[{D}], T (&out)[{D}]) const {{
    (void)t;
{chr(10).join(em.lines)}
{chr(10).join(f"    out[{d}] = {n};" for d, n in enumerate(names))}
  }}
}};
"""
    return src, em.shared[n_args:], em.ops


def _event_functor(event, y_sample, dtype):
    """(struct source, shared tensors, ops, K) of the traced event, its K
    outputs sign-combined inside: min_k(e_k * s0_k)."""
    D = y_sample.shape[0]
    em = _Emitter(event.event_fn, dtype, 'e')
    t = torch.zeros((), dtype=dtype, device=y_sample.device)
    gm = _trace(event.event_fn, [t, y_sample])
    env = _inputs(em, gm.graph, gm, [
        (np.asarray('t', dtype=object), 'T'),
        (np.asarray([f"y[{d}]" for d in range(D)], dtype=object), 'T')])
    out = _run(em, gm, env)
    if out.ndim > 1:
        _refuse(f"an event value of shape {out.shape}", event.event_fn)
    outs = list(out.reshape(-1))
    K = len(outs)
    terms = [em.let(f"{e} * s0[{k}]", 'T') for k, e in enumerate(outs)]
    combined = terms[0]
    for x in terms[1:]:
        combined = em.let(f"tdt::nmin({combined}, {x})", 'T')
    src = f"""struct Event {{
  const T* __restrict__ s;
  T s0[{K}];
  __device__ __forceinline__ Event(const T* sign0, const T* shared, int b, int B)
      : s(shared) {{
#pragma unroll
    for (int k = 0; k < {K}; ++k) s0[k] = sign0[(size_t)k * B + b];
  }}
  __device__ __forceinline__ T operator()(T t, const T (&y)[{D}]) const {{
    (void)t;
{chr(10).join(em.lines)}
    return {combined};
  }}
}};
"""
    return src, em.shared, em.ops, K


_HEAD = """// A traced instance of the per-lane kernels, emitted by
// torchdiffeq_tpu_torch/ops/traced.py from {what}, for
// {method}'s tableau (see csrc/traced_field.cuh).
#define TDT_MAX_ALPHA {n_alpha}
#include "traced_field.cuh"

namespace {{
using T = {ctype};
{tableau}
{body}}}  // namespace
"""

_LANES_ENTRY = """
extern "C" int tdt_traced_lanes(int B, const void* y0, const void* ts, int S,
                                double t0, double t1, double rtol, double atol,
                                double safety, double ifactor, double dfactor,
                                double first_step, int use_first_step,
                                int max_steps, const void* lane,
                                const void* shared, int threads, void* ys,
                                void* n_acc, void* n_steps, void* stream) {{
  return tdt_lanes::launch_traced<T, {D}, Field, MethodTableau>(
      B, y0, ts, S, t0, t1, rtol, atol, safety, ifactor, dfactor, first_step,
      use_first_step, max_steps, lane, shared, threads, ys, n_acc, n_steps,
      stream);
}}
"""

_EVENTS_ENTRY = """
extern "C" int tdt_traced_events(int B, const void* y0, double t0, double rtol,
                                 double atol, double safety, double ifactor,
                                 double dfactor, double first_step,
                                 int use_first_step, int max_steps,
                                 const void* lane, const void* shared,
                                 const void* sign0, const void* ev_shared,
                                 int bisect_iters, int threads, void* event_t,
                                 void* y_event, void* found, void* n_acc,
                                 void* n_steps, void* stream) {{
  return tdt_events::launch_traced<T, {D}, Field, Event, MethodTableau>(
      B, y0, t0, rtol, atol, safety, ifactor, dfactor, first_step,
      use_first_step, max_steps, lane, shared, sign0, ev_shared, bisect_iters,
      threads, event_t, y_event, found, n_acc, n_steps, stream);
}}
"""


def _packed_entry(i, m):
    """The name of entry `i` of the packed tableau of `m` alphas
    (csrc/lane_ops.cuh's layout: alpha | beta | c_sol | c_err | c_mid)."""
    if i < m:
        return f"alpha[{i}]"
    i -= m
    if i < m * m:
        return f"beta[{i // m}][{i % m}]"
    i -= m * m
    return f"{('c_sol', 'c_err', 'c_mid')[i // (m + 1)]}[{i % (m + 1)}]"


def tableau_struct(method, dtype):
    """The C++ of `method`'s tableau compiled into a traced instance
    (``MethodTableau``, csrc/lane_ops.cuh's compiled kind) for a state of
    the torch `dtype`, and its n_alpha.  Each nonzero entry of
    ``packed_tableau(method, dtype)`` is a case of ``coef``, by its packed
    index and in its order, as the double that holds that dtype's value
    exactly (so ``T(coef(i))`` has the packed tensor's bits); the zero
    entries are absent, and ``coef`` returns 0 for them, so the kernel's
    sums drop them at compile time.  1/order is the double the
    hand-written instances convert to the state dtype, ``1.0 / order``."""
    from .kernels import _PACK_ALPHA, packed_tableau
    packed, n_alpha, order, fsal = packed_tableau(method, dtype,
                                                  torch.device('cpu'))
    vals = packed.double().numpy()
    cases = "\n".join(
        f"      case {i}: return {float(vals[i])!r};  // "
        f"{_packed_entry(i, _PACK_ALPHA)}"
        for i in np.flatnonzero(vals))
    name = str(dtype).replace('torch.', '')
    return f"""// {method}'s tableau in {name}, compiled into the instance
// (ops/kernels.py `packed_tableau`: its nonzero entries by packed index)
struct MethodTableau {{
  static constexpr bool kCompiled = true;
  static constexpr int n_alpha = {n_alpha};
  static constexpr bool fsal = {'true' if fsal else 'false'};
  static constexpr double inv_order = {1.0 / order!r};
  __host__ __device__ static constexpr double coef(int i) {{
    switch (i) {{
{cases}
      default: return 0.0;
    }}
  }}
}};
""", n_alpha


def _check_state(y0_lanes, func):
    if y0_lanes.dtype not in _C_TYPES:
        raise TypeError(
            f"a traced field takes a float32, float64, bfloat16 or float16 "
            f"state, got {y0_lanes.dtype}")
    if y0_lanes.dim() != 2 or y0_lanes.shape[1] < 1:
        raise ValueError(f"a (D, B) state with B >= 1, got "
                         f"{tuple(y0_lanes.shape)}")


def _plain(v):
    return v if isinstance(v, (bool, int, float, str, type(None))) else id(v)


def _func_key(func):
    """What a trace of `func` depends on besides its inputs: the function
    and the values of its closure cells and defaults (numbers by value,
    anything else by identity).  A field that reads a global that changes
    must be a new function for a new trace."""
    cells = []
    for c in getattr(func, '__closure__', None) or ():
        try:
            cells.append(_plain(c.cell_contents))
        except ValueError:   # an empty cell
            cells.append(None)
    return (func, tuple(cells),
            tuple(_plain(d) for d in getattr(func, '__defaults__', None)
                  or ()))


# traces by what they depend on (`_key`), the most recent last
_TRACES = {}
_MAX_TRACES = 64


def _cached(key, build):
    """`build()`, or its value for `key` from an earlier call; a key that
    cannot be hashed is built every time."""
    try:
        hit = _TRACES.pop(key, None)
    except TypeError:
        return build()
    if hit is None:
        hit = build()
        if len(_TRACES) >= _MAX_TRACES:
            _TRACES.pop(next(iter(_TRACES)))
    _TRACES[key] = hit
    return hit


def _key(field, y0_lanes, method, event=None):
    return (_func_key(field.func), field.axes,
            tuple((tuple(a.shape), a.dtype, a.device)
                  if isinstance(a, torch.Tensor) else _plain(a)
                  for a in field.args),
            y0_lanes.shape[0], y0_lanes.dtype, y0_lanes.device, method,
            None if event is None else _func_key(event.event_fn))


def _args_of(field, constants):
    """(per-lane args, shared tensors) of this call: the shared args, then
    the constants the traced field closes over."""
    lane = [a for a, ax in zip(field.args, field.axes) if ax == -1]
    shared = [a for a, ax in zip(field.args, field.axes) if ax is None]
    return lane, [torch.as_tensor(a) for a in shared] + list(constants)


def field_source(field, y0_lanes, method):
    """The traced K-dopri5 instance of `field` (a `PerSampleField`) for the
    (D, B) state `y0_lanes` and the explicit `method`, whose tableau is
    compiled into it (`tableau_struct`): a `TracedSource`.  The trace is
    kept for the next call with the same function, arg shapes, state and
    method."""
    _check_state(y0_lanes, field.func)
    dtype = y0_lanes.dtype

    def build():
        tableau, n_alpha = tableau_struct(method, dtype)
        body, constants, ops = _field_functor(field, y0_lanes[:, 0], dtype)
        src = _HEAD.format(what=f"the field {_name(field.func)}",
                           method=method, n_alpha=n_alpha,
                           ctype=_C_TYPES[dtype], tableau=tableau,
                           body=body) + _LANES_ENTRY.format(
                               D=y0_lanes.shape[0])
        return src, constants, ops

    src, constants, ops = _cached(_key(field, y0_lanes, method), build)
    lane_args, shared = _args_of(field, constants)
    return TracedSource(source=src, lane_args=lane_args, shared=shared,
                        ev_shared=[], field_ops=ops, event_ops=0, K=0)


def events_source(field, event, y0_lanes, method):
    """The traced K-events instance of `field` and `event` (a
    `PerSampleEvent`) for `method`: a `TracedSource`, its trace kept as
    `field_source` keeps one."""
    _check_state(y0_lanes, field.func)
    dtype = y0_lanes.dtype

    def build():
        tableau, n_alpha = tableau_struct(method, dtype)
        y_sample = y0_lanes[:, 0]
        fbody, constants, fops = _field_functor(field, y_sample, dtype)
        ebody, ev_shared, eops, K = _event_functor(event, y_sample, dtype)
        src = _HEAD.format(
            what=f"the field {_name(field.func)} and the event "
            f"{_name(event.event_fn)}", method=method, n_alpha=n_alpha,
            ctype=_C_TYPES[dtype], tableau=tableau,
            body=fbody + "\n" + ebody) \
            + _EVENTS_ENTRY.format(D=y0_lanes.shape[0])
        return src, constants, fops, ev_shared, eops, K

    src, constants, fops, ev_shared, eops, K = _cached(
        _key(field, y0_lanes, method, event), build)
    lane_args, shared = _args_of(field, constants)
    return TracedSource(source=src, lane_args=lane_args, shared=shared,
                        ev_shared=ev_shared, field_ops=fops, event_ops=eops,
                        K=K)
