"""Training loops over a step function (counterpart of
``torchdiffeq_tpu/training.py``).

* `make_sgd_step(loss_fn, lr)` / `make_optax_step(loss_fn, optimizer)`
  build a ``(carry, batch) -> (carry, loss)`` step from a loss
  ``loss_fn(params, batch)``.  Params and batches are a tensor, or a
  tuple, list or dict of them (nested as one likes): JAX's pytrees of
  arrays.  The gradient is ``torch.autograd.grad`` of the loss in the
  params, so a loss may close over `odeint` / `odeint_adjoint` (whose
  adjoint is an autograd Function that ``torch.func`` transforms cannot
  enter).
* `scan_steps(step_fn, carry, xs=None, length=None)` runs the steps in a
  host loop and stacks their outputs on the device.  The port has no
  counterpart of JAX's ``jit(lax.scan)``: the adaptive solvers read the
  device every step, so no CUDA graph can capture a step, and each step
  is dispatched from the host.  ``donate=True`` is the port's form of JAX's
  buffer donation: the steps built here update the carry's parameters in
  place, with no copy of the carry.
* `fit(step_fn, carry, batches, num_steps, steps_per_dispatch=32)` drives
  a data pipeline: it stacks each chunk of batches, runs the chunk through
  `scan_steps` and reads the chunk's losses to the host once, so
  `steps_per_dispatch` is the number of steps a host round trip.

The optimizers `make_optax_step` takes are the port's counterparts of
optax's transforms: `adam`, `rmsprop` and `sgd` (optax's arithmetic in
optax's order, ``examples/_optim.py`` computes with the same rules), each a
`GradientTransformation` of ``init(params)`` and ``update(grads, state,
params)``.
"""
from __future__ import annotations

import contextvars
from typing import Callable, NamedTuple

import numpy as np
import torch

# set while `scan_steps(donate=True)` runs: the steps built here then
# update the carry's parameters in place
_DONATED = contextvars.ContextVar('donated', default=False)


# ---- the trees of tensors --------------------------------------------------

def tree_map(fn, tree, *rest):
    """`fn` on each tensor (or other leaf) of `tree` and the matching
    leaves of `rest`, the structure kept (JAX ``tree_util.tree_map`` over
    tuples, lists and dicts).  None is an empty subtree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v, *(r[k] for r in rest)))
                          for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of `tree` in `tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _stack(outs):
    """The steps' outputs stacked on a leading axis, leaf by leaf."""
    if not outs:
        return None
    return tree_map(lambda *xs: torch.stack(xs), *outs)


# ---- the steps --------------------------------------------------------------

def _value_and_grad(loss_fn, params, batch, has_aux):
    """(the loss, or (loss, aux), detached; the gradient of each param
    leaf, in leaf order)."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        ps = [p.detach().requires_grad_(True) for p in leaves]
        out = loss_fn(_unflatten(params, ps), batch)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    out = tree_map(lambda x: x.detach() if isinstance(x, torch.Tensor)
                   else x, out)
    return out, grads


def make_sgd_step(loss_fn, lr=1e-3, has_aux=False):
    """Build a plain-SGD ``(params, batch) -> (params, loss)`` step.

    `loss_fn(params, batch)` must return a scalar loss (or ``(loss, aux)``
    with `has_aux=True`).  The carry is the params tree itself; each param
    becomes ``p - lr * g`` in p's dtype (in place under ``scan_steps(...,
    donate=True)``).
    """
    def step(params, batch):
        out, grads = _value_and_grad(loss_fn, params, batch, has_aux)
        donated = _DONATED.get()
        new = []
        with torch.no_grad():
            for p, g in zip(tree_leaves(params), grads):
                delta = torch.tensor(lr, dtype=p.dtype, device=p.device) * g
                new.append(p.sub_(delta) if donated else p - delta)
        return _unflatten(params, new), out

    return step


def make_optax_step(loss_fn, optimizer, has_aux=False):
    """Build an optimizer step; the carry is ``(params, opt_state)``.

    `optimizer` is a `GradientTransformation` (`adam`, `rmsprop`, `sgd`).
    Returns ``(init, step)``: ``init(params)`` builds the carry,
    ``step(carry, batch)`` returns ``(carry, loss)`` (or ``(carry, (loss,
    aux))`` with `has_aux=True`).  The updates are applied as optax's
    ``apply_updates`` does, ``p + u`` cast to p's dtype, so a bfloat16
    param stays bfloat16.
    """
    def init(params):
        return (params, optimizer.init(params))

    def step(carry, batch):
        params, opt_state = carry
        out, grads = _value_and_grad(loss_fn, params, batch, has_aux)
        updates, opt_state = optimizer.update(
            _unflatten(params, grads), opt_state, params)
        return (apply_updates(params, updates), opt_state), out

    return init, step


def apply_updates(params, updates):
    """``p + u`` in p's dtype for each param (``optax.apply_updates``); in
    place under ``scan_steps(..., donate=True)``."""
    donated = _DONATED.get()

    def apply(p, u):
        with torch.no_grad():
            return p.add_(u) if donated else (p + u).to(p.dtype)

    return tree_map(apply, params, updates)


# ---- the optimizers (optax's transforms) ------------------------------------

class GradientTransformation(NamedTuple):
    """An optimizer as optax's: ``init(params) -> state`` and
    ``update(grads, state, params=None) -> (updates, state)``."""
    init: Callable
    update: Callable


def rmsprop_rule(g, state, group):
    """``optax.rmsprop(lr, decay, eps)`` on one tensor: ``nu = (1 - decay)
    g**2 + decay nu``, update ``-lr * rsqrt(nu + eps) * g``."""
    decay = group['decay']
    nu = state.get('nu', torch.zeros_like(g))
    nu = (1 - decay) * g ** 2 + decay * nu
    state['nu'] = nu
    return torch.rsqrt(nu + group['eps']) * g * (-group['lr'])


def adam_rule(g, state, group):
    """``optax.adam(lr, b1, b2, eps)`` on one tensor: the moments' EMAs,
    their bias corrections ``1 - b**count``, update ``-lr * mu_hat /
    (sqrt(nu_hat) + eps)``."""
    b1, b2 = group['b1'], group['b2']
    count = state.get('count', 0) + 1
    mu = (1 - b1) * g + b1 * state.get('mu', torch.zeros_like(g))
    nu = (1 - b2) * g ** 2 + b2 * state.get('nu', torch.zeros_like(g))
    state.update(count=count, mu=mu, nu=nu)
    mu_hat = mu / (1 - b1 ** count)
    nu_hat = nu / (1 - b2 ** count)
    return mu_hat / (torch.sqrt(nu_hat) + group['eps']) * (-group['lr'])


def sgd_rule(g, state, group):
    """``optax.sgd(lr, momentum)`` on one tensor: ``trace = g + momentum *
    trace`` (no trace without momentum), update ``-lr * trace``."""
    if group['momentum'] is None:
        return g * (-group['lr'])
    trace = g + group['momentum'] * state.get('trace', torch.zeros_like(g))
    state['trace'] = trace
    return trace * (-group['lr'])


def _transform(rule, group):
    """A `GradientTransformation` applying `rule` to each gradient leaf;
    the state is one dict a leaf, replaced (never mutated) by `update`."""
    def init(params):
        return [{} for _ in tree_leaves(params)]

    def update(grads, state, params=None):
        new_state = [dict(s) for s in state]
        ups = [rule(g, s, group)
               for g, s in zip(tree_leaves(grads), new_state)]
        return _unflatten(grads, ups), new_state

    return GradientTransformation(init, update)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    """``optax.adam``."""
    return _transform(adam_rule, dict(lr=learning_rate, b1=b1, b2=b2,
                                      eps=eps))


def rmsprop(learning_rate, decay=0.9, eps=1e-8):
    """``optax.rmsprop`` (its defaults; torch's RMSprop is another rule)."""
    return _transform(rmsprop_rule, dict(lr=learning_rate, decay=decay,
                                         eps=eps))


def sgd(learning_rate, momentum=None):
    """``optax.sgd``."""
    return _transform(sgd_rule, dict(lr=learning_rate, momentum=momentum))


# ---- the loops --------------------------------------------------------------

def scan_steps(step_fn, carry, xs=None, *, length=None, donate=False):
    """Run `length` (or ``len(xs)``) steps of `step_fn` in a host loop.

    ``step_fn(carry, x) -> (carry, out)`` runs over `xs` (a tree of
    tensors with a leading steps axis, e.g. a stacked chunk of batches,
    step i getting slice i) or, with ``xs=None``, `length` times with
    ``x=None``.  Returns ``(final_carry, outs)``, the outputs stacked on a
    leading axis on their device (None for no steps).

    With ``donate=False`` the caller's carry tensors are left as they
    were.  With ``donate=True`` the steps built by `make_sgd_step` and
    `make_optax_step` update the carry's parameters in place (no copy of
    the carry: JAX's buffer donation); the caller's pre-call tensors then
    hold the final values.
    """
    if xs is None and length is None:
        raise ValueError("scan_steps: provide xs and/or length")
    if xs is not None:
        sizes = {x.shape[0] for x in tree_leaves(xs)}
        if len(sizes) != 1 or (length is not None
                               and sizes != {int(length)}):
            raise ValueError(f"scan_steps: xs' leading axes {sorted(sizes)} "
                             f"and length {length} disagree")
        length = sizes.pop()
    token = _DONATED.set(bool(donate))
    try:
        outs = []
        for i in range(int(length)):
            x = None if xs is None else tree_map(lambda a: a[i], xs)
            carry, out = step_fn(carry, x)
            outs.append(out)
    finally:
        _DONATED.reset(token)
    return carry, _stack(outs)


def _host(x):
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def fit(step_fn, carry, batches=None, *, num_steps, steps_per_dispatch=32,
        donate=False):
    """Chunked training driver: `steps_per_dispatch` steps a host round
    trip.

    `batches` is an iterable yielding one batch tree a step (a data
    pipeline), or None for batch-free losses.  Each chunk of batches is
    stacked on a leading axis and run by `scan_steps`, and the chunk's
    losses are read to the host once.  A pipeline that runs dry ends the
    loop early.

    Returns ``(carry, losses)`` with `losses` a host numpy array of the
    per-step outputs (the step's second output must be a scalar; use
    `scan_steps` for structured outputs).
    """
    if num_steps <= 0:
        raise ValueError("fit: num_steps must be positive")
    if steps_per_dispatch <= 0:
        raise ValueError("fit: steps_per_dispatch must be positive")
    it = iter(batches) if batches is not None else None
    losses = []
    done = 0
    while done < num_steps:
        k = min(steps_per_dispatch, num_steps - done)
        if it is None:
            xs, n = None, k
        else:
            chunk = []
            for _ in range(k):
                try:
                    chunk.append(next(it))
                except StopIteration:
                    break
            if not chunk:
                break   # the data pipeline ran dry
            xs = tree_map(lambda *leaves: torch.stack(leaves), *chunk)
            n = None    # the length is xs' leading axis
            k = len(chunk)
        carry, out = scan_steps(step_fn, carry, xs, length=n, donate=donate)
        losses.append(_host(out))
        done += k
    if not losses:   # the pipeline was empty before the first step
        return carry, np.zeros((0,))
    return carry, np.concatenate(losses)
