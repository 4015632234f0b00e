"""The tracer of the per-lane kernels' fields (`ops/traced.py`) on the CPU.

* The C++ it emits for the ensemble example's field and event, for a field
  with a shared matrix arg, and for an `MLPField`: its structure (the
  functors, the per-lane and shared loads, each operation in the graph's
  order and PyTorch's rounding: a power by 2 as a product, a scalar over a
  tensor as a reciprocal times the scalar) and its entry points.  The card
  compiles and runs it (tests/test_torch_cuda.py).
* The method's tableau compiled into the instance, for every explicit
  method and state dtype: each constant bit for bit ``packed_tableau``'s
  nonzero entry, no zero entry, and no tableau read from memory.
* A field or event outside the traced op set raises ``TypeError`` naming
  the operation.
* The per-lane route's plain version against JAX's Pallas kernel in
  interpret mode on the same ``pallas=True`` calls, for these fields: float64,
  every counter exactly, values to 1e-12.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdiffeq_tpu.parallel import (
    odeint_per_sample_with_stats as j_per_sample)
import torchdiffeq_tpu_torch as tt
from torchdiffeq_tpu_torch.models import MLPField
from torchdiffeq_tpu_torch.ops import kernels, traced
from torchdiffeq_tpu_torch.ops.traced import PerSampleEvent, PerSampleField
from test_torch_examples import one_thread  # noqa: F401 (autouse)


def osc(t, y, om):
    """examples/ensemble.py:46-48 (the port's examples/ensemble.field)."""
    return torch.stack([y[1], -om ** 2 * y[0] - 0.1 * y[1]])


W = np.array([[0.3, -1.2], [1.1, 0.2]])


def shared(t, y, Wt, k):
    return torch.tanh(y @ Wt) * k - 0.1 * y * torch.sum(y * y)


def j_shared(t, y, Wj, k):
    return jnp.tanh(y @ Wj) * k - 0.1 * y * jnp.sum(y * y)


def timed(t, y, k):
    return torch.stack([y[1] * torch.cos(t),
                        -k * torch.sin(y[0]) - 0.2 * y[1]])


def j_timed(t, y, k):
    return jnp.stack([y[1] * jnp.cos(t), -k * jnp.sin(y[0]) - 0.2 * y[1]])


def _lanes(B=8, dtype=torch.float64):
    y0 = torch.stack([torch.linspace(0.5, 1.5, B, dtype=dtype),
                      torch.zeros(B, dtype=dtype)])
    return y0, torch.linspace(1.0, 9.0, B, dtype=dtype)


@pytest.mark.parametrize("dtype,ctype", [(torch.float32, "float"),
                                         (torch.float64, "double")])
def test_ensemble_field_and_event_source(dtype, ctype):
    y0, om = _lanes(dtype=dtype)
    src = traced.events_source(PerSampleField(osc, (om,), (-1,)),
                               PerSampleEvent(lambda t, y: y[0]), y0, 'dopri5')
    code = src.source
    assert f"using T = {ctype};" in code
    assert '#include "traced_field.cuh"' in code
    assert "#define TDT_MAX_ALPHA 6" in code
    # one per-lane arg, read lanes-major like the state
    assert "T a[1];" in code and "a[p] = lane[(size_t)p * B + b];" in code
    # om ** 2 is a product, as PyTorch's pow kernel computes it, then the
    # graph's order: -(om*om) * y0 - y1 * 0.1
    body = code[code.index("struct Field"):code.index("struct Event")]
    assert body.index("a[0] * a[0]") < body.index("* y[0]") \
        < body.index("y[1] * T(0.1)")
    assert "out[0] =" in body and "out[1] =" in body
    # the event's one output, sign-combined inside its functor
    event = code[code.index("struct Event"):]
    assert "T s0[1];" in event and "y[0] * s0[0]" in event
    assert "tdt_traced_events" in code
    assert ("tdt_events::launch_traced<T, 2, Field, Event, MethodTableau>"
            in code)
    assert src.K == 1 and src.field_ops == 5 and len(src.lane_args) == 1


_BITS = {torch.float32: torch.int32, torch.float64: torch.int64,
         torch.bfloat16: torch.int16, torch.float16: torch.int16}
_CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"


def _function(path, name):
    """The text of the function `name` in a csrc header, up to its end."""
    text = (_CSRC / path).read_text()
    start = text.index(f"{name}(")
    return text[start:text.index("\n}\n", start)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16])
@pytest.mark.parametrize("method", kernels.PER_LANE_METHODS)
def test_tableau_compiled_into_the_instance(method, dtype):
    """A traced instance holds its method's tableau as constants of its
    source (csrc/lane_ops.cuh's compiled kind, `MethodTableau`): every
    nonzero entry of ``packed_tableau(method, dtype)`` by its packed index,
    in order, as a double whose value in the state dtype has the packed
    tensor's bits; no zero entry; n_alpha, fsal and 1/order.  The instance
    reads no tableau from memory: its entry points and the traced kernels
    take none, and stage none in shared memory."""
    y0, om = _lanes(dtype=dtype)
    field = PerSampleField(osc, (om.to(dtype),), (-1,))
    code = traced.events_source(field, PerSampleEvent(lambda t, y: y[0]),
                                y0.to(dtype), method).source
    lanes = traced.field_source(field, y0.to(dtype), method).source
    packed, n_alpha, order, fsal = kernels.packed_tableau(
        method, dtype, torch.device("cpu"))
    for src in (code, lanes):
        struct = src[src.index("struct MethodTableau"):
                     src.index("struct Field")]
        cases = re.findall(r"case (\d+): return ([^;]+);", struct)
        nonzero = torch.nonzero(packed).flatten().tolist()
        assert [int(i) for i, _ in cases] == nonzero
        vals = torch.tensor([float(v) for _, v in cases], dtype=torch.float64)
        assert torch.equal(vals.to(dtype).double(), vals)
        assert torch.equal(vals.to(dtype).view(_BITS[dtype]),
                           packed[nonzero].view(_BITS[dtype]))
        assert f"static constexpr int n_alpha = {n_alpha};" in struct
        assert (f"static constexpr bool fsal = {str(fsal).lower()};"
                in struct)
        assert f"static constexpr double inv_order = {1.0 / order!r};" \
            in struct
        assert f"#define TDT_MAX_ALPHA {n_alpha}" in src
    entries = (code[code.index('extern "C"'):],
               lanes[lanes.index('extern "C"'):])
    for entry in entries:
        assert not re.search(r"\btab\b|n_alpha|order|fsal", entry)
        assert "MethodTableau>(" in entry
    for path, name in (("dopri5_lanes.cuh", "lanes_traced_kernel"),
                       ("dopri5_lanes.cuh", "int launch_traced"),
                       ("dopri5_events.cuh", "events_traced_kernel"),
                       ("dopri5_events.cuh", "int launch_traced")):
        text = _function(path, name)
        assert not re.search(r"\btab\b|TDT_TAB_SIZE|tableau_from_shared",
                             text), name


def test_shared_matrix_field_source():
    y0, k = _lanes()
    Wt = torch.from_numpy(W)
    src = traced.field_source(PerSampleField(shared, (Wt, k), (None, -1)),
                              y0, 'dopri5')
    code = src.source
    # y @ W: each output the ordered sum of its products of shared loads
    assert "((y[0] * s[0]) + y[1] * s[2])" in code
    assert "((y[0] * s[1]) + y[1] * s[3])" in code
    assert "tdt::dtanh<T>(" in code and "a[0]" in code
    assert "tdt_lanes::launch_traced<T, 2, Field, MethodTableau>" in code
    assert [tuple(x.shape) for x in src.shared] == [(2, 2)]
    assert torch.equal(src.buffer(src.shared, torch.float64, "cpu"),
                       Wt.reshape(-1))
    assert torch.equal(src.lane_buffer(8, torch.float64, "cpu"), k[None])


def test_reciprocal_and_time_source():
    y0, k = _lanes()
    src = traced.field_source(PerSampleField(
        lambda t, y, kk: 1.0 / (1.0 + y * y) * kk + torch.cos(t), (k,),
        (-1,)), y0, 'dopri5')
    code = src.source
    # a scalar over a tensor: the reciprocal, then the product by 1.0, as
    # Tensor.__rtruediv__ computes it; the time reaches the functor
    assert "T(1) / v" in code and "* T(1.0)" in code
    assert "tdt::tcos<T>(t)" in code


def test_mlp_field_source():
    """An MLPField traced (the route an MLPField takes with a traced event):
    y**3 as (y*y)*y, the products' ordered sums over the shared weights."""
    y0, _ = _lanes()
    model = MLPField([2, 3, 2], power=3, dtype=torch.float64, device="cpu")
    src = traced.field_source(PerSampleField(model), y0, 'dopri5')
    assert "y[0] * y[0] * y[0]" in src.source
    assert src.source.count("tdt::dtanh<T>(") == 3
    assert [tuple(x.shape) for x in src.shared] == [(2, 3), (3,), (3, 2),
                                                    (2,)]


@pytest.mark.parametrize("func,op", [
    (lambda t, y: torch.nn.functional.elu(y), "aten.elu"),
    (lambda t, y: torch.sinh(y), "aten.sinh"),
    (lambda t, y: y.to(torch.float32).to(torch.float64), "aten._to_copy"),
    (lambda t, y: y if y[0] > 0 else -y, "torch.fx could not trace"),
    (lambda t, y: torch.cumsum(y, 0), "aten.cumsum"),
])
def test_ops_outside_the_set_raise_naming_them(func, op):
    y0, _ = _lanes()
    with pytest.raises(TypeError, match=op.replace(".", r"\.")):
        traced.field_source(PerSampleField(func), y0, 'dopri5')


def test_event_outside_the_set_and_16bit_states_raise():
    """An event outside the traced op set and a per-lane arg of another
    dtype raise.  A bfloat16 state, refused here until the 16-bit traced
    instances, now traces (the name is kept): its instance computes on
    tdt::bf16, and the plain route of the same field equals JAX's Pallas
    kernel in interpret mode bit for bit, compiled as
    tests/test_torch_lanes_16bit.py compiles it (ROADMAP C11)."""
    from test_torch_lanes_16bit import _jax_exact
    y0, om = _lanes()
    with pytest.raises(TypeError, match=r"aten\.erf"):
        traced.events_source(PerSampleField(osc, (om,), (-1,)),
                             PerSampleEvent(lambda t, y: torch.erf(y[0])),
                             y0, 'dopri5')
    with pytest.raises(TypeError, match="per-lane arg"):
        traced.field_source(PerSampleField(osc, (om.float(),), (-1,)), y0,
                            'dopri5')
    src = traced.field_source(PerSampleField(osc, (om.bfloat16(),), (-1,)),
                              y0.to(torch.bfloat16), 'dopri5')
    assert "using T = tdt::bf16;" in src.source
    t = np.linspace(0.0, 1.5, 4)
    y0n = np.stack([np.linspace(0.5, 1.5, 12), np.zeros(12)], axis=1)
    omn = np.linspace(1.0, 9.0, 12)
    kw = dict(args_axes=(-1,), rtol=1e-2, atol=1e-3,
              options=dict(pallas=True, interpret=True))
    ys_j, st_j = _jax_exact(
        lambda y, w: j_per_sample(CASES["oscillators"][1], y, t, args=(w,),
                                  **kw),
        jnp.asarray(y0n, jnp.bfloat16), jnp.asarray(omn, jnp.bfloat16))
    with torch.no_grad():
        ys_t, st_t = tt.odeint_per_sample_with_stats(
            osc, torch.from_numpy(y0n).bfloat16(), torch.from_numpy(t),
            args=(torch.from_numpy(omn).bfloat16(),), **kw)
    for a, b in zip(st_t[:5], st_j[:5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        ys_t.float().numpy(), np.asarray(ys_j.astype(jnp.float32)))


CASES = {
    "oscillators": (osc, lambda t, y, om: jnp.stack(
        [y[1], -om ** 2 * y[0] - 0.1 * y[1]]), lambda B: (
            np.linspace(1.0, 9.0, B),), (-1,)),
    "shared_matrix": (shared, j_shared, lambda B: (
        W, np.linspace(0.5, 2.0, B)), (None, -1)),
    "time": (timed, j_timed, lambda B: (np.linspace(0.5, 2.0, B),), (-1,)),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("event", [False, True])
def test_plain_route_matches_jax_interpret_kernel(name, event):
    """`odeint_per_sample_with_stats(..., options=dict(pallas=True))` on the
    CPU (the kernels' plain versions) against JAX's Pallas kernels in
    interpret mode, float64: every counter exactly, values to 1e-12.  With
    `event`, two outputs sign-combined per sample (the first zero of x, a
    cut-off at t=0.7)."""
    t_func, j_func, make_args, axes = CASES[name]
    B = 12
    args = make_args(B)
    y0 = np.stack([np.linspace(0.5, 1.5, B), np.zeros(B)], axis=1)
    kw = dict(args_axes=axes, rtol=1e-7, atol=1e-9)
    if event:
        t = np.array([0.0, 2.0])
        kw_t = dict(kw, event_fn=lambda tt_, y: torch.stack(
            [y[0], (0.7 - tt_).to(y.dtype)]))
        kw_j = dict(kw, event_fn=lambda tt_, y: jnp.stack([y[0], 0.7 - tt_]))
    else:
        t = np.linspace(0.0, 1.5, 4)
        kw_t = kw_j = kw
    out_j, st_j = j_per_sample(j_func, jnp.asarray(y0), jnp.asarray(t),
                               args=tuple(jnp.asarray(a) for a in args),
                               options=dict(pallas=True, interpret=True),
                               **kw_j)
    with torch.no_grad():
        out_t, st_t = tt.odeint_per_sample_with_stats(
            t_func, torch.from_numpy(y0), torch.from_numpy(t),
            args=tuple(torch.from_numpy(np.asarray(a)) for a in args),
            options=dict(pallas=True), **kw_t)
    for a, b in zip(st_t[:5], st_j[:5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    outs = zip(out_t, out_j) if event else [(out_t, out_j)]
    for a, b in outs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12 * float(np.abs(b).max()))
