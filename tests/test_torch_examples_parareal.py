"""The port's parareal_demo (`torchdiffeq_tpu_torch/examples/parareal_demo.py`)
against the JAX package's Parareal on the demo's problem
(examples/parareal_demo.py, which runs at import, so its field is written
out here, lines 38-41), in float64 at 8 slices: the values to 1e-10
relative and the correction norms JAX puts above 1e-12 to 1e-8 relative
(with tests/test_torch_parareal.py's floor of 1e-13 of max|y|); and the
demo's `main` whole, its `--mesh` handling and its default device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdiffeq_tpu.parallel import odeint_parareal_with_info as j_info
from torchdiffeq_tpu_torch.examples import parareal_demo
from test_torch_examples import one_thread  # noqa: F401 (autouse)


def j_field(t, y):
    x, v = y[0], y[1]
    return jnp.stack([v, -x - 0.05 * v + 0.3 * jnp.sin(1.3 * t)])


def test_main_matches_jax_parareal(capsys):
    out = parareal_demo.main(['--device', 'cpu', '--slices', '8'],
                             dtype=torch.float64)
    assert capsys.readouterr().out.rstrip().endswith('ok')
    t = np.linspace(0.0, 20.0, 9)
    ys_j, d_j = jax.jit(lambda y: j_info(
        j_field, y, jnp.asarray(t), rtol=1e-6, atol=1e-8,
        coarse_num_steps=4, n_iters=5))(jnp.array([1.0, 0.0]))
    ys_j, d_j = np.asarray(ys_j), np.asarray(d_j)
    scale = np.abs(ys_j).max()
    np.testing.assert_allclose(out['ys'].numpy(), ys_j, rtol=0,
                               atol=1e-10 * scale)
    big = d_j > 1e-12
    np.testing.assert_allclose(out['deltas'].numpy()[big], d_j[big],
                               rtol=1e-8, atol=1e-13 * scale)
    assert out['err'] < 100 * 1e-6


def test_main_float32_defaults_and_mesh_on_one_device(capsys):
    """The demo's own dtype (float32), 8 slices, ``--mesh`` with one
    device: JAX's message, and the run ends in its ok."""
    out = parareal_demo.main(['--device', 'cpu', '--slices', '8', '--mesh'])
    text = capsys.readouterr().out
    assert "--mesh ignored: only one device visible" in text
    assert text.rstrip().endswith('ok') and out['ys'].dtype == torch.float32


def test_mesh_over_several_cards_raises(monkeypatch):
    """With several ranks in the launch (torchrun's WORLD_SIZE) the demo
    builds a mesh of cards over them, which with no card raises rather
    than fall back to the CPU (its 2-rank CPU run is in
    tests/test_torch_sharding.py)."""
    monkeypatch.setenv('WORLD_SIZE', '4')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    args = parareal_demo.parser.parse_args(['--mesh', '--slices', '8'])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parareal_demo._mesh(args, torch.device('cuda'))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parareal_demo.main([])
