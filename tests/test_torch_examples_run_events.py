"""The port's event examples run whole through `main(argv)` on the CPU
(``--device cpu``), in-process, at the configurations of
tests/test_examples.py, each meeting its own assertions: bouncing_ball (the
first bounce against its closed form, the five gradients against finite
differences, in float64), learn_physics (120 iterations, gravity within 0.5
of 9.8) and ensemble (B=64: the kernel route within 1e-2 of the driver, the
first zeros within 5% of pi/(2 omega))."""
import torch

from torchdiffeq_tpu_torch.examples import (bouncing_ball, ensemble,
                                            learn_physics)
from test_torch_examples import one_thread  # noqa: F401 (autouse)

CPU = ["--device", "cpu"]


def test_bouncing_ball_runs():
    out = bouncing_ball.main(CPU)
    assert abs(out["times"][0] - out["exact"]) < 1e-6
    assert len(out["grads"]) == 5
    # float64 inside main only
    assert torch.get_default_dtype() == torch.float32


def test_learn_physics_runs():
    out = learn_physics.main(["--niters", "120"] + CPU)
    assert abs(out["gravity"] - learn_physics.TRUE_GRAVITY) < 0.5


def test_ensemble_runs():
    out = ensemble.main(["--batch", "64"] + CPU)
    assert out["err"] < 1e-2 and out["rel"] < 0.05
    assert int(out["steps"].max()) > 10 * int(out["steps"].min())
