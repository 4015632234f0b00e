"""Each of the port's examples run whole through its `main(argv)` on the
CPU (``--device cpu``), in-process, at the configurations
tests/test_examples.py runs the JAX examples at, meeting the example's own
assertions; and, on a machine with no card, each example's default device
raising rather than falling back to the CPU.

One cut, because the port's CPU path is slower there than JAX's compiled
one: cnf runs 4 iterations where tests/test_examples.py runs 25 (about
4 s an iteration of 512 samples on one CPU worker).  cnf asserts nothing;
its loss must stay finite and fall.  The physics examples are in
test_torch_examples_run_events.py.
"""
import math

import pytest

from torchdiffeq_tpu_torch.examples import (bouncing_ball, cnf, ensemble,
                                            latent_ode, learn_physics,
                                            ode_demo, odenet_mnist)
from test_torch_examples import one_thread  # noqa: F401 (autouse)

CPU = ["--device", "cpu"]


def test_ode_demo_runs():
    out = ode_demo.main(["--niters", "20", "--test_freq", "20",
                         "--data_size", "120"] + CPU)
    assert math.isfinite(out["test_loss"]) and out["test_loss"] < 2.0


def test_latent_ode_runs():
    out = latent_ode.main(["--niters", "12", "--nspiral", "8"] + CPU)
    assert math.isfinite(out["loss"])
    assert tuple(out["zs_b"].shape) == (11, 4)
    assert tuple(out["zs_f"].shape) == (21, 4)


def test_cnf_runs():
    first = cnf.main(["--niters", "1"] + CPU)["loss"]
    out = cnf.main(["--niters", "4"] + CPU)
    assert math.isfinite(out["loss"]) and out["loss"] < first


@pytest.mark.parametrize("network", ["odenet", "resnet"])
def test_odenet_mnist_runs(network):
    out = odenet_mnist.main(["--nepochs", "1", "--steps_per_epoch", "12",
                             "--hidden", "8", "--batch_size", "32",
                             "--network", network] + CPU)
    assert math.isfinite(out["loss"]) and 0.0 <= out["acc"] <= 1.0


@pytest.mark.parametrize("module,argv", [
    (ensemble, ["--batch", "4"]), (ode_demo, ["--niters", "1"]),
    (latent_ode, ["--niters", "1"]), (cnf, ["--niters", "1"]),
    (odenet_mnist, ["--nepochs", "1"]), (bouncing_ball, []),
    (learn_physics, ["--niters", "1"])])
def test_examples_default_to_the_card(module, argv):
    """Without a card the default ``--device cuda`` raises; nothing falls
    back to the CPU quietly."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
