"""The JAX package's examples (``examples/*.py``) on the port.

One module per example, under the same name, each runnable with
``python -m torchdiffeq_tpu_torch.examples.<name>`` and through
``main(argv)``: `ensemble`, `ode_demo`, `latent_ode`, `cnf`,
`odenet_mnist`, `bouncing_ball`, `learn_physics` and `parareal_demo`.
Each takes its JAX example's flags and defaults, plus ``--device`` (default ``cuda``: with no
card it raises; ``--device cpu`` runs on the CPU).  Module-level functions
carry the JAX example's names and take their random draws as arguments;
``main`` draws them with a ``torch.Generator`` seeded from ``--seed``.
Each example with parameters has a ``params_from_jax``.
"""
