"""Model fields (neural-ODE MLP fields)."""
from .neural_ode import (MLPField, init_mlp, mlp_apply, spiral_field,
                         init_spiral_model, mlp_params_from_jax)

__all__ = ['MLPField', 'init_mlp', 'mlp_apply', 'spiral_field',
           'init_spiral_model', 'mlp_params_from_jax']
