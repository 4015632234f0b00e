"""Model fields (neural-ODE MLP fields) and the affine event family."""
from .neural_ode import (LinearEvent, MLPField, init_mlp, mlp_apply,
                         spiral_field, init_spiral_model, mlp_params_from_jax)

__all__ = ['LinearEvent', 'MLPField', 'init_mlp', 'mlp_apply', 'spiral_field',
           'init_spiral_model', 'mlp_params_from_jax']
