"""Model fields (neural-ODE MLP fields, ODE blocks) and the affine event
family."""
from .neural_ode import (LinearEvent, MLPField, init_mlp, mlp_apply,
                         mlp_vector_field, spiral_field, init_spiral_model,
                         mlp_params_from_jax, ode_block)

__all__ = ['LinearEvent', 'MLPField', 'init_mlp', 'mlp_apply',
           'mlp_vector_field', 'spiral_field', 'init_spiral_model',
           'mlp_params_from_jax', 'ode_block']
