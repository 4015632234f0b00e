"""Model fields (neural-ODE MLP fields, the conv ODE-Net field, ODE blocks)
and the affine event family."""
from .conv_ode import (ConvField, concat_time, conv_apply, conv_apply_foldt,
                       conv_field, conv_field_flops, conv_field_foldt,
                       conv_params_from_jax, group_norm, init_conv,
                       init_conv_field)
from .neural_ode import (LinearEvent, MLPField, init_mlp, mlp_apply,
                         mlp_vector_field, spiral_field, init_spiral_model,
                         mlp_params_from_jax, ode_block)

__all__ = ['LinearEvent', 'MLPField', 'init_mlp', 'mlp_apply',
           'mlp_vector_field', 'spiral_field', 'init_spiral_model',
           'mlp_params_from_jax', 'ode_block', 'ConvField', 'concat_time',
           'conv_apply', 'conv_apply_foldt', 'conv_field', 'conv_field_flops',
           'conv_field_foldt', 'conv_params_from_jax', 'group_norm',
           'init_conv', 'init_conv_field']
