"""Batched solves with per-sample step control, Parareal, and the device
mesh on torch.distributed (`sharding.py`: one process a rank)."""
from .batched import odeint_per_sample, odeint_per_sample_with_stats
from .parareal import odeint_parareal, odeint_parareal_with_info
from .sharding import (Mesh, TensorParallelMLP, data_parallel_odeint,
                       make_mesh, shard_params, sharded_independent_odeint,
                       tensor_parallel_mlp)

__all__ = ['odeint_per_sample', 'odeint_per_sample_with_stats',
           'odeint_parareal', 'odeint_parareal_with_info', 'Mesh',
           'make_mesh', 'data_parallel_odeint', 'sharded_independent_odeint',
           'shard_params', 'tensor_parallel_mlp', 'TensorParallelMLP']
