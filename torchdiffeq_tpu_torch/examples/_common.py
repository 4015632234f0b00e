"""What the examples share: the device flag and the default dtype."""
from __future__ import annotations

import contextlib

import torch


def add_device_flag(parser):
    parser.add_argument('--device', default='cuda',
                        help="the device the example runs on (default the "
                        "card; 'cpu' runs it on the CPU)")
    return parser


def device_of(name):
    """The torch device `name`; a CUDA device that is not there raises
    rather than fall back to the CPU."""
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the examples run on the card; "
                           "pass --device cpu to run one on the CPU")
    return device


@contextlib.contextmanager
def default_dtype(dtype):
    """torch's default dtype set to `dtype` inside the block (the port's
    counterpart of ``jax_enable_x64`` for float64)."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(before)
