"""Plain PyTorch reference of what the benchmark's cells compute.

A frozen copy of the arithmetic of ColVO's model (ResNet encoders, the
Monodepth2 depth decoder, the pose decoder with optional DCDP fusion),
its self-supervised loss, the geometry and the bilinear sampler, Adam in
optax's order, and the two loaders' gather and augmentation. Everything
runs in float32 with TF32 off (``precise``); ``quant.fp8`` is the control
that rounds every convolution's operands to float8. Nothing here imports
``jax``, ``colvo`` or ``colvo_torch``; weights are handed in as a dict
keyed by the program's ``state_dict`` names.
"""

import contextlib

import torch


@contextlib.contextmanager
def precise():
    """float32 matmuls and convolutions without TF32 (restored on exit)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
