"""PyTorch/CUDA port of ``colvo`` for NVIDIA Hopper (H100).

Same layout as the JAX package: ``config``, ``geometry``, ``kernels``,
``models``, ``losses``, ``runtime``, ``data``. Public functions keep the
JAX package's tensor layouts (frames (B, F, H, W, 3), disparities
(B, h, w, 1), coords (B, h, w, 2)); convolutions run NCHW inside the
modules. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, and raise when asked for a card that is not there.
Under a ``torch.distributed`` launcher each rank's ``"cuda"`` is its own
card, ``cuda:LOCAL_RANK``.

This package imports torch and numpy only, never jax or ``colvo``.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    but absent (there is no silent drop to the CPU). A bare ``"cuda"`` in
    a rank of a process group is ``cuda:LOCAL_RANK``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "colvo_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    if (device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ
            and torch.distributed.is_available() and torch.distributed.is_initialized()):
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


__all__ = ["resolve_device"]
