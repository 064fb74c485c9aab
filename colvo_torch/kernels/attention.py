"""Multi-head attention softmax(q·kᵀ/√d)·v, the DPT depth net's only
attention.

On a CUDA tensor ``F.scaled_dot_product_attention`` runs with its backends
pinned to FlashAttention, cuDNN's fused attention or the memory-efficient
kernel: the math backend, which materialises the score matrix in several
kernels, is not allowed, so an input no fused kernel takes raises instead
of running ~10× slower. Each call counts as ``attn/fwd``
(``kernels.launch_counts``); the backward is the chosen kernel's own. On a
CPU tensor the plain softmax runs, in the input's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from colvo_torch.kernels import build


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v over (B, heads, N, d) tensors."""
    scores = torch.matmul(q, k.transpose(-2, -1)) * (1.0 / math.sqrt(q.shape[-1]))
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v over (B, heads, N, d) tensors → (B, heads, N, d);
    a fused kernel on the card (see the module's docstring)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        out = F.scaled_dot_product_attention(q, k, v)
    build.count_launch("attn/fwd")
    return out
