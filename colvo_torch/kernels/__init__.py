"""Hand-written CUDA kernels under the training loss (``colvo/kernels``'
ports) and their plain PyTorch versions, a module a kernel: ``sampler``
(S), ``scatter`` (T), ``project`` (P), ``fused_loss`` (F), ``lcc`` (L),
``ssim`` (E), ``factor_attention`` (FA), ``attention``, ``adam`` (A, the
optimizer's update); ``window`` holds
the plain windowed statistics, ``build`` what the wrappers share. Each
module chooses in one place by the tensor's device (CUDA: the kernel;
CPU: the plain version) and imports nothing of ``colvo_torch`` above this
package, which the loss imports (but the span recorder of the launch
counters, inside functions).
"""

from __future__ import annotations

from typing import Dict

from colvo_torch.kernels import build
from colvo_torch.kernels.adam import adam_update, clip_global_norm
from colvo_torch.kernels.attention import attention
from colvo_torch.kernels.factor_attention import factor_attention
from colvo_torch.kernels.fused_loss import fused_error
from colvo_torch.kernels.lcc import lcc_window
from colvo_torch.kernels.project import project_depth
from colvo_torch.kernels.sampler import (
    bilinear_sample_fast,
    bilinear_sample_grouped_planes,
    bilinear_sample_planes,
)
from colvo_torch.kernels.scatter import (
    bilinear_sample_full,
    bilinear_sample_full_multi,
    bilinear_sample_full_planes,
)
from colvo_torch.kernels.ssim import ssim_error


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset: ``S/grad/C3``,
    ``S/grad/C3/g4``, ``S/value/C1``, ``T/C1``, ``F/fwd/C3``, ``F/bwd/C3``,
    ``P/fwd``, ``P/bwd``, ``L/affine``, ``E/fwd/C3``, ``E/bwd/C3``,
    ``FA/fwd``, ``FA/bwd``, ``attn/fwd``, ``A/sumsq``, ``A/clip``,
    ``A/step``, ... (only CUDA launches count;
    the plain versions do not). They are the counters ``launch.<key>`` of ``runtime.spans``,
    which count whether it records or not (``spans.tally``)."""
    from colvo_torch.runtime import spans  # the runtime package imports this one

    return {k[len(build.LAUNCH):]: v for k, v in spans.counters(build.LAUNCH).items()}


def reset_launch_counts() -> None:
    from colvo_torch.runtime import spans

    spans.reset_counters(build.LAUNCH)


def add_launch_counts(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` × ``counts`` (keyed as ``launch_counts`` gives them):
    the launches of a CUDA graph replayed ``times`` times. The wrappers
    count a launch where Python calls them, so a captured launch is
    counted at capture, which launches nothing, and not at a replay."""
    from colvo_torch.runtime import spans

    for key, n in counts.items():
        spans.tally(build.LAUNCH + key, n * times)


__all__ = [
    "adam_update",
    "clip_global_norm",
    "attention",
    "factor_attention",
    "bilinear_sample_fast",
    "bilinear_sample_full",
    "bilinear_sample_planes",
    "bilinear_sample_full_planes",
    "bilinear_sample_full_multi",
    "bilinear_sample_grouped_planes",
    "fused_error",
    "project_depth",
    "lcc_window",
    "ssim_error",
    "launch_counts",
    "reset_launch_counts",
    "add_launch_counts",
]
