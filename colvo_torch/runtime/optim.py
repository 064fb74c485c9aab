"""Adam and AdamW as optax computes them, with the first moment stored in
``mu_dtype`` (float32, or bf16 under ``train.adam_mu_dtype="bfloat16"``, as
optax's ``scale_by_adam(mu_dtype=)``).

``torch.optim.Adam`` keeps its moments in the parameter's dtype and orders
its arithmetic otherwise, so the port has its own, in optax's order of
operations:

    μ' = (1 − b1)·g + b1·μ      (f32; with a bf16 μ, b1·μ is a bf16
                                 product, b1 rounded to bf16, as JAX types
                                 a Python scalar times a bf16 array)
    ν' = (1 − b2)·g² + b2·ν     (f32)
    u  = (μ' / (1 − b1^t)) / (sqrt(ν' / (1 − b2^t)) + eps)
    u += wd·p                   (AdamW: optax's ``add_decayed_weights``)
    p += −lr·u

and μ' is stored back in ``mu_dtype`` (rounded to nearest even in bf16);
ν stays f32. The update uses the f32 μ', not its rounded copy. A step is
``kernels.adam_update`` over each parameter group: on CUDA one launch of
kernel A (``A/step``, ``kernels/csrc/adam.cu``) over the whole group, which
reads and writes each byte of the state once; on the CPU the plain chain
of ``torch._foreach_*`` passes (``kernels.adam.step_plain``), whose bits A
gives. The step counts live on their parameter's device, whatever
``capturable`` says (a count a checkpoint brought on the host moves there
at the next step), so A reads no host scalar; with ``capturable=True`` the
learning rate may be a device tensor in the group (``lr``) too, and a CUDA
graph can capture the step. The tables of A's launches are the
optimizer's own, outside its state (``kernels.adam.Plans``). State keys
and ``param_groups`` are those of ``torch.optim.Adam`` (``step``,
``exp_avg``, ``exp_avg_sq``; ``lr``, ``capturable``), so checkpoints and
the captured chunk treat both alike; ``load_state_dict`` keeps
``exp_avg`` in ``mu_dtype``.
"""

from __future__ import annotations

from typing import Iterable

import torch

from colvo_torch.kernels.adam import Plans, adam_update


class Adam(torch.optim.Optimizer):
    """Adam (``weight_decay=0``) or AdamW with ``exp_avg`` in ``mu_dtype``."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float | torch.Tensor,
                 betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                 mu_dtype: torch.dtype = torch.float32, capturable: bool = False):
        defaults = dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                        capturable=capturable)
        super().__init__(params, defaults)
        self.mu_dtype = mu_dtype
        self._plans = Plans()

    def load_state_dict(self, state_dict) -> None:
        # torch casts every floating state to its parameter's dtype
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(self.mu_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                elif st["step"].device != p.device:
                    st["step"] = st["step"].to(p.device, torch.float32)
            adam_update(params, [p.grad for p in params],
                        [self.state[p]["exp_avg"] for p in params],
                        [self.state[p]["exp_avg_sq"] for p in params],
                        [self.state[p]["step"] for p in params], group["lr"], group["betas"],
                        group["eps"], group["weight_decay"], plans=self._plans)
        return None
