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
ν stays f32. The update uses the f32 μ', not its rounded copy. Every step is a few
``torch._foreach_*`` calls over all parameters; with ``capturable=True``
the learning rate is read from a device tensor in the group (``lr``) and
the step counts live on the device, so the step reads no host scalar and
a CUDA graph can capture it. State keys and ``param_groups`` are those of
``torch.optim.Adam`` (``step``, ``exp_avg``, ``exp_avg_sq``; ``lr``,
``capturable``), so checkpoints and the captured chunk treat both alike;
``load_state_dict`` keeps ``exp_avg`` in ``mu_dtype``.
"""

from __future__ import annotations

from typing import Iterable

import torch


class Adam(torch.optim.Optimizer):
    """Adam (``weight_decay=0``) or AdamW with ``exp_avg`` in ``mu_dtype``."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float | torch.Tensor,
                 betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                 mu_dtype: torch.dtype = torch.float32, capturable: bool = False):
        defaults = dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                        capturable=capturable)
        super().__init__(params, defaults)
        self.mu_dtype = mu_dtype

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
                    on = p.device if group["capturable"] else torch.device("cpu")
                    st["step"] = torch.zeros((), dtype=torch.float32, device=on)
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p)
            b1, b2 = group["betas"]
            grads = [p.grad for p in params]
            steps = [self.state[p]["step"] for p in params]
            mus = [self.state[p]["exp_avg"] for p in params]
            nus = [self.state[p]["exp_avg_sq"] for p in params]

            torch._foreach_add_(steps, 1.0)
            mu = torch._foreach_mul(grads, 1.0 - b1)
            b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
            torch._foreach_add_(mu, [m.float() for m in torch._foreach_mul(mus, b1_mu)])
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
            # the bias corrections, f32 as optax computes them (the step
            # counts of one group move together)
            t = steps[0].to(params[0].device)
            bc1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
            bc2 = 1.0 - torch.pow(torch.full_like(t, b2), t)
            denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            if group["weight_decay"]:
                torch._foreach_add_(upd, torch._foreach_mul(params, group["weight_decay"]))
            lr = group["lr"]
            torch._foreach_mul_(upd, -lr if not isinstance(lr, torch.Tensor) else torch.neg(lr))
            torch._foreach_add_(params, upd)
            torch._foreach_copy_(mus, mu)  # rounded to nearest even
        return None
