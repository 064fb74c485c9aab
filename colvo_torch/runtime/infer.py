"""Inference runner (port of ``colvo/runtime/infer.py``): depth, pose and
coupled depth+pose over trained weights, moved to the device once."""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from colvo_torch import resolve_device
from colvo_torch.config import ColvoConfig
from colvo_torch.geometry import disp_to_depth
from colvo_torch.models import ColVOModel


class InferenceRunner:
    """Batched forward functions over a port ``state_dict``.

    Frames come in as (B, H, W, 3) float arrays in [0, 1]; results go out
    as numpy arrays.
    """

    def __init__(self, cfg: ColvoConfig, state_dict: Mapping[str, torch.Tensor],
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = ColVOModel(cfg.model)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()

    def _nchw(self, imgs: np.ndarray) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(imgs), dtype=torch.float32).to(self.device)
        return x.permute(0, 3, 1, 2).contiguous()

    def _depth(self, disp: torch.Tensor) -> torch.Tensor:
        m = self.cfg.model
        return disp_to_depth(disp[:, 0], m.min_depth, m.max_depth)[1]

    @torch.inference_mode()
    def infer_depth(self, imgs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(B, H, W, 3) → (depth (B, H, W), disp (B, H, W))."""
        disps, _ = self.model.depth(self._nchw(imgs))
        return self._depth(disps[0]).cpu().numpy(), disps[0][:, 0].cpu().numpy()

    def _pair(self, img_a: np.ndarray, img_b: np.ndarray):
        a, b = self._nchw(img_a), self._nchw(img_b)
        # Both frames' depth in one batched pass (GroupNorm is per-sample).
        disps, feats = self.model.depth(torch.cat([a, b]))
        fa, fb = feats.chunk(2)
        aa, tr = self.model.pose(a, b, [fa, fb] if self.cfg.model.dcdp_fusion else None)
        return disps[0].chunk(2), aa, tr

    @torch.inference_mode()
    def infer_pose(self, img_a: np.ndarray, img_b: np.ndarray) -> np.ndarray:
        """Two frame batches → (B, 6) pose params (axisangle, translation)."""
        _, aa, tr = self._pair(img_a, img_b)
        return torch.cat([aa, tr], dim=-1).cpu().numpy()

    @torch.inference_mode()
    def infer_coupled(self, img_a: np.ndarray, img_b: np.ndarray):
        """Fused depth+pose for streaming VO: (depth_a, depth_b, aa, tr)."""
        (da, db), aa, tr = self._pair(img_a, img_b)
        out = (self._depth(da), self._depth(db), aa, tr)
        return tuple(o.cpu().numpy() for o in out)
