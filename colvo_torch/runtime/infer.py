"""Inference runner (port of ``colvo/runtime/infer.py``): depth, pose and
coupled depth+pose over trained weights, moved to the device once.

Each function is one program (``runtime.graphs``), as the reference jits
``_depth``, ``_pose`` and ``_coupled``: on CUDA a CUDA graph captured once
a batch shape and replayed at every later call.

Each call is the span ``infer.call`` (``runtime.spans``; attr ``call``, the
runner's call index) over ``infer.frames`` (the arrays as tensors), the
program's ``graph.*`` spans and ``infer.fetch`` (the copies of its outputs
to the host, which wait for the device; attr ``bytes``)."""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from colvo_torch import resolve_device
from colvo_torch.config import ColvoConfig
from colvo_torch.geometry import disp_to_depth
from colvo_torch.models import ColVOModel
from colvo_torch.runtime.graphs import Graphed
from colvo_torch.runtime.spans import span


def _nchw(imgs: torch.Tensor) -> torch.Tensor:
    return imgs.permute(0, 3, 1, 2).contiguous()


def _depth_of(runner: "InferenceRunner", disp: torch.Tensor) -> torch.Tensor:
    m = runner.cfg.model
    return disp_to_depth(disp[:, 0], m.min_depth, m.max_depth)[1]


def _depth_body(runner: "InferenceRunner", imgs: torch.Tensor):
    disps, _ = runner.model.depth(_nchw(imgs))
    return _depth_of(runner, disps[0]), disps[0][:, 0]


def _pair(runner: "InferenceRunner", img_a: torch.Tensor, img_b: torch.Tensor):
    a, b = _nchw(img_a), _nchw(img_b)
    # Both frames' depth in one batched pass (GroupNorm is per-sample).
    disps, feats = runner.model.depth(torch.cat([a, b]))
    fa, fb = feats.chunk(2)
    aa, tr = runner.model.pose(a, b, [fa, fb] if runner.cfg.model.dcdp_fusion else None)
    return disps[0].chunk(2), aa, tr


def _pose_body(runner: "InferenceRunner", img_a: torch.Tensor, img_b: torch.Tensor):
    _, aa, tr = _pair(runner, img_a, img_b)
    return torch.cat([aa, tr], dim=-1)


def _coupled_body(runner: "InferenceRunner", img_a: torch.Tensor, img_b: torch.Tensor):
    (da, db), aa, tr = _pair(runner, img_a, img_b)
    return _depth_of(runner, da), _depth_of(runner, db), aa, tr


def _host(x: torch.Tensor) -> np.ndarray:
    """A program's output as a fresh host array (the next call overwrites
    the output)."""
    return x.to("cpu", copy=True).numpy()


def _fetch(outs: Tuple[torch.Tensor, ...]) -> Tuple[np.ndarray, ...]:
    with span("infer.fetch", bytes=sum(o.nbytes for o in outs)):
        return tuple(_host(o) for o in outs)


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
        self._programs: Dict[Callable, Graphed] = {}
        self._calls = 0

    def program(self, body: Callable) -> Graphed:
        """``body(runner, ...)`` over this runner's weights as a program
        (``runtime.graphs.Graphed``, inputs copied to the runner's device),
        made once a body: its graphs live as long as the runner."""
        prog = self._programs.get(body)
        if prog is None:
            prog = self._programs[body] = Graphed(partial(body, self), device=self.device)
        return prog

    def _call(self, body: Callable, *imgs: np.ndarray) -> Tuple[np.ndarray, ...]:
        """``body``'s program on the frame batches ``imgs``; its outputs on
        the host, as a tuple."""
        call = self._calls
        self._calls += 1
        with span("infer.call", call=call):
            with span("infer.frames"):
                frames = [torch.as_tensor(np.asarray(i), dtype=torch.float32) for i in imgs]
            out = self.program(body)(*frames)
            return _fetch(out if isinstance(out, tuple) else (out,))

    @torch.inference_mode()
    def infer_depth(self, imgs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(B, H, W, 3) → (depth (B, H, W), disp (B, H, W))."""
        return self._call(_depth_body, imgs)

    @torch.inference_mode()
    def infer_pose(self, img_a: np.ndarray, img_b: np.ndarray) -> np.ndarray:
        """Two frame batches → (B, 6) pose params (axisangle, translation)."""
        return self._call(_pose_body, img_a, img_b)[0]

    @torch.inference_mode()
    def infer_coupled(self, img_a: np.ndarray, img_b: np.ndarray):
        """Fused depth+pose for streaming VO: (depth_a, depth_b, aa, tr)."""
        return self._call(_coupled_body, img_a, img_b)
