"""Typed nested config (the port's own copy of ``colvo/config.py``).

Knob names, defaults and the dotted-override / JSON serde are identical to
the JAX package's, so one config file drives both. The rationale for each
knob lives beside it in ``colvo/config.py``. Every knob is ported:
``data.loader="grain"`` is the port's checkpointable loader
(``data/grain_loader.py``), and ``mesh.data_parallel`` counts the ranks of
a ``torch.distributed`` process group (``runtime/mesh.py``).

The port also has knobs of its own, which ``PORT_ONLY`` names:
``model.depth_net`` chooses the depth network (``models/depthnet.py``).
``dump`` leaves a port-only knob out of the file while it holds its
default, so a file of a configuration both packages run loads in either;
one that sets it is refused by the JAX package's loader, which names the
key.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Sequence, Tuple


@dataclass
class DataConfig:
    data_root: str = ""
    dataset: str = "synthetic"  # synthetic | frames | video
    height: int = 256
    width: int = 320
    frame_offsets: Tuple[int, ...] = (-1, 1)  # source frames relative to target
    batch_size: int = 12
    loader: str = "numpy"  # numpy | grain | device
    num_workers: int = 4
    shuffle_buffer: int = 512
    augment: bool = True
    # Color jitter ranges (Monodepth2 protocol: loss on clean frames).
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    hue: float = 0.05
    hflip: bool = True


@dataclass
class ModelConfig:
    num_layers: int = 18  # ResNet depth for the encoder: 18 | 34
    n_scales: int = 4  # disparity output scales
    min_depth: float = 0.01  # colon-scale depth range (meters)
    max_depth: float = 1.0
    pose_rotation_scale: float = 0.01
    pose_translation_scale: float = 0.01
    dcdp_fusion: bool = True  # DCDP coupling; off = plain PoseNet
    batched_snippet: bool = True  # one (B·F) depth pass + one (B·S) pose pass
    fusion_channels: int = 64
    norm: str = "group"  # group | none (BN-folded family import target)
    dtype: str = "bfloat16"  # conv compute dtype; params stay float32
    remat: bool = False  # recompute conv blocks in the backward pass
    # depth network: resnet (ResNet encoder + Monodepth2 decoder) |
    # dpt_vits14 | dpt_vitb14 | dpt_vitl14 (Depth Anything V2: DINOv2 + DPT)
    depth_net: str = "resnet"


@dataclass
class LossConfig:
    ssim_alpha: float = 0.85  # α·(1−SSIM)/2 + (1−α)·L1
    smoothness_weight: float = 1e-3
    geometric_weight: float = 0.1  # DCDP cross-frame consistency
    geo_ramp_steps: int = 0  # linear ramp of the geo weight; 0 = off
    lcc: bool = True  # light-consistent calibration
    lcc_mode: str = "affine"  # affine | gain | off | global | global+affine | global+gain
    lcc_window: int = 15
    lcc_identity: bool = False  # also calibrate the automask's identity source
    fused_kernel: bool = False  # fused warp+LCC+SSIM+L1 kernel
    batched_photo: bool = False  # one grouped sampler launch for all warps
    automask: bool = True
    min_reprojection: bool = True
    photo_native: bool = False  # photometric term at each scale's native grid
    compute_dtype: str = ""  # photometric-plane dtype: "" (float32) | bfloat16
    photo_remat: bool = False  # recompute LCC/SSIM stats in the backward pass
    geo_full_res: bool = False  # geo term at full resolution
    geo_res_cap: int = 0  # max geo-grid height; 0 = no cap
    geo_grad: str = "both"  # both | sym
    scatter_audit: bool = False  # aux metric of dropped scatter classes
    gauge_weight: float = 1.0  # depth<->pose gauge hinge; 0 disables
    gauge_lo: float = 0.03
    gauge_hi: float = 0.3
    geo_stopgrad: bool = False  # stop-gradient the warped source depth


@dataclass
class TrainConfig:
    lr: float = 1e-4
    lr_decay_epochs: int = 15  # step decay after this epoch
    warmup_steps: int = 0  # linear LR warmup from 0; 0 = off
    lr_decay_factor: float = 0.1
    epochs: int = 20
    seed: int = 42
    grad_clip: float = 10.0
    weight_decay: float = 0.0
    log_every: int = 50
    eval_every_epochs: int = 1
    ckpt_every_steps: int = 1000
    ckpt_dir: str = "checkpoints"
    ckpt_keep: int = 3
    max_bad_steps: int = 10
    adam_mu_dtype: str = ""  # "" (float32) | bfloat16
    dispatch_ahead_windows: int = 2
    profile_steps: str = ""
    deterministic: bool = False
    debug_nans: bool = False
    restart_metric: str = "loss/geometric"
    restart_threshold: float = 0.0
    restart_check_step: int = 1500
    restart_max: int = 2


@dataclass
class MeshConfig:
    data_parallel: int = -1  # -1 = every rank of the process group (one alone)
    axis_name: str = "data"


@dataclass
class EvalConfig:
    depth_cap: float = 1.0
    median_scaling: bool = True
    ate_alignment: str = "sim3"  # sim3 | se3


# Knobs the JAX package's config lacks ("section.key").
PORT_ONLY: Tuple[str, ...] = ("model.depth_net",)


@dataclass
class ColvoConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def shared_dict(self) -> dict:
        """``to_dict`` without the port-only knobs: the keys the JAX
        package's config has."""
        d = self.to_dict()
        for key in PORT_ONLY:
            section, _, leaf = key.partition(".")
            del d[section][leaf]
        return d

    def dump(self, path: str) -> None:
        """Write the configuration as JSON; a port-only knob at its default
        is left out."""
        d, default = self.shared_dict(), ColvoConfig()
        for key in PORT_ONLY:
            section, _, leaf = key.partition(".")
            value = getattr(getattr(self, section), leaf)
            if value != getattr(getattr(default, section), leaf):
                d[section][leaf] = value
        with open(path, "w") as f:
            json.dump(d, f, indent=2, default=list)

    @classmethod
    def load(cls, path: str) -> "ColvoConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_dict(cls, d: dict) -> "ColvoConfig":
        cfg = cls()
        for section, values in d.items():
            sub = getattr(cfg, section)
            for k, v in values.items():
                if not hasattr(sub, k):
                    raise KeyError(f"unknown config key {section}.{k}")
                if isinstance(getattr(sub, k), tuple):
                    v = tuple(v)
                setattr(sub, k, v)
        return cfg

    def apply_overrides(self, overrides: Sequence[str]) -> "ColvoConfig":
        """Apply dotted CLI overrides like ``train.lr=2e-4`` (values parse
        as JSON when possible, else as raw strings)."""
        for ov in overrides:
            ov = ov.lstrip("-")
            key, _, raw = ov.partition("=")
            if not raw:
                raise ValueError(f"override must be key=value: {ov!r}")
            section_name, _, leaf = key.partition(".")
            section = getattr(self, section_name)
            if not hasattr(section, leaf):
                raise KeyError(f"unknown config key {key}")
            try:
                val: Any = json.loads(raw)
            except json.JSONDecodeError:
                val = raw
            if isinstance(getattr(section, leaf), tuple) and isinstance(val, list):
                val = tuple(val)
            setattr(section, leaf, val)
        return self
