"""Device-resident snippet store (port of ``colvo/data/device_store.py``).

For a corpus that fits in device memory (100 sequences × 100 frames at
256×320 uint8 are 2.46 GB of the H100's 80 GB), every frame is uploaded
once as uint8 and batches are assembled on the device: the index gather,
the uint8 → float32 scale and the colour augmentation (``assemble``). The
host draws each epoch's permutation and uploads it once; a batch is then a
slice of it through one captured program (``runtime.graphs.Graphed``, the
counterpart of the reference's jitted ``_assemble`` and ``augment_fn``):
on a card one CUDA-graph replay a batch, none of which waits for the
device.

The augmentation follows ``colvo_torch.data.augment``'s semantics: one draw
per snippet, applied to all of its frames; the jitter on the network-input
copy only; the horizontal flip on both (a geometric change, and K has a
centred principal point). Its random numbers come from an explicit
``torch.Generator`` and are drawn apart from the arithmetic
(``draw_augment``, ``apply_augment``), so that a test can feed the
reference's draws to the port: JAX's and torch's generators cannot agree.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from colvo_torch import resolve_device
from colvo_torch.config import DataConfig


def _rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    return (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]


def draw_augment(b: int, generator: torch.Generator, cfg: DataConfig,
                 device: str | torch.device) -> Dict[str, torch.Tensor]:
    """One draw per snippet from ``generator``, in this order and each only
    where its knob is on: ``flip`` (b,) bool, then the ``brightness``,
    ``contrast`` and ``saturation`` factors and the ``hue`` shift, (b,)
    float32 each, uniform over the reference's ranges."""
    def uniform(lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(b, generator=generator, device=device)

    draws = {}
    if cfg.hflip:
        draws["flip"] = torch.rand(b, generator=generator, device=device) < 0.5
    for name in ("brightness", "contrast", "saturation"):
        amount = getattr(cfg, name)
        if amount > 0:
            draws[name] = uniform(1 - amount, 1 + amount)
    if cfg.hue > 0:
        draws["hue"] = uniform(-cfg.hue, cfg.hue)
    return draws


def apply_augment(frames: torch.Tensor, draws: Dict[str, torch.Tensor],
                  cfg: DataConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, F, H, W, 3) float frames and ``draw_augment``'s draws → (aug,
    clean): the reference's ``device_augment`` arithmetic, step for step
    (``colvo/data/device_store.py:38-68``)."""
    def per_snippet(v: torch.Tensor) -> torch.Tensor:
        return v.reshape(-1, 1, 1, 1, 1).to(frames.dtype)

    clean = frames
    if cfg.hflip:
        clean = torch.where(draws["flip"].reshape(-1, 1, 1, 1, 1), frames.flip(3), frames)
    out = clean
    if cfg.brightness > 0:
        out = out * per_snippet(draws["brightness"])
    if cfg.contrast > 0:
        mean = out.mean(dim=(-3, -2, -1), keepdim=True)
        out = (out - mean) * per_snippet(draws["contrast"]) + mean
    if cfg.saturation > 0:
        gray = _rgb_to_gray(out)
        out = gray + (out - gray) * per_snippet(draws["saturation"])
    if cfg.hue > 0:
        out = out + per_snippet(draws["hue"]) * (torch.roll(out, 1, dims=-1) - out)
    return out.clamp(0.0, 1.0), clean


def device_augment(frames: torch.Tensor, generator: torch.Generator,
                   cfg: DataConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """On-device mirror of ``augment_snippet``: (B, F, H, W, 3) → (aug, clean)."""
    return apply_augment(frames, draw_augment(frames.shape[0], generator, cfg, frames.device),
                         cfg)


def gather(frames_u8: torch.Tensor, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Snippets ``idx`` of a store: (B, F, H, W, 3) float32 in [0, 1]. The
    scale multiplies by 1/255, as XLA compiles the reference's ``/ 255.0``."""
    return frames_u8[table[idx].long()].to(torch.float32) * (1.0 / 255.0)


def assemble(frames_u8: torch.Tensor, table: torch.Tensor, idx: torch.Tensor, k: torch.Tensor,
             generator: torch.Generator, cfg: DataConfig) -> Dict[str, torch.Tensor]:
    """The batch of snippets ``idx``: ``gather``, then ``device_augment``
    from ``generator`` where ``cfg.augment`` (else the clean frames twice).
    Returns {frames, frames_clean, k}. The body of the store's batch
    program and of each step of ``make_scan_train``."""
    clean = gather(frames_u8, table, idx)
    aug, clean = device_augment(clean, generator, cfg) if cfg.augment else (clean, clean)
    return {"frames": aug, "frames_clean": clean, "k": k}


class DeviceSnippetStore:
    """All frames on the device as uint8; batches assembled there.

    Args:
        sequences: (N, H, W, 3) float [0, 1] or uint8 arrays.
        intrinsics: one (3, 3) K per sequence; they must be equal (one K a
            batch is the contract).
        frame_offsets: source-frame offsets (``SnippetDataset``'s).
        device: where the corpus lives (``cuda`` unless told ``cpu``).

    Attributes:
        program: the batch program of the iterator ``batches`` made last
            (``runtime.graphs.Graphed``; None before).
    """

    def __init__(
        self,
        sequences: Sequence[np.ndarray],
        intrinsics: Sequence[np.ndarray],
        frame_offsets: Tuple[int, ...] = (-1, 1),
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        ks = np.stack([np.asarray(k, np.float32) for k in intrinsics])
        if not np.allclose(ks, ks[0:1], atol=1e-5):
            raise ValueError("DeviceSnippetStore requires a single shared K")

        frames_u8 = []
        table = []
        base = 0
        lo = min(0, *frame_offsets)
        hi = max(0, *frame_offsets)
        for seq in sequences:
            seq = np.asarray(seq)
            if seq.dtype != np.uint8:
                seq = (np.clip(seq, 0, 1) * 255).round().astype(np.uint8)
            n = len(seq)
            frames_u8.append(seq)
            for t in range(-lo, n - hi):
                table.append([base + t] + [base + t + o for o in frame_offsets])
            base += n
        self.k = torch.from_numpy(ks[0]).to(self.device)
        self.frames = torch.from_numpy(np.concatenate(frames_u8)).to(self.device)  # (T, H, W, 3)
        self.table = torch.from_numpy(np.asarray(table, np.int32)).to(self.device)  # (S, F)
        self.n_snippets = len(table)
        self.program = None

    def batches(self, cfg: DataConfig, seed: int = 0,
                epochs: Optional[int] = None) -> Iterator[dict]:
        """Yield {frames, frames_clean, k} batches on the device: a shuffled
        epoch after another (the reference's ``default_rng(seed)``
        permutations), the trailing partial batch dropped, the augmentation
        drawn from a ``torch.Generator`` seeded with ``seed``.

        Each batch is one call of a program made for this iterator
        (``Graphed`` over ``assemble``, the generator registered with it;
        on a card captured at the first batch and replayed after). Its
        batches are the program's static outputs, which the next batch
        overwrites: a caller that keeps one past its next ``next`` copies
        it. A consumer on the same stream (the loop's step, which copies
        the batch into its own inputs) needs no copy."""
        from colvo_torch.runtime.graphs import Graphed  # runtime imports this module

        if self.n_snippets < cfg.batch_size:
            raise ValueError(f"the store has {self.n_snippets} snippets but "
                             f"batch_size={cfg.batch_size}; no batch can be formed")
        rng = np.random.default_rng(seed)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        program = self.program = Graphed(
            lambda idx: assemble(self.frames, self.table, idx, self.k, generator, cfg),
            device=self.device, generators=(generator,), name="batch")
        bsz = cfg.batch_size
        epoch = 0
        while epochs is None or epoch < epochs:
            order = torch.from_numpy(rng.permutation(self.n_snippets))
            if self.device.type == "cuda":
                order = order.pin_memory().to(self.device, non_blocking=True)
            for start in range(0, self.n_snippets - bsz + 1, bsz):
                yield program(order[start:start + bsz])
            epoch += 1
