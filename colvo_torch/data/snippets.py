"""Snippet dataset and batch iterator (numpy-only copy of
``colvo/data/snippets.py``): target frame + source frames at
``frame_offsets``, plus intrinsics."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence, Tuple

import numpy as np

from colvo_torch.config import DataConfig
from colvo_torch.data.augment import augment_snippet
from colvo_torch.data.synthetic import render_sequence


@dataclass
class Snippet:
    """One sample: frames (n_frames, H, W, 3) with index 0 = target,
    then sources in ``frame_offsets`` order; k is full-res intrinsics."""

    frames: np.ndarray
    k: np.ndarray


class SnippetDataset:
    """Indexes all valid snippets over one or more frame sequences.

    Frames are pre-loaded per sequence (training sequences are short clips;
    full-colonoscopy streaming uses the VO loop, not this dataset).
    """

    def __init__(
        self,
        sequences: Sequence[np.ndarray],
        intrinsics: Sequence[np.ndarray],
        frame_offsets: Tuple[int, ...] = (-1, 1),
    ):
        if len(sequences) != len(intrinsics):
            raise ValueError(f"{len(sequences)} sequences but {len(intrinsics)} intrinsics")
        self.sequences = [np.asarray(s, dtype=np.float32) for s in sequences]
        self.intrinsics = [np.asarray(k, dtype=np.float32) for k in intrinsics]
        self.frame_offsets = tuple(frame_offsets)
        lo = min(0, *self.frame_offsets)
        hi = max(0, *self.frame_offsets)
        self._index = [
            (si, ti)
            for si, seq in enumerate(self.sequences)
            for ti in range(-lo, len(seq) - hi)
        ]

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, idx: int) -> Snippet:
        si, ti = self._index[idx]
        seq = self.sequences[si]
        stack = [seq[ti]] + [seq[ti + o] for o in self.frame_offsets]
        return Snippet(frames=np.stack(stack), k=self.intrinsics[si])


def synthetic_dataset(cfg: DataConfig, n_sequences: int = 2, n_frames: int = 48):
    """Build a SnippetDataset from rendered colon sequences (no real data
    reachable, SURVEY.md §7 hard part 3)."""
    seqs, ks = [], []
    for i in range(n_sequences):
        seq = render_sequence(
            n_frames=n_frames, height=cfg.height, width=cfg.width, seed=11 + 17 * i
        )
        seqs.append(seq.frames)
        ks.append(seq.k)
    return SnippetDataset(seqs, ks, cfg.frame_offsets)


def batch_iterator(
    dataset: SnippetDataset,
    cfg: DataConfig,
    seed: int = 0,
    epochs: int | None = None,
) -> Iterator[dict]:
    """Shuffled, epoched, augmented batch stream.

    Yields dicts with:
      * ``frames``:       (B, n_frames, H, W, 3) augmented network inputs
      * ``frames_clean``: un-jittered copies for the photometric loss
        (Monodepth2 protocol, SURVEY.md D4)
      * ``k``:            (3, 3) intrinsics (per-batch; one dataset per run)

    Drops the trailing partial batch (static shapes for jit).
    """
    rng = np.random.default_rng(seed)
    n = len(dataset)
    bsz = cfg.batch_size
    if n < bsz and (epochs is None or epochs > 0):
        # With fewer snippets than one batch the epoch loop below yields
        # NOTHING and next() blocks forever (measured: a silent 15-minute
        # hang when bench_train asked for B=24 from a 16-frame sequence).
        # Fail loudly instead.
        raise ValueError(
            f"dataset has {n} snippets but batch_size={bsz}; the trailing "
            "partial batch is dropped (static shapes), so no batch can "
            "ever be formed — use a longer corpus or a smaller batch"
        )
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n)
        for start in range(0, n - bsz + 1, bsz):
            idxs = order[start : start + bsz]
            snippets = [dataset[int(i)] for i in idxs]
            frames = np.stack([s.frames for s in snippets])  # (B, F, H, W, 3)
            k = snippets[0].k
            if cfg.augment:
                aug, clean = augment_snippet(frames, cfg, rng)
            else:
                aug = clean = frames
            yield {"frames": aug, "frames_clean": clean, "k": k}
        epoch += 1
