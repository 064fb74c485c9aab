"""Checkpointable input pipeline (port of ``colvo/data/grain_loader.py``).

The reference builds it on ``grain``; importing ``grain.python`` loads JAX,
so the port keeps grain's contract in numpy:

* **Records.** A continuous stream of record positions, as grain's
  ``IndexSampler(shuffle=True, seed, num_epochs)``: position ``p`` is
  record ``perm_e[p % n]`` of epoch ``e = p // n``, one seeded permutation
  an epoch. ``Batch(drop_remainder=True)`` takes consecutive positions, so
  a batch may span two epochs.
* **Augmentation** by ``augment_snippet`` from a generator keyed by
  ``(seed, batch position)``, not from a running generator, so that a
  restored state replays the same augmented batches bit for bit (grain's
  ``RandomMapTransform`` keys its generator so too).
* **State**: the next record position, the seed and the corpus
  fingerprint, as JSON bytes. A state saved against another corpus or seed
  is rejected, as grain rejects one whose ``repr(data_source)`` differs.

Batches follow ``batch_iterator``'s contract ({frames, frames_clean, k}).
Everything runs in process, as the reference's default (``worker_count``
0): the snippets are arrays in memory already.
"""

from __future__ import annotations

import json
import threading
import zlib
from typing import Iterator, Optional

import numpy as np

from colvo_torch.config import DataConfig
from colvo_torch.data.augment import augment_snippet
from colvo_torch.data.snippets import SnippetDataset

# Stream tags of the two generators keyed by the seed.
_PERMUTATION, _AUGMENT = 0, 1


def source_fingerprint(dataset: SnippetDataset) -> str:
    """Content-derived identity of the corpus, as the reference's
    ``_SnippetSource.__repr__``: n, the first sample's shape and dtype, and
    the adler32 of its bytes."""
    if len(dataset) == 0:
        return "_SnippetSource(n=0)"
    first = dataset[0]
    fp = zlib.adler32(np.ascontiguousarray(first.frames).tobytes())
    return (f"_SnippetSource(n={len(dataset)}, frames={tuple(first.frames.shape)}, "
            f"dtype={first.frames.dtype}, fp={fp:08x})")


class GrainIterator:
    """One pass over a :class:`GrainLoader`'s stream, with grain's
    ``get_state``/``set_state``."""

    def __init__(self, loader: "GrainLoader"):
        self._loader = loader
        self._position = 0  # the next record position
        self._perm_epoch, self._perm = -1, None

    def __iter__(self):
        return self

    def _record(self, position: int) -> int:
        n = len(self._loader.dataset)
        epoch = position // n
        if epoch != self._perm_epoch:
            rng = np.random.default_rng([self._loader.seed, _PERMUTATION, epoch])
            self._perm_epoch, self._perm = epoch, rng.permutation(n)
        return int(self._perm[position % n])

    def __next__(self) -> dict:
        ld = self._loader
        n, bsz = len(ld.dataset), ld.cfg.batch_size
        end = self._position + bsz
        if ld.num_epochs is not None and end > ld.num_epochs * n:
            raise StopIteration  # the remainder is dropped
        snippets = [ld.dataset[self._record(p)] for p in range(self._position, end)]
        batch_index = self._position // bsz
        self._position = end
        frames = np.stack([s.frames for s in snippets])
        if ld.cfg.augment:
            rng = np.random.default_rng([ld.seed, _AUGMENT, batch_index])
            aug, clean = augment_snippet(frames, ld.cfg, rng)
        else:
            aug = clean = frames
        return {"frames": aug, "frames_clean": clean, "k": snippets[0].k}

    def get_state(self) -> bytes:
        return json.dumps({"next_position": self._position, "seed": self._loader.seed,
                           "source": self._loader.fingerprint}).encode()

    def set_state(self, state: bytes) -> None:
        st = json.loads(state)
        ld = self._loader
        if st["source"] != ld.fingerprint or st["seed"] != ld.seed:
            raise ValueError(
                f"loader state of {st['source']} (seed {st['seed']}) does not match this "
                f"loader's {ld.fingerprint} (seed {ld.seed})")
        self._position = int(st["next_position"])


class GrainLoader:
    """The port's ``grain.DataLoader``: each ``iter`` starts at position 0."""

    def __init__(self, dataset: SnippetDataset, cfg: DataConfig, seed: int,
                 num_epochs: Optional[int]):
        if len(dataset) == 0:
            raise ValueError("the dataset has no snippets")
        self.dataset, self.cfg, self.seed, self.num_epochs = dataset, cfg, seed, num_epochs
        self.fingerprint = source_fingerprint(dataset)

    def __iter__(self) -> GrainIterator:
        return GrainIterator(self)


def grain_loader(dataset: SnippetDataset, cfg: DataConfig, seed: int = 0,
                 num_epochs: Optional[int] = None) -> GrainLoader:
    """A loader yielding the standard batch dict; its iterators support
    ``get_state``/``set_state`` for exact resume."""
    return GrainLoader(dataset, cfg, seed, num_epochs)


class StatefulGrainIterator:
    """Keeps the iterator's state after every batch, keyed by the count of
    batches yielded, so that the loop can ask for the state after exactly
    N consumed batches (``state_at(N)``) although its prefetcher has pulled
    further ahead; the resumed stream is then the bitwise continuation."""

    def __init__(self, it: GrainIterator, keep: int = 16):
        self._it = it
        self._keep = max(2, keep)
        self._count = 0
        self._states = {0: it.get_state()}
        # __next__ runs on the prefetch thread, state_at on the loop's
        self._lock = threading.Lock()

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = next(self._it)
        with self._lock:
            self._count += 1
            self._states[self._count] = self._it.get_state()
            self._states.pop(self._count - self._keep, None)
        return batch

    @property
    def count(self) -> int:
        return self._count

    def state_at(self, n_consumed: int) -> bytes:
        """Serialized iterator state after exactly ``n_consumed`` batches."""
        with self._lock:
            try:
                return self._states[n_consumed]
            except KeyError:
                have = sorted(self._states)
                raise KeyError(
                    f"grain iterator state for batch count {n_consumed} was "
                    f"evicted (retained: {have[0]}..{have[-1]}, keep="
                    f"{self._keep}). The consumer prefetched more than "
                    f"`keep` batches past the checkpointed step — construct "
                    f"grain_batch_iterator with keep >= prefetch depth + "
                    f"checkpoint lag."
                ) from None

    def set_state(self, state: bytes) -> None:
        """Restore; the count and history restart at the restored position."""
        with self._lock:
            self._it.set_state(state)
            self._count = 0
            self._states = {0: self._it.get_state()}


def grain_batch_iterator(dataset: SnippetDataset, cfg: DataConfig, seed: int = 0,
                         num_epochs: Optional[int] = None,
                         keep: int = 16) -> Iterator[dict]:
    """Iterator with ``batch_iterator``'s contract and a checkpointable
    position (``state_at``/``set_state``). ``keep`` bounds the retained
    state history and must exceed the consumer's prefetch depth."""
    return StatefulGrainIterator(iter(grain_loader(dataset, cfg, seed, num_epochs)),
                                 keep=keep)
