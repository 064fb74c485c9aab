"""colvo_torch.data.grain_loader against colvo.data.grain_loader (grain), on
the CPU: the batch contract and the augmentation's function, grain's record
stream (every record once an epoch, batches across epochs), the
``state_at``/``set_state`` resume bit for bit, the evicted-count and
foreign-corpus refusals, and a ``cli train --data.loader=grain`` kill and
resume bit for bit. Bits cannot match grain's: its shuffle is its own."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from colvo.config import DataConfig as JaxDataConfig
from colvo.data import SnippetDataset as JaxSnippetDataset
from colvo.data.augment import augment_snippet as jax_augment
from colvo.data.grain_loader import grain_batch_iterator as jax_grain_batch_iterator
from colvo_torch import cli
from colvo_torch.config import DataConfig
from colvo_torch.data import SnippetDataset, render_sequence
from colvo_torch.data.grain_loader import grain_batch_iterator, grain_loader
from colvo_torch.runtime import CheckpointManager

torch.set_num_threads(2)

H, W = 32, 48


def _cfgs(batch_size=2, augment=True):
    cfgs = DataConfig(), JaxDataConfig()
    for cfg in cfgs:
        cfg.height, cfg.width, cfg.batch_size, cfg.augment = H, W, batch_size, augment
    return cfgs


@pytest.fixture(scope="module")
def seq():
    return render_sequence(n_frames=9, height=H, width=W, seed=3)


def _index_of(frames, ds):
    """The record whose snippet is ``frames`` (un-jittered, unflipped)."""
    hits = [i for i in range(len(ds)) if np.array_equal(ds[i].frames, frames)]
    assert len(hits) == 1
    return hits[0]


def test_batch_contract_and_augmentation_match_the_reference(seq):
    """Keys, shapes, dtypes and k as colvo's grain batches; frames_clean a
    record, flipped or not; frames the reference's augment_snippet of the
    batch under the port's keyed generator (seed, batch position)."""
    cfg, jcfg = _cfgs()
    ds = SnippetDataset([seq.frames], [seq.k])
    jds = JaxSnippetDataset([seq.frames], [seq.k])
    ref = next(jax_grain_batch_iterator(jds, jcfg, seed=0))
    it = grain_batch_iterator(ds, cfg, seed=0)
    for b_index in range(3):
        got = next(it)
        assert set(got) == set(ref) == {"frames", "frames_clean", "k"}
        for key in got:
            assert got[key].shape == np.asarray(ref[key]).shape, key
            assert got[key].dtype == np.asarray(ref[key]).dtype, key
        np.testing.assert_array_equal(got["k"], np.asarray(ref["k"]))
        records, unflipped = [], []
        for clean in got["frames_clean"]:
            hits = [i for i in range(len(ds)) for fl in (False, True)
                    if np.array_equal(ds[i].frames[:, :, ::-1] if fl else ds[i].frames, clean)]
            assert len(hits) == 1
            records.append(hits[0])
            unflipped.append(ds[hits[0]].frames)
        rng = np.random.default_rng([0, 1, b_index])
        aug, clean = jax_augment(np.stack(unflipped), jcfg, rng)
        np.testing.assert_array_equal(got["frames"], aug)
        np.testing.assert_array_equal(got["frames_clean"], clean)
        assert 0.0 <= got["frames"].min() and got["frames"].max() <= 1.0


def _positions(batches, ds):
    return [_index_of(f, ds) for b in batches for f in b["frames"]]


def test_record_stream_is_one_permutation_an_epoch_across_batches(seq):
    """5 records, batch 2, as grain's IndexSampler + Batch: every epoch's
    five positions are a permutation of the records, a batch takes the
    last record of one epoch and the first of the next, and the
    reference's grain stream has the same structure."""
    cfg, jcfg = _cfgs(batch_size=2, augment=False)
    frames = seq.frames[:7]
    ds = SnippetDataset([frames], [seq.k])
    assert len(ds) == 5
    got = list(grain_batch_iterator(ds, cfg, seed=4, num_epochs=4))
    ref = list(jax_grain_batch_iterator(JaxSnippetDataset([frames], [seq.k]), jcfg, seed=4,
                                        num_epochs=4))
    assert len(got) == len(ref) == 10  # 20 positions, none dropped
    for stream in (_positions(got, ds), _positions(ref, ds)):
        for e in range(4):
            assert sorted(stream[5 * e:5 * e + 5]) == list(range(5))
    assert len(list(grain_batch_iterator(ds, cfg, seed=4, num_epochs=1))) == 2  # remainder dropped
    other = _positions(list(grain_batch_iterator(ds, cfg, seed=5, num_epochs=4)), ds)
    assert other != _positions(got, ds)


def test_state_at_and_set_state_resume_bitwise(seq, tmp_path):
    """The reference's test_grain_resume_bitwise: a checkpoint 'at step 4'
    while two more batches were prefetched carries state_at(4); a fresh
    iterator restored from it continues with batches 5, 6, 7 bit for bit,
    across an epoch boundary. A loader's own iterators get_state/set_state
    as grain's do."""
    cfg, _ = _cfgs()
    ds = SnippetDataset([seq.frames], [seq.k])
    it = grain_batch_iterator(ds, cfg, seed=0, num_epochs=4)
    consumed = [next(it) for _ in range(6)]
    state = it.state_at(4)
    assert json.loads(state)["next_position"] == 8
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    from test_torch_port_checkpoint import _small_state

    mgr.save(4, _small_state(), loader_state=state)
    _, step, loader_state = mgr.restore(_small_state(seed=1), with_loader_state=True)
    assert step == 4 and loader_state == state
    mgr.close()
    future = consumed[4:] + [next(it)]
    it2 = grain_batch_iterator(ds, cfg, seed=0, num_epochs=4)
    it2.set_state(loader_state)
    assert it2.count == 0
    for want in future:
        got = next(it2)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])

    loader = grain_loader(ds, cfg, seed=0, num_epochs=2)
    a = iter(loader)
    next(a)
    mid = a.get_state()
    b2 = next(a)
    b = iter(loader)
    b.set_state(mid)
    np.testing.assert_array_equal(next(b)["frames"], b2["frames"])


def test_evicted_count_and_foreign_corpus_are_refused(seq):
    cfg, _ = _cfgs()
    ds = SnippetDataset([seq.frames], [seq.k])
    it = grain_batch_iterator(ds, cfg, seed=0, keep=3)
    for _ in range(5):
        next(it)
    it.state_at(3)
    with pytest.raises(KeyError, match="evicted"):
        it.state_at(1)
    state = it.state_at(5)
    # the same shapes and length, other pixels: rejected, as grain rejects
    # a state whose repr(data_source) differs
    other = SnippetDataset([seq.frames[::-1].copy()], [seq.k])
    with pytest.raises(ValueError, match="does not match"):
        grain_batch_iterator(other, cfg, seed=0).set_state(state)
    with pytest.raises(ValueError, match="seed"):
        grain_batch_iterator(ds, cfg, seed=1).set_state(state)


def _cli_args(root, name):
    return ["--device", "cpu", "--log-dir", str(root / name / "log"),
            f"--train.ckpt_dir={root / name / 'ckpt'}", "--data.height=64", "--data.width=96",
            "--data.batch_size=2", "--model.dtype=float32", "--model.n_scales=2",
            "--data.frame_offsets=[1]", "--data.loader=grain", "--train.log_every=1",
            "--train.ckpt_every_steps=2"]


def test_cli_train_grain_kill_and_resume_bitwise(tmp_path, monkeypatch):
    """``cli train --data.loader=grain`` 4 steps on a corpus of 4 snippets
    (2 steps an epoch; checkpoints at 2 and 4, each with loader.bin), then
    a run that resumes from a copy of step 2: its step-4 checkpoint equals
    the straight run's bit for bit, loader state included. The resume
    crosses into the second epoch, where the other loaders' position skip
    (step % steps an epoch = 0) would replay the first epoch's batches."""
    from colvo_torch import pipelines

    render = pipelines.synthetic_dataset
    monkeypatch.setattr(pipelines, "synthetic_dataset",
                        lambda cfg: render(cfg, n_sequences=1, n_frames=5))
    ckpt_a, ckpt_b = tmp_path / "a" / "ckpt", tmp_path / "b" / "ckpt"
    try:  # (a checkpoint with Adam's moments is ~300 MB: none is left behind)
        assert cli.main(["train", "--max-steps", "4"] + _cli_args(tmp_path, "a")) == 0
        assert sorted(os.listdir(ckpt_a)) == ["2", "4"]
        for step in (2, 4):
            assert json.loads((ckpt_a / str(step) / "loader.bin").read_bytes())[
                "next_position"] == 2 * step
        os.makedirs(ckpt_b)
        shutil.move(ckpt_a / "2", ckpt_b / "2")
        assert cli.main(["train", "--max-steps", "4", "--resume"]
                        + _cli_args(tmp_path, "b")) == 0
        assert (ckpt_a / "4" / "loader.bin").read_bytes() \
            == (ckpt_b / "4" / "loader.bin").read_bytes()
        from test_torch_port_checkpoint import _flatten

        fa, fb = (dict(_flatten(torch.load(d / "4" / "state.pt", weights_only=True)))
                  for d in (ckpt_a, ckpt_b))
        assert fa.keys() == fb.keys()
        for key, v in fa.items():
            assert (torch.equal(v, fb[key]) if isinstance(v, torch.Tensor)
                    else v == fb[key]), key
    finally:
        shutil.rmtree(tmp_path / "a", ignore_errors=True)
        shutil.rmtree(tmp_path / "b", ignore_errors=True)
