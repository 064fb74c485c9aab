"""colvo_torch's metrics writer and async logger, its panel colormap and PNG
writer, and its config files, against colvo's on the same inputs."""

import json
import os
import time

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

import colvo.runtime.metrics as jax_metrics
import colvo_torch.runtime.metrics as port_metrics
from colvo.config import ColvoConfig as JaxConfig
from colvo.evaluation.viz import colormap_depth as jax_colormap_depth
from colvo_torch.config import ColvoConfig
from colvo_torch.evaluation.viz import colormap_depth

torch.set_num_threads(2)

PACKAGES = {"colvo": jax_metrics, "colvo_torch": port_metrics}


def _rows(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _close(logger, writer):
    logger._q.put(None)
    logger._thread.join(timeout=30)
    assert not logger._thread.is_alive()
    writer.close()


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_sps_skipped_on_backlog(tmp_path, package):
    """An item queued before the previous fetch completed gets no
    steps_per_sec stamp (the gap measures the queue's drain)."""
    m = PACKAGES[package]
    writer = m.MetricsWriter(str(tmp_path), also_stdout=False)
    logger = m.AsyncMetricsLogger(writer)
    t = 100.0
    logger._process((500, t, {"loss/total": np.float32(1.0)}))
    logger._process((1000, t + 0.001, {"loss/total": np.float32(1.0)}))
    _close(logger, writer)
    rows = _rows(str(tmp_path))
    assert len(rows) == 2
    assert "steps_per_sec" not in rows[1], rows[1]


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_sps_stamped_when_waiting(tmp_path, package):
    m = PACKAGES[package]
    writer = m.MetricsWriter(str(tmp_path), also_stdout=False)
    logger = m.AsyncMetricsLogger(writer, fps_scale=12.0)
    logger._process((500, time.time(), {"loss/total": np.float32(1.0)}))
    time.sleep(0.05)
    logger._process((1000, time.time(), {"loss/total": np.float32(1.0)}))
    _close(logger, writer)
    rows = _rows(str(tmp_path))
    sps = rows[1]["steps_per_sec"]
    assert 0 < sps <= 500 / 0.05 * 1.1, sps
    assert rows[1]["fps"] == sps * 12.0


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_nan_guard_counts_consecutive(tmp_path, package):
    m = PACKAGES[package]
    writer = m.MetricsWriter(str(tmp_path), also_stdout=False)
    logger = m.AsyncMetricsLogger(writer)
    t = 100.0
    logger._process((1, t, {"loss/total": np.float32(np.nan)}))
    logger._process((2, t, {"loss/total": np.float32(np.nan)}))
    assert logger.bad_steps == 2
    logger._process((3, t, {"loss/total": np.float32(0.5)}))
    assert logger.bad_steps == 0
    _close(logger, writer)


def test_logger_rows_match_reference_layout(tmp_path):
    """The same feeds through both loggers' threads give rows with the same
    keys in the same order and the same values; the port's torch scalars
    (stacked into one DeviceScalars) read back exactly."""
    feeds = [(2, {"loss/total": 0.5, "grad_norm": 1.25}), (4, {"loss/total": 0.25})]
    for name, m in PACKAGES.items():
        writer = m.MetricsWriter(str(tmp_path / name), also_stdout=False)
        logger = m.AsyncMetricsLogger(writer, fps_scale=2.0)
        for step, scalars in feeds:
            if name == "colvo_torch":
                scalars = port_metrics.DeviceScalars(
                    {k: torch.tensor(v) for k, v in scalars.items()})
            logger.log(step, scalars)
        logger.close()
    want, got = _rows(str(tmp_path / "colvo")), _rows(str(tmp_path / "colvo_torch"))
    strip = lambda r: {k: v for k, v in r.items()  # noqa: E731
                       if k not in ("time", "steps_per_sec", "fps")}
    assert [strip(r) for r in got] == [strip(r) for r in want]
    assert [list(r)[:2] for r in got] == [["step", "time"]] * 2


def test_logger_thread_error_reaches_close(tmp_path):
    writer = port_metrics.MetricsWriter(str(tmp_path), also_stdout=False)
    logger = port_metrics.AsyncMetricsLogger(writer)
    logger.log(1, {"loss/total": "not a number"})
    logger.log(2, {"loss/total": 0.5})
    with pytest.raises(RuntimeError, match="metrics thread failed"):
        logger.close()
    assert isinstance(logger.error, ValueError)
    assert _rows(str(tmp_path)) == []


def test_log_drops_the_new_item_when_full(tmp_path):
    writer = port_metrics.MetricsWriter(str(tmp_path), also_stdout=False)
    logger = port_metrics.AsyncMetricsLogger(writer, max_pending=2)
    logger._q.put(None)  # park the thread: it exits, and the queue fills
    logger._thread.join(timeout=30)
    for step in (1, 2, 3, 4):
        logger.log(step, {"loss/total": 1.0})
    assert logger.dropped == 2
    assert [item[0] for item in logger._q.queue] == [1, 2]
    writer.close()


def test_colormap_depth_matches_reference():
    """Percentile limits and given limits, a flat map and a NaN pixel, to
    1e-7 (the port indexes a copy of matplotlib's magma table)."""
    rng = np.random.default_rng(0)
    depth = rng.gamma(2.0, 0.1, (64, 96)).astype(np.float32)
    for args in ((), (0.05, 0.3), (0.2, 0.2)):
        got, want = colormap_depth(depth, *args), jax_colormap_depth(depth, *args)
        assert got.dtype == want.dtype == np.float32 and got.shape == (64, 96, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    depth[5, 7] = np.nan
    np.testing.assert_allclose(colormap_depth(depth, 0.05, 0.3),
                               np.nan_to_num(jax_colormap_depth(depth, 0.05, 0.3)),
                               rtol=0, atol=1e-7)


def test_log_image_writes_a_png_that_decodes_to_the_array(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.random((37, 53, 3)).astype(np.float32)
    img[0, 0] = (-1.0, 2.0, 1.0)  # clipped
    writer = port_metrics.MetricsWriter(str(tmp_path), also_stdout=False)
    writer.log_image(7, "panels/disp", img)
    writer.close()
    back = imageio.imread(tmp_path / "panels_disp_00000007.png")
    assert back.shape == (37, 53, 3) and back.dtype == np.uint8
    np.testing.assert_array_equal(back, (np.clip(img, 0, 1) * 255).astype(np.uint8))


@pytest.mark.parametrize("direction", ["colvo_to_port", "port_to_colvo"])
def test_config_files_cross_packages(tmp_path, direction):
    overrides = ["data.frame_offsets=[-2,1]", "train.lr=3e-4", "loss.lcc_mode=gain",
                 "model.dtype=float32", "train.profile_steps=5:7"]
    src, dst = (JaxConfig, ColvoConfig) if direction == "colvo_to_port" else (ColvoConfig,
                                                                              JaxConfig)
    cfg = src().apply_overrides(overrides)
    path = str(tmp_path / "cfg.json")
    cfg.dump(path)
    back = dst.load(path)
    assert back.to_dict() == cfg.to_dict()
    assert back.data.frame_offsets == (-2, 1)
