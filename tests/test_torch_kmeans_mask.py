"""The port's glyph-mask path (``ccd_tpu_torch/ops/kmeans_mask.py``,
``cli/generate_masks.py``) against the JAX package's
(``ccd_tpu/ops/kmeans_mask.py``, ``tools/generate_masks.py``), CPU; and the
finetune loop's ``Averager`` / ``Timer`` against the JAX classes.

The pixel assignment ``|x - c1| < |x - c0|`` is a strict comparison against
centroids that are fp32 sums, and the two frameworks sum in different
orders, so a pixel on the centroids' midpoint may land on either side. Held:
on rendered words, every pixel equal; on seeded random gray images (0-255
integers and [0, 1] floats), at most 1e-4 of the pixels differ, and each
differing pixel lies within 1e-3 relative of the midpoint of the two
centroids (computed in float64 by the same Lloyd steps, with
``chip_smoke.py``'s copy that the card's run uses). The border
flip both ways; the CLI's mask LMDB equal to the JAX tool's PNG for PNG, and
read by ``PretrainDataset``.
"""

import io
import sys
import time

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import tools.generate_masks as jax_generate_masks
from ccd_tpu.ops.kmeans_mask import kmeans_foreground_mask as jax_kmeans_foreground_mask
from ccd_tpu.utils.meters import Averager as JaxAverager
from ccd_tpu.utils.meters import Timer as JaxTimer
from ccd_tpu_torch.cli import generate_masks
from ccd_tpu_torch.data.dataset import PretrainDataset
from ccd_tpu_torch.data.lmdb import LmdbReader
from ccd_tpu_torch.data.synthetic import make_synthetic_batch, write_synthetic_lmdb
from ccd_tpu_torch.ops.kmeans_mask import kmeans_foreground_mask
from ccd_tpu_torch.utils.meters import Averager, Timer

from _torch_port import one_torch_thread  # noqa: F401
from chip_smoke import kmeans_centroids_float64

ITERS = 16
MAX_DIFF_SHARE, TIE_RTOL = 1e-4, 1e-3


def _both(gray: np.ndarray):
    got = kmeans_foreground_mask(torch.from_numpy(gray)).numpy()
    want = np.asarray(jax_kmeans_foreground_mask(jnp.asarray(gray)))
    return got, want


def _assert_equal_up_to_ties(gray, got, want):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == gray.shape
    assert set(np.unique(got)) <= {0.0, 1.0}
    differ = got != want
    assert differ.mean() <= MAX_DIFF_SHARE, differ.mean()
    c0, c1 = kmeans_centroids_float64(gray, ITERS)
    mid = ((c0 + c1) / 2).reshape(-1, 1, 1) * np.ones_like(gray, np.float64)
    x = gray.astype(np.float64)
    assert np.all(np.abs(x[differ] - mid[differ]) <= TIE_RTOL * np.abs(mid[differ]))


def _gray(images: np.ndarray) -> np.ndarray:
    return np.stack([cv2.cvtColor(im, cv2.COLOR_RGB2GRAY) for im in images]).astype(np.float32)


def test_rendered_words_match_jax_on_every_pixel():
    images, truth, _ = make_synthetic_batch(16, 32, 128, seed=5)
    for gray in (_gray(images), _gray(images) / 255.0,
                 np.stack([cv2.resize(g, (256, 64)) for g in _gray(images)])):
        got, want = _both(gray)
        np.testing.assert_array_equal(got, want)
    got, _ = _both(_gray(images))
    inter = (got * truth).sum((1, 2))
    union = np.maximum(got, truth).sum((1, 2))
    assert (inter / union).mean() > 0.5  # the masks find the glyphs


@pytest.mark.parametrize("scale", ["0_255", "0_1"])
def test_random_gray_images_match_jax_up_to_midpoint_ties(scale):
    rng = np.random.default_rng(11)
    if scale == "0_255":
        gray = rng.integers(0, 256, (12, 64, 256)).astype(np.float32)
    else:
        gray = rng.random((12, 64, 256), dtype=np.float32)
    got, want = _both(gray)
    _assert_equal_up_to_ties(gray, got, want)


@pytest.mark.parametrize("text", ["dark_on_light", "light_on_dark"])
def test_border_flip_makes_the_text_one(text):
    rng = np.random.default_rng(12)
    glyphs = np.zeros((3, 32, 128), bool)
    for i in range(3):
        glyphs[i, 8:24, 10 + 30 * i:30 + 30 * i] = True
    dark, light = rng.uniform(0, 60, glyphs.shape), rng.uniform(180, 255, glyphs.shape)
    gray = np.where(glyphs, dark, light) if text == "dark_on_light" \
        else np.where(glyphs, light, dark)
    gray = gray.astype(np.float32)
    got, want = _both(gray)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, glyphs.astype(np.float32))


def _run_jax_tool(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["generate_masks.py"] + argv)
    jax_generate_masks.main()


def test_generate_masks_cli_matches_the_jax_tool(tmp_path, monkeypatch):
    root = str(tmp_path / "data" / "training" / "SYNTH")
    write_synthetic_lmdb(root, 12, seed=13)
    port_root, jax_root = str(tmp_path / "port_masks"), str(tmp_path / "jax_masks")
    written = generate_masks.main(["--src", str(tmp_path / "data"), "--mask_root", port_root,
                                   "--batch", "5", "--device", "cpu"])
    assert written == {port_root + "/SYNTH": 12}
    _run_jax_tool(["--src", str(tmp_path / "data"), "--mask_root", jax_root, "--batch", "5"],
                  monkeypatch)
    with LmdbReader(port_root + "/SYNTH") as port, LmdbReader(jax_root + "/SYNTH") as ref:
        got, want = dict(port.items()), dict(ref.items())
    assert sorted(got) == sorted(want) and len(got) == 13
    for key, value in want.items():
        assert got[key] == value, key
    with LmdbReader(root) as src:
        image = cv2.imdecode(np.frombuffer(src.get(b"image-000000001"), np.uint8),
                             cv2.IMREAD_GRAYSCALE)
    mask = np.asarray(Image.open(io.BytesIO(got[b"mask-000000001"])))
    assert mask.shape == image.shape and set(np.unique(mask)) <= {0, 255}

    ds = PretrainDataset(path=root, is_training=False, mask=True, mask_path=port_root)
    assert ds.mask_env is not None and len(ds) == 12
    for i in range(len(ds)):
        image, mask = ds[i]
        assert image.shape == (32, 128, 3) and mask.shape == (32, 128) and mask.sum() > 0


def test_averager_and_timer_match_jax(monkeypatch):
    got, want = Averager(), JaxAverager()
    assert got.val() == want.val() == 0.0
    for v in (1.5, np.float32(2.25), torch.tensor(3.0)):
        got.add(v)
        want.add(float(v))
    assert (got.n_count, got.sum, got.val()) == (want.n_count, want.sum, want.val())
    got.reset()
    assert (got.n_count, got.sum, got.val()) == (0, 0.0, 0.0)

    assert (Timer().average_data_time(), Timer().average_running_time()) == (0.0, 0.0)
    clock = None
    monkeypatch.setattr(time, "time", lambda: next(clock))
    timers = []
    for cls in (Timer, JaxTimer):
        clock = iter([10.0, 11.0, 11.5, 14.0, 20.0, 21.0])
        t = cls()            # 10.0
        t.tic()              # 11.0
        t.toc_data()         # 11.5: data 0.5
        t.toc_running()      # 14.0: running 2.5
        t.tic()              # 20.0
        t.toc_data()         # 21.0: data 1.0
        timers.append((t.data_total_time, t.data_call, t.running_total_time, t.running_call,
                       t.average_data_time(), t.average_running_time()))
    assert timers[0] == timers[1] == (1.5, 2, 2.5, 1, 0.75, 2.5)
