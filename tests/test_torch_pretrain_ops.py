"""The pretraining step's plain tensor ops in the port against the JAX
package, same numpy inputs, fp32, CPU.

Tolerances: 1e-6 for the bilinear resize and 1e-5 for the pooling and the
affine grid (small fp32 products summed in another order); 1e-5 for
``grid_sample`` on O(1) values. ``label_clusters`` and the packed binary warp
are compared EXACTLY: they are integer-valued decisions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ccd_tpu.ops import (affine_grid as jax_affine_grid,
                         char_attention_pool as jax_char_attention_pool,
                         grid_sample as jax_grid_sample,
                         label_clusters as jax_label_clusters,
                         resize_bilinear as jax_resize_bilinear)
from ccd_tpu.ops.warp import grid_sample_binary_packed as jax_packed_warp
from ccd_tpu_torch.ops.cc_label import label_clusters
from ccd_tpu_torch.ops.image import resize_bilinear
from ccd_tpu_torch.ops.pooling import char_attention_pool
from ccd_tpu_torch.ops.warp import affine_grid, grid_sample, grid_sample_binary_packed

FUZZ_N = 334  # masks per kind; one JAX compile serves all kinds


# ------------------------------------------------------------------ resize

@pytest.mark.parametrize("shape,out_hw,channel_last", [
    ((2, 26, 32, 128), (8, 32), False),     # cluster maps down to the token grid
    ((3, 1, 8, 32), (32, 128), False),      # upsampling
    ((2, 32, 128, 3), (16, 64), True),      # NHWC images
])
def test_resize_bilinear_matches_jax(shape, out_hw, channel_last):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(x), out_hw, channel_last=channel_last))
    out = resize_bilinear(torch.from_numpy(x), out_hw, channel_last=channel_last).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_resize_bilinear_matches_interpolate():
    x = np.random.default_rng(1).normal(size=(2, 5, 32, 128)).astype(np.float32)
    ref = torch.nn.functional.interpolate(torch.from_numpy(x), size=(8, 32), mode="bilinear")
    out = resize_bilinear(torch.from_numpy(x), (8, 32), channel_last=False)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


# ------------------------------------------------------------------ pooling

def test_char_attention_pool_matches_jax():
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(2, 8, 32, 16)).astype(np.float32)
    clusters = np.zeros((2, 26, 32, 128), dtype=np.float32)
    clusters[:, 0, 4:10, 8:24] = 1.0
    clusters[:, 1, 12:20, 60:90] = 1.0
    clusters[1, 2, 0:3, 100:128] = 1.0
    ref_vecs, ref_index = jax_char_attention_pool(jnp.asarray(feats), jnp.asarray(clusters))
    vecs, index = char_attention_pool(torch.from_numpy(feats), torch.from_numpy(clusters))
    np.testing.assert_allclose(vecs.numpy(), np.asarray(ref_vecs), atol=1e-5)
    np.testing.assert_array_equal(index.numpy(), np.asarray(ref_index))
    assert index.dtype == torch.bool and index.sum() == 5
    assert float(vecs[0, 3:].abs().max()) == 0.0  # empty slots pool to zero, not NaN


def test_char_attention_pool_bf16_features_pool_in_fp32():
    """fp32 weights against bf16 features promote to fp32, as the JAX einsum does."""
    feats = torch.randn(1, 8, 32, 16, generator=torch.Generator().manual_seed(0)).bfloat16()
    clusters = torch.zeros(1, 26, 32, 128)
    clusters[:, 0, 4:10, 8:24] = 1.0
    vecs, _ = char_attention_pool(feats, clusters)
    ref, _ = jax_char_attention_pool(jnp.asarray(feats.float().numpy()).astype(jnp.bfloat16),
                                     jnp.asarray(clusters.numpy()))
    assert vecs.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(vecs.numpy(), np.asarray(ref), atol=1e-5)


# ------------------------------------------------------------------ warp

def _thetas(rng, b, scale):
    theta = np.tile(np.eye(2, 3, dtype=np.float32), (b, 1, 1))
    return theta + rng.normal(scale=scale, size=theta.shape).astype(np.float32)


def test_affine_grid_matches_jax_and_torch():
    theta = _thetas(np.random.default_rng(4), 4, 0.15)
    ref = np.asarray(jax_affine_grid(jnp.asarray(theta), (32, 128)))
    out = affine_grid(torch.from_numpy(theta), (32, 128))
    assert out.shape == (4, 32, 128, 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    lib = torch.nn.functional.affine_grid(torch.from_numpy(theta), (4, 1, 32, 128),
                                          align_corners=False)
    np.testing.assert_allclose(out.numpy(), lib.numpy(), atol=1e-5)


@pytest.mark.parametrize("hw", [(32, 128), (48, 160)])  # JAX: dense path, gather path
def test_grid_sample_matches_jax(hw):
    rng = np.random.default_rng(11)
    h, w = hw
    x = rng.random((3, h, w, 4)).astype(np.float32)
    # wildly out-of-bounds grid plus a band of exact pixel-center coords
    g = rng.uniform(-1.9, 1.9, (3, h, w, 2)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(float(h)), np.arange(float(w)), indexing="ij")
    g[:, :8, :, 0] = (xs[:8] + 0.5) * 2 / w - 1
    g[:, :8, :, 1] = (ys[:8] + 0.5) * 2 / h - 1
    ref = np.asarray(jax_grid_sample(jnp.asarray(x), jnp.asarray(g)))
    out = grid_sample(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    if hw == (32, 128):  # powers of two: the pixel-center coords are exact
        np.testing.assert_array_equal(out[:, :8], x[:, :8])  # identity rows, bit for bit
    lib = torch.nn.functional.grid_sample(
        torch.from_numpy(x.transpose(0, 3, 1, 2)), torch.from_numpy(g), mode="bilinear",
        padding_mode="zeros", align_corners=False).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, lib, atol=1e-5)


@pytest.mark.parametrize("seed,scale", [(12, 0.1), (13, 0.3), (14, 0.02)])
def test_packed_warp_equals_jax_and_unpacked(seed, scale):
    """Packed-int32 binary warp == JAX's == per-channel grid_sample > 0.1,
    exactly (the pretrain hot-loop cluster/mask warp)."""
    rng = np.random.default_rng(seed)
    b, h, w, n_bits = 4, 32, 128, 27
    chans = (rng.random((b, h, w, n_bits)) < 0.3).astype(np.float32)
    theta = _thetas(rng, b, scale)
    packed = (chans.astype(np.int64) << np.arange(n_bits)).sum(-1).astype(np.int32)
    jgrid = jax_affine_grid(jnp.asarray(theta), (h, w))
    ref = np.asarray(jax_packed_warp(jnp.asarray(packed), jgrid, n_bits))
    grid = affine_grid(torch.from_numpy(theta), (h, w))
    got = grid_sample_binary_packed(torch.from_numpy(packed), grid, n_bits)
    assert got.dtype == torch.float32 and got.shape == (b, h, w, n_bits)
    np.testing.assert_array_equal(got.numpy(), ref)
    unpacked = (grid_sample(torch.from_numpy(chans), grid) > 0.1).float()
    np.testing.assert_array_equal(got.numpy(), unpacked.numpy())


# ------------------------------------------------------------------ CC labeling
# mask generators of tests/test_ops.py

def _random_blob_mask(rng, h=32, w=128, n_blobs=6):
    mask = np.zeros((h, w), dtype=np.float32)
    for _ in range(n_blobs):
        ch = rng.integers(4, h - 4)
        cw = rng.integers(6, w - 6)
        rh = rng.integers(2, 7)
        rw = rng.integers(2, 7)
        mask[max(0, ch - rh):ch + rh, max(0, cw - rw):cw + rw] = 1.0
    return mask


def _smoothed_noise_mask(rng, h=32, w=128, sigma=2.0, thresh=0.55):
    from scipy import ndimage as ndi
    x = ndi.gaussian_filter(rng.random((h, w)), sigma)
    x = (x - x.min()) / max(x.max() - x.min(), 1e-9)
    return (x > thresh).astype(np.float32)


def _serpentine():
    mask = np.zeros((32, 128), dtype=np.float32)
    for r, row in enumerate(range(1, 31, 3)):
        mask[row, 2:126] = 1.0
        if row + 3 < 31:
            if r % 2 == 0:
                mask[row:row + 4, 124:126] = 1.0
            else:
                mask[row:row + 4, 2:4] = 1.0
    return mask


def _speck_storm():
    """> 256 isolated specks (JAX's scatter-add path) before one real glyph."""
    mask = np.zeros((32, 128), dtype=np.float32)
    mask[0:18:2, 0:128:2] = 1.0  # 9 x 64 = 576 one-pixel components
    mask[20:30, 100:120] = 1.0
    return mask


def _assert_same_labels(masks):
    """The port's labels against JAX's; returns them and the flood rounds."""
    ref = np.asarray(jax_label_clusters(jnp.asarray(masks)))
    out, rounds = label_clusters(torch.from_numpy(masks))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert isinstance(rounds, int) and rounds >= 1
    np.testing.assert_array_equal(out.numpy(), ref)
    return out.numpy(), rounds


@pytest.mark.parametrize("kind", ["specks", "blobs", "mixed"])
def test_label_clusters_fuzz_equals_jax(kind):
    rng = np.random.default_rng({"specks": 21, "blobs": 22, "mixed": 23}[kind])
    masks = np.zeros((FUZZ_N, 32, 128), dtype=np.float32)
    for i in range(FUZZ_N):
        if kind == "specks":
            m = (rng.random((32, 128)) < rng.uniform(0.02, 0.25)).astype(np.float32)
        elif kind == "blobs":
            m = _smoothed_noise_mask(rng, sigma=rng.uniform(1.0, 3.0),
                                     thresh=rng.uniform(0.4, 0.7))
        else:  # glyph blobs + speck noise overlay
            m = _random_blob_mask(rng, n_blobs=int(rng.integers(1, 8)))
            m = np.maximum(m, (rng.random((32, 128)) < 0.05).astype(np.float32))
        masks[i] = m
    _assert_same_labels(masks)


def test_label_clusters_hard_cases_equal_jax():
    full, empty = np.ones((32, 128), np.float32), np.zeros((32, 128), np.float32)
    order = np.zeros((32, 128), np.float32)
    order[20:28, 100:110] = 1.0  # right blob, met second in raster order...
    order[2:10, 5:15] = 1.0      # ...left blob first
    area = np.zeros((32, 128), np.float32)
    area[2:4, 2:4] = 1.0         # 4 px, below min_area
    area[10:20, 40:50] = 1.0
    masks = np.stack([_serpentine(), _speck_storm(), full, empty, order, area])
    out, _ = _assert_same_labels(masks)
    assert out[0, 0].sum() == masks[0].sum() and out[0, 1:].sum() == 0  # one snake
    assert out[1, 0].sum() == 200 and out[1, 1:].sum() == 0             # specks filtered
    assert out[2, 0].sum() == 32 * 128 and out[3].sum() == 0
    assert out[4, 0, 5, 10] == 1.0 and out[4, 1, 24, 105] == 1.0        # left to right
    assert out[5, 0].sum() == 100 and out[5, 1:].sum() == 0


def test_label_clusters_more_than_26_glyphs_keeps_the_first_26_survivors():
    mask = np.zeros((1, 32, 128), np.float32)
    for i in range(30):            # 30 components of area 36, two rows of 15
        r, c = (2, 8 * i) if i < 15 else (20, 8 * (i - 15))
        mask[0, r:r + 6, c:c + 6] = 1.0
    out, rounds = _assert_same_labels(mask)
    assert (out[0].sum((1, 2)) == 36).all()
    assert rounds >= 1
