"""Synthetic scene-text data generation (for tests, smoke runs and benches).

Renders random words onto noisy backgrounds with PIL, producing exactly the
artifacts the real pipeline consumes: RGB text images, ground-truth glyph
masks, and label strings. Also writes reference-layout LMDB environments
(image-%09d / label-%09d / num-samples [+ mask-%09d]) so the full LMDB
dataset/eval stack can be exercised end-to-end without external data.
"""

from __future__ import annotations

import io
import os
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

from ccd_tpu_torch.charsets import DICT36
from ccd_tpu_torch.data.lmdb import LmdbWriter


_FONT_DIR = "/usr/share/fonts/truetype/dejavu"
_HARD_FONTS = ("DejaVuSans-Bold.ttf", "DejaVuSans.ttf", "DejaVuSerif.ttf",
               "DejaVuSerif-Bold.ttf", "DejaVuSansMono.ttf",
               "DejaVuSansMono-Bold.ttf")


def _font(size: int = 22, name: Optional[str] = None):
    names = (name,) if name else ("DejaVuSans-Bold.ttf", "DejaVuSans.ttf")
    for fname in names:
        path = os.path.join(_FONT_DIR, fname)
        if os.path.exists(path):
            return ImageFont.truetype(path, size)
    return ImageFont.load_default()


def render_word(word: str, h: int = 32, w: int = 128,
                rng: Optional[np.random.Generator] = None,
                hard: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Render a word -> (RGB uint8 (h, w, 3), glyph mask float (h, w)).

    ``hard=True`` widens the rendering distribution (6 font faces, off-center
    placement, ±8° rotation, lower fg/bg contrast, heavier noise) so a
    recognizer cannot trivially memorize one glyph style — used by the
    convergence demo to create a task where self-supervised pretraining
    measurably helps a label-starved finetune.
    """
    rng = rng or np.random.default_rng(0)
    if hard:
        bg = int(rng.integers(110, 250))
        fg = int(rng.integers(0, max(bg - 45, 1)))
        font = _font(int(rng.integers(14, 26)),
                     _HARD_FONTS[int(rng.integers(0, len(_HARD_FONTS)))])
        noise_sigma = float(rng.uniform(2.0, 12.0))
        jx, jy = int(rng.integers(-10, 11)), int(rng.integers(-3, 4))
        angle = float(rng.uniform(-8.0, 8.0))
    else:
        bg = int(rng.integers(140, 250))
        fg = int(rng.integers(0, max(bg - 90, 1)))
        font = _font(int(rng.integers(18, 26)))
        noise_sigma, jx, jy, angle = 4.0, int(rng.integers(-4, 5)), \
            int(rng.integers(-2, 3)), 0.0
    img = Image.new("L", (w, h), color=bg)
    draw = ImageDraw.Draw(img)
    bbox = draw.textbbox((0, 0), word, font=font)
    tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
    x = max((w - tw) // 2 + jx, 0) - bbox[0]
    y = max((h - th) // 2 + jy, 0) - bbox[1]
    draw.text((x, y), word, fill=fg, font=font)
    gray = np.asarray(img, np.uint8)
    mask = (gray < (fg + bg) // 2).astype(np.uint8)
    if angle:
        gimg = Image.fromarray(gray).rotate(angle, resample=Image.BILINEAR,
                                            fillcolor=bg)
        mimg = Image.fromarray(mask * 255).rotate(angle,
                                                  resample=Image.NEAREST)
        gray = np.asarray(gimg, np.uint8)
        mask = (np.asarray(mimg, np.uint8) > 127).astype(np.uint8)
    noise = rng.normal(0, noise_sigma, gray.shape)
    rgb = np.clip(gray[..., None].astype(np.float32) + noise[..., None], 0, 255)
    rgb = np.repeat(rgb, 3, axis=-1).astype(np.uint8)
    return rgb, mask.astype(np.float32)


def random_words(n: int, rng: np.random.Generator, min_len: int = 2,
                 max_len: int = 8) -> List[str]:
    chars = np.array(list(DICT36))
    return ["".join(rng.choice(chars, size=int(rng.integers(min_len, max_len + 1))))
            for _ in range(n)]


def make_synthetic_batch(n: int, h: int = 32, w: int = 128, seed: int = 0
                         ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """(images uint8 (N,h,w,3), masks float (N,h,w), words)."""
    rng = np.random.default_rng(seed)
    words = random_words(n, rng)
    images = np.zeros((n, h, w, 3), np.uint8)
    masks = np.zeros((n, h, w), np.float32)
    for i, word in enumerate(words):
        images[i], masks[i] = render_word(word, h, w, rng)
    return images, masks, words


def write_synthetic_lmdb(path: str, n: int, seed: int = 0, with_mask_lmdb: bool = False,
                         mask_path: Optional[str] = None, h: int = 48, w: int = 160,
                         hard: bool = False) -> List[str]:
    """Write a reference-layout LMDB of rendered words; returns the labels.

    Images are stored PNG-encoded at a different (h, w) than the model input
    so the resize path is exercised. If ``with_mask_lmdb``, a parallel mask
    environment is written at ``mask_path`` (mask-%09d keys), mirroring
    mask_create/generate_mask.py's output layout.
    """
    rng = np.random.default_rng(seed)
    words = random_words(n, rng)
    mask_writer = LmdbWriter(mask_path) if with_mask_lmdb and mask_path else None
    with LmdbWriter(path) as w_:
        for i, word in enumerate(words):
            img, mask = render_word(word, h, w, rng, hard=hard)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            w_.put(f"image-{i + 1:09d}".encode(), buf.getvalue())
            w_.put(f"label-{i + 1:09d}".encode(), word.encode())
            if mask_writer is not None:
                mbuf = io.BytesIO()
                Image.fromarray((mask * 255).astype(np.uint8)).save(mbuf, format="PNG")
                mask_writer.put(f"mask-{i + 1:09d}".encode(), mbuf.getvalue())
        w_.put(b"num-samples", str(n).encode())
    if mask_writer is not None:
        mask_writer.put(b"num-samples", str(n).encode())
        mask_writer.close()
    return words
