"""The benchmark's traffic generator: random words rendered as 32x128 word
crops, with their glyph masks, from ``--seed`` alone.

One general generator for every traffic mix: a mix (``portbench/traffic/*.json``)
gives the word lengths, the batch and how many distinct batches to make.
The words are drawn from the configuration's character set; each is drawn
in Pillow's own FreeType face (``ImageFont.load_default(size=...)``, which
Pillow carries in its package, so no font file is read from the machine),
at a size, grey levels, placement and noise drawn per word. The generator
fails, rather than falls back to a bitmap face, where that face is not
FreeType: a bitmap face draws far under the line height and leaves most
character slots empty.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

H, W = 32, 128


def freetype_face(size: int):
    """Pillow's bundled FreeType face at ``size`` pixels; raises where Pillow
    has none (before 10.1, or built without FreeType)."""
    try:
        font = ImageFont.load_default(size=size)
    except TypeError as e:  # Pillow before 10.1 takes no size
        raise RuntimeError(f"Pillow's bundled FreeType face is not available: {e}") from e
    if not isinstance(font, ImageFont.FreeTypeFont):
        raise RuntimeError("Pillow's default face is a bitmap face here (no FreeType): the "
                           "words would be drawn far under the line height")
    return font


def font_name(size: int = 22) -> str:
    return " ".join(freetype_face(size).getname())


def draw_words(rng: np.random.Generator, n: int, charset: Sequence[str], min_len: int,
               max_len: int) -> List[str]:
    chars = np.array(list(charset))
    lengths = rng.integers(min_len, max_len + 1, size=n)
    return ["".join(rng.choice(chars, size=int(k))) for k in lengths]


def render(word: str, size: int, bg: int, fg: int, jx: int, jy: int,
           faces: dict) -> Tuple[np.ndarray, np.ndarray]:
    """One word -> (uint8 grey (H, W), uint8 glyph mask (H, W)), drawn at
    ``size`` pixels, shrunk until the word fits the width."""
    img = Image.new("L", (W, H), color=bg)
    draw = ImageDraw.Draw(img)
    while True:
        if size not in faces:
            faces[size] = freetype_face(size)
        x0, y0, x1, y1 = draw.textbbox((0, 0), word, font=faces[size])
        if x1 - x0 <= W - 4 or size <= 8:
            break
        size -= 1
    x = max((W - (x1 - x0)) // 2 + jx, 0) - x0
    y = max((H - (y1 - y0)) // 2 + jy, 0) - y0
    draw.text((x, y), word, fill=fg, font=faces[size])
    gray = np.asarray(img, np.uint8)
    return gray, (gray < (fg + bg) // 2).astype(np.uint8)


def make_words(seed: int, stream: int, n: int, charset: Sequence[str], min_len: int,
               max_len: int, sizes: Tuple[int, int] = (18, 26)
               ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """``n`` words of ``min_len``..``max_len`` characters: (uint8 images
    (n, H, W, 3), uint8 masks (n, H, W), the words). Per word a face size in
    ``sizes``, a background and a darker ink, a shift of the placement, and
    Gaussian noise of 4 grey levels. The same (seed, stream) gives the same
    words and pixels."""
    rng = np.random.default_rng([int(seed) % (1 << 63), int(stream)])
    words = draw_words(rng, n, charset, min_len, max_len)
    size = rng.integers(sizes[0], sizes[1] + 1, size=n)
    bg = rng.integers(140, 250, size=n)
    fg = (rng.random(n) * (bg - 90)).astype(np.int64)
    jx, jy = rng.integers(-4, 5, size=n), rng.integers(-2, 3, size=n)
    gray = np.empty((n, H, W), np.uint8)
    masks = np.empty((n, H, W), np.uint8)
    faces: dict = {}
    for i, word in enumerate(words):
        gray[i], masks[i] = render(word, int(size[i]), int(bg[i]), int(fg[i]), int(jx[i]),
                                   int(jy[i]), faces)
    noisy = gray.astype(np.float32) + rng.normal(0.0, 4.0, gray.shape).astype(np.float32)
    images = np.repeat(np.clip(noisy, 0, 255).astype(np.uint8)[..., None], 3, axis=-1)
    return images, masks, words
