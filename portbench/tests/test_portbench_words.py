"""The traffic generator: the same seed gives the same words and pixels,
and it fails rather than draw in a bitmap face."""

import numpy as np
import pytest
from PIL import ImageFont

from portbench import words

CHARS = "0123456789abcdefghijklmnopqrstuvwxyz"


def test_deterministic_in_the_seed():
    a = words.make_words(2**33 + 5, 0, 64, CHARS, 3, 12)
    b = words.make_words(2**33 + 5, 0, 64, CHARS, 3, 12)
    c = words.make_words(2**33 + 6, 0, 64, CHARS, 3, 12)
    assert a[2] == b[2] and np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert a[2] != c[2]
    assert all(3 <= len(w) <= 12 for w in a[2])
    assert a[0].shape == (64, 32, 128, 3) and a[0].dtype == np.uint8


def test_masks_cover_the_glyphs():
    images, masks, _ = words.make_words(11, 1, 32, CHARS, 3, 12)
    assert 0.03 < masks.mean() < 0.3


def test_fails_without_freetype(monkeypatch):
    bitmap = ImageFont.ImageFont()
    monkeypatch.setattr(ImageFont, "load_default", lambda size=None: bitmap)
    with pytest.raises(RuntimeError, match="bitmap"):
        words.make_words(1, 0, 2, CHARS, 3, 5)
