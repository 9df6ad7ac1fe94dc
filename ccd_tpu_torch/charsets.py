"""Character sets and charset-file mapping.

Parity targets: the DICT36/37/90/91 tuples of ``Dino/convertor/base.py:18-27``
and the tab-separated charset-file mapper of ``Dino/utils/utils.py:15-115``
(null char ``░`` at label 0, file labels shifted by +1).
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

DICT36 = tuple("0123456789abcdefghijklmnopqrstuvwxyz")
DICT37 = tuple("0123456789abcdefghijklmnopqrstuvwxyz ")
DICT90 = tuple(
    "0123456789abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ!\"#$%&'()"
    "*+,-./:;<=>?@[\\]_`~"
)
DICT91 = tuple(
    "0123456789abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ!\"#$%&'()"
    "*+,-./:;<=>?@[\\]_`~ "
)

DICTS: Dict[str, Sequence[str]] = {
    "DICT36": DICT36,
    "DICT37": DICT37,
    "DICT90": DICT90,
    "DICT91": DICT91,
}

NULL_CHAR = "░"  # light shade block '░'

_CHARSET_LINE = re.compile(r"(\d+)\t(.+)")


class CharsetMapper:
    """Maps ids <-> characters from a tab-separated charset file.

    File lines are ``<id>\\t<char>``; label 0 is reserved for the null char
    and file ids are shifted by +1, matching the reference mapper.
    """

    def __init__(self, filename: str = "", max_length: int = 30, null_char: str = NULL_CHAR):
        self.null_char = null_char
        self.max_length = max_length
        self.null_label = 0
        self.label_to_char = self._read_charset(filename)
        self.char_to_label = {c: l for l, c in self.label_to_char.items()}
        self.num_classes = len(self.label_to_char)

    def _read_charset(self, filename: str) -> Dict[int, str]:
        charset: Dict[int, str] = {self.null_label: self.null_char}
        with open(filename, "r") as f:
            for i, line in enumerate(f):
                m = _CHARSET_LINE.match(line)
                assert m, f"Incorrect charset file. line #{i}: {line}"
                charset[int(m.group(1)) + 1] = m.group(2)
        return charset

    def trim(self, text: str) -> str:
        return text.replace(self.null_char, "")

    def get_text(self, labels: Sequence[int], length: int = None, padding: bool = True,
                 trim: bool = False) -> str:
        length = length if length else self.max_length
        labels = [int(l) for l in labels]
        if padding:
            labels = labels + [self.null_label] * (length - len(labels))
        text = "".join(self.label_to_char[l] for l in labels)
        return self.trim(text) if trim else text

    def get_labels(self, text: str, length: int = None, padding: bool = True,
                   case_sensitive: bool = False) -> List[int]:
        length = length if length else self.max_length
        if padding:
            text = text + self.null_char * (length - len(text))
        if not case_sensitive:
            text = text.lower()
        return [self.char_to_label[c] for c in text]

    def pad_labels(self, labels: List[int], length: int = None) -> List[int]:
        length = length if length else self.max_length
        return labels + [self.null_label] * (length - len(labels))

    @property
    def digits(self) -> str:
        return "0123456789"

    @property
    def alphabets(self) -> str:
        return "".join(
            c for c in self.char_to_label
            if c in "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
        )


def write_charset_file(chars: Sequence[str], path: str) -> None:
    """Write a tab-separated charset file readable by :class:`CharsetMapper`."""
    with open(path, "w") as f:
        for i, c in enumerate(chars):
            f.write(f"{i}\t{c}\n")
