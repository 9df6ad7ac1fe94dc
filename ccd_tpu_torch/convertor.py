"""Text <-> index <-> tensor label codecs for the recognition pipeline.

Parity targets: ``Dino/convertor/base.py`` (``BaseConvertor``) and
``Dino/convertor/attn.py`` (``AttnConvertor``). The special-token id layout
must match exactly — for DICT90 with unknown: chars 0..89, ``<UKN>``=90,
``<BOS/EOS>``=91 (shared), ``<PAD>``=92, num_classes=93.

Tensors are numpy arrays (host-side codec; the model consumes the int arrays).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ccd_tpu_torch.charsets import DICTS
from ccd_tpu_torch.utils.tracing import span


class BaseConvertor:
    """Base text/index convertor over one of the DICT* charsets."""

    start_idx = end_idx = padding_idx = 0
    unknown_idx: Optional[int] = None
    lower = False

    def __init__(self, dict_type: str = "DICT90", dict_file: Optional[str] = None,
                 dict_list: Optional[Sequence[str]] = None):
        self.idx2char: List[str] = []
        if dict_file is not None:
            with open(dict_file) as f:
                for line_num, raw in enumerate(f):
                    line = raw.strip("\r\n")
                    if len(line) > 1:
                        raise ValueError(
                            f"Expect each line has 0 or 1 character, got {len(line)} "
                            f"characters at line {line_num + 1}")
                    if line != "":
                        self.idx2char.append(line)
        elif dict_list is not None:
            self.idx2char = list(dict_list)
        else:
            if dict_type not in DICTS:
                raise NotImplementedError(f"Dict type {dict_type} is not supported")
            self.idx2char = list(DICTS[dict_type])

        assert len(set(self.idx2char)) == len(self.idx2char), \
            "Invalid dictionary: Has duplicated characters."
        self.char2idx = {c: i for i, c in enumerate(self.idx2char)}

    def num_classes(self) -> int:
        return len(self.idx2char)

    def str2idx(self, strings: Sequence[str]) -> List[List[int]]:
        indexes = []
        for string in strings:
            if self.lower:
                string = string.lower()
            index = []
            for char in string:
                char_idx = self.char2idx.get(char, self.unknown_idx)
                if char_idx is None:
                    raise ValueError(
                        f"Character: {char} not in dict; use a custom dict file or "
                        f"set with_unknown=True")
                index.append(char_idx)
            indexes.append(index)
        return indexes

    def idx2str(self, indexes: Sequence[Sequence[int]]) -> List[str]:
        with span("convert"):
            return ["".join(self.idx2char[int(i)] for i in index) for index in indexes]


class AttnConvertor(BaseConvertor):
    """Convertor for the attention (encoder-decoder) recognition pipeline.

    Appends ``<UKN>`` (optional), ``<BOS/EOS>`` (shared start/end id by
    default) and ``<PAD>`` to the base charset, and converts strings to
    BOS+text+EOS sequences padded to ``max_seq_len``.
    """

    def __init__(self, dict_type: str = "DICT90", dict_file: Optional[str] = None,
                 dict_list: Optional[Sequence[str]] = None, with_unknown: bool = True,
                 max_seq_len: int = 40, lower: bool = False, start_end_same: bool = True,
                 **kwargs):
        super().__init__(dict_type, dict_file, dict_list)
        self.with_unknown = bool(with_unknown)
        self.max_seq_len = int(max_seq_len)
        self.lower = bool(lower)
        self.start_end_same = bool(start_end_same)
        self._update_dict()

    def _update_dict(self) -> None:
        self.unknown_idx = None
        if self.with_unknown:
            self.idx2char.append("<UKN>")
            self.unknown_idx = len(self.idx2char) - 1
        self.idx2char.append("<BOS/EOS>")
        self.start_idx = len(self.idx2char) - 1
        if not self.start_end_same:
            self.idx2char.append("<BOS/EOS>")
        self.end_idx = len(self.idx2char) - 1
        self.idx2char.append("<PAD>")
        self.padding_idx = len(self.idx2char) - 1
        self.char2idx = {c: i for i, c in enumerate(self.idx2char)}

    def str2tensor(self, strings: Sequence[str]) -> np.ndarray:
        """Convert strings to an ``(N, max_seq_len)`` int32 padded target array.

        Each row is ``[BOS, c0, ..., ck, EOS, PAD, ...]``; rows longer than
        ``max_seq_len`` are truncated (dropping the EOS), matching
        ``attn.py:71-105``.
        """
        indexes = self.str2idx(list(strings))
        out = np.full((len(indexes), self.max_seq_len), self.padding_idx, dtype=np.int32)
        for n, index in enumerate(indexes):
            src = [self.start_idx] + list(index) + [self.end_idx]
            if len(src) > self.max_seq_len:
                src = src[: self.max_seq_len]
            out[n, : len(src)] = src
        return out

    def tensor2idx(self, outputs: np.ndarray) -> Tuple[List[List[int]], List[List[float]]]:
        """Greedy-decode ``(N, T, C)`` scores to per-sample index/score lists.

        Applies a softmax over classes, argmaxes per step, skips PAD ids and
        stops at the first EOS, matching ``attn.py:107-139``. A ``convert``
        span, as ``idx2str``.
        """
        with span("convert"):
            outputs = np.asarray(outputs, dtype=np.float64)
            # softmax over classes
            m = outputs.max(axis=-1, keepdims=True)
            e = np.exp(outputs - m)
            probs = e / e.sum(axis=-1, keepdims=True)
            max_idx = probs.argmax(axis=-1)
            max_value = np.take_along_axis(probs, max_idx[..., None], axis=-1)[..., 0]

            indexes: List[List[int]] = []
            scores: List[List[float]] = []
            for n in range(outputs.shape[0]):
                str_index: List[int] = []
                str_score: List[float] = []
                for char_index, char_score in zip(max_idx[n].tolist(), max_value[n].tolist()):
                    if char_index == self.padding_idx:
                        continue
                    if char_index == self.end_idx:
                        break
                    str_index.append(char_index)
                    str_score.append(char_score)
                indexes.append(str_index)
                scores.append(str_score)
            return indexes, scores
