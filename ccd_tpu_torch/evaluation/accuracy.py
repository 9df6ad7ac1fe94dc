"""Word/char accuracy + edit-distance metrics for text recognition.

Parity target: ``Dino/metric/eval_acc.py`` (``TextAccuracy``): metrics
``{ccr, cwr, ted, ned, ted/w, words, time}`` with the same normalization —
lowercase + strip everything that is not ASCII alphanumeric or CJK
(``re.compile('[^A-Z^a-z^0-9^\\u4e00-\\u9fa5]')``).

The framework-facing API is functional: feed batches of (predicted, ground
truth) strings via :meth:`TextAccuracy.update`; a convenience
:meth:`TextAccuracy.compute` drives a ``predict_fn`` over a dataloader.
"""

from __future__ import annotations

import re
import time
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from ccd_tpu_torch.evaluation.editdistance import levenshtein
from ccd_tpu_torch.parallel.mesh import Group, all_reduce_max, all_reduce_sum, default_group

_NORMALIZE = re.compile("[^A-Z^a-z^0-9^一-龥]")


class TextAccuracy:
    """Accumulates char/word accuracy and edit-distance metrics."""

    names = ("ccr", "cwr", "ted", "ned", "ted/w", "words", "time")

    def __init__(self, case_sensitive: bool = False):
        self.case_sensitive = case_sensitive
        self.total_num_char = 0.0
        self.total_num_word = 0.0
        self.correct_num_char = 0.0
        self.correct_num_word = 0.0
        self.total_ed = 0.0
        self.total_ned = 0.0
        self.inference_time = 0.0

    def update(self, pt_text: Sequence[str], gt_text: Sequence[str]) -> None:
        for pred, gt in zip(pt_text, gt_text):
            gt_cmp, pred_cmp = gt, pred
            if not self.case_sensitive:
                gt_cmp = _NORMALIZE.sub("", gt.lower())
                pred_cmp = _NORMALIZE.sub("", pred.lower())
            if gt_cmp == pred_cmp:
                self.correct_num_word += 1
            distance = levenshtein(gt_cmp, pred_cmp)
            self.total_ed += distance
            self.total_ned += float(distance) / max(len(gt), 1)
            self.total_num_word += 1
            # raw (un-normalized) per-character positional accuracy
            for a, b in zip(gt, pred):
                if a == b:
                    self.correct_num_char += 1
            self.total_num_char += len(gt)

    def merge(self, other: "TextAccuracy") -> None:
        """Fold another accumulator's counters into this one (counters sum;
        inference time takes the max — shards run concurrently)."""
        self.total_num_char += other.total_num_char
        self.total_num_word += other.total_num_word
        self.correct_num_char += other.correct_num_char
        self.correct_num_word += other.correct_num_word
        self.total_ed += other.total_ed
        self.total_ned += other.total_ned
        self.inference_time = max(self.inference_time, other.inference_time)

    _COUNTERS = ("total_num_char", "total_num_word", "correct_num_char", "correct_num_word",
                 "total_ed", "total_ned")

    def synchronize_between_processes(self, group: Group = None) -> None:
        """Sum the counters over ``group`` (default: the default group) and
        take the largest inference time, as :meth:`merge` folds shards that
        ran side by side (parity: the reference's meter ``dist.all_reduce``,
        ``Dino/modules/utils.py:253-264``); no-op without a group."""
        group = default_group() if group is None else group
        if group is None:
            return
        sums = all_reduce_sum(torch.tensor([getattr(self, k) for k in self._COUNTERS],
                                           dtype=torch.float64), group, "accuracy")
        for k, v in zip(self._COUNTERS, sums.tolist()):
            setattr(self, k, v)
        self.inference_time = float(all_reduce_max(
            torch.tensor([self.inference_time], dtype=torch.float64), group, "accuracy_time")[0])

    def result(self) -> Dict[str, float]:
        mets = [
            self.correct_num_char / max(self.total_num_char, 1),
            self.correct_num_word / max(self.total_num_word, 1),
            self.total_ed,
            self.total_ned,
            self.total_ed / max(self.total_num_word, 1),
            self.total_num_word,
            self.inference_time,
        ]
        return dict(zip(self.names, mets))

    def compute(self, predict_fn: Callable[[object], List[str]],
                dataloader: Iterable[Tuple[object, Sequence[str]]]) -> Dict[str, float]:
        """Run ``predict_fn(images) -> list[str]`` over ``(images, gt_texts)`` batches."""
        for images, gt_texts in dataloader:
            start = time.time()
            pt_texts = predict_fn(images)
            self.inference_time += time.time() - start
            self.update(pt_texts, list(gt_texts))
        return self.result()
