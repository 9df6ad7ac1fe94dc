"""What the pretraining and finetuning drivers share: the staged chunks, the
first steps that the check reads, the measured window and the check.

A job builds ONE training state, drives it from the seed through its first
``checked_steps`` steps through the window's own call (one step to a call,
on rows that all differ), warms up a whole chunk, and hands that same state
to the window. The first steps leave three readings for the check: each
step's losses, the norm of each parameter's first gradient as the optimizer
got it (AdamW's first moment after one step is (1 - b1) times it; both sides
share b1, so the moments are compared) and the norm of each parameter's
change after the checked steps; where the state has an EMA teacher, also
the norm of each teacher parameter's change and of the DINO centre's. The
reference then follows the same steps from the same weights, inputs and
generator seeds (``correctness.py`` compares).
"""

from __future__ import annotations

import gc
import math
import time
from typing import List, Tuple

import numpy as np
import torch

from portbench import correctness, sut
from portbench.weights import make_weights
from portbench.words import font_name, make_words


class TrainingJob:
    """Subclasses give ``build(side, dtype, fp8)`` -> (state, step, model),
    ``charset()``, ``aux(masks, words)`` (the second input of a step, one
    row a word) and ``loss_keys``."""

    loss_keys: Tuple[str, ...] = ("loss",)

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.mix = ctx.cfg, ctx.mix
        self.batch = int(self.mix["batch"])
        self.k = int(self.mix["steps_per_call"])
        self.device = ctx.device

    # ------------------------------------------------------------- inputs
    def charset(self) -> str:
        raise NotImplementedError

    def render_calls(self) -> Tuple[np.ndarray, np.ndarray, List[List[str]]]:
        """(raw uint8 (P, K, B, H, W, 3), aux (P, K, B, ...), words) for the
        ``distinct_calls`` chunks; every row is a word of its own."""
        raws, auxes, words = [], [], []
        lo, hi = self.mix["word_length"]
        for p in range(int(self.mix["distinct_calls"])):
            img, masks, w = make_words(self.ctx.seed, p, self.k * self.batch, self.charset(), lo,
                                       hi, tuple(self.mix["face_sizes"]))
            shape = (self.k, self.batch)
            raws.append(img.reshape(shape + img.shape[1:]))
            a = self.aux(masks, w)
            auxes.append(a.reshape(shape + a.shape[1:]))
            words.append(w)
        return np.stack(raws), np.stack(auxes), words

    def aux(self, masks: np.ndarray, words: List[str]) -> np.ndarray:
        raise NotImplementedError

    # -------------------------------------------------------------- set-up
    def setup(self) -> None:
        raws, auxes, self.words = self.render_calls()
        checked = int(self.mix["checked_steps"])
        if checked > self.k:
            raise ValueError(f"checked_steps {checked} > steps_per_call {self.k}: the checked "
                             "steps take their rows from the first chunk")
        # the checked steps' rows, kept on the host for the reference
        self.first_rows = (raws[0, :checked].copy(), auxes[0, :checked].copy())
        self.calls = [(torch.from_numpy(r).to(self.device), torch.from_numpy(a).to(self.device))
                      for r, a in zip(raws, auxes)]
        self.traffic = {"font": font_name(), "words": sum(len(w) for w in self.words),
                        "mean_word_length": float(np.mean([len(x) for w in self.words
                                                           for x in w]))}
        side = self.ctx.side
        self.state, self.step, self.model = self.build(side, self.ctx.dtype, self.ctx.fp8)
        self.step = self.ctx.broken(self.step)
        self.record = self.first_steps(self.state, self.step, self.model, self.calls[0], checked)
        self.state, metrics = self.step(self.state, *self.calls[1 % len(self.calls)])  # warm-up
        self._finite(metrics["loss"])
        self.next_call = 0

    def first_steps(self, state, step, model, call, n: int) -> dict:
        """Run ``n`` steps, one a call, on rows 0..n-1 of ``call``."""
        names = [name for name, _ in model.named_parameters()]
        losses, grad = [], None
        centre = state.center.detach().clone() if hasattr(state, "center") else None
        for i in range(n):
            state, m = step(state, call[0][i:i + 1], call[1][i:i + 1])
            losses.append([float(m[key][0]) for key in self.loss_keys])
            if i == 0:
                grad = {name: float(mu.float().norm())
                        for name, mu in zip(names, state.opt_state.mu)}
        params = dict(model.named_parameters())
        init = make_weights({name: tuple(p.shape) for name, p in params.items()},
                            self.ctx.seed, params[names[0]].device)
        change = {name: float((p.detach() - init[name]).norm()) for name, p in params.items()}
        record = {"losses": losses, "grad": grad, "change": change}
        if hasattr(state, "teacher"):
            # the teacher starts as the student's backbone and head
            record["teacher_change"] = dict(
                {name: float((p.detach() - init[name]).norm())
                 for name, p in state.teacher.named_parameters()},
                center=float((state.center - centre).norm()))
        return record

    @staticmethod
    def _finite(losses: torch.Tensor) -> None:
        if not bool(torch.isfinite(losses).all()):
            raise RuntimeError(f"a loss of the warm-up is not finite: {losses.tolist()}")

    # -------------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        """Whole chunks until ``seconds`` have passed; the window ends when
        the last chunk's steps have finished on the card."""
        images_per_call = self.k * self.batch
        losses, marks = [], []
        sync(self.device)
        t0 = time.perf_counter()
        start = event(self.device)
        calls = 0
        while True:
            self.state, m = self.step(self.state, *self.calls[self.next_call])
            self.next_call = (self.next_call + 1) % len(self.calls)
            losses.append(m["loss"])
            marks.append(event(self.device))
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        losses = torch.cat([x.reshape(-1) for x in losses]).cpu()  # waits for the last step
        elapsed = time.perf_counter() - t0
        failed = int((~torch.isfinite(losses)).sum())
        done_s = [start.elapsed_time(e) / 1e3 for e in marks] if start is not None else []
        return {"attempted": calls * self.k, "failed": failed, "elapsed_s": elapsed,
                "profile": profile(done_s, images_per_call),
                "metrics": {"train_images_per_s": calls * images_per_call / elapsed}}

    def traced_segment(self) -> dict:
        """What the traced run records: ``traced_calls`` whole chunks."""
        n = int(self.mix["traced_calls"])
        for _ in range(n):
            self.state, _ = self.step(self.state, *self.calls[self.next_call])
            self.next_call = (self.next_call + 1) % len(self.calls)
        return {"steps": n * self.k, "images": n * self.k * self.batch}

    def release(self) -> None:
        self.state = self.step = self.model = self.calls = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --------------------------------------------------------------- check
    def check(self) -> List[dict]:
        """The reference follows the checked steps in float32 (TF32 off)."""
        ref = sut.reference()
        with correctness.exact_float32():
            state, step, model = self.build(ref, torch.float32, False)
            call = tuple(torch.from_numpy(x).to(self.device) for x in self.first_rows)
            rec = self.first_steps(state, step, model, call, len(self.first_rows[0]))
        del state, step, model
        return correctness.training_numbers(self.record, rec, self.ctx.limits)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def event(device: torch.device):
    """A CUDA event recorded now on the current stream (None on the CPU)."""
    if device.type != "cuda":
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def profile(done_s: List[float], per_unit: int, parts: int = 5) -> List[float]:
    """Units a second in each fifth of the window, from each unit's
    completion time (seconds from the window's start): where a window
    is slow, whether throughout or in bursts."""
    if not done_s:
        return []
    end = done_s[-1]
    edges = [end * i / parts for i in range(parts + 1)]
    return [sum(1 for t in done_s if a < t <= b) * per_unit / (b - a)
            for a, b in zip(edges, edges[1:])]


def cosine_total(epochs: float, images: int, batch: int) -> Tuple[int, int]:
    """(iterations an epoch, total iterations) of a schedule over ``images``."""
    per_epoch = max(math.ceil(images / batch), 1)
    return per_epoch, max(int(epochs * per_epoch), 1)
