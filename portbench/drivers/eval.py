"""Recognition traffic: ``evaluation/runner.py::decode`` over batches of
uint8 word crops copied to the card inside the window, with one batch in
flight: batch n+1 is issued before batch n's probabilities are read back and
turned into strings by the configuration's ``AttnConvertor``. A batch's
latency runs from its issue to its strings on the host."""

from __future__ import annotations

import collections
import gc
import statistics
import time
from typing import List

import numpy as np
import torch

from portbench import correctness, sut
from portbench.drivers.recognizer import build_recognizer
from portbench.drivers.training import profile, sync
from portbench.reference.models.layers import set_fp8
from portbench.words import font_name, make_words

IMAGE_STREAM = 100  # the words' stream of the seed (training mixes use 0, 1, ...)


class Job:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.mix = ctx.cfg, ctx.mix
        self.batch = int(self.mix["batch"])
        self.device = ctx.device

    def setup(self) -> None:
        side, lo_hi = self.ctx.side, self.mix["word_length"]
        charset = "".join(side.DICTS[self.cfg["dataset"]["charset_type"]])
        pool = [make_words(self.ctx.seed, IMAGE_STREAM + p, self.batch, charset, *lo_hi,
                           tuple(self.mix["face_sizes"]))
                for p in range(int(self.mix["distinct_batches"]))]
        lengths = [len(w) for _, _, words in pool for w in words]
        pool = [images for images, _, _ in pool]
        self.host_images = np.stack(pool)
        self.traffic = {"font": font_name(), "words": len(lengths),
                        "mean_word_length": float(np.mean(lengths))}
        pin = self.device.type == "cuda"
        self.pool = [torch.from_numpy(x).pin_memory() if pin else torch.from_numpy(x)
                     for x in pool]
        self.model, self.convertor = build_recognizer(side, self.cfg, self.device,
                                                      self.ctx.dtype, self.ctx.seed)
        if self.ctx.fp8:
            set_fp8(self.model)
        self.model.eval()
        self.decode = self.ctx.broken(side.decode)
        probs_shape = (self.batch, self.cfg["decoder"]["max_seq_len"],
                       self.convertor.num_classes() - 1)
        self.buffers = [torch.empty(probs_shape, dtype=torch.float32, pin_memory=pin)
                        for _ in range(int(self.mix["in_flight"]) + 1)]
        self.next_batch = 0
        self.run_batches(len(self.pool), record=False)  # warm-up: every buffer and batch

    # -------------------------------------------------------------- window
    def run_batches(self, count: int = 0, seconds: float = 0.0, record: bool = True) -> dict:
        """Issue batches (``count`` of them, or until ``seconds`` have passed)
        with ``in_flight`` batches ahead of the one read back."""
        pending = collections.deque()
        done = []
        in_flight = int(self.mix["in_flight"])
        sync(self.device)
        t0 = time.perf_counter()
        issued = 0
        while (issued < count) if count else (time.perf_counter() - t0 < seconds):
            p = self.next_batch % len(self.pool)
            buf = self.buffers[self.next_batch % len(self.buffers)]
            t_issue = time.perf_counter()
            images = self.pool[p].to(self.device, non_blocking=True)
            buf.copy_(self.decode(self.model, images), non_blocking=True)
            ready = torch.cuda.Event() if self.device.type == "cuda" else None
            if ready is not None:
                ready.record()
            pending.append((p, t_issue, buf, ready))
            self.next_batch += 1
            issued += 1
            if len(pending) > in_flight:
                done.append(self.finish(*pending.popleft()))
        while pending:
            done.append(self.finish(*pending.popleft()))
        elapsed = time.perf_counter() - t0
        return {"batches": done, "elapsed_s": elapsed,
                "profile": profile([b["done_at"] - t0 for b in done], self.batch)} \
            if record else {}

    def finish(self, p: int, t_issue: float, buf: torch.Tensor, ready) -> dict:
        if ready is not None:
            ready.synchronize()
        probs = buf.numpy()
        indexes, _ = self.convertor.tensor2idx(probs)
        strings = self.convertor.idx2str(indexes)
        now = time.perf_counter()
        tokens = probs.argmax(-1)
        return {"pool": p, "latency_s": now - t_issue, "done_at": now,
                "tokens": tokens.astype(np.int16),
                "served_prob": np.take_along_axis(probs, tokens[..., None], -1)[..., 0],
                "finite": bool(np.isfinite(probs).all()), "strings": strings}

    def window(self, seconds: float) -> dict:
        out = self.run_batches(seconds=seconds)
        self.done = out["batches"]
        images = len(self.done) * self.batch
        latencies_ms = [b["latency_s"] * 1e3 for b in self.done]
        p95 = statistics.quantiles(latencies_ms, n=20, method="inclusive")[18] \
            if len(latencies_ms) > 1 else latencies_ms[0]
        return {"attempted": len(self.done),
                "failed": sum(1 for b in self.done if not b["finite"]),
                "elapsed_s": out["elapsed_s"], "profile": out["profile"],
                "metrics": {"eval_images_per_s": images / out["elapsed_s"],
                            "eval_batch_ms_p95": p95}}

    def traced_segment(self) -> dict:
        """``traced_batches`` batches, the recognizer's parts inside the
        benchmark's own ranges (``portbench.backbone``, ``portbench.encoder``,
        ``portbench.decoder``: the greedy decode)."""
        n = int(self.mix["traced_batches"])
        hooks = []
        for part in ("backbone", "encoder", "decoder"):
            hooks += _range_hooks(getattr(self.model, part), f"portbench.{part}")
        try:
            self.run_batches(n, record=False)
        finally:
            for h in hooks:
                h.remove()
        return {"batches": n, "images": n * self.batch}

    def release(self) -> None:
        self.model = self.pool = self.buffers = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --------------------------------------------------------------- check
    def check(self) -> List[dict]:
        """A sample of the window's images, drawn from the seed, with the
        ones read longest: the float32 reference runs each once over its
        served tokens (teacher forcing), and the gap by which a served
        token's logit lies below the reference's best is compared."""
        rows = correctness.sample_rows(self.done, self.ctx.seed, int(self.mix["checked_images"]),
                                       int(self.mix["checked_longest"]))
        images = np.stack([self.host_images[self.done[i]["pool"], r] for i, r in rows])
        tokens = np.stack([self.done[i]["tokens"][r] for i, r in rows]).astype(np.int64)
        strings = [self.done[i]["strings"][r] for i, r in rows]
        served_prob = np.stack([self.done[i]["served_prob"][r] for i, r in rows])
        ref = sut.reference()
        with correctness.exact_float32():
            model, convertor = build_recognizer(ref, self.cfg, self.device, torch.float32,
                                                self.ctx.seed)
            logits = correctness.teacher_forced_logits(model.eval(), convertor, images, tokens,
                                                       self.device)
        return correctness.eval_numbers(logits, tokens, served_prob, strings, convertor,
                                        self.ctx.limits)


def _range_hooks(module: torch.nn.Module, name: str) -> list:
    """A ``record_function`` range around every call of ``module``."""
    from torch.profiler import record_function
    open_ranges = []

    def enter(_module, _args):
        r = record_function(name)
        r.__enter__()
        open_ranges.append(r)

    def leave(_module, _args, _out):
        open_ranges.pop().__exit__(None, None, None)

    return [module.register_forward_pre_hook(enter), module.register_forward_hook(leave)]
