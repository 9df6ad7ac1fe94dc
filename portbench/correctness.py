"""What decides ``correct``: the numbers that compare what the timed path
produced with the plain reference, each held to its limit from
``portbench/limits/<workload>.json``.

Training (``training_numbers``), from the first steps of the one state the
window then trains on, against the reference's same steps:

* ``loss_gap``: the largest relative gap of a step's loss (every loss the
  step reports), over the checked steps;
* ``grad_gap``: by the worst parameter, the gap between the norms of the
  first gradient as the optimizer got it (AdamW's first moment after one
  step), over the larger of the reference's norm of that parameter and the
  median parameter's;
* ``change_gap``: the same of the parameters' change after the checked
  steps; parameters whose reference gradient is under a thousandth of the
  median parameter's are left out (their change is AdamW's response to
  round-off);
* ``teacher_change_gap`` (where the state has an EMA teacher): the same of
  the teacher's parameters' change and of the DINO centre's, the teacher's
  parameters left out by the rule on the student's namesakes.

Recognition (``eval_numbers``), on a sample of the window's images:

* ``logit_gap``: the widest gap by which a served token's logit lies below
  the reference's best at its position (teacher forcing over the served
  tokens, up to the first end token);
* ``logprob_gap``: the widest gap between the log-probability the program
  served for its token and the reference's log-probability of that token
  at that position (same positions); ``logprob_mean``: its mean over them;
* ``string_mismatches``: served strings that differ from the strings the
  reference's convertor makes of the served tokens (limit 0).

A limit of null marks a number that is read and printed but not compared.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

DEAD_GRADIENT = 1e-3  # of the median parameter's first-gradient norm


@contextlib.contextmanager
def exact_float32():
    """float32 matrix products and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def number(name: str, value: float, limits: dict, worst: str = "") -> dict:
    return {"name": name, "value": float(value), "limit": limits.get(name), "worst": worst}


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep: Sequence[str]) -> Tuple[float, str]:
    floor = statistics.median(ref[n] for n in keep)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in keep}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def training_numbers(prog: dict, ref: dict, limits: dict) -> List[dict]:
    losses_p, losses_r = np.asarray(prog["losses"]), np.asarray(ref["losses"])
    loss_gap = np.abs(losses_p - losses_r) / np.maximum(np.abs(losses_r), 1e-12)
    where = np.unravel_index(int(np.nanargmax(loss_gap)) if np.isfinite(loss_gap).any() else 0,
                             loss_gap.shape)
    names = sorted(ref["grad"])
    grad_gap, grad_worst = _leaf_gap(prog["grad"], ref["grad"], names)
    median_grad = statistics.median(ref["grad"][n] for n in names)
    live = [n for n in names if ref["grad"][n] >= DEAD_GRADIENT * median_grad]
    change_gap, change_worst = _leaf_gap(prog["change"], ref["change"], live)
    loss_value = float(np.max(loss_gap)) if np.isfinite(loss_gap).all() else float("inf")
    out = [number("loss_gap", loss_value, limits, f"step {where[0] + 1}, loss {where[1]}"),
           number("grad_gap", _finite(grad_gap), limits, grad_worst),
           number("change_gap", _finite(change_gap), limits,
                  f"{change_worst}; {len(names) - len(live)} left out")]
    if "teacher_change" in ref:
        leaves = ref["teacher_change"]
        kept = [n for n in sorted(leaves) if n == "center" or n in live]
        gap, worst = _leaf_gap(prog["teacher_change"], leaves, kept)
        out.append(number("teacher_change_gap", _finite(gap), limits,
                          f"{worst}; {len(leaves) - len(kept)} left out"))
    return out


def _finite(value: float) -> float:
    return float(value) if np.isfinite(value) else float("inf")


# ----------------------------------------------------------------- recognition
def sample_rows(batches: list, seed: int, n_random: int, n_longest: int
                ) -> List[Tuple[int, int]]:
    """(batch, row) pairs: ``n_random`` drawn from the seed among every row
    of the window, and the ``n_longest`` longest served strings."""
    rows = len(batches[0]["strings"])
    total = len(batches) * rows
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    picked = set(int(i) for i in rng.choice(total, size=min(n_random, total), replace=False))
    lengths = [(-len(s), b * rows + r) for b, batch in enumerate(batches)
               for r, s in enumerate(batch["strings"])]
    picked.update(i for _, i in sorted(lengths)[:n_longest])
    return [(i // rows, i % rows) for i in sorted(picked)]


@torch.no_grad()
def teacher_forced_logits(model, convertor, images: np.ndarray, tokens: np.ndarray,
                          device: torch.device, block: int = 16) -> np.ndarray:
    """The reference's logits (N, T, C-1) at every position of the served
    tokens: the decoder reads [start, t_0, ..., t_{T-2}] under its causal
    mask, as the greedy decode read them."""
    from portbench.reference.evaluation import IMAGENET_MEAN, IMAGENET_STD
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    start = np.full((tokens.shape[0], 1), convertor.start_idx, np.int64)
    inputs = np.concatenate([start, tokens[:, :-1]], axis=1)
    out = []
    for i in range(0, len(images), block):
        x = torch.from_numpy(images[i:i + block]).to(device).float() / 255.0
        t = torch.from_numpy(inputs[i:i + block]).to(device)
        logits, _ = model((x - mean) / std, t, train_mode=True)
        out.append(logits.float().cpu().numpy())
    return np.concatenate(out)


def served_length(tokens: np.ndarray, end_idx: int) -> int:
    """Positions up to and including the first end token."""
    ends = np.nonzero(tokens == end_idx)[0]
    return int(ends[0]) + 1 if len(ends) else len(tokens)


def eval_numbers(logits: np.ndarray, tokens: np.ndarray, served_prob: np.ndarray,
                 strings: Sequence[str], convertor, limits: dict) -> List[dict]:
    gap, worst, lp_gap, lp_worst, mismatches = 0.0, "", 0.0, "", 0
    lp_all = []
    for n in range(len(tokens)):
        k = served_length(tokens[n], convertor.end_idx)
        rows = logits[n, :k].astype(np.float64)
        if tokens[n, :k].max() >= rows.shape[-1] or not np.isfinite(rows).all():
            gap = lp_gap = float("inf")
            worst = lp_worst = f"image {n}: a token outside the classes"
            continue
        at = rows[np.arange(k), tokens[n, :k]]
        g = rows.max(-1) - at
        if g.max() > gap:
            gap, worst = float(g.max()), f"image {n}, position {int(g.argmax())}"
        ref_logprob = at - (rows.max(-1) + np.log(np.exp(rows - rows.max(-1, keepdims=True))
                                                 .sum(-1)))
        d = np.abs(np.log(np.maximum(served_prob[n, :k].astype(np.float64), 1e-300))
                   - ref_logprob)
        lp_all.append(d)
        if d.max() > lp_gap:
            lp_gap, lp_worst = float(d.max()), f"image {n}, position {int(d.argmax())}"
        served = [int(t) for t in tokens[n, :k] if t not in (convertor.end_idx,
                                                               convertor.padding_idx)]
        mismatches += convertor.idx2str([served])[0] != strings[n]
    lp_all = np.concatenate(lp_all) if lp_all else np.array([float("inf")])
    return [number("logit_gap", gap, limits, worst),
            number("logprob_gap", lp_gap, limits, lp_worst),
            number("logprob_mean", float(lp_all.mean()), limits, f"{lp_all.size} positions"),
            number("string_mismatches", mismatches, limits)]
