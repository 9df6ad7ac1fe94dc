#!/usr/bin/env python
"""Learnability probe (counterpart of ``tools/overfit_probe.py``): overfit a
recognizer on a handful of rendered words through the finetune step, then
greedy-decode the SAME images and report the word accuracy. It isolates the
model, the step and the decode from the trainer and its data pipeline.

Usage:
  python -m ccd_tpu_torch.cli.overfit_probe [--n 32] [--steps 160] [--lr 1e-3] \\
      [--hard] [-c ccd_tpu_torch/configs/ccd_finetune_ard.yaml] [--device cuda|cpu]

Without ``-c`` it trains the JAX tool's model: ``vit_micro``, ``max_seq_len``
25, no drop path, the default decoder (6 layers, dropout 0.1), fp32. With
``-c`` it trains that configuration's recognizer (``build_recognizer``: at
``ccd_finetune_ard.yaml`` ViT-Small, the 6-layer NRTR, bf16). ``--hard``
renders through the convergence demo's hard path (48x160 render, 6 fonts,
rotation, low contrast, then ``cv2.resize`` to 32x128). Runs on the GPU
unless ``--device cpu`` is given; asking for the GPU on a machine without
one is an error.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence, Tuple

import numpy as np


def probe_data(n: int, hard: bool = False, seed: int = 0) -> Tuple[list, np.ndarray]:
    """The probe's words and uint8 images (n, 32, 128, 3), drawn as the JAX
    tool draws them."""
    import cv2

    from ccd_tpu_torch.data.synthetic import random_words, render_word

    rng = np.random.default_rng(seed)
    words = random_words(n, rng, min_len=2, max_len=6)
    images = np.zeros((n, 32, 128, 3), np.uint8)
    for i, word in enumerate(words):
        if hard:
            big, _ = render_word(word, 48, 160, rng, hard=True)
            images[i] = cv2.resize(big, (128, 32))
        else:
            images[i], _ = render_word(word, 32, 128, rng)
    return words, images


def run_overfit_probe(model, *, n: int = 32, steps: int = 160, lr: float = 1e-3,
                      hard: bool = False, seed: int = 0, log_every: int = 50) -> dict:
    """Train ``model`` (a ``CCDRecognizer``, on its device) for ``steps``
    finetune steps on the probe's ``n`` words (targets from
    ``AttnConvertor("DICT90", model.max_seq_len)``), then greedy-decode them.

    The step is ``make_fused_finetune_step`` without augmentation, cosine
    schedule from ``lr`` to 1e-6 over ``steps`` with 20 warm-up steps,
    weight decay 0.05, global-norm clip 5.0; dropout draws from the state's
    generator (seeded with ``seed``). Images and targets are copied to the
    device once; the losses are read back at the logged steps and at the end.

    Returns ``{"words", "targets", "losses" (one per step), "lrs",
    "predictions", "correct", "accuracy", "seconds" (the training loop, the
    device drained), "model"}``; the model is left in evaluation mode."""
    import torch

    from ccd_tpu_torch.convertor import AttnConvertor
    from ccd_tpu_torch.data.augment import normalize
    from ccd_tpu_torch.training.finetune_step import (init_finetune_state,
                                                      make_fused_finetune_step)

    convertor = AttnConvertor("DICT90", max_seq_len=model.max_seq_len, with_unknown=True)
    words, images = probe_data(n, hard, seed)
    targets = convertor.str2tensor(words)
    print("targets[0]:", targets[0][:12], "word:", words[0])
    device = next(model.parameters()).device
    images_d = torch.from_numpy(images).to(device)
    targets_d = torch.from_numpy(targets).to(device)

    state = init_finetune_state(model, seed=seed)
    step = make_fused_finetune_step(base_lr=lr, min_lr=1e-6, total_iters=steps,
                                    warmup_iters=20, weight_decay=0.05, clip_grad=5.0)
    losses, lrs = [], []
    t0 = time.time()
    for it in range(steps):
        state, metrics = step(state, images_d, targets_d)
        losses.append(metrics["loss"])
        lrs.append(metrics["lr"])
        if it % log_every == 0 or it == steps - 1:
            print(f"it {it:4d} loss {float(metrics['loss']):.4f} "
                  f"lr {metrics['lr']:.2e} ({time.time() - t0:.0f}s)", flush=True)
    losses = torch.stack(losses).float().cpu().numpy().tolist()  # drains the device
    seconds = time.time() - t0

    model.eval()
    with torch.no_grad():
        scores = model(normalize(images_d.float() / 255.0), train_mode=False)
    indexes, _ = convertor.tensor2idx(scores.float().cpu().numpy())
    predictions = convertor.idx2str(indexes)
    correct = sum(p.lower() == w.lower() for p, w in zip(predictions, words))
    for p, w in list(zip(predictions, words))[:10]:
        print(f"  gt={w!r:>10} pred={p!r}")
    print(f"train word acc: {correct}/{n} = {correct / n:.2%}")
    return {"words": words, "targets": targets, "losses": losses, "lrs": lrs,
            "predictions": predictions, "correct": correct, "accuracy": correct / n,
            "seconds": seconds, "model": model}


def _parse_arguments(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hard", action="store_true")
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--steps", type=int, default=160)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("-c", "--config", type=str, default=None,
                   help="train this configuration's recognizer (default: vit_micro)")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns what :func:`run_overfit_probe` returns."""
    args = _parse_arguments(argv)
    import torch

    from ccd_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    generator = torch.Generator().manual_seed(0)
    if args.config:
        from ccd_tpu_torch.builders import build_recognizer
        from ccd_tpu_torch.config import Config
        model, _ = build_recognizer(Config(args.config), device=device, generator=generator)
    else:
        from ccd_tpu_torch.models.recognizer import CCDRecognizer
        model = CCDRecognizer(arch="vit_micro", max_seq_len=25, drop_path_rate=0.0)
        model.reset_parameters(generator)
        model.to(device)
    return run_overfit_probe(model, n=args.n, steps=args.steps, lr=args.lr, hard=args.hard)


if __name__ == "__main__":
    main()
