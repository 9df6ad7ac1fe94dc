#!/usr/bin/env python
"""Teacher-forced against greedy predictions of a finetune checkpoint
(counterpart of ``tools/debug_decode.py``): restore the recognizer, take the
first ``--n`` images of its training set (``--eval``: of its test set), and
print for each the label, the padded target, the teacher-forced argmax and
the greedy decode. A model whose teacher-forced predictions are right while
its greedy decode is not has learned the decoder's inputs but not to run on
its own outputs.

Usage:
  python -m ccd_tpu_torch.cli.debug_decode [--config C] [--checkpoint P] [--eval] \\
      [--n 8] [--device cuda|cpu]

The defaults are the JAX tool's hard-coded paths (the micro convergence run's
scratch arm), relative to the working directory, with the port's checkpoint
file ``best_accuracy.pt`` in place of the Orbax directory. Runs on the GPU
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

DEFAULT_CONFIG = "workdir/conv_micro/configs/conv_ft_scratch.yaml"
DEFAULT_CHECKPOINT = "workdir/conv_micro/saved_models/conv_ft_scratch/best_accuracy.pt"


def _parse_arguments(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default=DEFAULT_CONFIG)
    p.add_argument("--checkpoint", type=str, default=DEFAULT_CHECKPOINT)
    p.add_argument("--eval", action="store_true", help="the test roots, not the train roots")
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def render(ids, convertor) -> str:
    """Ids as text, with <E>, <P> and <B> for the end, padding and start."""
    out = []
    for i in ids:
        i = int(i)
        if i == convertor.end_idx:
            out.append("<E>")
            break
        if i == convertor.padding_idx:
            out.append("<P>")
        elif i == convertor.start_idx:
            out.append("<B>")
        else:
            out.append(convertor.idx2char[i] if i < len(convertor.idx2char) else f"?{i}")
    return "".join(out)


def debug_decode(config_path: str, checkpoint: str, use_eval: bool = False, n: int = 8,
                 device="cuda") -> dict:
    """``{"checkpoint", "iteration", "split", "rows": [{"gt", "target",
    "teacher_forced", "greedy"}], "greedy_correct", "teacher_forced_correct"}``
    for the first ``n`` images, each row printed as the JAX tool prints it.
    ``target`` is rendered without its start token (which is also the end
    token, so it would end the text at once)."""
    import numpy as np
    import torch

    from ccd_tpu_torch.builders import build_recognizer
    from ccd_tpu_torch.config import Config
    from ccd_tpu_torch.data.augment import normalize
    from ccd_tpu_torch.data.dataset import SupervisedDataset, build_dataset
    from ccd_tpu_torch.utils import resolve_device

    device = resolve_device(device)
    config = Config(config_path)
    model, convertor = build_recognizer(config, device=device)
    payload = torch.load(checkpoint, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["net"] if "net" in payload else payload, strict=True)
    roots = config.dataset_test_roots if use_eval else config.dataset_train_roots
    ds = build_dataset(SupervisedDataset, roots, is_training=False, convertor=convertor)
    items = [ds[i] for i in range(min(n, len(ds)))]
    images = torch.from_numpy(np.stack([im for im, _, _ in items])).to(device)
    targets = torch.from_numpy(np.stack([t for _, t, _ in items]).astype(np.int64)).to(device)
    texts = [t for _, _, t in items]
    x = normalize(images.float() / 255.0)
    with torch.no_grad():
        logits, _ = model(x, targets, train_mode=True)         # teacher forced
        scores = model(x, train_mode=False)                    # greedy
    pred_tf = logits.argmax(-1).cpu().numpy()
    pred_free = scores.argmax(-1).cpu().numpy()
    rows = []
    for i, text in enumerate(texts):
        row = {"gt": text, "target": render(targets[i].cpu().numpy()[1:], convertor),
               "teacher_forced": render(pred_tf[i], convertor),
               "greedy": render(pred_free[i], convertor)}
        rows.append(row)
        print(f"gt={row['gt']!r:>14} tgt={row['target']!r:>16} "
              f"tf={row['teacher_forced']!r:>16} free={row['greedy']!r:>16}")
    strip = lambda s: s.split("<E>")[0]
    return {"checkpoint": checkpoint, "iteration": payload.get("iteration"),
            "split": "eval" if use_eval else "train", "rows": rows,
            "greedy_correct": sum(strip(r["greedy"]) == r["gt"] for r in rows),
            "teacher_forced_correct": sum(strip(r["teacher_forced"]) == r["gt"] for r in rows)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = _parse_arguments(argv)
    return debug_decode(args.config, args.checkpoint, args.eval, args.n, args.device)


if __name__ == "__main__":
    main()
