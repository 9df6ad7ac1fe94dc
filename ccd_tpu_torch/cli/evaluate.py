#!/usr/bin/env python
"""Benchmark evaluation CLI (parity target: reference test.py:43-218).

Usage:
  python -m ccd_tpu_torch.cli.evaluate --config ccd_tpu_torch/configs/ccd_finetune_ard.yaml \
      --checkpoint saved_models/best_accuracy.pth [--test_root <lmdb dir>] \
      [--batch_size 288] [--device cuda|cpu]

Accepts reference torch ``.pth`` checkpoints and ``state_dict`` files saved
from this package. ``--synthetic N`` evaluates on freshly generated synthetic
data for smoke runs without external datasets. Runs on the GPU unless
``--device cpu`` is given; asking for the GPU on a machine without one is an
error.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
from typing import Optional, Sequence


def _parse_arguments(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--test_root", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--test_speed", action="store_true",
                   help="use the early-exit greedy decode "
                        "(forward_test_speed, nrtr_decoder.py:177-203)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="evaluate on N freshly generated synthetic samples")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Returns ``(per-dataset results, weighted total accuracy)``."""
    args = _parse_arguments(argv)
    from ccd_tpu_torch.builders import build_recognizer, load_recognizer_params
    from ccd_tpu_torch.config import Config
    from ccd_tpu_torch.evaluation.runner import evaluate_benchmarks

    config = Config(args.config)
    config.override(dataset_test_batch_size=args.batch_size,
                    model_checkpoint=args.checkpoint)
    if args.test_root:
        config.dataset_test_roots = [args.test_root]
    logging.info(config)

    model, _convertor = build_recognizer(config, device=args.device)
    if config.model_checkpoint:
        logging.info(f"Read model from {config.model_checkpoint}.")
        load_recognizer_params(config.model_checkpoint, model)

    test_roots = list(config.dataset_test_roots or [])
    if args.synthetic:
        from ccd_tpu_torch.data.synthetic import write_synthetic_lmdb
        tmp = tempfile.mkdtemp(prefix="ccd_synth_eval_")
        root = os.path.join(tmp, "evaluation", "SYNTH")
        write_synthetic_lmdb(root, args.synthetic, seed=123)
        test_roots = [root]

    batch = config.dataset_test_batch_size or 288
    results, weighted = evaluate_benchmarks(
        model, test_roots, batch_size=batch,
        max_seq_len=config.decoder_max_seq_len,
        charset_type=config.dataset_charset_type or "DICT90",
        case_sensitive=bool(config.dataset_eval_case_sensitive),
        test_speed=args.test_speed)

    dashed = "-" * 80
    print(dashed)
    for res in results:
        print(f"dataset: {os.path.basename(str(res['name']))} --> "
              f"word_num: {int(res['words'])} --> accuracy: {res['cwr']:0.3f} "
              f"(ccr {res['ccr']:0.3f}, ned {res['ned']:0.2f}, "
              f"time {res['time']:.1f}s)")
    print(f"total_accuracy: {weighted:0.3f}")
    print(dashed)
    return results, weighted


if __name__ == "__main__":
    main()
