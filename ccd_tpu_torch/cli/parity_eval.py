#!/usr/bin/env python
"""Released-weight accuracy-parity harness (counterpart of ``tools/parity_eval.py``).

One command from a recognizer checkpoint and the benchmark LMDB roots to the
11-benchmark word-accuracy table against the published CCD numbers: it
loads the checkpoint through ``builders.load_recognizer_params`` (a
reference CCD ``.pth`` such as the released weights, a file written by
``checkpoints/torch_export.py::save_recognizer_torch``, or a payload of the
``train_finetune`` CLI), evaluates every benchmark as the reference's
``test.py:150-218`` does (``evaluation/runner.py::evaluate_benchmarks``),
prints the table and a ``total_accuracy:`` line, writes a JSON artifact, and
exits 1 if any benchmark's word accuracy lies more than ``--tol`` (default
0.2 percentage points) from its baseline.

Usage:
  python -m ccd_tpu_torch.cli.parity_eval --pth CCD_vit_small_ARD.pth \\
      --test_root /data/evaluation --variant ard [--tol 0.2] \\
      [-c ccd_tpu_torch/configs/ccd_finetune_ard.yaml] [--out parity.json] \\
      [--batch_size 288] [--device cuda|cpu]

``--test_root`` takes LMDB directories (each holding ``data.mdb``) or parent
directories, scanned recursively; each root is named by its basename.
``--baseline FILE.json`` (``{"IIIT5k": 96.8, ...}``, word accuracy in %)
replaces the built-in table. Orbax directories are the JAX package's format
and are refused. Runs on the GPU unless ``--device cpu`` is given; asking
for the GPU on a machine without one is an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CONFIG = os.path.join(_PKG_DIR, "configs", "ccd_finetune_ard.yaml")

# Published CCD ViT-Small word accuracy (%), BASELINE.md (the reference
# README's table). Keys are canonical benchmark names.
PUBLISHED = {
    "std": {
        "IIIT5k": 96.8, "SVT": 94.4, "IC13": 96.6, "IC15": 87.3,
        "SVTP": 91.3, "CUTE80": 92.4, "COCOText": 64.7, "CTW": 80.4,
        "TotalText": 82.1, "HOST": 77.9, "WOST": 85.8,
    },
    "ard": {
        "IIIT5k": 98.0, "SVT": 96.4, "IC13": 98.3, "IC15": 90.3,
        "SVTP": 92.7, "CUTE80": 98.3, "COCOText": 76.7, "CTW": 86.5,
        "TotalText": 91.3, "HOST": 77.3, "WOST": 86.0,
    },
}

# basename (lowercased) prefixes -> canonical name; longer prefixes first so
# that e.g. "svtp" wins over "svt". The reference's eval_data_name list
# (test.py:190-202) and the released LMDB directory names.
_NAME_PREFIXES = [
    ("iiit5k", "IIIT5k"), ("iiit", "IIIT5k"),
    ("svtp", "SVTP"), ("svt", "SVT"),
    ("ic13", "IC13"), ("ic15", "IC15"),
    ("cute80", "CUTE80"), ("cute", "CUTE80"),
    ("totaltext", "TotalText"), ("cocotext", "COCOText"), ("coco", "COCOText"),
    ("ctw", "CTW"), ("host", "HOST"), ("wost", "WOST"),
]


def canonical_name(root: str) -> str:
    base = os.path.basename(os.path.normpath(root)).lower()
    for prefix, name in _NAME_PREFIXES:
        if base.startswith(prefix):
            return name
    return os.path.basename(os.path.normpath(root))


def discover_roots(paths: Sequence[str]) -> List[str]:
    """Expand each path to LMDB roots (directories holding data.mdb)."""
    roots = []
    for p in paths:
        if os.path.isfile(os.path.join(p, "data.mdb")):
            roots.append(p)
            continue
        for dirpath, _dirnames, filenames in sorted(os.walk(p)):
            if "data.mdb" in filenames:
                roots.append(dirpath)
    return roots


def _parse_arguments(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pth", required=True,
                   help="reference .pth, an exported file, or a finetune payload")
    p.add_argument("--test_root", nargs="+", required=True,
                   help="benchmark LMDB dirs, or parent dirs to scan")
    p.add_argument("-c", "--config", default=DEFAULT_CONFIG)
    p.add_argument("--variant", choices=["std", "ard"], default="ard",
                   help="which published column to diff against")
    p.add_argument("--baseline", default=None,
                   help="JSON file {benchmark: word_acc_pct} overriding the "
                        "built-in published table")
    p.add_argument("--tol", type=float, default=0.2,
                   help="max |delta| in word-acc percentage points")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--out", default=None, help="write JSON artifact here")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def run_parity_eval(pth: str, test_roots: Sequence[str], config_path: str,
                    baseline: Dict[str, float], tol: float = 0.2,
                    batch_size: Optional[int] = None, out_path: Optional[str] = None,
                    device: str = "cuda") -> Tuple[List[dict], float, bool]:
    """The harness; returns ``(rows, weighted accuracy in [0, 1], ok)``."""
    if os.path.isdir(pth):
        raise ValueError(f"{pth} is a directory; pass a checkpoint file. An Orbax "
                         "checkpoint directory is the JAX package's format: export it "
                         "with that package's torch_export.save_recognizer_torch first")
    import torch

    from ccd_tpu_torch.builders import build_recognizer, load_recognizer_params
    from ccd_tpu_torch.config import Config
    from ccd_tpu_torch.evaluation.runner import evaluate_benchmarks

    config = Config(config_path)
    config.override(dataset_test_batch_size=batch_size)
    model, _convertor = build_recognizer(config, device=device)
    load_recognizer_params(pth, model)
    dev = next(model.parameters()).device

    roots = discover_roots(test_roots)
    if not roots:
        raise FileNotFoundError(f"no LMDB roots under {list(test_roots)}")
    names = [canonical_name(r) for r in roots]
    results, weighted = evaluate_benchmarks(
        model, roots, batch_size=config.dataset_test_batch_size or 288,
        max_seq_len=config.decoder_max_seq_len,
        charset_type=config.dataset_charset_type or "DICT90",
        case_sensitive=bool(config.dataset_eval_case_sensitive),
        names=names)

    rows, ok = [], True
    for res in results:
        name = str(res["name"])
        acc = 100.0 * float(res["cwr"])
        base = baseline.get(name)
        delta = None if base is None else acc - float(base)
        within = delta is None or abs(delta) <= tol
        ok = ok and within
        rows.append({"benchmark": name, "words": int(res["words"]),
                     "word_acc_pct": round(acc, 3),
                     "baseline_pct": base,
                     "delta_pct": None if delta is None else round(delta, 3),
                     "within_tol": within})

    dashed = "-" * 88
    print(dashed)
    print(f"{'benchmark':<12} {'words':>7} {'acc %':>8} {'baseline':>9} "
          f"{'delta':>7}  status")
    for r in rows:
        base = "—" if r["baseline_pct"] is None else f"{r['baseline_pct']:.1f}"
        delta = "—" if r["delta_pct"] is None else f"{r['delta_pct']:+.2f}"
        status = "ok" if r["within_tol"] else f"FAIL (> {tol})"
        print(f"{r['benchmark']:<12} {r['words']:>7} "
              f"{r['word_acc_pct']:>8.2f} {base:>9} {delta:>7}  {status}")
    print(f"total_accuracy: {100.0 * weighted:0.2f}")
    print(dashed)

    artifact = {"checkpoint": str(pth), "tol_pct": tol, "ok": ok,
                "weighted_acc_pct": round(100.0 * weighted, 3),
                "device": {"type": dev.type,
                           "name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                                    else "cpu")},
                "benchmarks": rows}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"wrote {out_path}")
    return rows, weighted, ok


def main(argv: Optional[Sequence[str]] = None) -> Tuple[List[dict], float, bool]:
    """Exits 1 (``PARITY FAIL``) where a benchmark lies outside the
    tolerance; otherwise prints ``PARITY OK`` and returns what
    :func:`run_parity_eval` returned."""
    args = _parse_arguments(argv)
    if args.baseline:
        with open(args.baseline) as f:
            baseline = {str(k): float(v) for k, v in json.load(f).items()}
    else:
        baseline = PUBLISHED[args.variant]
    rows, weighted, ok = run_parity_eval(
        args.pth, args.test_root, args.config, baseline, tol=args.tol,
        batch_size=args.batch_size, out_path=args.out, device=args.device)
    if not ok:
        print(f"PARITY FAIL: at least one benchmark deviates more than "
              f"{args.tol} pct points from baseline", file=sys.stderr)
        sys.exit(1)
    print("PARITY OK")
    return rows, weighted, ok


if __name__ == "__main__":
    main()
