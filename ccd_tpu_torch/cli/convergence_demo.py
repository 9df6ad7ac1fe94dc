#!/usr/bin/env python
"""Three-phase convergence demo on synthetic data (counterpart of
``tools/convergence_demo.py``): that the port trains a working recognizer
and that char-distillation pretraining helps it downstream, the paper's
central claim (reference ``train.py:45-301`` -> ``train_finetune.py:191-200``),
through the real entry points, each in a process of its own:

  1. **Pretrain**: ``python -m ccd_tpu_torch.cli.train``, DINO
     char-distillation of a ViT on an UNLABELED synthetic corpus with its
     ground-truth glyph masks.
  2. **Finetune (handoff)**: ``python -m ccd_tpu_torch.cli.train_finetune``
     with ``model.pretrain_checkpoint`` naming phase 1's checkpoint, whose
     teacher backbone is copied in by name, on a small LABELED subset, with
     periodic held-out evaluation.
  3. **Finetune (scratch)**: the same run from a random backbone, with the
     same iteration budget.

The three corpora are disjoint (``data/synthetic.py``, seeds apart; hard
rendering unless ``--easy``). Everything is written under ``--workdir``: the
corpora, the configurations, each phase's log and checkpoints, the
TensorBoard files (each phase runs with the workdir as its working
directory) and the summary ``CONVERGENCE.json``, whose keys are the JAX
tool's (``pretrain``, ``finetune``, ``handoff``, ``scratch``, ``smoke``,
``command``) plus ``wall_s`` (each phase's seconds), ``device`` and
``debug_decode`` (``cli/debug_decode.py`` on each arm's best checkpoint,
8 training images). The repository's own ``CONVERGENCE.json`` (the JAX
demo's record) is never written.

Usage:
  python -m ccd_tpu_torch.cli.convergence_demo [--workdir DIR] [--device cuda|cpu] ...
  python -m ccd_tpu_torch.cli.convergence_demo --smoke --device cpu   # plumbing only

``--smoke`` is the JAX tool's micro scale (vit_micro, 3 iterations a phase,
fp32): a check that the phases connect, whose accuracies mean nothing. Runs
on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Optional, Sequence

import yaml

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default=None,
                   help="default: ./workdir/convergence (or _smoke under --smoke)")
    p.add_argument("--smoke", action="store_true", help="micro-scale plumbing check")
    p.add_argument("--arch", default="vit_tiny")
    p.add_argument("--out_dim", type=int, default=8192)
    p.add_argument("--pretrain_samples", type=int, default=40000)
    p.add_argument("--labeled", type=int, default=1000)
    p.add_argument("--eval_samples", type=int, default=1000)
    p.add_argument("--pretrain_iters", type=int, default=6000)
    p.add_argument("--finetune_iters", type=int, default=2000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--ft_batch", type=int, default=64)
    p.add_argument("--eval_batch", type=int, default=250)
    p.add_argument("--eval_iters", type=int, default=500)
    p.add_argument("--lr_pretrain", type=float, default=5e-4)
    p.add_argument("--lr_finetune", type=float, default=1e-3)
    p.add_argument("--ft_warmup_epochs", type=int, default=1)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--easy", action="store_true",
                   help="easy rendering distribution (debug/micro runs)")
    p.add_argument("--no_aug", action="store_true",
                   help="disable finetune-time augmentation")
    p.add_argument("--skip_pretrain", action="store_true",
                   help="reuse an existing phase-1 checkpoint in --workdir")
    p.add_argument("--skip_handoff", action="store_true")
    p.add_argument("--skip_scratch", action="store_true")
    p.add_argument("--resummarize", action="store_true",
                   help="run nothing; rebuild CONVERGENCE.json from the logs already "
                        "in --workdir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def _smoke_overrides(args) -> None:
    args.arch = "vit_micro"
    args.out_dim = 128
    args.pretrain_samples = 64
    args.labeled = 32
    args.eval_samples = 16
    args.pretrain_iters = 3
    args.finetune_iters = 3
    args.batch = args.ft_batch = 8
    args.eval_batch = 8
    args.eval_iters = 1000
    args.dtype = "float32"


def generate_corpora(args, dirs: dict) -> None:
    """Three disjoint LMDB corpora: unlabeled pretrain (with its glyph-mask
    LMDB), labeled finetune train, held-out eval. A corpus of the right size
    already in the workdir is reused."""
    from ccd_tpu_torch.data.dataset import mask_env_path
    from ccd_tpu_torch.data.lmdb import LmdbReader
    from ccd_tpu_torch.data.synthetic import write_synthetic_lmdb

    def have(root: str) -> int:
        if not os.path.exists(os.path.join(root, "data.mdb")):
            return -1
        return int(LmdbReader(root).get(b"num-samples"))

    hard = not args.easy
    t0 = time.time()
    made = []
    if have(dirs["pre_root"]) != args.pretrain_samples:
        shutil.rmtree(dirs["pre_root"], ignore_errors=True)
        shutil.rmtree(dirs["mask_root"], ignore_errors=True)
        write_synthetic_lmdb(dirs["pre_root"], args.pretrain_samples, seed=args.seed + 10,
                             with_mask_lmdb=True,
                             mask_path=mask_env_path(dirs["pre_root"], dirs["mask_root"]),
                             hard=hard)
        made.append(f"pretrain={args.pretrain_samples}")
    for key, n, seed in (("lab_root", args.labeled, args.seed + 20),
                         ("eval_root", args.eval_samples, args.seed + 30)):
        if have(dirs[key]) != n:
            shutil.rmtree(dirs[key], ignore_errors=True)
            write_synthetic_lmdb(dirs[key], n, seed=seed, hard=hard)
            made.append(f"{key[:-5]}={n}")
    if made:
        print(f"[data] generated {', '.join(made)} in {time.time() - t0:.0f}s", flush=True)
    else:
        print(f"[data] reusing corpora under {os.path.dirname(dirs['mask_root'])}", flush=True)


def _run(cmd, cwd: str, log_path: str) -> float:
    """Run one phase's process with its output in ``log_path``; its seconds.
    A failure raises with the log's tail."""
    print(f"[run] {' '.join(cmd)}\n      (log: {log_path})", flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [PKG_ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.time()
    with open(log_path, "w") as log:
        proc = subprocess.run(cmd, cwd=cwd, env=env, stdout=log, stderr=subprocess.STDOUT)
    seconds = time.time() - t0
    if proc.returncode != 0:
        with open(log_path) as f:
            tail = f.read()[-3000:]
        raise RuntimeError(f"{cmd} failed rc={proc.returncode}:\n{tail}")
    print(f"[run] done in {seconds:.0f}s", flush=True)
    return seconds


def _write_yaml(path: str, cfg: dict) -> str:
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def pretrain_config(args, dirs) -> dict:
    iter_num = max(args.pretrain_samples // args.batch, 1)
    epochs = max(-(-args.pretrain_iters // iter_num), 1)
    # imgnet_based sized so virtual epochs tick ~20x over the run (teacher
    # temp schedule + per-epoch checkpoints) while staying < gt_mask_epochs=30
    # (GT glyph masks throughout: the synthetic masks are exact)
    images_total = args.pretrain_iters * args.batch
    imgnet_based = max(images_total // 20, args.batch * 10)
    return {
        "global": {"name": "conv_pretrain", "phase": "train",
                   "stage": "pretrain-vision", "workdir": dirs["logs"], "seed": args.seed},
        "output_dir": dirs["ckpt"],
        "dataset": {
            "scheme": "selfsupervised_kmeans",
            "train": {"roots": [dirs["pre_root"]]},
            "mask": True, "mask_path": dirs["mask_root"],
            "num_workers": 8, "augmentation_severity": 5,
        },
        "training": {"epochs": int(epochs), "show_iters": 100,
                     "steps_per_dispatch": 1 if args.smoke else 8},
        "arch": args.arch, "patch_size": 4, "out_dim": args.out_dim,
        "norm_last_layer": False, "momentum_teacher": 0.996,
        "teacher_temp": 0.04, "warmup_teacher_temp": 0.04,
        "warmup_teacher_temp_epochs": 0,
        "batch_size_per_gpu": args.batch, "lr": args.lr_pretrain,
        "min_lr": 1e-6, "weight_decay": 0.04, "weight_decay_end": 0.4,
        "clip_grad": 3.0, "freeze_last_layer": 1,
        "imgnet_based": int(imgnet_based),
        "warmup_epoch": 1, "drop_path_rate": 0.1,
        "compute_dtype": args.dtype, "saveckp_freq": 10,
    }


def finetune_config(args, dirs, name: str, pretrain_ckpt) -> dict:
    iter_num = max(args.labeled // args.ft_batch, 1)
    epochs = max(-(-args.finetune_iters // iter_num), 1)
    return {
        "global": {"name": name, "phase": "train", "stage": "train-supervised",
                   "workdir": dirs["logs"], "seed": args.seed + 1},
        "output_dir": dirs["ckpt"],
        "dataset": {
            "scheme": "supervised",
            "train": {"roots": [dirs["lab_root"]], "batch_size": args.ft_batch},
            "test": {"roots": [dirs["eval_root"]], "batch_size": args.eval_batch},
            "num_workers": 8, "charset_type": "DICT90",
            "data_aug": not args.no_aug,
        },
        "training": {"epochs": int(epochs), "show_iters": 100,
                     "eval_iters": args.eval_iters, "save_iters": 10 ** 9,
                     "steps_per_dispatch": 1 if args.smoke else 8},
        "model": {"pretrain_checkpoint": pretrain_ckpt},
        "decoder": {"n_layers": 3, "d_embedding": 256, "n_head": 8,
                    "d_model": 256, "d_inner": 1024, "d_k": 32, "d_v": 32,
                    "max_seq_len": 25, "start_idx": 91, "padding_idx": 92},
        "arch": args.arch, "patch_size": 4, "weight_decay": 0.05,
        "clip_grad": 5.0, "lr": args.lr_finetune, "min_lr": 1e-6,
        "warmup_epochs": args.ft_warmup_epochs, "drop_path_rate": 0.1,
        "compute_dtype": args.dtype,
    }


def parse_eval_log(path: str):
    """(best, final, [[iteration, acc], ...]) from log_all_evaluation.txt."""
    if not os.path.exists(path):
        return None, None, []
    with open(path) as f:
        text = f.read()
    traj = [[int(i), float(a)] for i, a in
            re.findall(r"iteration:\s*(\d+)\s*\n(?:dataset:[^\n]*\n)+"
                       r"total_accuracy:\s*([0-9.]+)", text)]
    accs = [float(m) for m in re.findall(r"total_accuracy:\s*([0-9.]+)", text)]
    if not accs:
        return None, None, []
    # drop the duplicate final-eval entry the finetune CLI appends
    dedup = []
    for it, acc in traj:
        if not dedup or dedup[-1][0] != it:
            dedup.append([it, acc])
    return max(accs), accs[-1], dedup


def parse_pretrain_losses(log_dir: str):
    """[[iteration, total loss], ...] as the pretrain CLI logged them."""
    path = os.path.join(log_dir, "train.txt")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [[int(it), float(loss)] for it, loss in
                re.findall(r"it (\d+) epoch \d+ loss ([0-9.]+) \(", f.read())]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = _parse_args(argv)
    command = " ".join([os.path.basename(sys.argv[0])] + list(
        sys.argv[1:] if argv is None else argv))
    if args.resummarize:
        args.skip_pretrain = args.skip_handoff = args.skip_scratch = True
    if args.smoke:
        _smoke_overrides(args)
    if args.workdir is None:
        args.workdir = os.path.join("workdir",
                                    "convergence_smoke" if args.smoke else "convergence")
    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)

    data_dir = os.path.join(workdir, "data")
    dirs = {
        "logs": os.path.join(workdir, "logs"),
        "ckpt": os.path.join(workdir, "saved_models"),
        "pre_root": os.path.join(data_dir, "training", "SYNTH_PRETRAIN"),
        "lab_root": os.path.join(data_dir, "training", "SYNTH_LABELED"),
        "eval_root": os.path.join(data_dir, "evaluation", "SYNTH_EVAL"),
        "mask_root": os.path.join(data_dir, "Mask"),
    }
    wall = {}
    if not args.resummarize:
        t0 = time.time()
        generate_corpora(args, dirs)
        wall["data"] = time.time() - t0

    cfg_dir = os.path.join(workdir, "configs")
    os.makedirs(cfg_dir, exist_ok=True)
    pretrain_ckpt = os.path.join(dirs["ckpt"], "conv_pretrain")
    device = ["--device", args.device]

    # ---- phase 1: self-supervised pretrain (unlabeled corpus + GT masks)
    if not args.skip_pretrain:
        shutil.rmtree(pretrain_ckpt, ignore_errors=True)
        shutil.rmtree(os.path.join(dirs["logs"], "conv_pretrain"), ignore_errors=True)
        cfg = _write_yaml(os.path.join(cfg_dir, "pretrain.yaml"), pretrain_config(args, dirs))
        wall["pretrain"] = _run(
            [sys.executable, "-m", "ccd_tpu_torch.cli.train", "-c", cfg,
             "--max_iters", str(args.pretrain_iters), *device],
            workdir, os.path.join(workdir, "pretrain.log"))

    # ---- phases 2+3: labeled finetune with/without the teacher handoff
    results, decoded = {}, {}
    for name, ckpt, skip in (("conv_ft_handoff", pretrain_ckpt, args.skip_handoff),
                             ("conv_ft_scratch", None, args.skip_scratch)):
        arm = name.replace("conv_ft_", "")
        if skip and not args.resummarize:
            continue
        cfg_path = os.path.join(cfg_dir, f"{name}.yaml")
        if not skip:
            shutil.rmtree(os.path.join(dirs["ckpt"], name), ignore_errors=True)
            shutil.rmtree(os.path.join(dirs["logs"], name), ignore_errors=True)
            _write_yaml(cfg_path, finetune_config(args, dirs, name, ckpt))
            wall[arm] = _run(
                [sys.executable, "-m", "ccd_tpu_torch.cli.train_finetune", "-c", cfg_path,
                 "--max_iters", str(args.finetune_iters), *device],
                workdir, os.path.join(workdir, f"{name}.log"))
        best, final, traj = parse_eval_log(
            os.path.join(dirs["ckpt"], name, "log_all_evaluation.txt"))
        if best is None and args.resummarize:
            continue
        results[arm] = {"best_acc": best, "final_acc": final, "trajectory_iter_acc": traj}
        best_ckpt = os.path.join(dirs["ckpt"], name, "best_accuracy.pt")
        if os.path.isfile(best_ckpt) and os.path.isfile(cfg_path) and not args.resummarize:
            from ccd_tpu_torch.cli.debug_decode import debug_decode
            print(f"[debug_decode] {arm}: teacher forced against greedy, 8 training images",
                  flush=True)
            decoded[arm] = debug_decode(cfg_path, best_ckpt, n=8, device=args.device)

    # phases skipped this invocation keep their entry from the summary already
    # in the workdir (same corpora seeds => comparable), so a handoff-only
    # rerun does not clobber the scratch ablation or the other way round
    out_path = os.path.join(workdir, "CONVERGENCE.json")
    prior = {}
    if os.path.exists(out_path):
        try:
            with open(out_path) as f:
                prior = json.load(f)
        except (OSError, ValueError):
            prior = {}
    for key, skipped in (("handoff", args.skip_handoff), ("scratch", args.skip_scratch)):
        if skipped and key not in results and key in prior:
            results[key] = prior[key]
        if skipped and key not in decoded and key in prior.get("debug_decode", {}):
            decoded[key] = prior["debug_decode"][key]

    losses = parse_pretrain_losses(os.path.join(dirs["logs"], "conv_pretrain"))
    pretrain_meta = {"iters": args.pretrain_iters, "arch": args.arch,
                     "out_dim": args.out_dim, "samples": args.pretrain_samples,
                     "loss_first_logged": losses[0][1] if losses else None,
                     "loss_last_logged": losses[-1][1] if losses else None,
                     "loss_curve": losses}
    finetune_meta = {"iters": args.finetune_iters, "labeled_samples": args.labeled,
                     "eval_samples": args.eval_samples}
    if args.resummarize:
        # the run's settings cannot be read back from the logs: keep the
        # prior summary's, and its losses where the logs are gone
        pretrain_meta = {**prior.get("pretrain", pretrain_meta),
                         **({"loss_first_logged": losses[0][1],
                             "loss_last_logged": losses[-1][1],
                             "loss_curve": losses} if losses else {})}
        finetune_meta = prior.get("finetune", finetune_meta)
    summary = {
        "pretrain": pretrain_meta,
        "finetune": finetune_meta,
        **results,
        "smoke": bool(args.smoke),
        "command": prior.get("command", "") if args.resummarize else command,
        "device": prior.get("device") if args.resummarize else _device_name(args.device),
        "wall_s": {**prior.get("wall_s", {}), **wall},
        "debug_decode": decoded,
    }
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k != "debug_decode"}, indent=2))
    h, s = results.get("handoff", {}), results.get("scratch", {})
    if h.get("best_acc") is not None and s.get("best_acc") is not None and not args.smoke:
        print(f"[verdict] handoff {h['best_acc']:.3f} vs scratch {s['best_acc']:.3f} "
              f"(delta {h['best_acc'] - s['best_acc']:+.3f}) at {finetune_meta['iters']} "
              f"iters / {finetune_meta['labeled_samples']} labels")
    return summary


def _device_name(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, or 'cpu'."""
    if device == "cpu":
        return "cpu"
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        import torch
        return torch.cuda.get_device_name(0)


if __name__ == "__main__":
    main()
