#!/usr/bin/env python
"""Collective traffic of the data-parallel pretraining step (counterpart of
``tools/collective_audit.py``).

Runs ``--steps`` fused pretraining steps of a configuration under the
process group that ``torchrun`` describes (one process per GPU; without
``torchrun``, no group and no collective), on rendered words with their
glyph masks, and counts every collective the port calls
(``parallel/mesh.py``): calls and bytes a step by (operation, what it
carries). The JAX tool reads the collectives GSPMD put into the compiled
step; here the port calls them itself, so the counters are the schedule:
one flat all-reduce of every gradient, the DINO centre's sum and count, the
SegHead BatchNorms' sums (forward and backward), the denominators and the
reported losses. Rank 0 prints one JSON line.

Usage:
  torchrun --standalone --nproc_per_node N -m ccd_tpu_torch.cli.collective_audit \\
      [-c ccd_tpu_torch/configs/ccd_pretrain_vit_small.yaml] [--arch A] [--batch B] \\
      [--steps 2] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

_DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                               "configs", "ccd_pretrain_vit_small.yaml")


def _parse_arguments(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", type=str, default=_DEFAULT_CONFIG)
    p.add_argument("--arch", type=str, default=None)
    p.add_argument("--batch", type=int, default=None, help="per process (default: the config's)")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns (and rank 0 prints) ``{"world", "steps", "batch_per_process",
    "student_parameters", "collectives": {"<op>:<what>": {"calls_per_step",
    "bytes_per_step"}}, "bytes_per_step"}``."""
    args = _parse_arguments(argv)
    import torch

    from ccd_tpu_torch.builders import build_pretrain_models
    from ccd_tpu_torch.config import Config
    from ccd_tpu_torch.data.synthetic import make_synthetic_batch
    from ccd_tpu_torch.losses import teacher_temp_schedule
    from ccd_tpu_torch.parallel.mesh import (broadcast_module, collective_counts,
                                             distributed_run, pretrain_mesh, rank,
                                             reset_collective_counts, world)
    from ccd_tpu_torch.training.pretrain_step import (init_pretrain_state,
                                                      make_fused_pretrain_step)
    from ccd_tpu_torch.utils import resolve_device

    config = Config(args.config)
    config.override(arch=args.arch, batch_size_per_gpu=args.batch)
    with distributed_run(resolve_device(args.device)) as device:
        group = pretrain_mesh(config.mesh_num_devices, config.mesh_model_parallel)
        me, n_proc = rank(group), world(group)
        batch = int(config.batch_size_per_gpu or 64)
        seed = int(config.seed or 0)
        student, teacher = build_pretrain_models(
            config, device=device, generator=torch.Generator().manual_seed(seed))
        state = init_pretrain_state(student, teacher, seed=seed,
                                    optimizer=str(config.optimizer or "adamw"), process=me)
        for module in (student, teacher):
            broadcast_module(module, group)
        global_batch = batch * n_proc
        step = make_fused_pretrain_step(
            severity=int(config.dataset_augmentation_severity or 5),
            base_lr=float(config.lr) * global_batch / 256.0, min_lr=float(config.min_lr or 0.0),
            total_iters=1000, warmup_iters=1, weight_decay=float(config.weight_decay or 0.04),
            weight_decay_end=float(config.weight_decay_end or 0.4),
            momentum_teacher=float(config.momentum_teacher),
            teacher_temps=teacher_temp_schedule(0.04, 0.04, 0, 2),
            clip_grad=config.clip_grad, freeze_last_layer=0, global_batch=global_batch,
            imgnet_based=int(config.imgnet_based or 1_000_000), group=group)
        # each rank's share of one global batch of rendered words
        images, masks, _ = make_synthetic_batch(global_batch, seed=seed)
        mine = slice(me * batch, (me + 1) * batch)
        raw = torch.from_numpy(images[mine]).to(device)
        mask = torch.from_numpy(masks[mine].astype("uint8")).to(device)
        reset_collective_counts()
        for _ in range(args.steps):
            state, metrics = step(state, raw, mask)
        float(metrics["loss"])  # the steps have ended
        counts = collective_counts()
        result = {
            "world": n_proc, "steps": args.steps, "batch_per_process": batch,
            "arch": config.arch, "out_dim": student.out_dim,
            "device": device.type if device.type == "cpu" else torch.cuda.get_device_name(device),
            "student_parameters": sum(p.numel() for p in student.parameters()),
            "collectives": {k: {"calls_per_step": v["calls"] / args.steps,
                                "bytes_per_step": v["bytes"] / args.steps}
                            for k, v in sorted(counts.items())},
            "bytes_per_step": sum(v["bytes"] for v in counts.values()) / args.steps}
        if me == 0:
            print(json.dumps(result), flush=True)
        return result


if __name__ == "__main__":
    main()
