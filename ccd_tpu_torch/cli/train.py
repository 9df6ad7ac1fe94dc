#!/usr/bin/env python
"""CCD self-supervised pretraining CLI (parity target: root ``train.py``,
itself the counterpart of the reference train.py).

DINO-style student/teacher distillation over per-character features. Each
iteration runs on the card: uint8 images and glyph masks staged ahead by a
background thread → 3-view augmentation with theta → student ViT + SegHead →
glyph clusters → char pooling + DINO heads → both losses → AdamW → EMA
teacher → centre EMA (``make_multi_pretrain_step``, K iterations per staged
chunk).

One process, or one process per GPU under ``torchrun`` (data parallelism,
``parallel/mesh.py``): every rank reads its shard of the data, the global
batch is ``batch_size_per_gpu`` x the world size (it sets the learning
rate, the warm-up and the virtual epochs, as in the JAX CLI), the step sums
the ranks' gradients, and rank 0 alone writes checkpoints, the log and
TensorBoard. ``mesh.num_devices`` must be null or the world size;
``mesh.model_parallel`` above 1 (tensor parallelism) is refused until
ROADMAP M11b.

Usage:
  python -m ccd_tpu_torch.cli.train -c ccd_tpu_torch/configs/ccd_pretrain_vit_small.yaml \
      [--batch_size_per_gpu N] [--max_iters N] [--synthetic N] [--device cuda|cpu]
  torchrun --standalone --nproc_per_node 8 -m ccd_tpu_torch.cli.train -c ...

Runs on the GPU unless ``--device cpu`` is given; asking for the GPU on a
machine without one is an error. Checkpoints go to
``<output_dir>/<global.name>/`` at every virtual-epoch boundary and at the
end; a run finds the latest one there and resumes from it. Metrics go to
the log, averaged per virtual epoch to ``<workdir>/log.txt``, and, where
``torch.utils.tensorboard`` can be imported, as TensorBoard scalars
``metric/{loss,mask_loss,dino_loss,lr,wd}`` at every show boundary to
``./tensorboard/<global.name>``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
import tempfile
import time
from typing import Optional, Sequence


def _parse_arguments(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", type=str, required=True)
    p.add_argument("--arch", type=str, default=None)
    p.add_argument("--batch_size_per_gpu", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max_iters", type=int, default=None,
                   help="hard cap on iterations (smoke runs)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="pretrain on N freshly generated synthetic samples")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of steps 10..10+K here")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns ``{"iteration", "last" (the last logged metrics),
    "images_per_s" (with data loading), "checkpoint" (latest step saved)}``."""
    args = _parse_arguments(argv)
    from ccd_tpu_torch.config import Config
    from ccd_tpu_torch.parallel.mesh import distributed_run, pretrain_mesh, rank
    from ccd_tpu_torch.utils import resolve_device
    from ccd_tpu_torch.utils.logging import run_log

    config = Config(args.config)
    config.override(arch=args.arch, batch_size_per_gpu=args.batch_size_per_gpu,
                    training_epochs=args.epochs, lr=args.lr, seed=args.seed)
    with distributed_run(resolve_device(args.device)) as device:
        group = pretrain_mesh(config.mesh_num_devices, config.mesh_model_parallel)
        with run_log(config, lead=rank(group) == 0):
            return _run(config, args, device, group)


def _run(config, args, device, group) -> dict:
    tmp = None
    try:
        if args.synthetic:
            from ccd_tpu_torch.data.dataset import mask_env_path
            from ccd_tpu_torch.data.synthetic import write_synthetic_lmdb
            tmp = tempfile.mkdtemp(prefix="ccd_synth_pre_")
            root = os.path.join(tmp, "training", "SYNTH")
            mask_root = os.path.join(tmp, "Mask")
            write_synthetic_lmdb(root, args.synthetic, seed=3, with_mask_lmdb=True,
                                 mask_path=mask_env_path(root, mask_root))
            config.dataset_train_roots = [root]
            config.dataset_mask_path = mask_root
            config.dataset_mask = True
        return _train(config, args, device, group)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _train(config, args, device, group) -> dict:
    import numpy as np
    import torch

    from ccd_tpu_torch.builders import build_pretrain_models
    from ccd_tpu_torch.checkpoints.torch_io import CheckpointManager
    from ccd_tpu_torch.data.dataset import PretrainDataset, build_dataset
    from ccd_tpu_torch.data.pipeline import (DataLoader, device_chunks, infinite_batches,
                                             stage_pretrain_chunk, wait_for_chunk)
    from ccd_tpu_torch.losses import teacher_temp_schedule
    from ccd_tpu_torch.parallel.mesh import backend, broadcast_module, rank, world
    from ccd_tpu_torch.training.pretrain_step import (init_pretrain_state,
                                                      make_multi_pretrain_step,
                                                      pretrain_state_payload,
                                                      restore_pretrain_state)
    from ccd_tpu_torch.utils import MetricLogger
    from ccd_tpu_torch.utils.logging import summary_writer

    # ------------------------------------------------------------ data
    me, n_proc = rank(group), world(group)
    batch_size = int(config.batch_size_per_gpu or 64)
    h, w = int(config.dataset_image_height), int(config.dataset_image_width)
    train_ds = build_dataset(
        PretrainDataset, config.dataset_train_roots, is_training=True,
        img_h=h, img_w=w, mask=bool(config.dataset_mask),
        mask_path=config.dataset_mask_path or "",
        data_portion=float(config.dataset_portion or 1.0))
    loader = DataLoader(train_ds, batch_size=batch_size, shuffle=True, drop_last=True,
                        num_workers=int(config.dataset_num_workers or 8),
                        process_index=me, process_count=n_proc)
    config.iter_num = len(loader)
    logging.info(f"each epoch iteration: {config.iter_num}")
    logging.info(f"LMDB reader: {train_ds.reader}")
    logging.info(f"data parallel: {n_proc} process(es), rank {me}, "
                 f"{'no process group' if group is None else backend(group) + ' group'}, "
                 f"global batch {batch_size * n_proc}")

    # ------------------------------------------------------------ models
    seed = int(config.seed or 0)
    student, teacher = build_pretrain_models(
        config, device=device, generator=torch.Generator().manual_seed(seed))
    state = init_pretrain_state(student, teacher, seed=seed,
                                optimizer=str(config.optimizer or "adamw"), process=me)
    for module in (student, teacher):  # every rank starts from rank 0's weights
        broadcast_module(module, group)

    global_batch = batch_size * n_proc
    total_iters = max(int(config.training_epochs) * config.iter_num, 1)
    # virtual-epoch count (train.py:118-119)
    nepochs = int(config.training_epochs * config.iter_num * global_batch
                  / config.imgnet_based) + 1
    logging.info(f"training epochs is {nepochs}")

    severity = int(config.dataset_augmentation_severity or 5)
    k_steps = max(int(config.training_steps_per_dispatch or 1), 1)
    step_fn = make_multi_pretrain_step(
        severity=severity,
        base_lr=float(config.lr) * global_batch / 256.0,
        min_lr=float(config.min_lr),
        total_iters=total_iters,
        warmup_iters=int(config.warmup_epoch * config.imgnet_based / global_batch),
        weight_decay=float(config.weight_decay),
        weight_decay_end=float(config.weight_decay_end),
        momentum_teacher=float(config.momentum_teacher),
        teacher_temps=teacher_temp_schedule(
            float(config.warmup_teacher_temp), float(config.teacher_temp),
            int(config.warmup_teacher_temp_epochs), nepochs),
        clip_grad=config.clip_grad,
        freeze_last_layer=int(config.freeze_last_layer),
        global_batch=global_batch,
        imgnet_based=int(config.imgnet_based),
        group=group)

    ckpt_dir = os.path.join(config.output_dir, config.global_name)
    manager = CheckpointManager(ckpt_dir, max_to_keep=3,
                                keep_period=int(config.saveckp_freq or 10), group=group)
    latest = manager.latest_step()
    if latest is not None:
        logging.info(f"resuming from checkpoint step {latest}")
        restore_pretrain_state(state, manager.restore(latest, map_location=device), group)
        for module in (student, teacher):
            broadcast_module(module, group)

    metric_logger = MetricLogger(delimiter="  ")
    # background staging: K uint8 batches stacked, pinned and copied ahead of
    # the loop on a side stream, so decoding and the copy overlap the card's work
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    staged = device_chunks(infinite_batches(loader), k_steps,
                           lambda chunk: stage_pretrain_chunk(chunk, device, copy_stream))
    iteration = state.iteration
    start_iteration = iteration
    global_epoch = 0
    # None without TensorBoard or off rank 0; before the clock
    writer = summary_writer(config.global_name) if me == 0 else None
    start = time.time()
    n_steps = min(total_iters, args.max_iters or total_iters)
    if args.max_iters and args.max_iters > total_iters:
        logging.warning(f"--max_iters {args.max_iters} exceeds the schedule length "
                        f"epochs*iter_num={total_iters}; running {total_iters} iterations")
    log_path = os.path.join(config.global_workdir, "log.txt")
    os.makedirs(config.global_workdir, exist_ok=True)

    show_iters = int(config.training_show_iters or 200)
    if (n_steps - iteration) % k_steps != 0:
        logging.warning(
            f"remaining steps {n_steps - iteration} not a multiple of "
            f"training.steps_per_dispatch={k_steps}; the loop runs "
            f"{(iteration - n_steps) % k_steps} extra iterations; checkpoints are labeled "
            f"with the actual iteration count")
    profiler, last = None, {}
    try:
        while iteration < n_steps:
            if args.profile_dir and profiler is None and 10 <= iteration < 10 + k_steps:
                from torch.profiler import ProfilerActivity, profile
                activities = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if device.type == "cuda" else [])
                profiler = profile(activities=activities)
                profiler.__enter__()
            raws, masks, ready = next(staged)
            wait_for_chunk(raws, masks, ready)
            state, metrics = step_fn(state, raws, masks)
            iteration += k_steps
            if profiler is not None and iteration >= 10 + k_steps:
                profiler.__exit__(None, None, None)
                os.makedirs(args.profile_dir, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
                profiler, args.profile_dir = None, None

            # the virtual epoch is a function of the iteration, computed on the
            # host: the loop waits for the card only to log and to checkpoint
            epoch = int(iteration * global_batch // config.imgnet_based)
            if epoch != global_epoch:
                global_epoch = epoch
                metric_logger.synchronize_between_processes(group)
                logging.info(f"Averaged stats: {metric_logger}")
                manager.save(iteration, pretrain_state_payload(state, group))
                if me == 0:
                    stats = {f"train_{k}": m.global_avg for k, m in metric_logger.meters.items()}
                    stats["epoch"] = epoch
                    with open(log_path, "a") as f:
                        f.write(json.dumps(stats) + "\n")
                metric_logger = MetricLogger(delimiter="  ")

            if iteration % show_iters < k_steps:  # boundary crossed this chunk
                host = {k: v.cpu().numpy() for k, v in metrics.items()}  # waits for the card
                last = {k: float(v[-1]) for k, v in host.items()}
                # NaN-loss abort (reference train.py:239-241), at the logging
                # sync point so that it costs no extra wait
                if not np.isfinite(host["loss"]).all():
                    logging.error(f"Loss is {last['loss']}, stopping training")
                    sys.exit(1)
                metric_logger.update(loss=last["loss"], lr=last["lr"], wd=last["wd"])
                ips = global_batch * (iteration - start_iteration) / (time.time() - start)
                logging.info(f"it {iteration - 1} epoch {epoch} loss {last['loss']:.4f} "
                             f"(mask {last['mask_loss']:.4f} dino {last['dino_loss']:.4f}) "
                             f"lr {last['lr']:.2e} {ips:.1f} img/s")
                if writer is not None:
                    for k in ("loss", "mask_loss", "dino_loss", "lr", "wd"):
                        writer.add_scalar(f"metric/{k}", last[k], iteration)
    finally:
        if writer is not None:
            writer.close()

    manager.save(iteration, pretrain_state_payload(state, group))
    manager.wait()
    total = time.time() - start
    images_per_s = global_batch * (iteration - start_iteration) / total
    logging.info(f"Training time {total:.0f}s ({images_per_s} img/s with data loading)")
    return {"iteration": iteration, "last": last, "images_per_s": images_per_s,
            "checkpoint": manager.latest_step()}


if __name__ == "__main__":
    main()
