#!/usr/bin/env python
"""Supervised finetune CLI (parity target: root ``train_finetune.py``, itself
the counterpart of the reference train_finetune.py).

Teacher-forced recognition training with periodic benchmark evaluation and
best-checkpoint keeping. Each iteration runs on the card: uint8 images and
int32 targets staged ahead by a background thread → ``supervised_augment`` →
normalisation → ViT + Mlp encoder + NRTR decoder (teacher forced) →
``tf_loss`` → backward → global-norm clipping → AdamW
(``make_multi_finetune_step``, K iterations per staged chunk).

One process, or one process per GPU under ``torchrun`` (data parallelism,
``parallel/mesh.py``): every rank reads its shard of the training data
(``batch_size`` is per process), the step sums the ranks' gradients, every
evaluation is sharded over the ranks and each gets the full benchmarks'
figures, and rank 0 alone writes checkpoints, the evaluation log and
TensorBoard. ``mesh.num_devices`` must be null or the world size;
``mesh.model_parallel`` is not read (as in the JAX CLI: only the pretraining
head is split over a model axis).

Usage:
  python -m ccd_tpu_torch.cli.train_finetune -c ccd_tpu_torch/configs/ccd_finetune_ard.yaml \
      [--batch_size N] [--checkpoint path] [--run_only_test] [--test_root p] \
      [--epochs N] [--eval_iters N] [--max_iters N] [--synthetic N] [--device cuda|cpu]
  torchrun --standalone --nproc_per_node 8 -m ccd_tpu_torch.cli.train_finetune -c ...

Runs on the GPU unless ``--device cpu`` is given; asking for the GPU on a
machine without one is an error. ``model.pretrain_checkpoint`` in the
configuration names a pretraining checkpoint (this package's ``train`` CLI
output, or a reference CCD ``.pth``) whose teacher backbone starts the
recognizer. Checkpoints go to ``<output_dir>/<global.name>/``: ``ckpt_<it>.pt``
every ``save_iters`` and at the end, ``best_accuracy.pt`` whenever an
evaluation is at least as good as the best so far, and
``log_all_evaluation.txt``. A run finds the latest ``ckpt_<it>.pt`` there and
resumes from it, ``best_accuracy`` included. Where ``torch.utils.tensorboard``
can be imported, ``./tensorboard/<global.name>`` receives the scalars
``metric/train_loss`` and ``metric/lr`` and the images ``Mask/Input_image``
and ``Mask/vis_Maps`` (the last decoder layer's cross-attention per character
over the input) at every show boundary, and ``metric/eval_acc`` after every
periodic evaluation.
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--run_only_test", action="store_true", default=None)
    p.add_argument("--test_root", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--eval_iters", type=int, default=None)
    p.add_argument("--max_iters", type=int, default=None,
                   help="hard cap on iterations (smoke runs)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N freshly generated synthetic samples")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def _log_attention_maps(writer, model, images, iteration: int) -> None:
    """The per-character cross-attention heatmap grid over the input image
    (parity: root ``train_finetune.py::_log_attention_maps``, reference
    train_finetune.py:301-326): the last decoder layer's cross-attention of
    a teacher-forced forward on ``images[:1]`` (normalised, (B, H, W, 3)),
    without dropout and without a gradient, with a start token followed by
    padding as targets, averaged over heads. Writes ``Mask/Input_image``
    (3, H, W) and ``Mask/vis_Maps``, the T maps over the image five to a row.
    A failure is logged and never stops training."""
    try:
        import cv2
        import numpy as np
        import torch

        from ccd_tpu_torch.data.augment import denormalize

        decoder = model.decoder
        targets = torch.full((1, model.max_seq_len), decoder.padding_idx, dtype=torch.long,
                             device=images.device)
        targets[:, 0] = decoder.start_idx
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                _logits, attn = model(images[:1], targets, train_mode=True)
        finally:
            model.train(was_training)
        attn = attn.float().mean(1).cpu().numpy()  # (1, T, 256)
        t = attn.shape[1]
        img = denormalize(images[0].float()).cpu().numpy()
        img = np.clip(img * 255.0, 0, 255).astype(np.float32)
        writer.add_image("Mask/Input_image", (img / 255.0).transpose(2, 0, 1), iteration)
        overlaps = []
        for step in range(t):
            amap = attn[0, step].reshape(8, 32)
            amap = (amap - amap.min()) / (amap.max() - amap.min() + 1e-12)
            amap = cv2.resize(amap, (img.shape[1], img.shape[0]))
            heat = cv2.applyColorMap((amap * 255).astype(np.uint8),
                                     cv2.COLORMAP_JET).astype(np.float32)
            overlaps.append(cv2.addWeighted(heat, 0.6, img, 0.4, 0))
        grid_rows = []
        for r in range(0, t, 5):
            row = overlaps[r:r + 5]
            grid_rows.append(np.concatenate(row + [np.zeros_like(overlaps[0])] * (5 - len(row)),
                                            axis=1))
        grid = np.concatenate(grid_rows, axis=0) / 255.0
        writer.add_image("Mask/vis_Maps", grid.transpose(2, 0, 1), iteration)
    except Exception as e:  # visualisation must never stop training
        logging.warning(f"attention maps not written: {type(e).__name__}: {e}")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns ``{"iteration", "accuracy" (the last evaluation's),
    "best_accuracy", "images_per_s" (with data loading), "checkpoint"}``."""
    args = _parse_arguments(argv)
    from ccd_tpu_torch.config import Config
    from ccd_tpu_torch.parallel.mesh import data_mesh, distributed_run, rank
    from ccd_tpu_torch.utils import resolve_device
    from ccd_tpu_torch.utils.logging import run_log

    config = Config(args.config)
    config.override(dataset_train_batch_size=args.batch_size,
                    model_checkpoint=args.checkpoint, training_epochs=args.epochs,
                    training_eval_iters=args.eval_iters)
    if args.test_root:
        config.dataset_test_roots = [args.test_root]
    with distributed_run(resolve_device(args.device)) as device:
        # the JAX CLI lays a data mesh (train_finetune.py:244) and reads no
        # mesh.model_parallel: a recognizer has no wide head to split
        group = data_mesh(config.mesh_num_devices)
        with run_log(config, lead=rank(group) == 0):
            return _run(config, args, device, group)


def _run(config, args, device, group) -> dict:
    tmp = None
    try:
        if args.synthetic:
            from ccd_tpu_torch.data.synthetic import write_synthetic_lmdb
            tmp = tempfile.mkdtemp(prefix="ccd_synth_ft_")
            train_root = os.path.join(tmp, "training", "SYNTH")
            test_root = os.path.join(tmp, "evaluation", "SYNTH")
            write_synthetic_lmdb(train_root, args.synthetic, seed=1)
            write_synthetic_lmdb(test_root, max(args.synthetic // 4, 8), seed=2)
            config.dataset_train_roots = [train_root]
            config.dataset_test_roots = [test_root]
        return _train(config, args, device, group)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _train(config, args, device, group) -> dict:
    import numpy as np
    import torch

    from ccd_tpu_torch.builders import (build_recognizer, load_finetune_payload,
                                        load_pretrained_backbone, load_recognizer_params)
    from ccd_tpu_torch.checkpoints.torch_io import CheckpointManager, save_payload
    from ccd_tpu_torch.data.augment import abinet_augment, normalize, supervised_augment
    from ccd_tpu_torch.data.dataset import SupervisedDataset, build_dataset
    from ccd_tpu_torch.data.pipeline import (DataLoader, device_chunks, infinite_batches,
                                             stage_finetune_chunk, wait_for_chunk)
    from ccd_tpu_torch.evaluation.runner import evaluate_benchmarks
    from ccd_tpu_torch.parallel.mesh import backend, broadcast_module, rank, world
    from ccd_tpu_torch.training.finetune_step import (finetune_state_payload,
                                                      init_finetune_state,
                                                      make_multi_finetune_step,
                                                      restore_finetune_state)
    from ccd_tpu_torch.utils.logging import summary_writer
    from ccd_tpu_torch.utils.meters import Averager, Timer

    # ------------------------------------------------------------ data
    me, n_proc = rank(group), world(group)
    batch_size = int(config.dataset_train_batch_size or 288)
    max_seq_len = int(config.decoder_max_seq_len)
    charset = config.dataset_charset_type or "DICT90"
    train_ds = build_dataset(
        SupervisedDataset, config.dataset_train_roots, is_training=True,
        max_seq_len=max_seq_len, charset_type=charset,
        data_portion=float(config.dataset_portion or 1.0),
        multiscales=bool(config.dataset_multiscales))
    loader = DataLoader(train_ds, batch_size=batch_size, shuffle=True, drop_last=True,
                        num_workers=int(config.dataset_num_workers or 4),
                        process_index=me, process_count=n_proc)
    config.iter_num = len(loader)
    logging.info(f"each epoch iteration: {config.iter_num}")
    logging.info(f"LMDB reader: {train_ds.reader}")
    logging.info(f"data parallel: {n_proc} process(es), rank {me}, "
                 f"{'no process group' if group is None else backend(group) + ' group'}, "
                 f"global batch {batch_size * n_proc}")

    # ------------------------------------------------------------ model
    seed = int(config.seed or 0)
    model, _convertor = build_recognizer(config, device=device,
                                         generator=torch.Generator().manual_seed(seed))
    if config.model_pretrain_checkpoint:
        logging.info(f"Read pretrain vision model from {config.model_pretrain_checkpoint}.")
        load_pretrained_backbone(config.model_pretrain_checkpoint, model)
    if config.model_checkpoint:
        logging.info(f"Read vision model from {config.model_checkpoint}.")
        load_recognizer_params(config.model_checkpoint, model)
    state = init_finetune_state(model, seed=seed, process=me)
    broadcast_module(model, group)  # every rank starts from rank 0's weights

    ckpt_dir = os.path.join(config.output_dir, config.global_name)
    eval_loader_cache = {}  # benchmark datasets and loaders built once per run

    def run_eval(iteration=None) -> float:
        results, weighted = evaluate_benchmarks(
            model, list(config.dataset_test_roots or []),
            batch_size=int(config.dataset_test_batch_size or batch_size),
            max_seq_len=max_seq_len, charset_type=charset,
            case_sensitive=bool(config.dataset_eval_case_sensitive),
            process_index=me, process_count=n_proc, loader_cache=eval_loader_cache)
        # per-benchmark evaluation log (reference train_finetune.py:352-371)
        evaluation_log = "" if iteration is None else f"iteration: {iteration} \n"
        for res in results:
            line = (f"dataset: {os.path.basename(str(res['name']))} --> "
                    f"word_num: {int(res['words'])} --> accuracy: {res['cwr']:0.3f}")
            logging.info(line)
            evaluation_log += line + "\n"
        logging.info(f"total_accuracy: {weighted:0.3f}")
        evaluation_log += f"total_accuracy: {weighted:0.3f}"
        if me == 0:
            os.makedirs(ckpt_dir, exist_ok=True)
            with open(os.path.join(ckpt_dir, "log_all_evaluation.txt"), "a") as log:
                log.write("-" * 80 + "\n")
                log.write(evaluation_log + "\n")
        return weighted

    if args.run_only_test:
        acc = run_eval()
        return {"iteration": state.iteration, "accuracy": acc, "best_accuracy": None,
                "images_per_s": None, "checkpoint": None}

    # ------------------------------------------------------------ train
    total_iters = max(int(config.training_epochs * config.iter_num), 1)
    aug_fn = None
    if config.dataset_data_aug:
        aug_fn = abinet_augment if config.dataset_use_abi else supervised_augment
    k_steps = max(int(config.training_steps_per_dispatch or 1), 1)
    step_fn = make_multi_finetune_step(
        aug_fn=aug_fn, base_lr=float(config.lr), min_lr=float(config.min_lr or 0.0),
        total_iters=total_iters,
        warmup_iters=int((config.warmup_epochs or 0) * config.iter_num),
        weight_decay=float(config.weight_decay), clip_grad=config.clip_grad, group=group)

    # ---- full-state resume (weights + AdamW moments + iteration + best):
    # a checkpoint of this run's own directory first, else a full payload at
    # --checkpoint (a reference .pth was loaded above as weights only)
    manager = CheckpointManager(ckpt_dir, max_to_keep=3, group=group)
    best_path = os.path.join(ckpt_dir, "best_accuracy.pt")
    best_accuracy = 0.0
    payload = None
    if manager.latest_step() is not None:
        logging.info(f"resuming mid-run from {ckpt_dir} step {manager.latest_step()}")
        payload = load_finetune_payload(ckpt_dir, map_location=device)
    elif config.model_checkpoint:
        payload = load_finetune_payload(config.model_checkpoint, map_location=device)
    if payload is not None:
        restore_finetune_state(state, payload, group)
        broadcast_module(model, group)
        best_accuracy = float(payload["best_accuracy"])
        logging.info(f"continue to train:{state.iteration} (best_accuracy {best_accuracy:0.3f})")

    # background staging: K uint8 batches and their targets stacked, pinned
    # and copied ahead of the loop on a side stream
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    staged = device_chunks(infinite_batches(loader), k_steps,
                           lambda chunk: stage_finetune_chunk(chunk, device, copy_stream))
    n_steps = min(total_iters, args.max_iters or total_iters)
    if args.max_iters and args.max_iters > total_iters:
        logging.warning(f"--max_iters {args.max_iters} exceeds the schedule length "
                        f"epochs*iter_num={total_iters}; running {total_iters} iterations")
    show_iters = int(config.training_show_iters or 50)
    eval_iters = int(config.training_eval_iters or 3000)
    save_iters = int(config.training_save_iters or 20000)
    iteration = start_iteration = state.iteration
    if (n_steps - iteration) % k_steps != 0:
        logging.warning(
            f"remaining steps {n_steps - iteration} not a multiple of "
            f"training.steps_per_dispatch={k_steps}; the loop runs "
            f"{(iteration - n_steps) % k_steps} extra iterations; checkpoints are labeled "
            f"with the actual iteration count")
    pending = []
    loss_avg, timer = Averager(), Timer()
    # None without TensorBoard or off rank 0; before the clock
    writer = summary_writer(config.global_name) if me == 0 else None
    start = time.time()
    try:
        while iteration < n_steps:
            timer.tic()
            images, targets, ready = next(staged)
            wait_for_chunk(images, targets, ready)
            timer.toc_data()  # the host's wait for the loader and the chunk's copy
            state, metrics = step_fn(state, images, targets)
            pending.append(metrics["loss"])  # (K,) on the device; fetched at log time
            iteration += k_steps

            if iteration % show_iters < k_steps:
                losses = torch.cat(pending).float().cpu().numpy()  # waits for the card
                pending.clear()
                if not np.isfinite(losses).all():
                    logging.error(f"Loss is {losses[-1]}, stopping training")
                    sys.exit(1)
                for v in losses:
                    loss_avg.add(v)
                lr = float(metrics["lr"][-1])
                ips = batch_size * n_proc * (iteration - start_iteration) / (time.time() - start)
                logging.info(f"iteration:{iteration - 1}--> train loss:{loss_avg.val():.4f} "
                             f"lr:{lr:.2e} ({time.time() - start:.0f}s, {ips:.1f} img/s, "
                             f"data wait {1e3 * timer.average_data_time():.1f} ms/chunk)")
                if writer is not None:
                    writer.add_scalar("metric/train_loss", loss_avg.val(), iteration)
                    writer.add_scalar("metric/lr", lr, iteration)
                    # the last batch of the chunk as loaded, before augmentation
                    _log_attention_maps(writer, model, normalize(images[-1].float() / 255.0),
                                        iteration)
                loss_avg.reset()

            if iteration >= k_steps and iteration % eval_iters < k_steps:
                logging.info("eval model")
                acc = run_eval(iteration)
                if writer is not None:
                    writer.add_scalar("metric/eval_acc", acc, iteration)
                if acc >= best_accuracy:
                    # durable best checkpoint at a fixed path that the manager's
                    # retention never evicts (reference best_accuracy.pth,
                    # train_finetune.py:373-378), overwritten on improvement
                    best_accuracy = acc
                    save_payload(best_path, finetune_state_payload(state, best_accuracy, group),
                                 group)

            if iteration >= k_steps and iteration % save_iters < k_steps:
                manager.save(iteration, finetune_state_payload(state, best_accuracy, group))
    finally:
        if writer is not None:
            writer.close()

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    total = time.time() - start
    images_per_s = (batch_size * n_proc * (iteration - start_iteration) / total
                    if total > 0 else 0.0)
    logging.info(f"Training time {total:.0f}s ({images_per_s} img/s with data loading)")

    # final eval + save (labeled with the ACTUAL trained iteration count)
    acc = run_eval(iteration)
    if acc >= best_accuracy:
        best_accuracy = acc
        save_payload(best_path, finetune_state_payload(state, best_accuracy, group), group)
    if manager.latest_step() != iteration:
        manager.save(iteration, finetune_state_payload(state, best_accuracy, group))
    manager.wait()
    logging.info(f"done: final accuracy {acc:0.3f}, best {best_accuracy:0.3f}")
    return {"iteration": iteration, "accuracy": acc, "best_accuracy": best_accuracy,
            "images_per_s": images_per_s, "checkpoint": manager.latest_step()}


if __name__ == "__main__":
    main()
