#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU, ``nvcc`` and nothing outside the repository.
It builds the CUDA kernels of ``ccd_tpu_torch`` from their sources (all
``nvcc`` runs started together), holds each against its plain PyTorch version
on the card, then drives the port's two main paths at the full width of the
shipped configurations, with random weights from a seed:

  * the recognizer's evaluation (ViT-Small + 6-layer NRTR greedy decode, bf16,
    batch 288, ``ccd_finetune_ard.yaml``) over synthetic LMDBs through
    ``evaluate_benchmarks`` as the CLI calls it;
  * the greedy decode replayed from its CUDA graphs (``decode_graph``):
    batches of 1024 and a ragged 1000, three different batches a size and
    the parameters updated in place between calls, each call bit for bit
    equal to the eager decode; both sides' host ms and the graphs held;
  * the training steps' augmentations replayed from their CUDA graphs
    (``augment_graph``) against the eager chains over 10 calls each:
    generator states, draws and theta equal after every call, the views
    equal under deterministic algorithms; host launches a call;
  * the pretraining step on raw images (on-device severity-5 augmentation
    with the bilateral filter, three views and theta, eager in a step
    object's first step, captured in its second, replayed after, each
    call's host K3 launches held to its kind; student/teacher
    ViT-Small, SegHead, glyph clusters, char pooling, 65536-wide DINO head,
    both losses, backward, AdamW, EMA; bf16, batch 64,
    ``ccd_pretrain_vit_small.yaml``) through ``build_pretrain_models`` /
    ``init_pretrain_state`` / ``make_fused_pretrain_step`` on rendered words
    as uint8 and their masks, first with ground-truth masks, then with
    self-predicted ones;
  * the ``train`` CLI on the same configuration over a synthetic LMDB, under
    ``torchrun --nproc_per_node 1`` (one process over NCCL): 16 iterations
    in two dispatches of 8, a checkpoint written by rank 0, and a second
    run that resumes from it; then as one plain process with 2 loader
    threads;
  * the card's calibration (``python -m ccd_tpu_torch.cli.calibrate``, in
    process, fewer calls per row): matrix-product and copy rates, and the
    folded attention forward and backward (K1b) at (768, 256, 64);
  * the finetune step at full width (``ccd_finetune_ard.yaml``: ViT-Small +
    6-layer NRTR, bf16, batch 288, dropout and drop path 0.1) on rendered
    words as uint8 and their targets, through ``build_recognizer`` /
    ``init_finetune_state`` / ``make_fused_finetune_step`` with
    ``supervised_augment``;
  * the pretraining step of ``ccd_pretrain_vit_base.yaml`` at full width
    (ViT-Base, C = 512, 8 heads, batch 48, ``out_dim`` 65536, bf16, severity
    5, ``norm_last_layer``), its kernels' launches counted by shape and its
    first step held against the plain versions; a ViT-Small pretraining step
    at augmentation severity 2, and a finetune step with ``abinet_augment``;
  * the augmentation chains beside severity 5 on their own: ``pretrain_views``
    at severities 1, 2, 3, 4 and 6 (batch 64) and ``abinet_augment`` (batch
    288), each without a host synchronisation and equal to the same chain run
    on the CPU with the card run's draws;
  * the ``train_finetune`` CLI under ``torchrun --nproc_per_node 1`` on the
    shipped configuration over synthetic LMDBs, its backbone handed over
    from the ``train`` CLI's checkpoint: 16 iterations with evaluations
    through the sharded runner, a checkpoint, and a resume to 32. Both CLIs'
    TensorBoard event files are read back where ``tensorboard`` is installed;
  * the learnability probe (``cli.overfit_probe``, in process): 32 rendered
    words, 160 finetune steps, then a greedy decode of the same images, on
    the JAX tool's ``vit_micro`` (fp32) and at full width
    (``ccd_finetune_ard.yaml``, bf16);
  * checkpoint interchange: the full-width probe's recognizer and the
    ``train`` CLI's checkpoint exported in the reference's layout
    (``checkpoints/torch_export.py``) and read back through the port's
    loaders, bit for bit, under the JAX export's names;
  * the released-weight harness (``cli.parity_eval``, in process) on that
    export at batch 288 over two LMDBs named like benchmarks, against a
    direct evaluation of the probe's model, and with a moved baseline;
  * the glyph-mask generator (``cli.generate_masks``, in process) over the
    ``train`` CLI's synthetic LMDB on the card and on the CPU, read back by
    ``PretrainDataset``;
  * the ViT-Small pretraining step with ``optimizer: sgd`` and ``lars``
    (each held against the plain versions), and with ``remat: True`` against
    the same step without it (same loss, gradients and draws; 36 K1-fwd a
    step; the peak with and without);
  * ``get_last_selfattention`` of the evaluation model at batch 288, against
    the last block's attention written out here;
  * data parallelism at world size 1: the ViT-Small pretraining step and
    the finetune step through a one-process NCCL group, in turns with the
    same steps without it from one state and one input: losses and first
    moments held, the collectives' calls, bytes and device time;
  * tensor parallelism of the DINO head (``mesh.model_parallel`` 2): the
    ViT-Small pretraining step in two processes sharing the card over gloo
    (``out_dim`` 65536 as two 32768-column shards, no K2: the plain CE chain
    over the shards), held against the same steps in one process; then the
    ``train`` CLI at ``model_parallel`` 2 in both (a run and its resume) and
    one process resuming its checkpoint;
  * the C++ LMDB reader (``ccd_tpu_torch/native/``, built by ``g++`` at
    first use) against the Python one over the ``train`` CLI's 1024 words,
    byte for byte; the ``train`` CLI reads through it;
  * the convergence demo (``cli.convergence_demo``) at ``vit_tiny``,
    ``out_dim`` 8192, ``--easy --no_aug``, a few hundred iterations a phase:
    falling pretrain losses and the teacher backbone handed over by name;
  * the fused pretraining step of ``ccd_pretrain_vit_tiny.yaml`` in fp32
    (``fp32_step``: the fp32 attention kernels at (128, 256, 192, 3)), held
    against the plain versions, with the card's busy time and the attention
    kernels' device time under the profiler.

    python3 chip_smoke.py --only attention_fp32 --only fp32_step [--kernels-from DIR]

runs only the fp32 attention cases of the kernel checks and the fp32 step
after the build (``--only decode_graph``: the decode's graphs alone;
``--only layer_norm``: the LayerNorm kernels against the plain chain at the
main paths' shapes, with their times beside their bounds; ``--only
augment_graph``: the training steps' augmentation graphs against the eager
chains, draws and generator states equal); with
``--kernels-from`` each also with the attention kernels built from another
checkout's sources (the parent unpacked by ``git archive``, say), in turns
with this tree's.

It checks that each path went through the kernels (launch counts set to 0
just before a path and read just after; every LayerNorm of a path counted
from the model) and that its output agrees with a
run in which the script puts the plain versions in the kernels' place. Every
phase that fails ends the run with a non-zero exit code.

Prints one JSON object per phase, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

import ccd_tpu_torch
import ccd_tpu_torch.data.aug_ops as aug_ops_mod
import ccd_tpu_torch.data.augment as augment_mod
import ccd_tpu_torch.losses.losses as losses_mod
import ccd_tpu_torch.models.layers as layers_mod
import ccd_tpu_torch.models.pretrain as pretrain_model_mod
import ccd_tpu_torch.models.vit as vit_mod
import ccd_tpu_torch.ops.flash_attention as flash_attention_mod
import ccd_tpu_torch.ops.fused_dino_ce as fused_dino_ce_mod
import ccd_tpu_torch.training.finetune_step as finetune_step_mod
import ccd_tpu_torch.training.pretrain_step as pretrain_step_mod
from ccd_tpu_torch.builders import (build_pretrain_models, build_recognizer,
                                    load_pretrained_backbone, load_recognizer_params)
from ccd_tpu_torch.checkpoints import save_pretrain_torch, save_recognizer_torch
from ccd_tpu_torch.checkpoints.torch_io import CheckpointManager
from ccd_tpu_torch.cli import calibrate, generate_masks, overfit_probe, parity_eval
from ccd_tpu_torch.config import Config
from ccd_tpu_torch.convertor import AttnConvertor
from ccd_tpu_torch.data.dataset import (PretrainDataset, SupervisedDataset, build_dataset,
                                        mask_env_path)
from ccd_tpu_torch.data.lmdb import LmdbReader, LmdbWriter
from ccd_tpu_torch.data.pipeline import DataLoader
from ccd_tpu_torch.data.augment import abinet_augment, pretrain_views, supervised_augment
from ccd_tpu_torch.data.random import TorchKey
from ccd_tpu_torch.data.synthetic import make_synthetic_batch, write_synthetic_lmdb
from ccd_tpu_torch.evaluation import runner
from ccd_tpu_torch.losses import teacher_temp_schedule
from ccd_tpu_torch.ops import _build
from ccd_tpu_torch.ops.bilateral import (bilateral_filter_fused, bilateral_filter_plain,
                                         kernel_attributes as bilateral_attributes)
from ccd_tpu_torch.ops.kmeans_mask import kmeans_foreground_mask
import ccd_tpu_torch.ops.layer_norm as layer_norm_mod
from ccd_tpu_torch.ops.layer_norm import (check_kernel_inputs as check_layer_norm_inputs,
                                          kernel_attributes as layer_norm_attributes,
                                          layer_norm, layer_norm_plain)
from ccd_tpu_torch.models.nrtr import NRTRDecoder
from ccd_tpu_torch.parallel.mesh import (collective_counts, collective_counts_by_group,
                                         init_distributed, pretrain_mesh,
                                         reset_collective_counts)
from ccd_tpu_torch.ops.flash_attention import (backward_kernel_attributes, flash_attention,
                                               flash_attention_bwd, flash_attention_bwd_plain,
                                               flash_attention_fwd, flash_attention_plain,
                                               forward_kernel_attributes, mha, mha_packed_bias,
                                               mha_packed_bias_bwd, mha_packed_bias_bwd_plain,
                                               mha_packed_bias_fwd, mha_packed_bias_plain)
from ccd_tpu_torch.ops.fused_dino_ce import (backward_kernel_attributes as ce_backward_attributes,
                                             fused_dino_ce_backward, fused_dino_ce_backward_plain,
                                             fused_dino_ce_forward, fused_dino_ce_stats_plain,
                                             fused_dino_row_ce, fused_dino_row_ce_plain)
from ccd_tpu_torch.training.finetune_step import (FinetuneState, init_finetune_state,
                                                  make_fused_finetune_step)
from ccd_tpu_torch.training.optim import MomentumState
from ccd_tpu_torch.training.pretrain_step import (SHARDED_PARAMETERS, PretrainState,
                                                  init_pretrain_state, make_fused_pretrain_step,
                                                  pretrain_state_payload, shard_pretrain_state)

KERNEL_LIBRARIES = ("packed_attention", "packed_attention_bwd", "fused_dino_ce", "bilateral",
                    "layer_norm")

# published peaks of one H100 SXM (dense): device memory and tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,  # bf16 tensor cores
              torch.float32: 67e12}    # fp32 outside the tensor cores (no TF32 here)
# what stands behind the fp32 peak: 132 SMs of 128 fp32 lanes, an FMA counted
# as two operations, at 1.98 GHz; the special-function unit (ex2, rcp) has 16
# lanes an SM
SM_COUNT, FP32_LANES_PER_SM, SFU_LANES_PER_SM = 132, 128, 16
SM_CLOCK_HZ = PEAK_FLOPS[torch.float32] / (2 * FP32_LANES_PER_SM * SM_COUNT)

SEED = 0
BATCH = 288
N_FULL, N_RAGGED = 1152, 100           # four full batches, and a ragged set
PKG_DIR = os.path.dirname(os.path.abspath(ccd_tpu_torch.__file__))
CONFIG = os.path.join(PKG_DIR, "configs", "ccd_finetune_ard.yaml")
PRETRAIN_CONFIG = os.path.join(PKG_DIR, "configs", "ccd_pretrain_vit_small.yaml")
PRETRAIN_BATCH = 64                    # -> 2B = 128 images of 256 tokens, 3328 rows of 65536
GT_STEPS, PREDICTED_STEPS = 6, 3       # pretraining steps in the two mask regimes
VIT_BASE_CONFIG = os.path.join(PKG_DIR, "configs", "ccd_pretrain_vit_base.yaml")
VIT_BASE_BATCH = 48                    # -> 2B = 96 images, 2496 rows of 65536
VIT_BASE_STEPS = 4                     # the compared step and three timed ones
CHAIN_SEVERITIES = (1, 2, 3, 4, 6)     # pretrain_views at these, beside severity 5
# LayerNorms of a 12-block ViT: two a block and the final one; the pretraining
# student adds its three seg taps (the teacher and the recognizer compute none),
# and the NRTR decoder has three a layer and a final one, 19 a pass of 6 layers
VIT_NORMS, SEG_TAPS, DECODER_NORMS = 2 * 12 + 1, 3, 3 * 6 + 1
LAUNCHES_PER_STEP = {"K1-fwd": 24, "K1-bwd": 12, "K1b-fwd": 0, "K1b-bwd": 0, "K2-fwd": 1,
                     "K2-bwd": 1, "K3": 2, "LN-fwd": 2 * VIT_NORMS + SEG_TAPS,
                     "LN-bwd": VIT_NORMS + SEG_TAPS}
# remat: each of the student's 12 blocks runs its forward again in the backward
LAUNCHES_PER_STEP_REMAT = dict(LAUNCHES_PER_STEP, **{"K1-fwd": 36,
                                                     "LN-fwd": 2 * VIT_NORMS + SEG_TAPS + 24})
OPT_TIMED_STEPS = 3                    # sgd and lars: timed steps after the compared one
REMAT_TIMED_STEPS = 3                  # timed steps with and without remat after the first
# the convergence demo on the card, cut to a few hundred iterations a phase
# so that the script stays under 750 s (the demo logs its pretrain loss
# every 100 iterations: two readings, whose fall is the gate)
CONV_SHORT = {"pretrain_samples": 2048, "pretrain_iters": 200, "labeled": 1024,
              "eval_samples": 256, "finetune_iters": 100, "eval_iters": 50,
              "lr_finetune": 1e-3}
CLI_ITERS, CLI_RESUMED_ITERS, CLI_WORDS = 16, 48, 1024  # 1024 words: 16 iterations an epoch
STEP_PHASES = ("augment", "student_encode", "segment", "label_clusters", "warp", "teacher_encode",
               "pool_head", "seg_loss", "dino_ce", "backward", "update")
# the finetune step: 12 ViT blocks forward through K1-fwd and backward through K1-bwd
FT_LAUNCHES_PER_STEP = {"K1-fwd": 12, "K1-bwd": 12, "K1b-fwd": 0, "K1b-bwd": 0, "K2-fwd": 0,
                        "K2-bwd": 0, "K3": 0, "LN-fwd": VIT_NORMS + DECODER_NORMS,
                        "LN-bwd": VIT_NORMS + DECODER_NORMS}
FT_STEPS = 6                           # timed finetune steps after the compared one
FT_PHASES = ("augment", "forward", "tf_loss", "backward", "update")
# finetune CLI: 1152 words = 4 iterations an epoch at batch 288, 35 epochs;
# evaluations every 8 iterations over the CLI's 288-word test LMDB
FT_CLI_WORDS, FT_CLI_ITERS, FT_CLI_RESUMED_ITERS, FT_CLI_EVAL_ITERS = 1152, 16, 32, 8
CALIBRATE_ITERS = 10                   # calls per calibration row (the CLI's default is 50)
# data parallelism at world size 1 over NCCL: each step (pretrain, finetune)
# DP_STEPS times with the group and DP_STEPS times without, in turns, from one
# state and one input
DP_STEPS = 3
# the CLIs' data-parallel launcher: torchrun, one process (the card machine has one GPU)
TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1"]
TORCHRUN_LINE = "data parallel: 1 process(es), rank 0, nccl group"
# tensor parallelism of the DINO head (mesh.model_parallel 2): two processes
# on the one GPU in a gloo group (NCCL refuses two ranks on one device), one
# data rank of two model ranks, TP_STEPS steps beside the same steps in one
# process; then the train CLI at model_parallel 2 (TP_CLI_ITERS iterations,
# a resume to TP_CLI_RESUMED_ITERS) and one process resuming its checkpoint
# to TP_CLI_FINAL_ITERS
TP_WORLD, TP_STEPS = 2, 3
# 256 words: 4 iterations an epoch, 12 in the configuration's 3 epochs
TP_CLI_WORDS, TP_CLI_ITERS, TP_CLI_RESUMED_ITERS, TP_CLI_FINAL_ITERS = 256, 4, 8, 10
TP_WORKER_FLAG = "--tensor-parallel-worker"
TP_LINE = f"tensor parallel: 1 data rank(s) x {TP_WORLD} model ranks"
# the learnability probe at the JAX tool's size (tools/overfit_probe.py: 32
# words, 160 steps), first on its own model (vit_micro, fp32), then at full
# width; the JAX package's CPU run of the same probe read 32 of 32 words
# back (loss 4.6021 -> 0.0057), a figure printed beside the port's
PROBE_WORDS, PROBE_STEPS, PROBE_LOG_EVERY = 32, 160, 50
PROBE_MIN_ACCURACY = 0.9
PROBE_JAX_CPU = {"correct": 32, "words": 32, "first_loss": 4.6021, "last_loss": 0.0057}
# the harness: a second benchmark of other words, four full batches of 288;
# a baseline moved by this many points must fail the run at 0.2
PARITY_OTHER_WORDS, PARITY_MOVED = 1152, 0.5
# generate_masks: the train CLI's synthetic LMDB (cli/train.py --synthetic),
# masks batched at 256 as the CLI's default
MASK_BATCH = 256
# k-means on the card against the CPU: a pixel on the midpoint of the two
# fp32 centroids may land on either side (another summation order); at most
# this share of the pixels, each within this relative distance of the
# midpoint (computed in float64)
MASK_MAX_DIFF_SHARE, MASK_TIE_RTOL = 1e-4, 1e-3
# names in the JAX package's reference-layout exports at ViT-Small (12
# blocks) with the 6-layer NRTR: recognizer, pretraining student and teacher
REFERENCE_KEY_COUNTS = {"recognizer": 274, "student": 252, "teacher": 164}
LONG = 4096                            # a long sequence: K/V (or Q/dO) stream through shared memory
# attention shapes (B, S, C, H) of the kernels phase: the evaluation and
# finetune batch, the ViT-Small pretraining batch (2 x 64 images), a small
# one, ViT-Base and ViT-Tiny at their pretraining batches (2 x 48 and 2 x 64
# images), the learnability probe's batch at full width and at vit_micro,
# 64-row tiles where S % 128 != 0, and a long sequence
EVAL_SHAPE, TRAIN_SHAPE, SMALL_SHAPE = (BATCH, 256, 384, 6), (2 * PRETRAIN_BATCH, 256, 384, 6), \
    (4, 256, 64, 2)
BASE_SHAPE, TINY_SHAPE = (2 * VIT_BASE_BATCH, 256, 512, 8), (2 * PRETRAIN_BATCH, 256, 192, 3)
PROBE_SHAPE, MICRO_SHAPE = (PROBE_WORDS, 256, 384, 6), (PROBE_WORDS, 256, 64, 2)
ODD_TILES_SHAPE, LONG_SHAPE = (2, 192, 128, 2), (1, LONG, 64, 1)
FOLDED_SHAPE = (6 * 2 * PRETRAIN_BATCH, 256, 64)          # (768, 256, 64): calibrate's
# the fp32 attention kernels' cases (all with bias but the backward's second
# train and small cases): vit_micro (the probe) and vit_tiny (the smoke
# configurations, the convergence demo) run in fp32
FP32_FORWARD_SHAPES = (EVAL_SHAPE, SMALL_SHAPE, MICRO_SHAPE, TINY_SHAPE, ODD_TILES_SHAPE,
                       LONG_SHAPE)
FP32_BACKWARD_CASES = ((TRAIN_SHAPE, True), (TRAIN_SHAPE, False), (SMALL_SHAPE, True),
                       (SMALL_SHAPE, False), (MICRO_SHAPE, True), (TINY_SHAPE, True),
                       (ODD_TILES_SHAPE, True), (LONG_SHAPE, True))
FP32_FLASH_SHAPES = (FOLDED_SHAPE, (8, 64, 32))
ATTENTION_LIBRARIES = ("packed_attention", "packed_attention_bwd")
# the vit_tiny pretraining step in fp32 (ccd_pretrain_vit_tiny.yaml with
# compute_dtype float32, batch 64: attention at TINY_SHAPE): a step held
# against the plain versions, FP32_STEP_TIMED timed ones, one profiled
TINY_CONFIG = os.path.join(PKG_DIR, "configs", "ccd_pretrain_vit_tiny.yaml")
FP32_STEP_TIMED = 3

# |kernel - plain| on O(1) outputs. bf16: both round p and the output to bf16
# (ulp 2^-8 relative, 2^-7 absolute just below 2), at different points of the
# softmax normalisation. fp32: same products, summed in another order.
# The backward's outputs are O(1) to O(4) and rounded once more (dS, P) than the
# forward's, at the same places in kernel and plain version: the same limits.
# K1b (folded and (B, S, H, D) operands) runs the same device code: the same limits.
# The backward reads the forward's saved output and log-sum-exp, the plain
# version the same tensors; the kernels' exponential is ex2.approx (2 ulp),
# far inside these limits.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# The forward's saved log-sum-exp (base 2, O(8) at S = 256) against the
# plain version's: the same fp32 logits summed in another order, through
# ex2.approx in the bf16 kernel; a few fp32 ulps of an O(10) value.
TOL_LSE = 1e-3
# dbias sums dqkv over B*S rows; kernel and plain dqkv differ by roundings of
# either sign, so the sums are compared relative to the largest entry.
TOL_DBIAS_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# Fused CE, |kernel - plain| <= rtol * |plain| + atol per row. ce is a
# difference of two O(10) terms; with bf16 logits both sides read the same
# rounded inputs, so what differs is fp32 summation order and the fast
# exponential (2 ulp). ds is compared relative to its largest entry: bf16
# rounds it to 2^-9 relative, fp32 differs by summation order in the row sums.
TOL_CE = {torch.bfloat16: (1e-3, 1e-3), torch.float32: (1e-5, 1e-4)}
TOL_DS_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# The forward's saved statistics (5, R) against fused_dino_ce_stats_plain,
# each of the five relative to its largest entry: the maxima differ by the
# rounding of s / st against s * (1 / st), the sums of 65536 positive (or, for
# the last, mixed-sign) terms by summation order and the fast exponential.
TOL_STATS_REL = 1e-4
# Pretraining step, kernels against plain versions, bf16, same state and
# drop-path draws: the losses are O(1) to O(10) means over thousands of rows
# whose logits differ by bf16 roundings of either sign; the first moments
# (0.1 x the clipped gradients) pass through 12 bf16 blocks backwards.
# The finetune step is held to the same limits: its tf_loss is a mean over
# thousands of targets, its first moments pass through 12 ViT blocks and 6
# decoder layers backwards in bf16.
TOL_STEP_LOSS_REL = 1e-2
TOL_STEP_GRAD_REL = 0.15
# The pretraining step with remat against the same step without it: both
# sides launch the same kernels on the same state, inputs and drop-path
# draws, and differ only where an op of the step is not deterministic on the
# card, by a bf16 rounding here and there. Read on the student's blocks (the
# ones remat recomputes; ViT-Small, H100): losses within 2.1e-6, the blocks'
# first moments within 7.0e-3 in L2. A recompute that draws other drop-path
# masks than the first pass (the generator not replayed) reads 0.176 there;
# in the whole model's L2 the heads' moments hide it (4.9e-3 against 7e-4).
# The limit sits between the two readings (PERF.md section 6, the remat gate).
TOL_REMAT_LOSS_REL = 1e-4
TOL_REMAT_GRAD_REL = 4e-2
REMAT_BLOCKS = "backbone.blocks."
# End to end, kernel run against plain-attention run, bf16, random weights:
# per-step probabilities (each <= 1, mostly ~1/92) compared up to the first
# step where the two runs' greedy tokens part (after it their inputs differ).
TOL_PROBS = 2e-2
# Untrained weights give near-uniform probabilities, so top-2 near-ties are
# common and bf16 rounding flips some; a flip changes every later step of its
# row. A run through a wrong kernel agrees on about 1/92 of the positions.
MIN_TOKEN_AGREEMENT = 0.5
# get_last_selfattention (bf16 probabilities, typically ~1/256) against the
# last block's attention written out in fp32 from the same weights, the
# earlier blocks through the plain versions: bf16 rounding of each
# probability and of the tokens fed in, a few 1e-5 (5.9e-5 measured). A
# wrong scale or head split moves near-uniform rows by far more.
TOL_LAST_ATTN = 1e-3
# A row of 256 bf16 probabilities, each rounded by at most 2^-8 of itself,
# sums to 1 within 2^-8 plus fp32 noise.
TOL_ROW_SUM_BF16 = 4e-3
# Bilateral filter, kernel against plain version, fp32 [0,1] images. The
# kernel folds 255^2, log2(e) and gs d^2 into the exponent's constants, lets
# the compiler contract into FMAs and takes ex2.approx (2 ulp): each weight
# differs from the plain version's exp by a few ulp of its exponent, and the
# output, a weighted mean of values in [0, 1], by at most that relative error
# of its heaviest weights (exp(e) |e| ulp peaks near |e| = 1): a few 1e-7.
TOL_BILATERAL = 1e-5
# The DINOHead normalises its bottleneck with the reference's clamp: the
# cotangent of an all-zero vector (a char slot whose cluster has no support
# on the 8x32 token grid) is multiplied by 1e12. The reference's validity
# mask keeps at least 4 slots an image whether or not they pooled anything,
# and on rendered words most slots pool nothing. Where such a student row is
# paired with a teacher row that pooled something, the three MLP biases get
# an exact, large gradient on both sides (the ViT-Small run). Where every such
# row's teacher pooled nothing too, the kernel's gradient on the row is
# exactly 0 while the plain version's is fp32 round-off, and the 1e12 makes
# that round-off the biases' whole first-step gradient (the ViT-Base run:
# first moments at the clip, 0.3 a tensor, on the plain side, ~3e-4 on the
# kernels'). The ViT-Base comparison reports them and holds the rest.
EMPTY_SLOT_BIASES = ("head.mlp.0.bias", "head.mlp.2.bias", "head.mlp.4.bias")
# An augmentation chain on the card against the same chain on the CPU, fed
# the card's own draws: the same fp32 arithmetic, summed in another order in
# places (resizes, means, products of the warps); a sampling position that
# moves by a few ulps moves the output by that much times the image's step
# at an edge (up to 1), and a rounding op (k-means, quantisation) may put a
# value within fp32 noise of an edge on the other side. The CPU tests' limit
# for the chains with a warp: 1e-4 on at least 99 % of the values.
TOL_CARD_CPU, MIN_CARD_CPU_SHARE = 1e-4, 0.99
# fp32-pipe instructions a tap of the bilateral filter cannot avoid: 3
# subtractions and 2 additions of absolute values (the L1 distance), the
# exponent's multiply and multiply-add, 3 multiply-adds into the numerator
# and 1 add into the denominator; beside one exponential on the
# special-function unit
BILATERAL_FP32_PER_TAP = 11
# the former count, 25 fp32 operations a tap (expf's helper instructions
# included) over the 67 TFLOP/s FMA peak, reported beside the new bound
BILATERAL_FORMER_OPS_PER_TAP = 25
# LayerNorm kernels against the plain chain (layer_norm_plain and its
# autograd), the same fp32 arithmetic summed in another order (a warp's
# butterfly against ATen's Welford; the parameters' gradients over up to 262k
# rows in blocks) and rsqrtf (2 ulp):
# * y in bf16: both sides round an fp32 value to bf16; where the two fp32
#   values straddle a rounding boundary they part by one bf16 ulp. Below
#   |y| = 2^-10 the fp32 difference of the row's mean (~1e-7 of the row's
#   scale) may pass a bf16 ulp of the value itself, so the ulp is taken at
#   2^-10 at the least. fp32 y, the saved mean (relative to the row's
#   largest |x|) and rstd: TOL_LN_REL.
# * dx = rstd (g - mean(g) - xh mean(g xh)): three fp32 terms whose
#   difference cancels; the fp32 error is ~1e-6 of the largest term, held at
#   TOL_LN_REL of the tensor's largest |dx|, plus one bf16 ulp of the value
#   where dx is bf16.
# * dw, db: sums over the rows in another order; each column within
#   TOL_LN_SUM_REL of the sum of its terms' magnitudes (sum |dy xh|, sum
#   |dy|): a recursive sum's error is a few ulp of that per term added in
#   sequence (~1e-6 here); a block's rows left out or counted twice moves a
#   column by ~1e-4 of it at the shapes below.
TOL_LN_REL, TOL_LN_SUM_REL, LN_ULP_FLOOR = 1e-5, 1e-5, 2.0 ** -10
LN_FLOPS_FWD, LN_FLOPS_BWD = 8, 14       # fp32 operations an element, each direction
# (rows, C, type, output type, eps, what): the main paths' norms
LN_SHAPES = (
    (1024 * 256, 384, torch.bfloat16, torch.bfloat16, 1e-6, "ViT-Small, recognition batch 1024"),
    (512 * 256, 384, torch.bfloat16, torch.bfloat16, 1e-6, "ViT-Small pretraining, 2 x 256"),
    (288 * 256, 384, torch.bfloat16, torch.bfloat16, 1e-6, "ViT-Small, batch 288"),
    (1024, 512, torch.bfloat16, torch.bfloat16, 1e-5, "NRTR greedy step, batch 1024"),
    (288 * 25, 512, torch.bfloat16, torch.bfloat16, 1e-5, "NRTR teacher-forced, batch 288"),
    (96 * 256, 512, torch.bfloat16, torch.bfloat16, 1e-6, "ViT-Base pretraining, 2 x 48"),
    (128 * 256, 192, torch.float32, torch.float32, 1e-6, "ViT-Tiny fp32 step, 2 x 64"),
    (32 * 256, 64, torch.float32, torch.float32, 1e-6, "vit_micro fp32 probe, 32"))
# every pairing of types and every count of loads a lane a row (C up to 1024)
LN_COVERAGE = ((37, 8, torch.bfloat16, torch.float32), (33, 1024, torch.float32, torch.bfloat16),
               (5, 200, torch.bfloat16, torch.bfloat16), (129, 776, torch.float32, torch.float32),
               (3, 1016, torch.bfloat16, torch.float32), (1, 520, torch.float32, torch.bfloat16))


STARTED = time.time()


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it ended (seconds since
    the script started)."""
    if "phase" in obj:
        obj = dict(obj, ended_at_s=time.time() - STARTED)
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    return out.splitlines()[0]


def call_ms(fn) -> float:
    """One call of ``fn`` between two CUDA events, the card idle before it."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def time_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median of ``reps`` single calls timed with CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return statistics.median(call_ms(fn) for _ in range(reps))


def time_pair_ms(fn_a, fn_b, reps: int = 30, warmup: int = 3):
    """Medians of ``reps`` single calls of ``fn_a`` and of ``fn_b`` timed in
    turns (a b, b a, ...): a call of a few tenths of a millisecond carries the
    host's time to issue it, which drifts within a run, and in turns both
    calls see the same drift."""
    for _ in range(warmup):
        fn_a()
        fn_b()
    torch.cuda.synchronize()
    times = ([], [])
    for i in range(reps):
        for which in ((0, 1) if i % 2 == 0 else (1, 0)):
            times[which].append(call_ms((fn_a, fn_b)[which]))
    return statistics.median(times[0]), statistics.median(times[1])


def roofline(nbytes: float, flops: float, dtype, bytes_per_s: float = HBM_BYTES_PER_S):
    """(least time in ms, what bounds it): bytes over the memory rate against
    operations over the type's peak rate."""
    t_bytes = nbytes / bytes_per_s * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_bound(b, s, c, h, dtype, with_bias):
    """Least time the card could take: each input read once, each output
    written once, over the memory rate; 4*S*S*D flop per head and batch row
    over the peak rate of the type."""
    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = (b * s * 3 * c + (3 * c if with_bias else 0) + b * s * c) * elem
    return roofline(nbytes, 4 * s * s * (c // h) * h * b, dtype)


def check_attention(shape, dtype, with_bias, gen):
    """Kernel against plain version (and the library call as a yardstick) on
    the same seeded inputs on the card."""
    b, s, c, h = shape
    qkv = torch.randn(b, s, 3 * c, device="cuda", generator=gen).to(dtype)
    bias = (0.5 * torch.randn(3 * c, device="cuda", generator=gen)).to(dtype) if with_bias else None
    scale = (c // h) ** -0.5
    out = mha_packed_bias(qkv, bias, scale, h)
    torch.cuda.synchronize()
    ref = mha_packed_bias_plain(qkv, bias, scale, h)
    err = float((out.float() - ref.float()).abs().max())
    if out.shape != (b, s, c) or out.dtype != dtype or not bool(torch.isfinite(out).all()):
        raise SystemExit(f"packed attention {shape} {dtype}: bad output")
    if not err <= TOL[dtype]:
        raise SystemExit(f"packed attention {shape} {dtype} bias={with_bias}: "
                         f"max |kernel - plain| = {err} > {TOL[dtype]}")
    extra = {}
    if dtype == torch.float32:
        # every fp32 case: two forward calls and two backward calls at its
        # shape bitwise equal (no atomics in either direction)
        out2, lse = mha_packed_bias_fwd(qkv, bias, scale, h)
        dout = torch.randn(b, s, c, device="cuda", generator=gen)
        grads = [mha_packed_bias_bwd(qkv, bias, dout, scale, h, out=out2, lse=lse)
                 for _ in range(2)]
        torch.cuda.synchronize()
        if not bool(torch.equal(out, out2)) or not bool(torch.equal(*grads)):
            raise SystemExit(f"packed attention {shape} {dtype}: two calls on the same inputs "
                             f"differ")
        extra = {"bitwise_reproducible": True, "bitwise_reproducible_backward": True}
    biased = qkv if bias is None else qkv + bias
    q, k, v = biased.view(b, s, 3, h, c // h).permute(2, 0, 3, 1, 4)
    heavy = b * s * c > 1 << 24
    bound_ms, bound_by = attention_bound(b, s, c, h, dtype, with_bias)
    kernel = lambda: mha_packed_bias(qkv, bias, scale, h)
    # one library call on ready-made q, k, v views; used nowhere in the port
    library = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
    kernel_ms, library_ms = time_pair_ms(kernel, library)
    return time_ratios({
        "shape": list(shape), "dtype": str(dtype).replace("torch.", ""), "bias": with_bias,
        "max_abs_err": err, "tol": TOL[dtype], "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda: mha_packed_bias_plain(qkv, bias, scale, h),
                            reps=3 if heavy else 10, warmup=1),
        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by, **extra,
    }, kernel, library)


def time_ratios(entry: dict, kernel, library) -> dict:
    """A case's time against the library call's and the bound (``ms`` as
    timed: one call between CUDA events, host issue included), and both
    calls' device time alone."""
    entry["ms_over_library"] = entry["kernel_ms"] / entry["library_ms"]
    entry["ms_over_bound"] = entry["kernel_ms"] / entry["bound_ms"]
    entry["device_ms"] = kernel_device_ms(kernel)
    entry["library_device_ms"] = kernel_device_ms(library)
    entry["device_ms_over_library"] = entry["device_ms"] / entry["library_device_ms"]
    return entry


def attention_bwd_bound(b, s, c, h, dtype, with_bias):
    """Backward: qkv and dO read once, dqkv written once; five products of
    2*S*S*D flop per head and batch row."""
    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * b * s * 3 * c + b * s * c + (3 * c if with_bias else 0)) * elem
    return roofline(nbytes, 10 * s * s * (c // h) * h * b, dtype)


def check_saved_lse(lse, ref_lse, what):
    """The forward's saved log-sum-exp against the plain version's."""
    err = float((lse - ref_lse).abs().max())
    if lse.dtype != torch.float32 or lse.shape != ref_lse.shape or not err <= TOL_LSE:
        raise SystemExit(f"{what}: saved lse {tuple(lse.shape)} {lse.dtype} off by {err} "
                         f"> {TOL_LSE}")
    return err


def check_attention_bwd(shape, dtype, with_bias, gen):
    """Backward kernel against its plain version (dqkv, and dbias through the
    autograd function), both given the forward kernel's saved output and
    log-sum-exp, as autograd passes them; two calls bitwise equal; the
    library's attention backward as a yardstick, timed in turns."""
    b, s, c, h = shape
    qkv = torch.randn(b, s, 3 * c, device="cuda", generator=gen).to(dtype)
    bias = (0.5 * torch.randn(3 * c, device="cuda", generator=gen)).to(dtype) if with_bias else None
    dout = torch.randn(b, s, c, device="cuda", generator=gen).to(dtype)
    scale = (c // h) ** -0.5
    what = f"packed attention backward {shape} {dtype} bias={with_bias}"
    out, lse = mha_packed_bias_fwd(qkv, bias, scale, h)
    lse_err = check_saved_lse(lse, mha_packed_bias_plain(qkv, bias, scale, h, return_lse=True)[1],
                              what)
    dqkv = mha_packed_bias_bwd(qkv, bias, dout, scale, h, out=out, lse=lse)
    again = mha_packed_bias_bwd(qkv, bias, dout, scale, h, out=out, lse=lse)
    torch.cuda.synchronize()
    ref = mha_packed_bias_bwd_plain(qkv, bias, dout, scale, h, out=out, lse=lse)
    err = float((dqkv.float() - ref.float()).abs().max())
    if dqkv.shape != qkv.shape or dqkv.dtype != dtype or not bool(torch.isfinite(dqkv).all()):
        raise SystemExit(f"{what}: bad output")
    if not err <= TOL[dtype]:
        raise SystemExit(f"{what}: max |kernel - plain| = {err} > {TOL[dtype]}")
    if not bool(torch.equal(dqkv, again)):
        raise SystemExit(f"{what}: two calls on the same inputs differ")
    dbias_rel = None
    if with_bias:
        q, bb = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
        mha_packed_bias(q, bb, scale, h).backward(dout)
        want = ref.float().sum((0, 1))
        dbias_rel = float((bb.grad.float() - want).abs().max() / want.abs().max())
        if not float((q.grad.float() - dqkv.float()).abs().max()) == 0.0:
            raise SystemExit(f"{what}: the autograd function's dqkv is not the kernel's")
        if not dbias_rel <= TOL_DBIAS_REL[dtype]:
            raise SystemExit(f"{what}: dbias off by {dbias_rel} of its largest entry "
                             f"> {TOL_DBIAS_REL[dtype]}")
    biased = qkv if bias is None else qkv + bias
    lq, lk, lv = (x.detach().requires_grad_()
                  for x in biased.view(b, s, 3, h, c // h).permute(2, 0, 3, 1, 4))
    lout = F.scaled_dot_product_attention(lq, lk, lv, scale=scale)
    ldo = dout.view(b, s, h, c // h).permute(0, 2, 1, 3)
    heavy = b * s * c > 1 << 24
    bound_ms, bound_by = attention_bwd_bound(b, s, c, h, dtype, with_bias)
    kernel = lambda: mha_packed_bias_bwd(qkv, bias, dout, scale, h, out=out, lse=lse)
    # the library's backward alone, on a graph built once over ready-made
    # q, k, v; used nowhere in the port
    library = lambda: torch.autograd.grad(lout, (lq, lk, lv), ldo, retain_graph=True)
    kernel_ms, library_ms = time_pair_ms(kernel, library)
    return time_ratios({
        "shape": list(shape), "dtype": str(dtype).replace("torch.", ""), "bias": with_bias,
        "max_abs_err": err, "tol": TOL[dtype], "dbias_rel_err": dbias_rel,
        "tol_dbias_rel": TOL_DBIAS_REL[dtype], "lse_max_abs_err": lse_err, "tol_lse": TOL_LSE,
        "bitwise_reproducible": True, "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda: mha_packed_bias_bwd_plain(qkv, bias, dout, scale, h, out=out,
                                                              lse=lse),
                            reps=3 if heavy else 10, warmup=1),
        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }, kernel, library)


def launched_tensors(fn) -> list:
    """(entry, names of the non-null tensors) of each C entry that one call
    of ``fn`` launches: the wrapper's arguments as the kernel gets them."""
    seen, real = [], flash_attention_mod._c_call

    def spy(entry, library, tensors, *args, **kwargs):
        seen.append((entry, [name for name, t in tensors if t is not None]))
        return real(entry, library, tensors, *args, **kwargs)

    flash_attention_mod._c_call = spy
    try:
        fn()
    finally:
        flash_attention_mod._c_call = real
    return seen


def forward_lse_check(shape, gen) -> dict:
    """The eval-shape forward without a gradient hands the kernel no lse
    array (so none is written) and the one that autograd runs does; the
    device time of both, and the plain forward's agreement with the saved
    lse."""
    b, s, c, h = shape
    qkv = torch.randn(b, s, 3 * c, device="cuda", generator=gen).bfloat16()
    bias = (0.5 * torch.randn(3 * c, device="cuda", generator=gen)).bfloat16()
    scale = (c // h) ** -0.5
    with torch.no_grad():
        plain_call = launched_tensors(lambda: mha_packed_bias(qkv, bias, scale, h))
    leaf = qkv.clone().requires_grad_()
    graph_call = launched_tensors(lambda: mha_packed_bias(leaf, bias, scale, h))
    want = [("packed_attention_forward", ["qkv", "bias", "out"])]
    if plain_call != want or graph_call != [("packed_attention_forward",
                                             ["qkv", "bias", "out", "lse"])]:
        raise SystemExit(f"forward lse: without a gradient the kernel got {plain_call}, with "
                         f"one {graph_call}")
    with torch.no_grad():
        no_lse_ms = kernel_device_ms(lambda: mha_packed_bias(qkv, bias, scale, h))
    return {"shape": list(shape), "dtype": "bfloat16", "no_grad_launch": plain_call,
            "grad_launch": graph_call, "device_ms_without_lse": no_lse_ms,
            "device_ms_with_lse": kernel_device_ms(lambda: mha_packed_bias_fwd(qkv, bias, scale,
                                                                              h))}


def fused_ce_bounds(r, k, dtype):
    """Forward: s and t read once (and the centre, and the per-row outputs);
    backward: both read again, ds written. About a dozen fp32 operations per
    logit pair either way, against the fp32 rate outside the tensor cores."""
    elem = torch.empty((), dtype=dtype).element_size()
    fwd_bytes = 2 * r * k * elem + 4 * k + 4 * r * 6
    bwd_bytes = 3 * r * k * elem + 4 * k + 4 * r * 6
    return [roofline(fwd_bytes, 12 * r * k, torch.float32),
            roofline(bwd_bytes, 10 * r * k, torch.float32)]


def check_fused_ce(r, k, dtype, swap_halves, gen, teacher_temp=0.04, student_temp=0.1):
    """Fused CE forward and backward kernels against the plain version:
    through autograd against autograd of the plain chain; then the kernels
    alone, the forward's saved statistics against
    ``fused_dino_ce_stats_plain`` and the backward against
    ``fused_dino_ce_backward_plain`` on those same statistics. Times: single
    calls between CUDA events (host issue included; the backward as one
    autograd call) and each kernel's device time alone, beside the library
    composition's."""
    s = (0.5 * torch.randn(r, k, device="cuda", generator=gen)).to(dtype).requires_grad_()
    t = (0.5 * torch.randn(r, k, device="cuda", generator=gen)).to(dtype)
    c = 0.1 * torch.randn(1, k, device="cuda", generator=gen)
    g = torch.randn(r, device="cuda", generator=gen)
    args = (c, teacher_temp, student_temp, swap_halves)
    ce = fused_dino_row_ce(s, t, *args)
    (ds,) = torch.autograd.grad(ce, s, g, retain_graph=True)
    torch.cuda.synchronize()
    ref = fused_dino_row_ce_plain(s, t, *args)
    (ds_ref,) = torch.autograd.grad(ref, s, g, retain_graph=True)
    what = f"fused CE ({r}, {k}) {dtype} swap_halves={swap_halves}"
    if ce.shape != (r,) or ce.dtype != torch.float32 or ds.dtype != dtype \
            or not bool(torch.isfinite(ce).all()) or not bool(torch.isfinite(ds).all()):
        raise SystemExit(f"{what}: bad output")
    rtol, atol = TOL_CE[dtype]
    ce_err = (ce - ref).abs().detach()
    if not bool((ce_err <= rtol * ref.abs() + atol).all()):
        raise SystemExit(f"{what}: ce off by {float(ce_err.max())} (rtol {rtol}, atol {atol})")
    ds_err = float((ds.float() - ds_ref.float()).abs().max())
    ds_rel = ds_err / float(ds_ref.float().abs().max())
    if not ds_rel <= TOL_DS_REL[dtype]:
        raise SystemExit(f"{what}: ds off by {ds_rel} of its largest entry > {TOL_DS_REL[dtype]}")
    # the kernels alone, the backward on the forward kernel's saved statistics
    _, stats = fused_dino_ce_forward(s, t, *args)
    stats_ref = fused_dino_ce_stats_plain(s, t, *args)
    stats_rel = max(float((stats[i] - stats_ref[i]).abs().max() / stats_ref[i].abs().max())
                    for i in range(5))
    if not stats_rel <= TOL_STATS_REL:
        raise SystemExit(f"{what}: saved statistics off by {stats_rel} of their largest entries "
                         f"> {TOL_STATS_REL}")
    saved_args = (c, g, stats, teacher_temp, student_temp, swap_halves)
    ds_saved = fused_dino_ce_backward(s, t, *saved_args)
    ds_saved_ref = fused_dino_ce_backward_plain(s, t, *saved_args)
    saved_rel = float((ds_saved.float() - ds_saved_ref.float()).abs().max()
                      / ds_saved_ref.float().abs().max())
    if ds_saved.dtype != dtype or not saved_rel <= TOL_DS_REL[dtype]:
        raise SystemExit(f"{what}: the backward kernel on saved statistics is off by "
                         f"{saved_rel} of the plain version's largest entry > {TOL_DS_REL[dtype]}")
    del ds_saved, ds_saved_ref, stats_ref
    heavy = r * k > 1 << 24
    reps = dict(reps=3, warmup=1) if heavy else {}
    (fwd_bound, fwd_by), (bwd_bound, bwd_by) = fused_ce_bounds(r, k, dtype)
    common = {"shape": [r, k], "dtype": str(dtype).replace("torch.", ""),
              "swap_halves": swap_halves,
              "library_call": "F.cross_entropy(s / student_temp, torch.softmax((t - c) / "
                              "teacher_temp)) on rows already paired: no one call computes "
                              "the centred, cross-view CE"}
    sd = s.detach()
    # the closest library composition, on the same inputs with the teacher's
    # rows paired beforehand (outside the timing); used nowhere in the port
    tp = torch.roll(t, -(r // 2), dims=0) if swap_halves else t
    sl = s.detach().clone().requires_grad_()
    library = lambda x: F.cross_entropy(
        x.float() / student_temp, torch.softmax((tp.float() - c) / teacher_temp, dim=-1),
        reduction="none")
    lce = library(sl)
    add_out = torch.empty_like(sd)
    kernel_fwd = lambda: fused_dino_row_ce(sd, t, *args)
    kernel_bwd = lambda: torch.autograd.grad(ce, s, g, retain_graph=True)
    library_bwd = lambda: torch.autograd.grad(lce, sl, g, retain_graph=True)
    fwd = dict(common, max_abs_err=float(ce_err.max()), tol={"rtol": rtol, "atol": atol},
               stats_rel_err=stats_rel, tol_stats_rel=TOL_STATS_REL,
               kernel_ms=time_ms(kernel_fwd),
               plain_ms=time_ms(lambda: fused_dino_row_ce_plain(sd, t, *args), **reps),
               library_ms=time_ms(lambda: library(sd), **reps),
               bound_ms=fwd_bound, bound_by=fwd_by,
               device_ms=kernel_device_ms(kernel_fwd, "dino_ce_forward"),
               library_device_ms=kernel_device_ms(lambda: library(sd)))
    bwd = dict(common, max_abs_err=ds_err, rel_err=ds_rel, tol_rel=TOL_DS_REL[dtype],
               saved_stats_rel_err=saved_rel,
               kernel_ms=time_ms(kernel_bwd),
               plain_ms=time_ms(lambda: torch.autograd.grad(ref, s, g, retain_graph=True),
                                **reps),
               library_ms=time_ms(library_bwd, **reps),
               bound_ms=bwd_bound, bound_by=bwd_by,
               device_ms=kernel_device_ms(kernel_bwd, "dino_ce_backward"),
               library_device_ms=kernel_device_ms(library_bwd),
               # the card's rate for this traffic: one elementwise call that
               # reads two (R, K) arrays of s's type and writes a third
               same_bytes_add_device_ms=kernel_device_ms(
                   lambda: torch.add(sd, t, out=add_out)))
    for entry in (fwd, bwd):
        entry["bound_over_device_ms"] = entry["bound_ms"] / entry["device_ms"]
    return fwd, bwd


def check_flash(shape, dtype, gen):
    """K1b forward and backward against their plain versions on the same
    seeded inputs: folded (BH, S, D) through ``flash_attention``, or
    (B, S, H, D) through ``mha``; the backward given the forward kernel's
    saved output and log-sum-exp, and bitwise equal over two calls; the
    library's attention, forward and backward, as a yardstick, each timed
    in turns with the kernel. Bounds: q, k, v read and o written (forward),
    q, k, v, dO read and dq, dk, dv written (backward), once each; 4 and 10
    S*S*D flop per head."""
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(4))
    scale = shape[-1] ** -0.5
    bshd = len(shape) == 4
    fn = mha if bshd else flash_attention
    what = f"{'mha' if bshd else 'flash_attention'} {shape} {dtype}"
    out = fn(q, k, v, scale)
    torch.cuda.synchronize()
    err = float((out.float() - flash_attention_plain(q, k, v, scale).float()).abs().max())
    fout, lse = flash_attention_fwd(q, k, v, scale)
    lse_err = check_saved_lse(lse, flash_attention_plain(q, k, v, scale, return_lse=True)[1], what)
    grads = flash_attention_bwd(q, k, v, do, scale, out=fout, lse=lse)
    again = flash_attention_bwd(q, k, v, do, scale, out=fout, lse=lse)
    torch.cuda.synchronize()
    refs = flash_attention_bwd_plain(q, k, v, do, scale, out=fout, lse=lse)
    err_bwd = max(float((g.float() - r.float()).abs().max()) for g, r in zip(grads, refs))
    if not all(bool(torch.equal(g, a)) for g, a in zip(grads, again)):
        raise SystemExit(f"{what}: two backward calls on the same inputs differ")
    if out.shape != q.shape or out.dtype != dtype or not bool(torch.isfinite(out).all()) \
            or not all(g.shape == q.shape and bool(torch.isfinite(g).all()) for g in grads):
        raise SystemExit(f"{what}: bad output")
    if not err <= TOL[dtype] or not err_bwd <= TOL[dtype]:
        raise SystemExit(f"{what}: max |kernel - plain| = {err} forward, {err_bwd} backward "
                         f"> {TOL[dtype]}")
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fn(*leaves, scale).backward(do)
    if not all(bool(torch.equal(x.grad, g)) for x, g in zip(leaves, grads)):
        raise SystemExit(f"{what}: the autograd function's gradients are not the kernel's")
    # the library's attention on 4-D views of the same tensors (with 3-D ones it
    # takes its unfused fallback): (B, H, S, D) from (B, S, H, D), (1, BH, S, D)
    # from folded
    heads_first = (lambda x: x.transpose(1, 2)) if bshd else (lambda x: x.unsqueeze(0))
    fq, fk, fv = (heads_first(x) for x in (q, k, v))
    n, s_len, d = q.numel(), shape[1], shape[-1]
    heads_rows = n // (s_len * d)
    elem = q.element_size()
    heavy = n > 1 << 24
    slow = dict(reps=3, warmup=1) if heavy else {}
    common = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
              "layout": "(B, S, H, D)" if bshd else "(BH, S, D)", "tol": TOL[dtype]}
    fwd_bytes, fwd_flops = 4 * n * elem, 4 * s_len * s_len * d * heads_rows
    bwd_bytes, bwd_flops = 7 * n * elem, 10 * s_len * s_len * d * heads_rows
    # one library call on the same q, k, v, as the kernel is called (no graph
    # recorded); used nowhere in the port
    library = lambda: F.scaled_dot_product_attention(fq, fk, fv, scale=scale)
    kernel = lambda: fn(q, k, v, scale)
    kernel_ms, library_ms = time_pair_ms(kernel, library)
    fwd = dict(common, max_abs_err=err, bytes=fwd_bytes, flops=fwd_flops,
               kernel_ms=kernel_ms,
               plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, scale), **slow),
               library_ms=library_ms)
    fwd["bound_ms"], fwd["bound_by"] = roofline(fwd_bytes, fwd_flops, dtype)
    time_ratios(fwd, kernel, library)
    lq, lk, lv = (heads_first(x).detach().requires_grad_() for x in (q, k, v))
    lout = F.scaled_dot_product_attention(lq, lk, lv, scale=scale)
    ldo = heads_first(do)
    kernel = lambda: flash_attention_bwd(q, k, v, do, scale, out=fout, lse=lse)
    # the library's backward alone, on a graph built once
    library = lambda: torch.autograd.grad(lout, (lq, lk, lv), ldo, retain_graph=True)
    kernel_ms, library_ms = time_pair_ms(kernel, library)
    bwd = dict(common, max_abs_err=err_bwd, lse_max_abs_err=lse_err, tol_lse=TOL_LSE,
               bitwise_reproducible=True, bytes=bwd_bytes, flops=bwd_flops,
               kernel_ms=kernel_ms,
               plain_ms=time_ms(lambda: flash_attention_bwd_plain(q, k, v, do, scale, out=fout,
                                                                  lse=lse), **slow),
               library_ms=library_ms)
    bwd["bound_ms"], bwd["bound_by"] = roofline(bwd_bytes, bwd_flops, dtype)
    time_ratios(bwd, kernel, library)
    return fwd, bwd


def attention_fp32_checks(gen):
    """Every fp32 case of the kernels phase: (forward entries, backward
    entries, K1b (forward, backward) pairs)."""
    f32 = torch.float32
    return ([check_attention(shape, f32, True, gen) for shape in FP32_FORWARD_SHAPES],
            [check_attention_bwd(shape, f32, bias, gen) for shape, bias in FP32_BACKWARD_CASES],
            [check_flash(shape, f32, gen) for shape in FP32_FLASH_SHAPES])


@contextlib.contextmanager
def attention_kernels_from(root: str):
    """Inside, the attention wrappers launch the kernels built from
    ``<root>/ccd_tpu_torch/csrc`` (a checkout of another commit, whose C
    entries take the same arguments) into ``<root>/ccd_tpu_torch/_build``;
    this tree's come back on leaving."""
    import ctypes
    pkg = os.path.join(os.path.abspath(root), "ccd_tpu_torch")
    libs = _build.build_libraries(ATTENTION_LIBRARIES, csrc_dir=os.path.join(pkg, "csrc"),
                                  build_dir=os.path.join(pkg, "_build"))
    saved = {name: _build.load_library(name) for name in ATTENTION_LIBRARIES}
    entries = dict(flash_attention_mod._entries)
    flash_attention_mod._entries.clear()
    _build._loaded.update({name: ctypes.CDLL(lib) for name, lib in zip(ATTENTION_LIBRARIES, libs)})
    try:
        yield
    finally:
        _build._loaded.update(saved)
        flash_attention_mod._entries.clear()
        flash_attention_mod._entries.update(entries)


def resource_usage(library_path: str, kernel_part: str) -> dict | None:
    """Registers, stack, shared and local (spill) bytes per thread of the
    kernel whose mangled name holds ``kernel_part`` in a built library, as
    ``cuobjdump -res-usage`` reads them from its code; None where the toolkit
    has no cuobjdump or no such kernel is there."""
    import re
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    text = subprocess.run([tool, "-res-usage", library_path], capture_output=True, text=True,
                          check=True).stdout
    found = {}
    for name, line in re.findall(r"Function ([^\s:]+):?\s*\n\s*(REG:[^\n]*)", text):
        if kernel_part in name:
            found[name] = {k.lower(): int(v)
                           for k, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)", line)}
    return found or None


FP32_KERNEL_NAMES = ("attention_fwd_f32", "attention_bwd_dq_f32", "attention_bwd_dkdv_f32")


def fp32_code_resources(libs) -> dict:
    """``resource_usage`` of the three fp32 attention kernels (each head dim)
    in the built forward and backward libraries."""
    fwd_lib, bwd_lib = libs
    return {name: resource_usage(fwd_lib if "fwd" in name else bwd_lib, name)
            for name in FP32_KERNEL_NAMES}


def attention_fp32_phase(card: str, kernels: str) -> None:
    """The fp32 attention cases of the kernels phase alone, with the kernels
    named by ``kernels`` (this tree's, or another checkout's): one line with
    every case's entry and the kernels' resources."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    fwd, bwd, flash = attention_fp32_checks(gen)
    libs = [_build.load_library(name)._name for name in ATTENTION_LIBRARIES]
    try:
        launch_resources = {"forward": fp32_forward_resources(),
                            "backward": [r for r in backward_resources()
                                         if r["dtype"] == "float32"]}
    except (AttributeError, RuntimeError) as exc:  # an older library without the entry
        launch_resources = {"not available": str(exc)[:200]}
    emit({"phase": "attention_fp32", "gpu": card, "kernels": kernels, "forward": fwd,
          "backward": bwd, "flash_forward": [c[0] for c in flash],
          "flash_backward": [c[1] for c in flash], "resources": launch_resources,
          "code_resources": fp32_code_resources(libs)})


def bilateral_taps(rad2: torch.Tensor, max_radius: int) -> int:
    """Taps a pixel the filter evaluates, summed over the samples: those of
    the disc of ``max_radius`` with dy²+dx² <= rad2 (the centre always)."""
    d2 = torch.tensor([dy * dy + dx * dx for dy in range(-max_radius, max_radius + 1)
                       for dx in range(-max_radius, max_radius + 1)
                       if dy * dy + dx * dx <= max_radius * max_radius], dtype=torch.float32)
    return int(((d2[None] <= rad2.float().cpu()[:, None]) | (d2[None] == 0)).sum())


def bilateral_bound(shape, rad2: torch.Tensor, max_radius: int):
    """(least time in ms, what bounds it, taps, the former count's bound) for
    the filter's own work. Bytes: one fp32 image read and one written (and 3
    scalars a sample) over the memory rate. Operations: the taps this run's
    radii need, each with BILATERAL_FP32_PER_TAP instructions on the fp32
    pipe at 128 lanes a clock per SM, and with one exponential on the
    special-function unit at 16 a clock per SM; 132 SMs at the clock of the
    fp32 peak (67e12 / (2 * 128 * 132) = 1.98 GHz). So a tap costs 11/128 of
    an SM-clock on the fp32 pipe and 1/16 on the special-function unit: the
    fp32 pipe bounds it, at taps * 11 / 33.5e12 seconds. The former count
    (25 operations a tap over the 67 TFLOP/s FMA peak) is returned beside."""
    b, h, w, c = shape
    nbytes = 2 * b * h * w * c * 4 + 3 * b * 4
    taps = bilateral_taps(rad2, max_radius) * h * w
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_fp32 = taps * BILATERAL_FP32_PER_TAP / (FP32_LANES_PER_SM * SM_COUNT * SM_CLOCK_HZ) * 1e3
    t_sfu = taps / (SFU_LANES_PER_SM * SM_COUNT * SM_CLOCK_HZ) * 1e3
    t_ops = max(t_fp32, t_sfu)
    former = roofline(nbytes, taps * BILATERAL_FORMER_OPS_PER_TAP, torch.float32)[0]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), taps, former


def kernel_device_ms(fn, name_part: str = "", reps: int = 20, attempts: int = 3) -> float:
    """Mean device time per call of ``fn`` of the kernels whose name holds
    ``name_part`` (all of them by default), from the profiler's device trace:
    the kernels' own time, without the host's time to issue the call. A
    trace that holds none of them is taken again (the profiler now and then
    drops a short kernel's record), up to ``attempts`` traces."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for ev in prof.key_averages():
            if name_part in ev.key:
                us = getattr(ev, "self_device_time_total", None)
                total += getattr(ev, "self_cuda_time_total", 0.0) if us is None else us
        if total > 0:
            return total / reps / 1e3
    raise SystemExit(f"no device time for a kernel named like {name_part!r} in {attempts} traces")


def check_bilateral(shape, gen, max_radius=5, rad2=None):
    """K3 against its plain version on the card, sigmas in [10, 250] as
    op_bilateral_blur draws them. ``rad2`` per sample: the squares of radii
    drawn from 1..5 by default, else the values given, cycled over the
    samples (a value that is no perfect square, as 8, admits taps such as
    (2, 2) that no integer radius below the next square names)."""
    b = shape[0]
    x = torch.rand(shape, device="cuda", generator=gen)
    sc = 10.0 + 240.0 * torch.rand(b, device="cuda", generator=gen)
    ss = 10.0 + 240.0 * torch.rand(b, device="cuda", generator=gen)
    if rad2 is None:
        radius = "per sample 1..5"
        rad2 = torch.randint(1, 6, (b,), device="cuda", generator=gen).float() ** 2
    else:
        radius = f"rad2 {list(rad2)} over the samples"
        rad2 = torch.tensor([rad2[i % len(rad2)] for i in range(b)], device="cuda")
    r = max_radius
    out = bilateral_filter_fused(x, sc, ss, rad2, r)
    torch.cuda.synchronize()
    ref = bilateral_filter_plain(x, sc, ss, rad2, r)
    err = float((out - ref).abs().max())
    what = f"bilateral {shape} max radius {r}, {radius}"
    if out.shape != x.shape or out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
        raise SystemExit(f"{what}: bad output")
    if not err <= TOL_BILATERAL:
        raise SystemExit(f"{what}: max |kernel - plain| = {err} > {TOL_BILATERAL}")
    bound_ms, bound_by, taps, former_bound_ms = bilateral_bound(shape, rad2, r)
    call = lambda: bilateral_filter_fused(x, sc, ss, rad2, r)
    device_ms = kernel_device_ms(call, "bilateral_kernel")
    return {"shape": list(shape), "dtype": "float32", "max_radius": r, "radius": radius,
            "max_abs_err": err, "tol": TOL_BILATERAL,
            # the kernel's own time on the card; a call through the wrapper
            # (its few small argument kernels included) takes longer on the
            # host than on the card, so events around calls time the host
            "kernel_ms": device_ms, "device_ms": device_ms,
            "wrapper_call_ms": time_ms(call),
            "plain_ms": time_ms(lambda: bilateral_filter_plain(x, sc, ss, rad2, r), reps=5,
                                warmup=1),
            "library_ms": None,  # no library call computes this filter
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_over_device_ms": bound_ms / device_ms,
            "taps": taps, "exp_count": taps, "fp32_per_tap": BILATERAL_FP32_PER_TAP,
            "former_bound_ms": former_bound_ms,
            "former_ops_per_tap": BILATERAL_FORMER_OPS_PER_TAP}


def layer_norm_bytes(rows: int, c: int, dtype, out_dtype, backward: bool) -> int:
    """Bytes one LayerNorm must move: forward x read and y written, the
    weight and bias read; backward x and dy read and dx written, the weight
    read and its and the bias's gradients written (the saved fp32
    statistics, 8 bytes a row, are the kernels' own)."""
    e, eo = torch.empty((), dtype=dtype).element_size(), \
        torch.empty((), dtype=out_dtype).element_size()
    n = rows * c
    return n * (2 * e + eo) + 3 * c * 4 if backward else n * (e + eo) + 2 * c * 4


def layer_norm_bound(rows: int, c: int, dtype, out_dtype, backward: bool):
    """(least time in ms, what bounds it) for one LayerNorm's own work: its
    bytes (:func:`layer_norm_bytes`) against LN_FLOPS_FWD (LN_FLOPS_BWD) fp32
    operations an element."""
    return roofline(layer_norm_bytes(rows, c, dtype, out_dtype, backward),
                    (LN_FLOPS_BWD if backward else LN_FLOPS_FWD) * rows * c, torch.float32)


def queued_device_ms(fn, reps: int = 20, spin_cycles: int = 50_000_000,
                     attempts: int = 4) -> float:
    """Device time per call of ``fn`` from CUDA events around ``reps`` calls
    queued behind a spin kernel: the host issues every call while the card
    spins, so the card runs them back to back and the events time the card's
    work (the gaps between its launches included), not the host's issue.
    Every launch is inside the events, where the profiler's device trace
    now and then drops a kernel's record. Taken again with a spin four times
    as long where the host's issue outlasted the spin."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        spun, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spun.record()
        torch.cuda._sleep(spin_cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        issue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if issue_ms < spun.elapsed_time(start):
            return start.elapsed_time(end) / reps
        spin_cycles *= 4
    raise SystemExit(f"the host's issue of {reps} calls outlasted a spin of "
                     f"{spin_cycles // 4} cycles in {attempts} attempts")


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each |v| (of LN_ULP_FLOOR at the least)."""
    return torch.exp2(torch.floor(torch.log2(v.float().abs().clamp_min(LN_ULP_FLOOR))) - 7)


def check_layer_norm(rows: int, c: int, dtype, out_dtype, eps: float, gen, what: str = "",
                     timed: bool = True):
    """The LayerNorm kernels against the plain chain on the card, forward and
    backward, at (rows, C): rows of mixed scale and offset, the weight near 1
    and the bias near 0. Returns (forward entry, backward entry); timed, each
    with the kernel's device time, its bound, the plain chain's device time
    and one ATen call's (``F.layer_norm`` with the parameters in x's type,
    and its autograd) as the yardstick."""
    name = f"layer_norm ({rows}, {c}) {dtype} -> {out_dtype}"
    x = (torch.randn((rows, c), device="cuda", generator=gen)
         * (0.5 + 2.5 * torch.rand((rows, 1), device="cuda", generator=gen))
         + torch.randn((rows, 1), device="cuda", generator=gen)).to(dtype)
    w = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)
    b = 0.1 * torch.randn(c, device="cuda", generator=gen)
    dy = torch.randn((rows, c), device="cuda", generator=gen).to(out_dtype)
    check_layer_norm_inputs(x, w, b, out_dtype)
    forward = lambda: layer_norm_mod._forward(x, w, b, eps, out_dtype, save=True)
    backward = lambda: layer_norm_mod._backward(x, dy, w, stats)
    y, stats = forward()
    mean, rstd = stats
    dx, grads = backward()
    again_dx, again_grads = backward()
    torch.cuda.synchronize()
    deterministic = torch.equal(dx, again_dx) and torch.equal(grads, again_grads)
    dw, db = grads

    xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, w, b))
    y_p = layer_norm_plain(xr, wr, br, eps, out_dtype)
    dx_p, dw_p, db_p = torch.autograd.grad(y_p, (xr, wr, br), dy, retain_graph=True)
    xf = x.float()
    mean_p = xf.mean(-1)
    rstd_p = torch.rsqrt(((xf - mean_p[:, None]) ** 2).mean(-1) + eps)
    xh = (xf - mean_p[:, None]) * rstd_p[:, None]

    want = y_p.detach()
    if out_dtype == torch.bfloat16:
        y_err = float(((y.float() - want.float()).abs() / bf16_ulp(want)).max())
        y_ok = y_err <= 1.0
    else:
        y_err = float((y - want).abs().max() / want.abs().max())
        y_ok = y_err <= TOL_LN_REL
    mean_err = float(((mean - mean_p).abs() / xf.abs().amax(-1)).max())
    rstd_err = float(((rstd - rstd_p).abs() / rstd_p).max())
    dx_scale = float(dx_p.float().abs().max())
    dx_diff = (dx.float() - dx_p.float()).abs()
    if dtype == torch.bfloat16:
        dx_ok = bool((dx_diff <= bf16_ulp(dx_p) + TOL_LN_REL * dx_scale).all())
    else:
        dx_ok = float(dx_diff.max()) <= TOL_LN_REL * dx_scale
    dx_err = float(dx_diff.max()) / dx_scale
    dy_f = dy.float()
    dw_err = float(((dw - dw_p).abs() / (dy_f * xh).abs().sum(0)).max())
    db_err = float(((db - db_p).abs() / dy_f.abs().sum(0)).max())
    errors = {"y": y_err, "mean": mean_err, "rstd": rstd_err, "dx": dx_err, "dw": dw_err,
              "db": db_err}
    if not (y_ok and dx_ok and mean_err <= TOL_LN_REL and rstd_err <= TOL_LN_REL
            and dw_err <= TOL_LN_SUM_REL and db_err <= TOL_LN_SUM_REL and deterministic) \
            or y.dtype != out_dtype or dx.dtype != dtype:
        raise SystemExit(f"{name}: kernel against plain {errors} (y in bf16 ulps where bf16), "
                         f"types {y.dtype} {dx.dtype}, backward twice equal: {deterministic}")
    common = {"shape": [rows, c], "dtype": str(dtype).replace("torch.", ""),
              "out_dtype": str(out_dtype).replace("torch.", ""), "eps": eps, "what": what}
    fwd = dict(common, max_abs_err=y_err,
               tol="1 bf16 ulp" if out_dtype == torch.bfloat16 else TOL_LN_REL,
               mean_rel_err=mean_err, rstd_rel_err=rstd_err)
    bwd = dict(common, max_abs_err=dx_err, tol=TOL_LN_REL, dw_rel_err=dw_err, db_rel_err=db_err,
               tol_sums=TOL_LN_SUM_REL, bit_equal_twice=deterministic)
    if not timed:
        return fwd, bwd
    lib_w, lib_b = w.to(dtype), b.to(dtype)
    xl, wl, bl = (t.detach().clone().requires_grad_() for t in (x, lib_w, lib_b))
    y_l = F.layer_norm(xl, (c,), wl, bl, eps)
    l2_bytes = getattr(torch.cuda.get_device_properties(x.device), "L2_cache_size", 50 << 20)
    for entry, backward_pass, kernel, plain, library in (
            (fwd, False, lambda: layer_norm_mod._forward(x, w, b, eps, out_dtype, save=False),
             lambda: layer_norm_plain(x, w, b, eps, out_dtype),
             lambda: F.layer_norm(x, (c,), lib_w, lib_b, eps)),
            (bwd, True, backward,
             lambda: torch.autograd.grad(y_p, (xr, wr, br), dy, retain_graph=True),
             lambda: torch.autograd.grad(y_l, (xl, wl, bl), dy.to(dtype), retain_graph=True))):
        device_ms = queued_device_ms(kernel)
        bound_ms, bound_by = layer_norm_bound(rows, c, dtype, out_dtype, backward_pass)
        # operands the L2 cannot hold come from HBM at every call: a time
        # under their bound is a fault of the timing, not a fast kernel
        from_hbm = layer_norm_bytes(rows, c, dtype, out_dtype, backward_pass) > 2 * l2_bytes
        if from_hbm and device_ms < bound_ms:
            raise SystemExit(f"{name}: {'backward' if backward_pass else 'forward'} timed at "
                             f"{device_ms} ms, under its bound {bound_ms} ms")
        entry.update(kernel_ms=device_ms, device_ms=device_ms, bound_ms=bound_ms,
                     bound_by=bound_by, bound_over_device_ms=bound_ms / device_ms,
                     operands_exceed_l2=from_hbm,
                     plain_ms=queued_device_ms(plain), library_ms=queued_device_ms(library),
                     wrapper_call_ms=time_ms(kernel),
                     timing="CUDA events around 20 calls queued behind a spin kernel")
    return fwd, bwd


def layer_norm_checks(gen) -> dict:
    """Every LN_SHAPES case timed, every LN_COVERAGE case checked, the
    kernels' resources and what the wrapper refuses."""
    main = [check_layer_norm(rows, c, dt, odt, eps, gen, what)
            for rows, c, dt, odt, eps, what in LN_SHAPES]
    coverage = [check_layer_norm(rows, c, dt, odt, 1e-5, gen, "coverage", timed=False)
                for rows, c, dt, odt in LN_COVERAGE]
    zeros = lambda *shape, dtype=torch.bfloat16: torch.zeros(shape, device="cuda", dtype=dtype)
    w = zeros(64, dtype=torch.float32)
    refused = count_refusals("layer norm", [
        lambda: layer_norm(zeros(4, 64, dtype=torch.float16), w, w, 1e-6, torch.bfloat16),
        lambda: layer_norm(zeros(4, 64), w, w, 1e-6, torch.float16),
        lambda: layer_norm(zeros(4, 100), zeros(100, dtype=torch.float32),
                           zeros(100, dtype=torch.float32), 1e-6, torch.bfloat16),
        lambda: layer_norm(zeros(4, 1032), zeros(1032, dtype=torch.float32),
                           zeros(1032, dtype=torch.float32), 1e-6, torch.bfloat16),
        lambda: layer_norm(zeros(64, 64).t(), w, w, 1e-6, torch.bfloat16),
        lambda: layer_norm(zeros(4, 64), w.bfloat16(), w, 1e-6, torch.bfloat16)])
    resources = [dict(c=c, dtype=str(dt).replace("torch.", ""), backward=bwd,
                      **layer_norm_attributes(c, dt, dt, backward=bwd))
                 for c, dt in ((384, torch.bfloat16), (512, torch.bfloat16),
                               (192, torch.float32), (64, torch.float32), (1024, torch.float32))
                 for bwd in (False, True)]
    return {"forward": [m[0] for m in main] + [c[0] for c in coverage],
            "backward": [m[1] for m in main] + [c[1] for c in coverage],
            "refused": refused, "resources": resources}


def layer_norm_phase(card: str) -> dict:
    """The LayerNorm kernels' checks alone, as one line."""
    checks = layer_norm_checks(torch.Generator(device="cuda").manual_seed(SEED + 31))
    emit(dict({"phase": "layer_norm_checks", "gpu": card}, **checks))
    return checks


def count_refusals(what, calls, expected=(ValueError, TypeError, RuntimeError)):
    """What a kernel does not take is refused, not computed some other way."""
    refused = 0
    for call in calls:
        try:
            call()
        except expected:
            refused += 1
    if refused != len(calls):
        raise SystemExit(f"{what}: {refused} of {len(calls)} unsupported inputs were refused")
    return refused


def normalise(images: torch.Tensor) -> torch.Tensor:
    x = images.float() / 255.0
    mean = torch.tensor(runner.IMAGENET_MEAN, device=x.device)
    std = torch.tensor(runner.IMAGENET_STD, device=x.device)
    return (x - mean) / std


@torch.no_grad()
def decode_with_plain_attention(model, images: torch.Tensor) -> torch.Tensor:
    """The recognizer's forward written out here with the ViT's attention
    going through the plain version — no switch in the package does this."""
    vit = model.backbone
    tokens = vit.prepare_tokens(normalise(images))
    for blk in vit.blocks:
        qkv, bias = blk.attn.qkv_unbiased(blk.norm1(tokens))
        attn = mha_packed_bias_plain(qkv, bias, blk.attn.scale, blk.attn.num_heads)
        tokens = tokens + blk.attn.proj(attn)
        tokens = tokens + blk.mlp(blk.norm2(tokens))
    return model.decoder.decode_greedy(model.encoder(vit.norm(tokens)))


def profiled_kernels(fn):
    """(wall ms, [(device ms, calls, kernel name)]) of one call under
    torch.profiler, device kernels only: named ranges (the step's phases)
    are not kernels and are left out."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) is not None and "CUDA" not in str(ev.device_type):
            continue
        if getattr(ev, "is_user_annotation", False) or ev.key in STEP_PHASES + FT_PHASES:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    return wall_ms, sorted(rows, reverse=True)


def device_busy(fn):
    """(wall ms, summed device-kernel ms, top kernels, device-kernel launches)
    of one call under torch.profiler; the kernel sum is None when the trace
    holds no device time."""
    wall_ms, rows = profiled_kernels(fn)
    if not rows:
        return wall_ms, None, [], 0
    top = [{"kernel": k[:60], "ms": ms, "calls": n} for ms, n, k in rows[:8]]
    return wall_ms, sum(r[0] for r in rows), top, sum(r[1] for r in rows)


def decode_graph_phase(card: str) -> dict:
    """The greedy decode replayed from its CUDA graphs against the eager
    decode, bit for bit: the evaluation configuration's decoder (bf16, random
    weights from ``SEED``) on the encoder's output of random crops, three
    different batches at 1024 and at a ragged 1000 (the first call eager, the
    second captured, the third replayed: a stale static input would show),
    then every parameter updated in place and the three batches of 1024
    again, each a replay of the same graph. Host ms (the call's return) and
    wall ms (synchronised) a decode of 1024 on both sides, and the graphs
    held."""
    config = Config(CONFIG)
    model, _ = build_recognizer(config, device="cuda",
                                generator=torch.Generator().manual_seed(SEED))
    model.eval()
    dec = model.decoder
    cache = dec.decode_graphs
    captures = []
    capture = cache.capture
    cache.capture = lambda fn, x, gens: (captures.append(tuple(x.shape)),
                                         capture(fn, x, gens))[1]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    sizes = (1024, 1000)

    def encoded(n):
        images = torch.randint(0, 256, (n, 32, 128, 3), dtype=torch.uint8, device="cuda",
                               generator=gen)
        return model.encoder(model.extract_feat(normalise(images)))

    def held(enc, what):
        out, ref = dec.decode_greedy(enc), dec._decode_steps(enc)
        equal = torch.equal(out, ref)
        calls.append({"batch": enc.shape[0], "call": what, "graphs": len(cache),
                      "bit_equal": equal, "max_abs_diff": float((out - ref).abs().max())})
        if not equal:
            raise SystemExit(f"decode_graph: the {what} at batch {enc.shape[0]} differs from "
                             f"the eager decode by {calls[-1]['max_abs_diff']}")
        return out

    calls = []
    with torch.no_grad():
        encs = {n: [encoded(n) for _ in range(3)] for n in sizes}
        for n in sizes:
            for enc, what in zip(encs[n], ("eager call", "capture", "replay")):
                held(enc, what)
        if captures != [tuple(encs[n][0].shape) for n in sizes]:
            raise SystemExit(f"decode_graph: captures {captures}, expected one a size")
        before = dec.decode_greedy(encs[sizes[0]][0])
        g = torch.Generator().manual_seed(SEED + 18)
        for p in dec.parameters():
            p.add_((1e-2 * torch.randn(p.shape, generator=g)).to(p.device))
        after = [held(enc, "replay after an update in place") for enc in encs[sizes[0]]]
        if len(captures) != len(sizes) or torch.equal(after[0], before):
            raise SystemExit("decode_graph: the update in place did not reach the replay "
                             f"(captures {captures})")
        torch.cuda.set_sync_debug_mode("error")  # a replay waits for nothing on the host
        try:
            dec.decode_greedy(encs[sizes[0]][1])
        finally:
            torch.cuda.set_sync_debug_mode("default")

        def timed(fn, reps=5):
            host, wall = [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                host.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(host), statistics.median(wall)

        def behind(fn, reps=5):  # host ms of a call issued while the card runs another
            host = []
            for _ in range(reps):
                torch.cuda.synchronize()
                fn()
                t0 = time.perf_counter()
                fn()
                host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            return statistics.median(host)

        def profiled_host(fn, reps=5):  # host ms of a call under the CPU+CUDA profiler
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                return timed(fn, reps)[0]

        enc = encs[sizes[0]][2]
        eager_host, eager_wall = timed(lambda: dec._decode_steps(enc))
        graph_host, graph_wall = timed(lambda: dec.decode_greedy(enc))
        busy = {"eager": behind(lambda: dec._decode_steps(enc)),
                "graph": behind(lambda: dec.decode_greedy(enc))}
        profiled = {"eager": profiled_host(lambda: dec._decode_steps(enc)),
                    "graph": profiled_host(lambda: dec.decode_greedy(enc))}
    result = {"phase": "decode_graph", "gpu": card, "config": "ccd_finetune_ard.yaml",
              "dtype": "bfloat16", "calls": calls, "captures": len(captures),
              "graphs_held": len(cache), "update_in_place_reached_the_replay": True,
              "host_ms_a_decode_of_1024": {"eager": eager_host, "graph": graph_host},
              "wall_ms_a_decode_of_1024": {"eager": eager_wall, "graph": graph_wall},
              "host_ms_behind_a_busy_card": busy, "host_ms_under_the_profiler": profiled,
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(result)
    del model, dec, cache, encs
    torch.cuda.empty_cache()
    return result


class DrawRecorder(TorchKey):
    """A key over the same generator that keeps every draw it hands out, in
    order (``bernoulli``, ``permutations`` and ``laplace`` draw through
    ``uniform``; ``split`` and ``fold_in`` hand out the recorder itself)."""

    def __init__(self, generator: torch.Generator):
        super().__init__(generator)
        self.draws = []

    def uniform(self, shape, lo=0.0, hi=1.0):
        self.draws.append(super().uniform(shape, lo, hi))
        return self.draws[-1]

    def randint(self, shape, lo, hi):
        self.draws.append(super().randint(shape, lo, hi))
        return self.draws[-1]

    def normal(self, shape):
        self.draws.append(super().normal(shape))
        return self.draws[-1]


def with_draws(chain):
    """``chain(key, images, *args)`` whose output also carries every draw the
    chain made: (outputs..., draws...)."""
    def run(key, images, *args):
        recorder = DrawRecorder(key.generator)
        out = chain(recorder, images, *args)
        return (out if isinstance(out, tuple) else (out,)) + tuple(recorder.draws)
    return run


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
AUGMENT_GRAPH_CALLS = 10
AUGMENT_GRAPH_BATCHES = {"pretrain_views": 256, "supervised_augment": 288}


def host_launches(fn) -> dict:
    """The host's calls that put work on the card during ``fn()``, by runtime
    call, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = collections.Counter(ev.name for ev in prof.events() if ev.name in LAUNCH_CALLS)
    return dict(counts, total=sum(counts.values()))


def augment_graph_phase(card: str) -> dict:
    """The training steps' augmentations replayed from their CUDA graphs
    against the eager chains: ``pretrain_views`` at severity 5 (batch 256)
    and ``supervised_augment`` with the normalisation (the finetune step's
    phase, batch 288), each over AUGMENT_GRAPH_CALLS calls on different
    rendered words through ``graphed_augment`` (the first eager, the second
    captured, later ones replayed), beside two eager runs of the chain from
    the same seed. After every call the generator's state is byte-equal to
    the eager run's and every draw and theta equal. The views: the k-means,
    the histogram equalisation and CLAHE sum by a float ``scatter_add_``,
    whose order the card does not fix, so two eager runs differ where a row
    took one of them; their differences are reported. The same calls again
    under ``torch.use_deterministic_algorithms(True)`` (a fixed-order
    ``scatter_add_``, in the eager chain and in the captured one) hold the
    views bit for bit, the two eager runs first. Host launches a call,
    eager and replayed, under the profiler: a replay is one graph launch
    among a handful (input copy, the generator's seed and offset, output
    clones). Host and wall ms a call on both sides."""
    from ccd_tpu_torch.data.augment import graphed_augment
    from ccd_tpu_torch.training.finetune_step import _augment_normalize
    from ccd_tpu_torch.utils.cuda_graphs import GraphCache
    seed = 3_141_592_653
    chains = {"pretrain_views": (pretrain_views, (5,), 2),
              "supervised_augment": (_augment_normalize, (supervised_augment,), 1)}

    def differ(p, q) -> dict:
        rows = (p != q).flatten(1).any(1)
        return {"max_abs": float((p - q).abs().max()), "rows": int(rows.sum()),
                "share": float((p != q).float().mean())}

    def calls_of(chain, args, n_out, batches, deterministic: bool):
        gens = {side: torch.Generator(device="cuda").manual_seed(seed)
                for side in ("eager", "eager_again", "graph")}
        graphs = GraphCache("augment_graph")
        calls = []
        torch.use_deterministic_algorithms(deterministic)
        try:
            for i, x in enumerate(batches):
                a = chain(TorchKey(gens["eager"]), x, *args)
                again = chain(TorchKey(gens["eager_again"]), x, *args)
                got = graphed_augment(graphs, gens["graph"], x, chain, *args)
                same = lambda p, q: all(torch.equal(u, v) for u, v in zip(p, q))  # noqa: E731
                row = {"call": i, "graphs": len(graphs), "draws": len(a) - n_out,
                       "state_equal": bool(torch.equal(gens["graph"].get_state(),
                                                       gens["eager"].get_state())),
                       "eager_states_equal": bool(torch.equal(gens["eager_again"].get_state(),
                                                              gens["eager"].get_state())),
                       "draws_equal": len(got) == len(a) and same(got[n_out:], a[n_out:]),
                       "eager_draws_equal": len(again) == len(a)
                       and same(again[n_out:], a[n_out:]),
                       "theta_equal": n_out == 1 or bool(torch.equal(got[1], a[1])),
                       "views": differ(got[0], a[0]), "eager_views": differ(again[0], a[0])}
                calls.append(row)
                del a, again, got
        finally:
            torch.use_deterministic_algorithms(False)
        return calls, len(graphs)

    report, faults = {}, []
    for name, (plain, args, n_out) in chains.items():
        chain = with_draws(plain)
        b = AUGMENT_GRAPH_BATCHES[name]
        images, _, _ = make_synthetic_batch(AUGMENT_GRAPH_CALLS * b, seed=11)
        batches = torch.from_numpy(images).cuda().float().div(255.0).reshape(
            AUGMENT_GRAPH_CALLS, b, 32, 128, 3)
        for mode in ("default", "deterministic"):
            calls, held = calls_of(chain, args, n_out, batches, mode == "deterministic")
            bad = [r["call"] for r in calls
                   if not (r["state_equal"] and r["draws_equal"] and r["theta_equal"]
                           and r["eager_states_equal"] and r["eager_draws_equal"])]
            if mode == "deterministic":
                bad += [r["call"] for r in calls
                        if r["views"]["rows"] or r["eager_views"]["rows"]]
            if bad or held != 1:
                faults.append(f"{name} ({mode} algorithms): calls {sorted(set(bad))} apart from "
                              f"the eager run, {held} graphs")
            emit({"phase": "augment_graph", "chain": name, "algorithms": mode, "batch": b,
                  "calls": calls, "gpu": card})

        # the launches and times of one call (the chain alone, without its draws as outputs)
        timing = GraphCache("augment_graph")
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = batches[0]
        eager_call = lambda: plain(TorchKey(g), x, *args)                       # noqa: E731
        graph_call = lambda: graphed_augment(timing, g, x, plain, *args)        # noqa: E731
        graph_call()                         # eager
        graph_call()                         # captured
        launches = {"eager": host_launches(eager_call), "graph": host_launches(graph_call)}
        if launches["graph"].get("cudaGraphLaunch") != 1 or launches["graph"]["total"] > 8:
            faults.append(f"{name}: a replay made {launches['graph']}")

        def timed(fn, reps=5):
            host, wall = [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                host.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
            return {"host_ms": statistics.median(host), "wall_ms": statistics.median(wall)}

        torch.cuda.set_sync_debug_mode("error")  # a replay waits for nothing on the host
        try:
            graph_call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        report[name] = {"batch": b, "host_launches_a_call": launches,
                        "eager": timed(eager_call), "graph": timed(graph_call)}
        del batches, timing
        torch.cuda.empty_cache()
    result = {"phase": "augment_graph", "gpu": card, "seed": seed, **report,
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(result)
    if faults:
        raise SystemExit(f"augment_graph: {'; '.join(faults)}")
    return result


def evaluation_path(card: str) -> dict:
    """The recognizer's evaluation at full width; returns the attention's
    and the LayerNorm's forward launches on it."""
    config = Config(CONFIG)
    model, _ = build_recognizer(config, device="cuda",
                                generator=torch.Generator().manual_seed(SEED))
    if model.dtype != torch.bfloat16 or len(model.backbone.blocks) != 12:
        raise SystemExit("main path: not the full-width bf16 ViT-Small configuration")
    tmp = tempfile.mkdtemp(prefix="ccd_chip_smoke_")
    try:
        roots = [os.path.join(tmp, "evaluation", "SYNTH_FULL"),
                 os.path.join(tmp, "evaluation", "SYNTH_RAGGED")]
        write_synthetic_lmdb(roots[0], N_FULL, seed=123)
        write_synthetic_lmdb(roots[1], N_RAGGED, seed=124)
        eval_args = dict(batch_size=BATCH, max_seq_len=config.decoder_max_seq_len,
                         charset_type=config.dataset_charset_type or "DICT90",
                         case_sensitive=bool(config.dataset_eval_case_sensitive))
        evaluate = lambda: runner.evaluate_benchmarks(model, roots, **eval_args)
        evaluate()  # warm-up: library handles, allocator, cast weights
        torch.cuda.synchronize()

        mha_packed_bias.launches = layer_norm.launches = layer_norm.bwd_launches = 0
        with decoder_runs() as passes:
            t0 = time.time()
            results, weighted = evaluate()
            torch.cuda.synchronize()
            wall = time.time() - t0
        launches = mha_packed_bias.launches

        n_batches = sum(-(-n // BATCH) for n in (N_FULL, N_RAGGED))
        if launches != 12 * n_batches:
            raise SystemExit(f"main path: {launches} kernel launches, expected "
                             f"{12 * n_batches} (12 per batch, {n_batches} batches)")
        # the ViT's norms every batch; the decoder's on the host only where its
        # pass runs there (a replay launches its graph's norms on the card alone)
        vit_norms, dec_norms = recognizer_norms(model)
        norms = {"LN-fwd": layer_norm.launches, "LN-bwd": layer_norm.bwd_launches,
                 "decoder_passes_on_the_host": passes[0]}
        if norms["LN-fwd"] != vit_norms * n_batches \
                + dec_norms * model.decoder.max_seq_len * passes[0] or norms["LN-bwd"]:
            raise SystemExit(f"main path: LayerNorm launches {norms}, expected {vit_norms} a "
                             f"batch and {dec_norms} a decode step run on the host")
        words = [int(r["words"]) for r in results]
        if words != [N_FULL, N_RAGGED] or not all(
                np.isfinite(r[k]) for r in results for k in ("cwr", "ccr", "ned")):
            raise SystemExit(f"main path: bad metrics {results}")
        infer_s = sum(r["time"] for r in results)

        # the same batches once more: kernel run against plain-attention run
        convertor_len = config.decoder_max_seq_len
        worst, agree, total = 0.0, 0, 0
        for root, n in zip(roots, (N_FULL, N_RAGGED)):
            ds = build_dataset(SupervisedDataset, [root], is_training=False,
                               max_seq_len=convertor_len)
            seen = 0
            for images, _targets, _texts in DataLoader(ds, batch_size=BATCH, shuffle=False,
                                                       drop_last=False, num_workers=4):
                batch = torch.from_numpy(images).cuda()
                probs = runner.decode(model, batch)
                plain = decode_with_plain_attention(model, batch)
                for p in (probs, plain):
                    if p.shape != (len(images), convertor_len, 92) or p.dtype != torch.float32 \
                            or not bool(torch.isfinite(p).all()) \
                            or float((p.sum(-1) - 1).abs().max()) > 1e-3:
                        raise SystemExit("main path: probabilities are not (N, 25, 92) "
                                         "finite fp32 rows summing to 1")
                same = probs.argmax(-1) == plain.argmax(-1)           # (N, T)
                # steps whose inputs were the same in both runs: up to and
                # including the first step where the tokens part
                comparable = torch.cumsum((~same).long(), 1) - (~same).long() == 0
                diff = (probs - plain).abs().amax(-1)
                worst = max(worst, float(diff[comparable].max()))
                agree += int(same.sum())
                total += same.numel()
                seen += len(images)
            if seen != n:
                raise SystemExit(f"{root}: read {seen} images, expected {n}")
        share = agree / total
        if not worst <= TOL_PROBS:
            raise SystemExit(f"main path: kernel and plain runs differ by {worst} > {TOL_PROBS}")
        if not share >= MIN_TOKEN_AGREEMENT:
            raise SystemExit(f"main path: greedy tokens agree on {share:.3f} of the "
                             f"positions < {MIN_TOKEN_AGREEMENT}")

        # where a batch's time goes on the device (one full batch, events)
        images = torch.from_numpy(next(iter(DataLoader(
            build_dataset(SupervisedDataset, [roots[0]], is_training=False,
                          max_seq_len=convertor_len),
            batch_size=BATCH, shuffle=False, drop_last=False, num_workers=4)))[0]).cuda()
        with torch.no_grad():
            x = normalise(images)
            tokens = model.extract_feat(x)
            enc = model.encoder(tokens)
            split = {"vit_ms": time_ms(lambda: model.extract_feat(x), reps=5, warmup=1),
                     "encoder_ms": time_ms(lambda: model.encoder(tokens), reps=5, warmup=1),
                     "decode_ms": time_ms(lambda: model.decoder.decode_greedy(enc), reps=5,
                                          warmup=1),
                     "batch_ms": time_ms(lambda: runner.decode(model, images), reps=5, warmup=1)}
        # how busy the card is during one batch (the profiler slows the host side)
        prof_wall, busy, top, _ = device_busy(lambda: runner.decode(model, images))
        split.update({"profiled_batch_wall_ms": prof_wall, "profiled_device_busy_ms": busy,
                      "profiled_device_idle_share": None if busy is None
                      else 1.0 - busy / prof_wall, "profiled_top_kernels": top})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    emit({"phase": "main_path", "path": "evaluation", "gpu": card, "config": "ccd_finetune_ard.yaml",
          "arch": "vit_small + 6-layer NRTR", "dtype": "bfloat16", "batch": BATCH,
          "images": N_FULL + N_RAGGED, "batches": n_batches, "kernel_launches": launches,
          "layer_norm_launches": norms,
          "images_per_s_inference": (N_FULL + N_RAGGED) / infer_s,
          "images_per_s_with_loading": (N_FULL + N_RAGGED) / wall,
          **split, "max_abs_prob_diff_vs_plain": worst, "tol_probs": TOL_PROBS,
          "token_agreement_vs_plain": share, "min_token_agreement": MIN_TOKEN_AGREEMENT,
          "total_accuracy": weighted})

    return {"K1-fwd": launches, "LN-fwd": norms["LN-fwd"]}


class PlainAttention(torch.autograd.Function):
    """The attention kernels' plain versions under one differentiable call."""

    @staticmethod
    def forward(ctx, qkv, bias, scale, heads):
        ctx.save_for_backward(qkv, bias)
        ctx.scale, ctx.heads = scale, heads
        return mha_packed_bias_plain(qkv, bias, scale, heads)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias = ctx.saved_tensors
        dqkv = mha_packed_bias_bwd_plain(qkv, bias, dout, ctx.scale, ctx.heads)
        dbias = None if bias is None else dqkv.float().sum((0, 1)).to(bias.dtype)
        return dqkv, dbias, None, None


@contextlib.contextmanager
def plain_versions_in_place_of_kernels():
    """Inside, the ViT's attention, the fused CE, the augmentation's
    bilateral filter and every LayerNorm go through their plain versions:
    done here by the script, the package has no switch. The pretraining
    step's augmentation then runs eagerly (counted_graphed_augment)."""
    saved = (vit_mod.mha_packed_bias, losses_mod.fused_dino_row_ce,
             aug_ops_mod.bilateral_filter_fused, layers_mod.layer_norm)
    vit_mod.mha_packed_bias = PlainAttention.apply
    losses_mod.fused_dino_row_ce = fused_dino_row_ce_plain
    aug_ops_mod.bilateral_filter_fused = bilateral_filter_plain
    layers_mod.layer_norm = layer_norm_plain
    try:
        yield
    finally:
        (vit_mod.mha_packed_bias, losses_mod.fused_dino_row_ce,
         aug_ops_mod.bilateral_filter_fused, layers_mod.layer_norm) = saved


class PhaseEvents:
    """Stands in for the step module's span helper: CUDA events around each phase."""
    records = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        PhaseEvents.records.append((self.name, self.start, end))
        return False


def kernel_counts():
    """The kernels' launches by the host, and the pretraining steps'
    augmentation calls by how their graph cache ran them (see
    counted_graphed_augment)."""
    return {"K1-fwd": mha_packed_bias.launches, "K1-bwd": mha_packed_bias_bwd.launches,
            "K1b-fwd": flash_attention.launches, "K1b-bwd": flash_attention_bwd.launches,
            "K2-fwd": fused_dino_row_ce.launches, "K2-bwd": fused_dino_row_ce.bwd_launches,
            "K3": bilateral_filter_fused.launches,
            "LN-fwd": layer_norm.launches, "LN-bwd": layer_norm.bwd_launches,
            **{kind: AUGMENT_CALLS[kind] for kind in AUGMENT_KINDS}}


def reset_kernel_counts() -> None:
    mha_packed_bias.launches = mha_packed_bias_bwd.launches = 0
    flash_attention.launches = flash_attention_bwd.launches = mha.launches = 0
    fused_dino_row_ce.launches = fused_dino_row_ce.bwd_launches = 0
    bilateral_filter_fused.launches = 0
    layer_norm.launches = layer_norm.bwd_launches = 0
    AUGMENT_CALLS.clear()


# how the pretraining step's graph cache runs an augmentation call, and how
# many times the host launches an eager run's K3 in it: once eagerly, twice
# in a capture (the warm-up and the captured run), never in a replay (the
# graph launches what the capture launched)
AUGMENT_KINDS = {"augment-eager": 1, "augment-capture": 2, "augment-replay": 0}
AUGMENT_CALLS = collections.Counter()


def counted_graphed_augment(graphs, generator, images, chain, *args):
    """The pretraining step's ``graphed_augment``, its call counted by kind,
    the kind read from the cache before the call: a replay if the key holds
    a graph, a capture if the key was seen once, eager otherwise. The K3
    launches the host makes in the call must be the kind's share of an
    eager run's: two at severity 5 (one a photometric chain), none at
    another severity. Where the plain versions stand in, the chain runs
    eagerly and uncounted: a graph captured before would replay the kernel,
    and one captured now would hold the plain version."""
    if aug_ops_mod.bilateral_filter_fused is bilateral_filter_plain:
        return chain(TorchKey(generator), images, *args)
    key = augment_mod.graph_key(generator, images, chain, args)
    kind = ("augment-eager" if not augment_mod._graphable(images)
            else "augment-replay" if key in graphs._graphs
            else "augment-capture" if key in graphs._seen else "augment-eager")
    before = bilateral_filter_fused.launches
    out = augment_mod.graphed_augment(graphs, generator, images, chain, *args)
    host = bilateral_filter_fused.launches - before
    eager = LAUNCHES_PER_STEP["K3"] if chain is pretrain_views and args == (5,) else 0
    if host != AUGMENT_KINDS[kind] * eager:
        raise SystemExit(f"augmentation ({kind}): {host} K3 launches on the host, expected "
                         f"{AUGMENT_KINDS[kind] * eager}")
    AUGMENT_CALLS[kind] += 1
    return out


def due(table: dict, counts: dict, steps: int = 1) -> dict:
    """What ``counts`` (``kernel_counts()``, or a step's share of it) should
    read after ``steps`` steps that each launch ``table``'s kernels, with
    their augmentation calls as ``counts`` has them: ``table``'s K3 (an
    eager augmentation's) as many times as AUGMENT_KINDS gives each call."""
    want = {k: v * steps for k, v in table.items()}
    want.update({kind: counts[kind] for kind in AUGMENT_KINDS},
                K3=table["K3"] * sum(n * counts[kind] for kind, n in AUGMENT_KINDS.items()))
    return want


def recognizer_norms(model) -> tuple:
    """(LayerNorms of one ViT forward without the taps, of one decoder pass)."""
    return 2 * len(model.backbone.blocks) + 1, 3 * len(model.decoder.layer_stack) + 1


@contextlib.contextmanager
def decoder_runs():
    """Counts the greedy decode's passes over its steps that run on the host,
    each launching the decoder's norms once a step: an eager decode runs one,
    a capture two (its warm-up and the captured run), a replay none."""
    passes = [0]
    inner = NRTRDecoder._decode_steps

    def counted(self, out_enc):
        passes[0] += 1
        return inner(self, out_enc)

    NRTRDecoder._decode_steps = counted
    try:
        yield passes
    finally:
        NRTRDecoder._decode_steps = inner


def pretrain_inputs(batch: int, seed: int):
    """Rendered words as uint8 and their glyph masks as uint8, on the card:
    what the data path hands the fused step, which draws the views itself."""
    images, masks, _words = make_synthetic_batch(batch, seed=seed)
    return torch.from_numpy(images).cuda(), torch.from_numpy(masks.astype(np.uint8)).cuda()


def augmentation_alone(raw: torch.Tensor, augment, name: str) -> dict:
    """An augmentation at the step's batch on its own (``augment(key,
    images)``, ``name`` its function): its time, the card's idle share and
    kernel launches under the profiler, and the host synchronisations it
    makes (none are allowed: it runs inside the step)."""
    import warnings
    images = raw.float() / 255.0
    key = TorchKey(torch.Generator(device="cuda").manual_seed(SEED))
    out = augment(key, images)
    if not all(bool(torch.isfinite(x).all()) for x in (out if isinstance(out, tuple) else (out,))):
        raise SystemExit(f"augmentation: {name} gave values that are not finite")
    ms = time_ms(lambda: augment(key, images), reps=5, warmup=1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            augment(key, images)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message)[:200] for w in caught if "synchroniz" in str(w.message).lower()]
    wall, busy, top, n_kernels = device_busy(lambda: augment(key, images))
    return {f"{name}_ms": ms, "host_synchronisations": len(syncs),
            "host_synchronisation_messages": syncs[:3],
            "profiled_wall_ms": wall, "profiled_device_busy_ms": busy,
            "profiled_device_idle_share": None if busy is None else 1.0 - busy / wall,
            "profiled_kernel_launches": n_kernels, "profiled_top_kernels": top}


def pretrain_views_checked(key, images):
    views, theta = pretrain_views(key, images)
    if views.shape != (images.shape[0], 3, *images.shape[1:]) \
            or theta.shape != (images.shape[0], 3, 3):
        raise SystemExit("augmentation: views or theta of the wrong shape")
    return views, theta


def pretrain_schedule(config, batch: int) -> dict:
    """The configuration's schedule, except its length: warm-up and cosine
    are cut to a run of a few steps so that the learning rate is not ~0
    throughout."""
    return dict(
        base_lr=float(config.lr) * batch / 256.0, min_lr=float(config.min_lr),
        total_iters=1000, warmup_iters=3, weight_decay=float(config.weight_decay),
        weight_decay_end=float(config.weight_decay_end),
        momentum_teacher=float(config.momentum_teacher),
        teacher_temps=teacher_temp_schedule(
            float(config.warmup_teacher_temp), float(config.teacher_temp),
            int(config.warmup_teacher_temp_epochs), 2),
        clip_grad=config.clip_grad, freeze_last_layer=int(config.freeze_last_layer),
        global_batch=batch, imgnet_based=int(config.imgnet_based))


def pretrain_twin(state: PretrainState) -> PretrainState:
    """The same state once more (models, moments, centre, generators), for
    the same first step through the plain versions."""
    twin = PretrainState(
        student=copy.deepcopy(state.student), teacher=copy.deepcopy(state.teacher),
        opt_state=copy.deepcopy(state.opt_state), center=state.center.clone(),
        iteration=state.iteration,
        generator=torch.Generator(device="cuda"), aug_generator=torch.Generator(device="cuda"))
    twin.generator.set_state(state.generator.get_state())
    twin.aug_generator.set_state(state.aug_generator.get_state())
    return twin


def run_pretrain_step(step, st, raw, masks, what: str):
    """One step, timed with CUDA events: (metrics, the launches it made, ms);
    a loss that is not finite, or another count of augmentation calls than
    one (none where the plain versions stand in), ends the run."""
    before = kernel_counts()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    st, metrics = step(st, raw, masks)
    b.record()
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in kernel_counts().items()}
    calls = sum(made[kind] for kind in AUGMENT_KINDS)
    if calls != int(aug_ops_mod.bilateral_filter_fused is not bilateral_filter_plain):
        raise SystemExit(f"{what}: {calls} counted augmentation calls in one step")
    metrics = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(metrics[k]) for k in ("loss", "mask_loss", "dino_loss")):
        raise SystemExit(f"{what}: a loss is not finite: {metrics}")
    return metrics, made, a.elapsed_time(b)


def optimizer_moments(state: PretrainState) -> list:
    """What the step's gradients go into: AdamW's first moments, or the
    sgd/lars momentum."""
    opt = state.opt_state
    return opt.trace if isinstance(opt, MomentumState) else opt.mu


def against_plain_step(what: str, step, state, twin, raw, masks, first: dict,
                       left_out=()) -> dict:
    """The step again from the same state (``twin``) through the plain
    versions: no kernel launched, losses, first moments (sgd/lars: the
    momentum) and centre held to the kernels' step. The parameters named in
    ``left_out`` are reported (first moments' norms on both sides) but not
    held (see EMPTY_SLOT_BIASES)."""
    counts = kernel_counts()
    with plain_versions_in_place_of_kernels():
        plain, made, _ = run_pretrain_step(step, twin, raw, masks, what)
    if any(made.values()) or kernel_counts() != counts:
        raise SystemExit(f"{what}: the plain-version step launched kernels: {made}")
    loss_rel = {k: abs(first[k] - plain[k]) / abs(plain[k])
                for k in ("loss", "mask_loss", "dino_loss")}
    names = [n for n, _ in state.student.named_parameters()]
    moments, twin_moments = optimizer_moments(state), optimizer_moments(twin)
    pairs = [(n, a, b) for n, a, b in zip(names, moments, twin_moments) if n not in left_out]
    by_param = sorted(((float((a - b).norm() / b.norm()), n) for n, a, b in pairs
                       if float(b.norm()) > 0), reverse=True)
    not_held = {n: {"kernels": float(a.norm()), "plain": float(b.norm())}
                for n, a, b in zip(names, moments, twin_moments) if n in left_out}
    mu, mu_plain = (torch.cat([a.flatten() for _, a, _ in pairs]),
                    torch.cat([b.flatten() for _, _, b in pairs]))
    grad_rel = float((mu - mu_plain).norm() / mu_plain.norm())
    center_rel = float((state.center - twin.center).norm() / twin.center.norm())
    if not max(loss_rel.values()) <= TOL_STEP_LOSS_REL:
        raise SystemExit(f"{what}: kernel and plain steps' losses differ: {loss_rel} "
                         f"> {TOL_STEP_LOSS_REL}")
    if not grad_rel <= TOL_STEP_GRAD_REL or not float(mu_plain.norm()) > 0:
        raise SystemExit(f"{what}: kernel and plain steps' gradients differ by "
                         f"{grad_rel} in L2 > {TOL_STEP_GRAD_REL}; most by parameter: "
                         f"{by_param[:3]}")
    if not center_rel <= TOL_STEP_LOSS_REL:
        raise SystemExit(f"{what}: kernel and plain steps' centres differ by {center_rel}")
    return {"first_step_plain_versions": plain, "first_step_loss_rel_diff": loss_rel,
            "tol_step_loss_rel": TOL_STEP_LOSS_REL, "first_step_grad_rel_l2_diff": grad_rel,
            "tol_step_grad_rel": TOL_STEP_GRAD_REL,
            "first_step_grad_rel_l2_diff_largest_by_parameter": by_param[:3],
            "first_step_moment_norms_not_held": not_held,
            "first_step_grad_checksum": {"kernels": float(mu.abs().sum()),
                                         "plain": float(mu_plain.abs().sum())},
            "first_step_center_rel_diff": center_rel}


def pretrain_path(card: str) -> dict:
    """The pretraining step at full width; returns the kernels' launches on it."""
    config = Config(PRETRAIN_CONFIG)
    student, teacher = build_pretrain_models(config, device="cuda",
                                             generator=torch.Generator().manual_seed(SEED))
    state = init_pretrain_state(student, teacher, seed=SEED)
    if student.dtype != torch.bfloat16 or len(student.backbone.blocks) != 12 \
            or student.backbone.embed_dim != 384 or student.out_dim != 65536 \
            or tuple(student.head.last_layer.weight_v.shape) != (65536, 256) \
            or int(config.batch_size_per_gpu) != PRETRAIN_BATCH:
        raise SystemExit("pretrain path: not the full-width bf16 ViT-Small configuration")
    raw, masks = pretrain_inputs(PRETRAIN_BATCH, seed=321)
    schedule = pretrain_schedule(config, PRETRAIN_BATCH)
    step_gt = make_fused_pretrain_step(gt_mask_epochs=30, **schedule)
    step_predicted = make_fused_pretrain_step(gt_mask_epochs=0, **schedule)
    twin = pretrain_twin(state)
    teacher0 = [p.detach().clone() for p in teacher.parameters()]
    run_step = lambda step, st: run_pretrain_step(step, st, raw, masks, "pretrain path")

    reset_kernel_counts()
    history, step_ms = [], {"gt_masks": [], "predicted_masks": []}
    first, made, _ = run_step(step_gt, state)
    history.append(first)
    if made != due(LAUNCHES_PER_STEP, made):
        raise SystemExit(f"pretrain path: step launched {made}, expected "
                         f"{due(LAUNCHES_PER_STEP, made)}")

    # ---- the first step again from the same state, through the plain versions
    compared = against_plain_step("pretrain path", step_gt, state, twin, raw, masks, first)
    del twin
    torch.cuda.empty_cache()

    # ---- more steps, both mask regimes
    torch.cuda.reset_peak_memory_stats()
    flood_rounds = []
    for regime, step, n in (("gt_masks", step_gt, GT_STEPS - 1),
                            ("predicted_masks", step_predicted, PREDICTED_STEPS)):
        for _ in range(n):
            metrics, made, ms = run_step(step, state)
            if made != due(LAUNCHES_PER_STEP, made):
                raise SystemExit(f"pretrain path: step launched {made}, expected "
                                 f"{due(LAUNCHES_PER_STEP, made)}")
            history.append(dict(metrics, regime=regime))
            step_ms[regime].append(ms)
            flood_rounds.append(int(metrics["cluster_rounds"]))
    peak_bytes = torch.cuda.max_memory_allocated()

    # ---- where a step's time goes: CUDA events around the step's phases
    PhaseEvents.records = []
    marker = pretrain_step_mod.span
    pretrain_step_mod.span = PhaseEvents
    try:
        _, made, phased_ms = run_step(step_gt, state)
    finally:
        pretrain_step_mod.span = marker
    phases = dict.fromkeys(STEP_PHASES, 0.0)
    for name, a, b in PhaseEvents.records:
        phases[name] += a.elapsed_time(b)
    # ---- and how busy the card is during one step (the profiler slows the host side)
    prof_wall, busy, top, n_kernels = device_busy(lambda: step_gt(state, raw, masks))
    n_steps = GT_STEPS + PREDICTED_STEPS + 2
    launches = kernel_counts()
    if launches != due(LAUNCHES_PER_STEP, launches, n_steps) or state.iteration != n_steps:
        raise SystemExit(f"pretrain path: {launches} launches over {state.iteration} steps")
    # after the count: its launches are not the path's
    augment = augmentation_alone(raw, pretrain_views_checked, "pretrain_views")

    teacher_moved = max(float((p - p0).abs().max()) for p, p0 in
                        zip(teacher.parameters(), teacher0))
    center_moved = float(state.center.abs().max())
    if not teacher_moved > 0 or not center_moved > 0:
        raise SystemExit("pretrain path: the teacher or the centre did not move")
    median_ms = statistics.median(step_ms["gt_masks"])
    emit({"phase": "main_path", "path": "pretrain", "gpu": card,
          "config": "ccd_pretrain_vit_small.yaml", "arch": "vit_small student + teacher",
          "dtype": "bfloat16", "batch": PRETRAIN_BATCH, "out_dim": student.out_dim,
          "logit_rows": 2 * PRETRAIN_BATCH * student.num_slots, "steps": n_steps,
          "launches_per_step": LAUNCHES_PER_STEP, "kernel_launches": launches,
          "step_ms_median": median_ms, "images_per_s": PRETRAIN_BATCH / median_ms * 1e3,
          "step_ms": step_ms,
          "step_ms_median_predicted_masks": statistics.median(step_ms["predicted_masks"]),
          "label_clusters_flood_rounds": flood_rounds,
          "phases_ms": phases, "phased_step_ms": phased_ms,
          "peak_device_memory_bytes": peak_bytes,
          "profiled_step_wall_ms": prof_wall, "profiled_device_busy_ms": busy,
          "profiled_device_idle_share": None if busy is None else 1.0 - busy / prof_wall,
          "profiled_kernel_launches": n_kernels, "profiled_top_kernels": top,
          "augmentation_alone": augment, "first_step": first, **compared,
          "losses": history, "teacher_moved_max_abs": teacher_moved,
          "center_max_abs": center_moved})
    if augment["host_synchronisations"]:
        raise SystemExit("augmentation: pretrain_views waits for the card "
                         f"{augment['host_synchronisations']} times; it must not")
    return launches


def finetune_inputs(batch: int, seed: int, max_seq_len: int):
    """Rendered words as uint8 and their padded targets as int32, on the
    card: what the data path hands the fused finetune step."""
    images, _masks, words = make_synthetic_batch(batch, seed=seed)
    targets = AttnConvertor("DICT90", max_seq_len=max_seq_len, with_unknown=True).str2tensor(words)
    return torch.from_numpy(images).cuda(), torch.from_numpy(targets).cuda()


def run_finetune_step(step, st, raw, targets, what: str):
    """One finetune step, timed with CUDA events: (loss, the launches it
    made, ms); a loss that is not finite ends the run."""
    before = kernel_counts()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    st, metrics = step(st, raw, targets)
    b.record()
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in kernel_counts().items()}
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise SystemExit(f"{what}: the loss is not finite: {loss}")
    return loss, made, a.elapsed_time(b)


def finetune_path(card: str) -> dict:
    """The finetune step at full width; returns the kernels' launches on it."""
    config = Config(CONFIG)
    model, _ = build_recognizer(config, device="cuda",
                                generator=torch.Generator().manual_seed(SEED))
    decoder = model.decoder
    if model.dtype != torch.bfloat16 or len(model.backbone.blocks) != 12 \
            or model.backbone.embed_dim != 384 or len(decoder.layer_stack) != 6 \
            or decoder.emb_drop.rate != 0.1 or model.encoder.drop.rate != 0.1 \
            or model.backbone.blocks[-1].drop_path.rate != 0.1 \
            or int(config.dataset_train_batch_size) != BATCH:
        raise SystemExit("finetune path: not the full-width bf16 ViT-Small + 6-layer NRTR "
                         "configuration with dropout and drop path 0.1 at batch 288")
    state = init_finetune_state(model, seed=SEED)
    raw, targets = finetune_inputs(BATCH, seed=654, max_seq_len=config.decoder_max_seq_len)
    # the shipped schedule, except its length: warm-up and cosine cut to this
    # run's few steps so that the learning rate is not ~0 throughout
    step = make_fused_finetune_step(
        aug_fn=supervised_augment, base_lr=float(config.lr), min_lr=float(config.min_lr),
        total_iters=1000, warmup_iters=3, weight_decay=float(config.weight_decay),
        clip_grad=config.clip_grad)

    # the same state once more, for the same first step through the plain versions
    twin = FinetuneState(model=copy.deepcopy(model), opt_state=copy.deepcopy(state.opt_state),
                         iteration=0, generator=torch.Generator(device="cuda"),
                         aug_generator=torch.Generator(device="cuda"))
    twin.generator.set_state(state.generator.get_state())
    twin.aug_generator.set_state(state.aug_generator.get_state())
    weights0 = [p.detach().clone() for p in model.parameters()]

    run_step = lambda st: run_finetune_step(step, st, raw, targets, "finetune path")

    reset_kernel_counts()
    first, made, _ = run_step(state)
    if made != due(FT_LAUNCHES_PER_STEP, made):
        raise SystemExit(f"finetune path: step launched {made}, expected {FT_LAUNCHES_PER_STEP}")

    # ---- the first step again from the same state and draws, plain versions
    counts = kernel_counts()
    with plain_versions_in_place_of_kernels():
        plain, made, _ = run_step(twin)
    if any(made.values()) or kernel_counts() != counts:
        raise SystemExit(f"finetune path: the plain-version step launched kernels: {made}")
    loss_rel = abs(first - plain) / abs(plain)
    mu, mu_plain = (torch.cat([m.flatten() for m in st.opt_state.mu]) for st in (state, twin))
    grad_rel = float((mu - mu_plain).norm() / mu_plain.norm())
    if not loss_rel <= TOL_STEP_LOSS_REL:
        raise SystemExit(f"finetune path: kernel and plain steps' losses differ by {loss_rel} "
                         f"> {TOL_STEP_LOSS_REL}")
    if not grad_rel <= TOL_STEP_GRAD_REL or not float(mu_plain.norm()) > 0:
        raise SystemExit(f"finetune path: kernel and plain steps' gradients differ by "
                         f"{grad_rel} in L2 > {TOL_STEP_GRAD_REL}")
    del twin, mu, mu_plain
    torch.cuda.empty_cache()

    # ---- more steps
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], [first]
    for _ in range(FT_STEPS):
        loss, made, ms = run_step(state)
        if made != due(FT_LAUNCHES_PER_STEP, made):
            raise SystemExit(f"finetune path: step launched {made}, expected "
                             f"{FT_LAUNCHES_PER_STEP}")
        step_ms.append(ms)
        losses.append(loss)
    peak_bytes = torch.cuda.max_memory_allocated()

    # ---- where a step's time goes: CUDA events around the step's phases
    PhaseEvents.records = []
    marker = finetune_step_mod.span
    finetune_step_mod.span = PhaseEvents
    try:
        _, made, phased_ms = run_step(state)
    finally:
        finetune_step_mod.span = marker
    phases = dict.fromkeys(FT_PHASES, 0.0)
    for name, a, b in PhaseEvents.records:
        phases[name] += a.elapsed_time(b)
    # ---- and how busy the card is during one step (the profiler slows the host side)
    prof_wall, busy, top, n_kernels = device_busy(lambda: step(state, raw, targets))
    n_steps = FT_STEPS + 3
    launches = kernel_counts()
    if launches != due(FT_LAUNCHES_PER_STEP, launches, n_steps) \
            or state.iteration != n_steps:
        raise SystemExit(f"finetune path: {launches} launches over {state.iteration} steps")
    # after the count: its launches are not the path's
    augment = augmentation_alone(raw, supervised_augment, "supervised_augment")

    moved = max(float((p.detach() - p0).abs().max())
                for p, p0 in zip(model.parameters(), weights0))
    if not moved > 0:
        raise SystemExit("finetune path: the weights did not move")
    median_ms = statistics.median(step_ms)
    emit({"phase": "main_path", "path": "finetune", "gpu": card, "config": "ccd_finetune_ard.yaml",
          "arch": "vit_small + 6-layer NRTR", "dtype": "bfloat16", "batch": BATCH,
          "dropout": 0.1, "drop_path": 0.1, "augmentation": "supervised_augment",
          "steps": n_steps, "launches_per_step": FT_LAUNCHES_PER_STEP,
          "kernel_launches": launches, "step_ms_median": median_ms,
          "images_per_s": BATCH / median_ms * 1e3, "step_ms": step_ms,
          "phases_ms": phases, "phased_step_ms": phased_ms,
          "peak_device_memory_bytes": peak_bytes,
          "profiled_step_wall_ms": prof_wall, "profiled_device_busy_ms": busy,
          "profiled_device_idle_share": None if busy is None else 1.0 - busy / prof_wall,
          "profiled_kernel_launches": n_kernels, "profiled_top_kernels": top,
          "augmentation_alone": augment,
          "first_step_loss": first, "first_step_loss_plain_versions": plain,
          "first_step_loss_rel_diff": loss_rel, "tol_step_loss_rel": TOL_STEP_LOSS_REL,
          "first_step_grad_rel_l2_diff": grad_rel, "tol_step_grad_rel": TOL_STEP_GRAD_REL,
          "losses": losses, "weights_moved_max_abs": moved})
    if augment["host_synchronisations"]:
        raise SystemExit("augmentation: supervised_augment waits for the card "
                         f"{augment['host_synchronisations']} times; it must not")
    return launches


@contextlib.contextmanager
def launch_shapes():
    """Inside, every launch of the attention and CE kernels is counted by
    (C entry, shape): the attention's (B, S, 3C) of its packed qkv (or the
    folded operand) and its heads, the CE's (R, K)."""
    seen = collections.Counter()
    real_attention, real_ce = flash_attention_mod._c_call, fused_dino_ce_mod._call

    def attention_spy(entry, library, tensors, dims, *args, **kwargs):
        b, s, h, d = dims
        seen[(entry, (b, s, 3 * h * d), h)] += 1
        return real_attention(entry, library, tensors, dims, *args, **kwargs)

    def ce_spy(entry, tensors, s, *args, **kwargs):
        seen[(entry, tuple(s.shape))] += 1
        return real_ce(entry, tensors, s, *args, **kwargs)

    flash_attention_mod._c_call, fused_dino_ce_mod._call = attention_spy, ce_spy
    try:
        yield seen
    finally:
        flash_attention_mod._c_call, fused_dino_ce_mod._call = real_attention, real_ce


class RecordingKey:
    """A ``TorchKey`` that keeps, in order, every draw it hands out."""

    def __init__(self, generator: torch.Generator):
        self.key, self.device, self.draws = TorchKey(generator), generator.device, []

    def split(self, n: int = 2):
        return [self] * n

    def fold_in(self, data: int):
        return self

    def _kept(self, draw):
        self.draws.append(draw)
        return draw

    def uniform(self, shape, lo=0.0, hi=1.0):
        return self._kept(self.key.uniform(shape, lo, hi))

    def bernoulli(self, p, shape):
        return self._kept(self.key.bernoulli(p, shape))

    def randint(self, shape, lo, hi):
        return self._kept(self.key.randint(shape, lo, hi))

    def normal(self, shape):
        return self._kept(self.key.normal(shape))

    def laplace(self, shape):
        return self._kept(self.key.laplace(shape))

    def permutations(self, b, n):
        return self._kept(self.key.permutations(b, n))


class ReplayKey:
    """Hands out a :class:`RecordingKey`'s draws again, in order, on the
    CPU: the same function then sees the card's draws."""

    def __init__(self, draws):
        self.draws, self.device, self.used = [d.cpu() for d in draws], torch.device("cpu"), 0

    def split(self, n: int = 2):
        return [self] * n

    def fold_in(self, data: int):
        return self

    def _next(self, shape):
        draw = self.draws[self.used]
        if tuple(draw.shape) != tuple(shape):
            raise SystemExit(f"replay: draw {self.used} is {tuple(draw.shape)}, the function "
                             f"asks for {tuple(shape)}")
        self.used += 1
        return draw

    def uniform(self, shape, lo=0.0, hi=1.0):
        return self._next(shape)

    def bernoulli(self, p, shape):
        return self._next(shape)

    def randint(self, shape, lo, hi):
        return self._next(shape)

    def normal(self, shape):
        return self._next(shape)

    def laplace(self, shape):
        return self._next(shape)

    def permutations(self, b, n):
        return self._next((b, n))


def chain_check(raw: torch.Tensor, augment, name: str) -> dict:
    """An augmentation chain (``augment(key, images)``; its output, or the
    first of its outputs, has the batch first) at the card: alone (time,
    idle share, launches, host synchronisations: none allowed), finite and
    different from its input, and held against the same function on a CPU
    copy of the images fed the card run's own draws."""
    before = kernel_counts()
    alone = augmentation_alone(raw, augment, name)
    if alone["host_synchronisations"]:
        raise SystemExit(f"augmentation: {name} waits for the card "
                         f"{alone['host_synchronisations']} times; it must not")
    images = raw.float() / 255.0
    recorder = RecordingKey(torch.Generator(device="cuda").manual_seed(SEED + 7))
    card = augment(recorder, images)
    replay = ReplayKey(recorder.draws)
    cpu = augment(replay, images.cpu())
    kernels = {k: v - before[k] for k, v in kernel_counts().items()}
    card, cpu = (card, cpu) if isinstance(card, tuple) else ((card,), (cpu,))
    if replay.used != len(recorder.draws):
        raise SystemExit(f"{name}: the CPU run took {replay.used} of {len(recorder.draws)} "
                         "draws")
    diffs = []
    for a, b in zip(card, cpu):
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise SystemExit(f"{name}: the card's output is not finite or not the CPU's shape")
        diffs.append((a.cpu() - b).abs().flatten())
    diff = torch.cat(diffs)
    worst, share = float(diff.max()), float((diff <= TOL_CARD_CPU).double().mean())
    out = card[0]
    changed = float((out[:, 1] - out[:, 0]).abs().max()) if out.dim() == 5 \
        else float((out - images).abs().max())  # views: the photometric view against the raw one
    if not share >= MIN_CARD_CPU_SHARE or not changed > 1e-3:
        raise SystemExit(f"{name}: card and CPU agree to {TOL_CARD_CPU} on {share} of the "
                         f"values (< {MIN_CARD_CPU_SHARE}), or the output equals the input "
                         f"(largest change {changed})")
    return dict(alone, draws=len(recorder.draws), card_vs_cpu_max_abs_diff=worst,
                card_vs_cpu_share_within_tol=share, tol_card_cpu=TOL_CARD_CPU,
                min_share=MIN_CARD_CPU_SHARE, largest_change=changed,
                kernel_launches=kernels)


def augmentation_chains(card: str) -> None:
    """``pretrain_views`` at every severity but 5 (which the pretraining path
    runs) at the pretraining batch, and ``abinet_augment`` at the finetune
    batch, on rendered words: each through :func:`chain_check`. None of
    these chains has a bilateral filter, so none launches a kernel."""
    raw_pretrain, _masks = pretrain_inputs(PRETRAIN_BATCH, seed=777)
    raw_finetune, _targets = finetune_inputs(BATCH, seed=778, max_seq_len=25)
    chains = {}
    for severity in CHAIN_SEVERITIES:
        views = lambda key, images, s=severity: pretrain_views(key, images, severity=s)
        chains[f"pretrain_views_severity_{severity}"] = chain_check(
            raw_pretrain, views, f"pretrain_views(severity={severity})")
    chains["abinet_augment"] = chain_check(raw_finetune, abinet_augment, "abinet_augment")
    launched = {name: c["kernel_launches"] for name, c in chains.items()
                if any(c["kernel_launches"].values())}
    emit({"phase": "augmentation_chains", "gpu": card, "image": [32, 128, 3],
          "batch": {"pretrain_views": PRETRAIN_BATCH, "abinet_augment": BATCH},
          "chains": chains})
    if launched:
        raise SystemExit(f"augmentation chains launched kernels: {launched}")


def vit_base_pretrain_path(card: str) -> dict:
    """``ccd_pretrain_vit_base.yaml`` at full width (ViT-Base, C = 512, 8
    heads, batch 48, ``out_dim`` 65536, bf16, severity 5,
    ``norm_last_layer: True``): VIT_BASE_STEPS fused steps on rendered words,
    the first compared with the same step through the plain versions, the
    launches counted by shape, the frozen gain ``weight_g`` held bit for bit
    while ``weight_v`` trains, then a profiled step. Returns the kernels'
    launches."""
    config = Config(VIT_BASE_CONFIG)
    student, teacher = build_pretrain_models(config, device="cuda",
                                             generator=torch.Generator().manual_seed(SEED))
    state = init_pretrain_state(student, teacher, seed=SEED, optimizer=str(config.optimizer))
    vit, batch = student.backbone, int(config.batch_size_per_gpu)
    severity = int(config.dataset_augmentation_severity)
    if student.dtype != torch.bfloat16 or len(vit.blocks) != 12 or vit.embed_dim != 512 \
            or vit.blocks[0].attn.num_heads != 8 or student.out_dim != 65536 \
            or not student.norm_last_layer or batch != VIT_BASE_BATCH or severity != 5:
        raise SystemExit("ViT-Base pretrain path: not the full-width bf16 ViT-Base "
                         "configuration with norm_last_layer at batch 48, severity 5")
    raw, masks = pretrain_inputs(batch, seed=432)
    # the compared step on the configuration's schedule, which freezes the
    # last layer for the first virtual epoch (all of this run), as the
    # ViT-Small path's does; the steps after it train the last layer, so
    # that weight_v moves while the frozen gain must not
    schedule = pretrain_schedule(config, batch)
    step = make_fused_pretrain_step(severity=severity, gt_mask_epochs=30, **schedule)
    step_open = make_fused_pretrain_step(severity=severity, gt_mask_epochs=30,
                                         **dict(schedule, freeze_last_layer=0))
    twin = pretrain_twin(state)
    gain0 = student.head.last_layer.weight_g.detach().clone()
    direction0 = student.head.last_layer.weight_v.detach().clone()
    what = "ViT-Base pretrain path"

    reset_kernel_counts()
    pooled = []
    real_pool = pretrain_model_mod.char_attention_pool

    def pool_spy(features, clusters):
        vecs, index = real_pool(features, clusters)
        pooled.append(int((vecs.detach().abs().amax(-1) == 0).sum()))
        return vecs, index

    pretrain_model_mod.char_attention_pool = pool_spy
    try:
        with launch_shapes() as shapes:
            first, made, _ = run_pretrain_step(step, state, raw, masks, what)
    finally:
        pretrain_model_mod.char_attention_pool = real_pool
    rows = 2 * batch * student.num_slots
    want_shapes = {("packed_attention_forward", (2 * batch, 256, 3 * 512), 8): 24,
                   ("packed_attention_backward", (2 * batch, 256, 3 * 512), 8): 12,
                   ("fused_dino_ce_forward", (rows, 65536)): 1,
                   ("fused_dino_ce_backward", (rows, 65536)): 1}
    if made != due(LAUNCHES_PER_STEP, made) or dict(shapes) != want_shapes:
        raise SystemExit(f"{what}: step launched {made} at {dict(shapes)}, expected "
                         f"{due(LAUNCHES_PER_STEP, made)} at {want_shapes}")
    compared = against_plain_step(what, step, state, twin, raw, masks, first,
                                  left_out=EMPTY_SLOT_BIASES)
    del twin
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    history, step_ms = [first], []
    for _ in range(VIT_BASE_STEPS - 1):
        metrics, made, ms = run_pretrain_step(step_open, state, raw, masks, what)
        if made != due(LAUNCHES_PER_STEP, made):
            raise SystemExit(f"{what}: step launched {made}, expected "
                             f"{due(LAUNCHES_PER_STEP, made)}")
        history.append(metrics)
        step_ms.append(ms)
    peak_bytes = torch.cuda.max_memory_allocated()
    prof_wall, busy, top, n_kernels = device_busy(lambda: step_open(state, raw, masks))
    n_steps = VIT_BASE_STEPS + 1
    launches = kernel_counts()
    if launches != due(LAUNCHES_PER_STEP, launches, n_steps) or state.iteration != n_steps:
        raise SystemExit(f"{what}: {launches} launches over {state.iteration} steps")
    gain_frozen = bool(torch.equal(student.head.last_layer.weight_g, gain0))
    direction_moved = float((student.head.last_layer.weight_v - direction0).abs().max())
    if not gain_frozen or not direction_moved > 0:
        raise SystemExit(f"{what}: last_layer.weight_g moved (norm_last_layer freezes it), "
                         f"or weight_v did not ({direction_moved})")
    emit({"phase": "main_path", "path": "pretrain_vit_base", "gpu": card,
          "config": "ccd_pretrain_vit_base.yaml", "arch": "vit_base student + teacher",
          "embed_dim": vit.embed_dim, "heads": vit.blocks[0].attn.num_heads,
          "blocks": len(vit.blocks), "dtype": "bfloat16", "batch": batch,
          "severity": severity, "out_dim": student.out_dim, "logit_rows": rows,
          "norm_last_layer": True,
          "freeze_last_layer": {"compared_step": int(config.freeze_last_layer), "later_steps": 0},
          "weight_g_bit_identical_after_steps": gain_frozen,
          "weight_v_moved_max_abs": direction_moved,
          "steps": n_steps, "launches_per_step": LAUNCHES_PER_STEP,
          "first_step_launches_by_shape": [[*k, v] for k, v in shapes.items()],
          "first_step_char_slots_pooled_to_zero": {"teacher": pooled[0], "student": pooled[1],
                                                   "of": rows},
          "kernel_launches": launches, "step_ms": step_ms,
          "step_ms_median": statistics.median(step_ms),
          "images_per_s": batch / statistics.median(step_ms) * 1e3,
          "peak_device_memory_bytes": peak_bytes,
          "profiled_step_wall_ms": prof_wall, "profiled_device_busy_ms": busy,
          "profiled_device_idle_share": None if busy is None else 1.0 - busy / prof_wall,
          "profiled_kernel_launches": n_kernels, "profiled_top_kernels": top,
          "first_step": first, **compared, "losses": history})
    return launches


def severity_2_pretrain_step(card: str) -> dict:
    """One fused ViT-Small pretraining step at augmentation severity 2 (the
    SomeOf chain with crops, elastic and perspective warps) at batch 64, and
    a second one timed: finite losses, the step's kernels launched (no K3:
    severity 2 has no bilateral filter). Returns the kernels' launches."""
    config = Config(PRETRAIN_CONFIG)
    student, teacher = build_pretrain_models(config, device="cuda",
                                             generator=torch.Generator().manual_seed(SEED))
    state = init_pretrain_state(student, teacher, seed=SEED)
    raw, masks = pretrain_inputs(PRETRAIN_BATCH, seed=543)
    step = make_fused_pretrain_step(severity=2, gt_mask_epochs=30,
                                    **pretrain_schedule(config, PRETRAIN_BATCH))
    want = dict(LAUNCHES_PER_STEP, K3=0)
    reset_kernel_counts()
    runs = [run_pretrain_step(step, state, raw, masks, "severity-2 pretrain step")
            for _ in range(2)]
    launches = kernel_counts()
    if any(made != due(want, made) for _, made, _ in runs):
        raise SystemExit(f"severity-2 pretrain step: launched {[m for _, m, _ in runs]}, "
                         f"expected {want} a step")
    emit({"phase": "main_path", "path": "pretrain_severity_2", "gpu": card,
          "config": "ccd_pretrain_vit_small.yaml, augmentation_severity 2",
          "batch": PRETRAIN_BATCH, "steps": 2, "kernel_launches": launches,
          "losses": [m for m, _, _ in runs], "step_ms": [ms for _, _, ms in runs]})
    return launches


def fp32_step_phase(card: str, kernels: str = "this tree") -> dict:
    """The fused pretraining step of ``ccd_pretrain_vit_tiny.yaml`` with
    ``compute_dtype: float32`` (ViT-Tiny, C = 192, 3 heads, ``out_dim``
    65536, batch 64, severity 5; the fp32 attention kernels at TINY_SHAPE):
    a first step held against the same step through the plain versions,
    FP32_STEP_TIMED timed steps and one under the profiler (the card's busy
    time, the attention kernels' device time by kernel), peak memory, and
    the launches of all five. ``kernels`` names the attention kernels'
    origin in the line. Returns the kernels' launches."""
    config = Config(TINY_CONFIG)
    config.compute_dtype = "float32"
    student, teacher = build_pretrain_models(config, device="cuda",
                                             generator=torch.Generator().manual_seed(SEED))
    blocks = student.backbone.blocks
    if student.dtype != torch.float32 or student.backbone.embed_dim != 192 \
            or len(blocks) != 12 or blocks[0].attn.num_heads != 3 \
            or student.out_dim != 65536 or int(config.batch_size_per_gpu) != PRETRAIN_BATCH:
        raise SystemExit("fp32 step: not the full-width fp32 ViT-Tiny configuration")
    what = f"fp32 step ({kernels})"
    state = init_pretrain_state(student, teacher, seed=SEED)
    raw, masks = pretrain_inputs(PRETRAIN_BATCH, seed=654)
    step = make_fused_pretrain_step(gt_mask_epochs=30, **pretrain_schedule(config, PRETRAIN_BATCH))
    twin = pretrain_twin(state)
    reset_kernel_counts()
    first, made, first_ms = run_pretrain_step(step, state, raw, masks, what)
    if made != due(LAUNCHES_PER_STEP, made):
        raise SystemExit(f"{what}: step launched {made}, expected "
                         f"{due(LAUNCHES_PER_STEP, made)}")
    compared = against_plain_step(what, step, state, twin, raw, masks, first)
    del twin
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runs = [run_pretrain_step(step, state, raw, masks, what) for _ in range(FP32_STEP_TIMED)]
    if any(m != due(LAUNCHES_PER_STEP, m) for _, m, _ in runs):
        raise SystemExit(f"{what}: launched {[m for _, m, _ in runs]}, expected "
                         f"{LAUNCHES_PER_STEP} a step")
    peak = torch.cuda.max_memory_allocated()
    wall, rows = profiled_kernels(lambda: step(state, raw, masks))
    launches = kernel_counts()
    n_steps = FP32_STEP_TIMED + 2
    if launches != due(LAUNCHES_PER_STEP, launches, n_steps):
        raise SystemExit(f"{what}: {launches} launches over {n_steps} steps")
    busy = sum(r[0] for r in rows) if rows else None
    attention = {name: {"device_ms": ms, "calls": n} for ms, n, name in rows
                 if "attention_" in name}
    if busy is None or not attention:
        raise SystemExit(f"{what}: the profiler saw no device time (or no attention kernel)")
    step_ms = [ms for _, _, ms in runs]
    emit({"phase": "fp32_step", "gpu": card, "kernels": kernels,
          "config": "ccd_pretrain_vit_tiny.yaml, compute_dtype float32",
          "batch": PRETRAIN_BATCH, "attention_shape": list(TINY_SHAPE), "steps": n_steps,
          "launches_per_step": LAUNCHES_PER_STEP, "kernel_launches": launches,
          "first_step_ms": first_ms, "step_ms": step_ms,
          "step_ms_median": statistics.median(step_ms), "peak_device_memory_bytes": peak,
          "profiled_step_wall_ms": wall, "profiled_device_busy_ms": busy,
          "profiled_device_idle_share": 1.0 - busy / wall,
          "attention_device_ms": sum(v["device_ms"] for v in attention.values()),
          "attention_kernels": attention,
          "profiled_top_kernels": [{"kernel": k[:60], "ms": ms, "calls": n}
                                   for ms, n, k in rows[:8]],
          "first_step": first, **compared, "losses": [m for m, _, _ in runs]})
    return launches


def abinet_finetune_step(card: str) -> dict:
    """One fused finetune step of ``ccd_finetune_ard.yaml`` (ViT-Small +
    6-layer NRTR, bf16, batch 288) with ``aug_fn=abinet_augment`` (the
    ``dataset.use_abi`` chain), and a second one timed: finite losses, the
    step's kernels launched. Returns the kernels' launches."""
    config = Config(CONFIG)
    model, _ = build_recognizer(config, device="cuda",
                                generator=torch.Generator().manual_seed(SEED))
    state = init_finetune_state(model, seed=SEED)
    raw, targets = finetune_inputs(BATCH, seed=765, max_seq_len=config.decoder_max_seq_len)
    step = make_fused_finetune_step(
        aug_fn=abinet_augment, base_lr=float(config.lr), min_lr=float(config.min_lr),
        total_iters=1000, warmup_iters=3, weight_decay=float(config.weight_decay),
        clip_grad=config.clip_grad)
    reset_kernel_counts()
    runs = [run_finetune_step(step, state, raw, targets, "abinet finetune step")
            for _ in range(2)]
    launches = kernel_counts()
    if any(made != due(FT_LAUNCHES_PER_STEP, made) for _, made, _ in runs):
        raise SystemExit(f"abinet finetune step: launched {[m for _, m, _ in runs]}, expected "
                         f"{FT_LAUNCHES_PER_STEP} a step")
    emit({"phase": "main_path", "path": "finetune_abinet", "gpu": card,
          "config": "ccd_finetune_ard.yaml, dataset.use_abi", "batch": BATCH, "steps": 2,
          "kernel_launches": launches, "losses": [loss for loss, _, _ in runs],
          "step_ms": [ms for _, _, ms in runs]})
    return launches


def vit_small_pretrain_state(optimizer: str = "adamw", remat: bool = False):
    """The ViT-Small pretraining configuration's models and state from SEED,
    with ``optimizer`` and ``remat`` set as the configuration would set them."""
    config = Config(PRETRAIN_CONFIG)
    config.optimizer, config.remat = optimizer, remat
    student, teacher = build_pretrain_models(config, device="cuda",
                                             generator=torch.Generator().manual_seed(SEED))
    if student.backbone.remat != remat or teacher.backbone.remat:
        raise SystemExit("remat: build_pretrain_models did not set it on the student alone")
    return config, init_pretrain_state(student, teacher, seed=SEED,
                                       optimizer=str(config.optimizer))


def optimizers_phase(card: str) -> dict:
    """The ViT-Small fused pretraining step (batch 64, ``out_dim`` 65536,
    bf16, severity 5) with ``optimizer: sgd`` and with ``lars``: per
    optimizer a first step (the learning rate is 0 at iteration 0, so the
    lars momentum stays 0), then the second step held against the same step
    through the plain versions (the momentum is what is compared), then
    OPT_TIMED_STEPS timed steps: finite losses, the kernels' launches, ms,
    the card's busy share and the peak. Returns the kernels' launches."""
    raw, masks = pretrain_inputs(PRETRAIN_BATCH, seed=654)
    launches, report = collections.Counter(), {}
    for name in ("sgd", "lars"):
        config, state = vit_small_pretrain_state(name)
        if not isinstance(state.opt_state, MomentumState) or state.opt_state.name != name:
            raise SystemExit(f"optimizers: the state does not train with {name}")
        step = make_fused_pretrain_step(gt_mask_epochs=30,
                                        **pretrain_schedule(config, PRETRAIN_BATCH))
        what = f"pretrain step, optimizer {name}"
        reset_kernel_counts()
        history = [run_pretrain_step(step, state, raw, masks, what)[0]]
        twin = pretrain_twin(state)
        second, made, _ = run_pretrain_step(step, state, raw, masks, what)
        history.append(second)
        compared = against_plain_step(what, step, state, twin, raw, masks, second)
        del twin
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        for _ in range(OPT_TIMED_STEPS):
            metrics, made_timed, ms = run_pretrain_step(step, state, raw, masks, what)
            history.append(metrics)
            step_ms.append(ms)
            if made_timed != due(LAUNCHES_PER_STEP, made_timed):
                raise SystemExit(f"{what}: step launched {made_timed}, expected "
                                 f"{due(LAUNCHES_PER_STEP, made_timed)}")
        peak = torch.cuda.max_memory_allocated()
        n_steps = 2 + OPT_TIMED_STEPS
        mine = kernel_counts()
        if made != due(LAUNCHES_PER_STEP, made) \
                or mine != due(LAUNCHES_PER_STEP, mine, n_steps):
            raise SystemExit(f"{what}: {mine} launches over {n_steps} steps")
        prof_wall, busy, _, _ = device_busy(lambda: step(state, raw, masks))
        momentum = float(torch.stack([t.float().norm() for t in state.opt_state.trace]).norm())
        if not momentum > 0:
            raise SystemExit(f"{what}: the momentum did not move")
        launches.update(mine)
        report[name] = {"steps": n_steps, "kernel_launches": mine, "step_ms": step_ms,
                        "step_ms_median": statistics.median(step_ms),
                        "peak_device_memory_bytes": peak, "profiled_step_wall_ms": prof_wall,
                        "profiled_device_busy_ms": busy,
                        "profiled_device_busy_share": None if busy is None else busy / prof_wall,
                        "momentum_l2": momentum, "losses": history, **compared}
    emit({"phase": "optimizers", "gpu": card, "config": "ccd_pretrain_vit_small.yaml",
          "batch": PRETRAIN_BATCH, "launches_per_step": LAUNCHES_PER_STEP, **report})
    return dict(launches)


def remat_phase(card: str) -> dict:
    """The ViT-Small fused pretraining step with ``remat: True`` against the
    same step without it, from the same state and draws (drop path 0.1):
    losses, and the student blocks' AdamW first moments (0.1 x the clipped
    gradients), within TOL_REMAT_*, the generators in the same state afterwards, K1-fwd
    LAUNCHES_PER_STEP_REMAT a step (each student block's forward runs again
    in the backward, through the kernel), and the peak device memory and
    time (and busy time, under the profiler) of a step with and without
    remat. Returns the remat steps' launches (the profiled step's left out)."""
    raw, masks = pretrain_inputs(PRETRAIN_BATCH, seed=765)
    runs = {}
    for remat in (False, True):
        config, state = vit_small_pretrain_state(remat=remat)
        step = make_fused_pretrain_step(gt_mask_epochs=30,
                                        **pretrain_schedule(config, PRETRAIN_BATCH))
        want = LAUNCHES_PER_STEP_REMAT if remat else LAUNCHES_PER_STEP
        what = f"pretrain step, remat {remat}"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        first, made, _ = run_pretrain_step(step, state, raw, masks, what)
        peak = torch.cuda.max_memory_allocated() - base
        moments = {n: m.detach().clone()
                   for (n, _), m in zip(state.student.named_parameters(), state.opt_state.mu)}
        gens = (state.generator.get_state(), state.aug_generator.get_state())
        timed = [run_pretrain_step(step, state, raw, masks, what) for _ in range(REMAT_TIMED_STEPS)]
        launches = kernel_counts()
        prof_wall, busy, _, _ = device_busy(lambda: step(state, raw, masks))
        if made != due(want, made) or any(m != due(want, m) for _, m, _ in timed):
            raise SystemExit(f"{what}: launched {[made] + [m for _, m, _ in timed]}, expected "
                             f"{want} a step")
        runs[remat] = {"first": first, "moments": moments, "generators": gens,
                       "peak_step_bytes": peak, "launches": launches,
                       "profiled": {"step_wall_ms": prof_wall, "device_busy_ms": busy},
                       "step_ms": [ms for _, _, ms in timed],
                       "losses": [first] + [m for m, _, _ in timed]}
        del state, step
    plain, remat = runs[False], runs[True]
    loss_rel = {k: abs(remat["first"][k] - plain["first"][k]) / abs(plain["first"][k])
                for k in ("loss", "mask_loss", "dino_loss")}

    def rel_l2(keep):
        names = [n for n in plain["moments"] if keep(n)]
        mu, mu_plain = (torch.cat([remat["moments"][n].flatten() for n in names]),
                        torch.cat([plain["moments"][n].flatten() for n in names]))
        return float((mu - mu_plain).norm() / mu_plain.norm()), float((mu - mu_plain).abs().max())

    # the blocks that remat recomputes, on their own: in the whole model's
    # norm the heads' moments dwarf theirs
    grad_rel, grad_max_abs = rel_l2(lambda n: n.startswith(REMAT_BLOCKS))
    grad_rel_all, _ = rel_l2(lambda n: True)
    same_draws = all(torch.equal(a, b) for a, b in zip(remat["generators"], plain["generators"]))
    emit({"phase": "remat", "gpu": card, "config": "ccd_pretrain_vit_small.yaml, remat True",
          "batch": PRETRAIN_BATCH, "drop_path_rate": 0.1,
          "launches_per_step": LAUNCHES_PER_STEP_REMAT,
          "kernel_launches": remat["launches"],
          "first_step_loss_rel_diff": loss_rel, "tol_loss_rel": TOL_REMAT_LOSS_REL,
          "first_step_blocks_grad_rel_l2_diff": grad_rel, "tol_grad_rel": TOL_REMAT_GRAD_REL,
          "first_step_blocks_grad_max_abs_diff": grad_max_abs,
          "first_step_grad_rel_l2_diff": grad_rel_all,
          "generators_equal_after_step": same_draws,
          "peak_step_bytes": {"remat": remat["peak_step_bytes"],
                              "no_remat": plain["peak_step_bytes"]},
          "step_ms_median": {"remat": statistics.median(remat["step_ms"]),
                             "no_remat": statistics.median(plain["step_ms"])},
          "step_ms": {"remat": remat["step_ms"], "no_remat": plain["step_ms"]},
          "profiled_step": {"remat": remat["profiled"], "no_remat": plain["profiled"]},
          "losses": {"remat": remat["losses"], "no_remat": plain["losses"]}})
    if not max(loss_rel.values()) <= TOL_REMAT_LOSS_REL or not grad_rel <= TOL_REMAT_GRAD_REL:
        raise SystemExit(f"remat: the step differs from the step without remat: losses "
                         f"{loss_rel}, the blocks' gradients {grad_rel} in L2")
    if not same_draws:
        raise SystemExit("remat: the generators end in another state than without remat")
    if not remat["peak_step_bytes"] < plain["peak_step_bytes"]:
        raise SystemExit(f"remat: the step's peak {remat['peak_step_bytes']} is not below "
                         f"{plain['peak_step_bytes']} without remat")
    return remat["launches"]


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def nccl_world_of_one():
    """A one-process NCCL group over a TCP store on 127.0.0.1 at a free port:
    the group ``torchrun --nproc_per_node 1`` gives the CLIs, made in this
    process."""
    torch.distributed.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                                         world_size=1, rank=0)
    return torch.distributed.group.WORLD


def steps_with_and_without_group(what: str, run, group_step, lone_step, state, twin, moments,
                                  launches_per_step: dict) -> dict:
    """DP_STEPS steps through the group from ``state`` and DP_STEPS from its
    copy ``twin`` without one, in turns, on the same input (``run(step,
    st)`` -> (losses, launches, ms)): the group's launches and collectives
    (counted over its steps alone), the losses and the first moments held to the
    steps without the group at the step-against-step tolerances, each
    side's ms, and one more step of each under the profiler: busy ms and the
    collectives' kernels."""
    reset_collective_counts()
    launches = collections.Counter()
    grouped, grouped_ms, lone, lone_ms = [], [], [], []
    for _ in range(DP_STEPS):
        losses, made, ms = run(group_step, state)
        if made != due(launches_per_step, made):
            raise SystemExit(f"{what}: a step through the group launched {made}, expected "
                             f"{launches_per_step}")
        launches.update(made)
        grouped.append(losses)
        grouped_ms.append(ms)
        losses, _, ms = run(lone_step, twin)
        lone.append(losses)
        lone_ms.append(ms)
    launches, collectives = dict(launches), collective_counts()
    loss_rel = max(abs(a - b) / abs(b) for g, l in zip(grouped, lone) for a, b in zip(g, l))
    mu = torch.cat([t.float().flatten() for t in moments(state)])
    mu_lone = torch.cat([t.float().flatten() for t in moments(twin)])
    grad_rel = float((mu - mu_lone).norm() / mu_lone.norm())
    if not loss_rel <= TOL_STEP_LOSS_REL or not grad_rel <= TOL_STEP_GRAD_REL:
        raise SystemExit(f"{what}: the steps through the group and without it differ: losses "
                         f"{loss_rel} (tol {TOL_STEP_LOSS_REL}), first moments {grad_rel} in "
                         f"L2 (tol {TOL_STEP_GRAD_REL})")
    wall_g, rows_g = profiled_kernels(lambda: run(group_step, state))
    wall_l, rows_l = profiled_kernels(lambda: run(lone_step, twin))
    nccl = [{"kernel": k[:80], "ms": ms, "calls": n} for ms, n, k in rows_g
            if "nccl" in k.lower()]
    per_step = {k: {"calls": v["calls"] / DP_STEPS, "bytes": v["bytes"] / DP_STEPS}
                for k, v in sorted(collectives.items())}
    return {"steps": DP_STEPS, "kernel_launches": launches, "losses_with_group": grouped,
            "losses_without_group": lone, "loss_rel_diff": loss_rel,
            "first_moment_rel_l2_diff": grad_rel, "tol_step_loss_rel": TOL_STEP_LOSS_REL,
            "tol_step_grad_rel": TOL_STEP_GRAD_REL,
            "step_ms_with_group": grouped_ms, "step_ms_without_group": lone_ms,
            "step_ms_median_with_group": statistics.median(grouped_ms[1:]),
            "step_ms_median_without_group": statistics.median(lone_ms[1:]),
            "profiled_step_wall_ms": {"with_group": wall_g, "without_group": wall_l},
            "profiled_device_busy_ms": {"with_group": sum(r[0] for r in rows_g),
                                        "without_group": sum(r[0] for r in rows_l)},
            "collectives_per_step": per_step,
            "collective_bytes_per_step": sum(v["bytes"] for v in per_step.values()),
            "nccl_kernels_profiled_step": nccl,
            "nccl_device_ms_profiled_step": sum(r["ms"] for r in nccl) if nccl else None}


def data_parallel_phase(card: str) -> dict:
    """Data parallelism at world size 1 (the card machine has one GPU): the
    full-width ViT-Small pretraining step (``ccd_pretrain_vit_small.yaml``,
    batch 64, ``out_dim`` 65536, bf16, severity 5) and the finetune step
    (``ccd_finetune_ard.yaml``, batch 288) through a one-process NCCL group,
    each beside the same step without a group from one state and one input.
    (The CLIs run under torchrun in the train_cli and train_finetune_cli
    phases.) Returns the kernels' launches of the steps through the group."""
    t0 = time.time()
    group = nccl_world_of_one()
    try:
        config, state = vit_small_pretrain_state()
        twin = pretrain_twin(state)
        raw, masks = pretrain_inputs(PRETRAIN_BATCH, seed=987)
        schedule = pretrain_schedule(config, PRETRAIN_BATCH)

        def run(step, st):
            m, made, ms = run_pretrain_step(step, st, raw, masks, "data_parallel pretrain")
            return [m[k] for k in ("loss", "mask_loss", "dino_loss")], made, ms

        pretrain = steps_with_and_without_group(
            "data_parallel pretrain", run,
            make_fused_pretrain_step(gt_mask_epochs=30, group=group, **schedule),
            make_fused_pretrain_step(gt_mask_epochs=30, **schedule), state, twin,
            optimizer_moments, LAUNCHES_PER_STEP)
        del state, twin
        torch.cuda.empty_cache()

        ft_config = Config(CONFIG)
        model, _ = build_recognizer(ft_config, device="cuda",
                                    generator=torch.Generator().manual_seed(SEED))
        ft_state = init_finetune_state(model, seed=SEED)
        ft_twin = FinetuneState(model=copy.deepcopy(model),
                                opt_state=copy.deepcopy(ft_state.opt_state), iteration=0,
                                generator=torch.Generator(device="cuda"),
                                aug_generator=torch.Generator(device="cuda"))
        ft_twin.generator.set_state(ft_state.generator.get_state())
        ft_twin.aug_generator.set_state(ft_state.aug_generator.get_state())
        raw_ft, targets = finetune_inputs(BATCH, seed=987,
                                          max_seq_len=ft_config.decoder_max_seq_len)
        ft_schedule = dict(aug_fn=supervised_augment, base_lr=float(ft_config.lr),
                           min_lr=float(ft_config.min_lr), total_iters=1000, warmup_iters=3,
                           weight_decay=float(ft_config.weight_decay),
                           clip_grad=ft_config.clip_grad)

        def run_ft(step, st):
            loss, made, ms = run_finetune_step(step, st, raw_ft, targets, "data_parallel finetune")
            return [loss], made, ms

        finetune = steps_with_and_without_group(
            "data_parallel finetune", run_ft,
            make_fused_finetune_step(group=group, **ft_schedule),
            make_fused_finetune_step(**ft_schedule), ft_state, ft_twin,
            lambda st: st.opt_state.mu, FT_LAUNCHES_PER_STEP)
        del model, ft_state, ft_twin
        torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()
    emit({"phase": "data_parallel", "gpu": card, "world_size": 1, "backend": "nccl",
          "pretrain": dict(pretrain, config="ccd_pretrain_vit_small.yaml",
                           batch=PRETRAIN_BATCH),
          "finetune": dict(finetune, config="ccd_finetune_ard.yaml", batch=BATCH),
          "seconds": time.time() - t0})
    return {"data_parallel_pretrain": pretrain["kernel_launches"],
            "data_parallel_finetune": finetune["kernel_launches"]}



def tensor_parallel_schedule(config) -> dict:
    """:func:`pretrain_schedule` with the last layer unfrozen from the first
    step, so that the sharded ``weight_v`` moves in the compared steps."""
    return dict(pretrain_schedule(config, PRETRAIN_BATCH), freeze_last_layer=0)


def tensor_parallel_worker(rank: int, work_dir: str, port: int) -> None:
    """One of TP_WORLD processes of the ``tensor_parallel`` phase, all on
    ``cuda:0``: joins a gloo group itself (each process sees ``LOCAL_RANK``
    0), then runs the port as one process per GPU would. The ViT-Small step
    at ``mesh.model_parallel`` TP_WORLD from the weights and raw batches the
    phase wrote (``shared.pt``), TP_STEPS steps and one more under the
    profiler; then the ``train`` CLI at TP_CLI_ITERS and resumed to
    TP_CLI_RESUMED_ITERS. Writes ``rank<r>.json`` (and, rank 0, the gathered
    ``weight_v`` and centre) into ``work_dir``."""
    import hashlib
    import logging

    from ccd_tpu_torch.cli import train

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(TP_WORLD), LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE=str(TP_WORLD), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                         world_size=TP_WORLD, rank=rank)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.time()
        device, _ = init_distributed(torch.device("cuda"))
        layout = pretrain_mesh(None, TP_WORLD)
        shared = torch.load(os.path.join(work_dir, "shared.pt"), weights_only=True)
        config, state = vit_small_pretrain_state()
        # every rank loads the same weights (the CLI runs below broadcast rank 0's)
        state.student.load_state_dict(shared["student"])
        state.teacher.load_state_dict(shared["teacher"])
        shard_pretrain_state(state, layout)
        step = make_fused_pretrain_step(gt_mask_epochs=30, group=layout,
                                        **tensor_parallel_schedule(config))
        raws = [r.to(device) for r in shared["raw"]]
        masks = [m.to(device) for m in shared["masks"]]
        reset_kernel_counts()
        reset_collective_counts()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        for raw, mask in zip(raws[:TP_STEPS], masks[:TP_STEPS]):
            metrics, _, ms = run_pretrain_step(step, state, raw, mask, "tensor_parallel")
            losses.append([metrics[k] for k in ("loss", "mask_loss", "dino_loss")])
            step_ms.append(ms)
        launches = kernel_counts()
        counts, by_group = collective_counts(), collective_counts_by_group()
        peak = torch.cuda.max_memory_allocated()
        payload = pretrain_state_payload(state, layout)
        if rank == 0:
            torch.save({"weight_v": payload["student"]["head.last_layer.weight_v"].float().cpu(),
                        "center": payload["center"].float().cpu()},
                       os.path.join(work_dir, "gathered.pt"))
        del payload
        digests = {n: hashlib.sha256(p.detach().float().cpu().numpy().tobytes()).hexdigest()
                   for who, model in (("student", state.student), ("teacher", state.teacher))
                   for n, p in [(f"{who}.{k}", v) for k, v in model.named_parameters()]
                   if n.split(".", 1)[1] not in SHARDED_PARAMETERS}
        # one more step, rank 0's under the profiler (the other rank's beside it)
        last = lambda: step(state, raws[TP_STEPS], masks[TP_STEPS])
        wall, busy, top = (device_busy(last)[:3] if rank == 0 else (None, None, None))
        if rank != 0:
            last()
            torch.cuda.synchronize()
        del state, step, last
        torch.cuda.empty_cache()

        steps_s = time.time() - t0
        # ---- the train CLI at model_parallel TP_WORLD: a run and its resume
        # (without TensorBoard, which the train_cli phase reads back)
        import ccd_tpu_torch.utils.logging as port_logging
        port_logging.summary_writer = lambda name: None
        records = []
        handler = logging.Handler()
        handler.emit = lambda record: records.append(record.getMessage())
        logging.getLogger().addHandler(handler)
        logging.getLogger().setLevel(logging.INFO)
        os.chdir(os.path.join(work_dir, "cli"))
        cli = []
        for max_iters in (TP_CLI_ITERS, TP_CLI_RESUMED_ITERS):
            t0 = time.time()
            out = train.main(["-c", os.path.join(work_dir, "pretrain_mp2.yaml"),
                              "--synthetic", str(TP_CLI_WORDS), "--max_iters", str(max_iters)])
            cli.append({"iteration": out["iteration"], "checkpoint": out["checkpoint"],
                        "last": out["last"], "seconds": time.time() - t0})
        logging.getLogger().removeHandler(handler)
        result = {"rank": rank, "layout": [layout.data_index, layout.model_index,
                                           layout.data_size, layout.model_size],
                  "backend": torch.distributed.get_backend(), "losses": losses,
                  "step_ms": step_ms, "kernel_launches": launches,
                  "collectives_per_step": {k: {"calls": v["calls"] / TP_STEPS,
                                               "bytes": v["bytes"] / TP_STEPS}
                                           for k, v in sorted(counts.items())},
                  "collectives_per_step_by_group": {
                      k: {"calls": v["calls"] / TP_STEPS, "bytes": v["bytes"] / TP_STEPS}
                      for k, v in sorted(by_group.items())},
                  "peak_device_memory_bytes": peak, "replicated_digests": digests,
                  "profiled_step_wall_ms": wall, "profiled_device_busy_ms": busy,
                  "profiled_top_kernels": top, "cli": cli, "steps_seconds": steps_s,
                  "cli_logged_layout": any(TP_LINE in r for r in records),
                  "cli_resumed": any(f"resuming from checkpoint step {TP_CLI_ITERS}" in r
                                     for r in records)}
        with open(os.path.join(work_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        torch.distributed.destroy_process_group()


def tensor_parallel_phase(card: str) -> dict:
    """Tensor parallelism of the DINO head (``mesh.model_parallel`` 2) on
    the card: the ViT-Small pretraining step (batch 64, ``out_dim`` 65536 as
    2 x 32768 columns, bf16, severity 5) in TP_WORLD processes sharing
    ``cuda:0`` over gloo (the card machine has one GPU, and NCCL refuses two
    ranks on one device), TP_STEPS steps from the weights and raw batches of
    the same steps run here in one process (the last layer unfrozen, so
    that its shards move): each step's losses held at TOL_STEP_LOSS_REL, the
    gathered ``weight_v`` and centre after them at TOL_STEP_GRAD_REL (both
    accumulate three steps of bf16 logits that the two layouts' head
    products, 65536 and 32768 columns wide, round apart), the replicated
    parameters bit for bit equal on both ranks, K1-fwd/K1-bwd/K3 launched as one process
    launches them and no K2 (the plain CE chain over the shards), the
    collectives of a step, step and busy ms, each rank's peak; then the
    ``train`` CLI at model_parallel 2 in both processes (a run and its
    resume) and here in one process resuming its checkpoint. Returns the
    launches of both runs."""
    import yaml

    from ccd_tpu_torch.cli import train

    t0 = time.time()
    work = tempfile.mkdtemp(prefix="ccd_chip_smoke_tp_")
    procs = []
    try:
        # ---- one process: the same steps, from the same weights and batches
        config, state = vit_small_pretrain_state()
        weight_v0 = state.student.head.last_layer.weight_v.detach().float().clone()
        inputs = [pretrain_inputs(PRETRAIN_BATCH, seed=4000 + i) for i in range(TP_STEPS + 1)]
        torch.save({"student": state.student.state_dict(), "teacher": state.teacher.state_dict(),
                    "raw": [r.cpu() for r, _ in inputs], "masks": [m.cpu() for _, m in inputs]},
                   os.path.join(work, "shared.pt"))
        with open(PRETRAIN_CONFIG) as f:
            cfg = yaml.safe_load(f)
        cfg["training"].update(steps_per_dispatch=2, show_iters=2)
        cfg["dataset"]["num_workers"] = 2
        for mp in (TP_WORLD, 1):
            cfg["mesh"] = dict(cfg.get("mesh") or {}, model_parallel=mp)
            with open(os.path.join(work, f"pretrain_mp{mp}.yaml"), "w") as f:
                yaml.safe_dump(cfg, f)
        os.makedirs(os.path.join(work, "cli"))
        step = make_fused_pretrain_step(gt_mask_epochs=30, **tensor_parallel_schedule(config))
        reset_kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        one_losses, one_ms = [], []
        for raw, mask in inputs[:TP_STEPS]:
            metrics, _, ms = run_pretrain_step(step, state, raw, mask,
                                               "tensor_parallel one process")
            one_losses.append([metrics[k] for k in ("loss", "mask_loss", "dino_loss")])
            one_ms.append(ms)
        one_launches = kernel_counts()
        one_peak = torch.cuda.max_memory_allocated()
        if one_launches != due(LAUNCHES_PER_STEP, one_launches, TP_STEPS):
            raise SystemExit(f"tensor_parallel: the one-process steps launched {one_launches}")
        weight_v = state.student.head.last_layer.weight_v.detach().float().clone()
        center = state.center.detach().float().clone()
        one_wall, one_busy, _, _ = device_busy(lambda: step(state, *inputs[TP_STEPS]))
        del state, step, inputs
        torch.cuda.empty_cache()

        # ---- TP_WORLD processes on this card, model_parallel TP_WORLD
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), TP_WORKER_FLAG,
                                   str(r), work, str(port)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(TP_WORLD)]
        logs = [p.communicate(timeout=600)[0] for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise SystemExit(f"tensor_parallel: worker {r} exited with {p.returncode}:\n"
                                 f"{log[-4000:]}")
        ranks = []
        for r in range(TP_WORLD):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        gathered = torch.load(os.path.join(work, "gathered.pt"), weights_only=True)

        # ---- one process resumes the model_parallel 2 checkpoint
        records = []
        import logging
        handler = logging.Handler()
        handler.emit = lambda record: records.append(record.getMessage())
        logging.getLogger().addHandler(handler)
        logging.getLogger().setLevel(logging.INFO)
        cwd = os.getcwd()
        os.chdir(os.path.join(work, "cli"))
        try:
            t_cli = time.time()
            final = train.main(["-c", os.path.join(work, "pretrain_mp1.yaml"), "--synthetic",
                                str(TP_CLI_WORDS), "--max_iters", str(TP_CLI_FINAL_ITERS)])
            final_s = time.time() - t_cli
        finally:
            os.chdir(cwd)
            logging.getLogger().removeHandler(handler)
        resumed_in_one = any(f"resuming from checkpoint step {TP_CLI_RESUMED_ITERS}" in r
                             for r in records)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)

    # ---- the gates
    rank0 = ranks[0]
    want = dict(LAUNCHES_PER_STEP, **{"K2-fwd": 0, "K2-bwd": 0})
    loss_rel = max(abs(a - b) / abs(b) for r in ranks for got, ref in zip(r["losses"], one_losses)
                   for a, b in zip(got, ref))
    weight_v_rel = float((gathered["weight_v"] - weight_v.cpu()).norm() / weight_v.norm())
    moved = float((weight_v - weight_v0).norm() / weight_v0.norm())
    center_rel = float((gathered["center"] - center.cpu()).norm() / center.norm())
    problems = []
    if [r["layout"] for r in ranks] != [[0, i, 1, TP_WORLD] for i in range(TP_WORLD)]:
        problems.append(f"layouts {[r['layout'] for r in ranks]}")
    if any(r["kernel_launches"] != due(want, r["kernel_launches"], TP_STEPS) for r in ranks):
        problems.append(f"launches {[r['kernel_launches'] for r in ranks]}, expected {want} "
                        f"a step")
    if not loss_rel <= TOL_STEP_LOSS_REL:
        problems.append(f"losses differ from one process's by {loss_rel}")
    if not weight_v_rel <= TOL_STEP_GRAD_REL or not center_rel <= TOL_STEP_GRAD_REL \
            or not moved > 0:
        problems.append(f"gathered weight_v / centre differ by {weight_v_rel} / {center_rel} "
                        f"(weight_v moved {moved})")
    if any(r["replicated_digests"] != rank0["replicated_digests"] for r in ranks):
        problems.append("the replicated parameters differ between the ranks")
    cli = [r["cli"] for r in ranks]
    if any([c["iteration"] for c in runs] != [TP_CLI_ITERS, TP_CLI_RESUMED_ITERS]
           or not all(np.isfinite(c["last"]["loss"]) for c in runs) for runs in cli) \
            or not all(r["cli_logged_layout"] and r["cli_resumed"] for r in ranks):
        problems.append(f"train CLI at model_parallel {TP_WORLD}: {cli}, logged layout "
                        f"{[r['cli_logged_layout'] for r in ranks]}, resumed "
                        f"{[r['cli_resumed'] for r in ranks]}")
    if final["iteration"] != TP_CLI_FINAL_ITERS or not resumed_in_one \
            or not np.isfinite(final["last"]["loss"]):
        problems.append(f"the one-process resume of the model_parallel {TP_WORLD} checkpoint: "
                        f"{final}, resumed {resumed_in_one}")
    emit({"phase": "tensor_parallel", "gpu": card, "config": "ccd_pretrain_vit_small.yaml",
          "problems": problems,
          "batch": PRETRAIN_BATCH, "out_dim": int(weight_v.shape[0]),
          "columns_per_rank": int(weight_v.shape[0]) // TP_WORLD, "world": TP_WORLD,
          "backend": rank0["backend"], "processes_on_one_gpu": TP_WORLD, "steps": TP_STEPS,
          "losses_model_parallel_2": [r["losses"] for r in ranks],
          "losses_one_process": one_losses, "loss_rel_diff": loss_rel,
          "tol_step_loss_rel": TOL_STEP_LOSS_REL,
          "gathered_weight_v_rel_l2_diff": weight_v_rel, "tol_step_grad_rel": TOL_STEP_GRAD_REL,
          "gathered_center_rel_l2_diff": center_rel, "weight_v_moved_rel_l2": moved,
          "replicated_parameters_bit_equal": True,
          "replicated_parameters": len(rank0["replicated_digests"]),
          "kernel_launches_per_rank": [r["kernel_launches"] for r in ranks],
          "kernel_launches_one_process": one_launches,
          "collectives_per_step": rank0["collectives_per_step"],
          "collectives_per_step_by_group": rank0["collectives_per_step_by_group"],
          "collective_bytes_per_step": sum(v["bytes"]
                                          for v in rank0["collectives_per_step"].values()),
          "step_ms_model_parallel_2": [r["step_ms"] for r in ranks],
          "step_ms_one_process": one_ms,
          "profiled_step_wall_ms": {"model_parallel_2_rank_0": rank0["profiled_step_wall_ms"],
                                    "one_process": one_wall},
          "profiled_device_busy_ms": {"model_parallel_2_rank_0":
                                      rank0["profiled_device_busy_ms"],
                                      "one_process": one_busy},
          "profiled_top_kernels_rank_0": rank0["profiled_top_kernels"],
          "peak_device_memory_bytes": {"model_parallel_2": [r["peak_device_memory_bytes"]
                                                            for r in ranks],
                                       "one_process": one_peak},
          "train_cli": {"model_parallel_2": cli,
                        "one_process_resume": {"iteration": final["iteration"],
                                               "last": final["last"], "seconds": final_s}},
          "worker_steps_seconds": [r["steps_seconds"] for r in ranks],
          "seconds": time.time() - t0})
    if problems:
        raise SystemExit("tensor_parallel: " + "; ".join(problems))
    return {"tensor_parallel": {k: sum(r["kernel_launches"][k] for r in ranks)
                                for k in ranks[0]["kernel_launches"]},
            "tensor_parallel_one_process": one_launches}


def native_reader_phase(card: str) -> None:
    """The train CLI's synthetic LMDB (CLI_WORDS words with masks, seed 3, as
    ``--synthetic`` writes it) read key by key through the C++ reader,
    built from ``ccd_tpu_torch/native/`` at first use, and the Python one:
    every value byte for byte, a missing key None in both, and each reader's
    rate over all keys."""
    from ccd_tpu_torch.native import NativeLmdbReader, library_path, open_reader
    tmp = tempfile.mkdtemp(prefix="ccd_chip_smoke_lmdb_")
    try:
        root, mask_root = os.path.join(tmp, "training", "SYNTH"), os.path.join(tmp, "Mask")
        write_synthetic_lmdb(root, CLI_WORDS, seed=3, with_mask_lmdb=True,
                             mask_path=mask_env_path(root, mask_root))
        report = {}
        for path in (root, mask_env_path(root, mask_root)):
            native, python = open_reader(path), LmdbReader(path)
            if not isinstance(native, NativeLmdbReader):
                raise SystemExit(f"native reader: open_reader gave {type(native).__name__}")
            items = list(python.items())
            keys = [k for k, _ in items]
            t0 = time.perf_counter()
            got = [native.get(k) for k in keys]
            native_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for k in keys:
                python.get(k)
            python_s = time.perf_counter() - t0
            if got != [v for _, v in items] or native.get(b"no-such-key") is not None \
                    or python.get(b"no-such-key") is not None or len(native) != len(python):
                raise SystemExit(f"native reader: {path} differs from LmdbReader")
            report[os.path.basename(path)] = {
                "keys": len(keys), "bytes": sum(len(v) for _, v in items),
                "native_gets_per_s": len(keys) / native_s,
                "python_gets_per_s": len(keys) / python_s}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "native_reader", "gpu": card, "words": CLI_WORDS,
          "library": os.path.relpath(library_path(), os.path.dirname(PKG_DIR)),
          "byte_equal": True, "readers": report})


def last_selfattention_phase(card: str) -> int:
    """``get_last_selfattention`` of the evaluation model's ViT-Small at the
    evaluation batch (288, bf16): (B, 6, 256, 256) probabilities whose rows
    sum to 1 within TOL_ROW_SUM_BF16, equal to the last block's attention
    written out here (the other blocks through the plain versions) within
    TOL_LAST_ATTN; the first 11
    blocks launch K1-fwd. Returns the kernels' launches."""
    config = Config(CONFIG)
    model, _ = build_recognizer(config, device="cuda",
                                generator=torch.Generator().manual_seed(SEED))
    vit = model.backbone
    images, _ = pretrain_inputs(BATCH, seed=876)
    x = normalise(images)
    reset_kernel_counts()
    with torch.no_grad():
        attn = vit.get_last_selfattention(x)
    launches = kernel_counts()
    with torch.no_grad(), plain_versions_in_place_of_kernels():
        tokens = vit.prepare_tokens(x)
        for blk in vit.blocks[:-1]:
            tokens = blk(tokens)
        last = vit.blocks[-1].attn
        qkv, bias = last.qkv_unbiased(vit.blocks[-1].norm1(tokens))
        qkv = (qkv + bias).reshape(BATCH, 256, 3, last.num_heads, -1)
        logits = torch.einsum("bqhd,bkhd->bhqk", qkv[:, :, 0].float(), qkv[:, :, 1].float())
        plain = torch.softmax(logits * last.scale, dim=-1)
    row_sums = attn.float().sum(-1)
    err = float((attn.float() - plain).abs().max())
    sum_err = float((row_sums - 1).abs().max())
    want = dict.fromkeys(launches, 0)
    want["K1-fwd"] = len(vit.blocks) - 1
    want["LN-fwd"] = 2 * len(vit.blocks)  # the last block's second norm runs too, no final one
    emit({"phase": "main_path", "path": "last_selfattention", "gpu": card,
          "config": "ccd_finetune_ard.yaml backbone", "batch": BATCH,
          "shape": list(attn.shape), "dtype": str(attn.dtype).replace("torch.", ""),
          "max_abs_err_vs_plain": err, "tol": TOL_LAST_ATTN, "row_sum_max_abs_err": sum_err,
          "tol_row_sum": TOL_ROW_SUM_BF16,
          "kernel_launches": launches})
    if tuple(attn.shape) != (BATCH, last.num_heads, 256, 256) or not err <= TOL_LAST_ATTN \
            or not sum_err <= TOL_ROW_SUM_BF16 or launches != want:
        raise SystemExit(f"last_selfattention: shape {tuple(attn.shape)}, error {err}, row "
                         f"sums off by {sum_err}, launches {launches} (expected {want})")
    return launches


def convergence_short_phase(card: str) -> None:
    """``python -m ccd_tpu_torch.cli.convergence_demo`` on the card at
    ``vit_tiny``, ``out_dim`` 8192, ``--easy --no_aug``, CONV_SHORT
    iterations a phase: every phase's process exits 0; the pretrain losses
    are finite and fall; the handoff arm read the pretraining checkpoint,
    and its teacher's backbone loads into a recognizer by name, equal entry
    for entry. Both arms' accuracies are printed, not gated."""
    tmp = tempfile.mkdtemp(prefix="ccd_chip_smoke_convergence_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(PKG_DIR)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "ccd_tpu_torch.cli.convergence_demo", "--workdir", tmp,
           "--easy", "--no_aug", "--arch", "vit_tiny", "--out_dim", "8192",
           *[str(a) for kv in CONV_SHORT.items() for a in (f"--{kv[0]}", kv[1])]]
    try:
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True,
                              timeout=900)
        wall = time.time() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise SystemExit(f"convergence demo exited with {proc.returncode}:\n{log[-4000:]}")
        with open(os.path.join(tmp, "CONVERGENCE.json")) as f:
            summary = json.load(f)
        with open(os.path.join(tmp, "conv_ft_handoff.log")) as f:
            handoff_log = f.read()
        with open(os.path.join(tmp, "pretrain.log")) as f:
            reader = "LMDB reader: native" in f.read()
        losses = [loss for _, loss in summary["pretrain"]["loss_curve"]]
        ckpt_dir = os.path.join(tmp, "saved_models", "conv_pretrain")
        config = Config(os.path.join(tmp, "configs", "conv_ft_handoff.yaml"))
        model, _ = build_recognizer(config, device="cpu")
        load_pretrained_backbone(ckpt_dir, model)
        manager = CheckpointManager(ckpt_dir)
        teacher = torch.load(manager.path(manager.latest_step()), map_location="cpu",
                             weights_only=True)["teacher"]
        by_name = all(torch.equal(v, teacher[f"backbone.{k}"])
                      for k, v in model.backbone.state_dict().items())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "convergence_short", "gpu": card, "arch": "vit_tiny", "out_dim": 8192,
          "flags": "--easy --no_aug", **CONV_SHORT, "process_wall_s": wall,
          "wall_s": summary["wall_s"], "pretrain_loss_curve": summary["pretrain"]["loss_curve"],
          "handoff": summary["handoff"], "scratch": summary["scratch"],
          "pretrain_reader_native": reader,
          "debug_decode_greedy_correct": {arm: d["greedy_correct"]
                                          for arm, d in summary["debug_decode"].items()},
          "teacher_backbone_loaded_by_name": by_name})
    if len(losses) < 2 or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise SystemExit(f"convergence_short: pretrain losses {losses} are not finite and "
                         "falling")
    if "Read pretrain vision model from" not in handoff_log or not by_name or not reader:
        raise SystemExit("convergence_short: the handoff did not load the teacher backbone by "
                         "name, or the pretraining did not read through the native reader")


PRETRAIN_TAGS = {f"metric/{k}" for k in ("loss", "mask_loss", "dino_loss", "lr", "wd",
                                          "cluster_rounds")}
FINETUNE_TAGS = {"metric/train_loss", "metric/lr", "metric/eval_acc", "Mask/Input_image",
                 "Mask/vis_Maps"}


def tensorboard_report(log_dir: str, log: str, want: set) -> dict:
    """Whether a CLI made its TensorBoard writer (it logs the directory, or
    why there is none) and, where it did, the tags of its event files as
    TensorBoard reads them: those of the JAX CLI (the pretraining CLI adds
    ``metric/cluster_rounds``), or the run fails. Without
    ``tensorboard`` on the machine the CLI trains without a writer, as the
    JAX CLI does: reported, not a failure."""
    if "TensorBoard: writing" not in log:
        reason = [ln for ln in log.splitlines() if "no TensorBoard writer" in ln]
        return {"writer": False, "reason": reason[0][-300:] if reason else None}
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    events = EventAccumulator(log_dir)
    events.Reload()
    tags = events.Tags()
    found = set(tags["scalars"]) | set(tags["images"])
    if found != want:
        raise SystemExit(f"TensorBoard under {log_dir}: tags {sorted(found)}, expected "
                         f"{sorted(want)}")
    return {"writer": True, "tags": sorted(found),
            "event_files": len([f for f in os.listdir(log_dir) if "tfevents" in f])}


def train_cli_phase(card: str, keep_dir: str) -> str:
    """``ccd_tpu_torch.cli.train`` on the full ViT-Small pretraining
    configuration over a synthetic LMDB of rendered words with masks (written
    by the CLI's ``--synthetic`` into a temporary directory): under torchrun
    (one process over NCCL, the data-parallel path), CLI_ITERS iterations
    (dispatches of 8) and a checkpoint written by rank 0, then a second run
    that resumes from it and goes on to CLI_RESUMED_ITERS; then, in a
    directory of its own and as one plain process (``python -m``),
    CLI_RESUMED_ITERS iterations with 2 loader threads instead of the
    configuration's 16 (the threads share the interpreter lock with the
    loop that issues the step's launches). The configuration is the shipped
    one but for ``show_iters`` = 8, so that each dispatch is logged and
    checked for a NaN loss. Each run's rate after its first dispatch comes
    from the log's timestamps. The resumed run's last checkpoint is moved
    into ``keep_dir``; returns its path."""
    import re
    from datetime import datetime

    import yaml
    with open(PRETRAIN_CONFIG) as f:
        cfg = yaml.safe_load(f)
    k = int(cfg["training"]["steps_per_dispatch"])
    cfg["training"]["show_iters"] = k
    batch = int(cfg["batch_size_per_gpu"])
    tmp = tempfile.mkdtemp(prefix="ccd_chip_smoke_cli_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(PKG_DIR)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    logged_line = re.compile(r"\[(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) [^\]]*\] "
                             r"it (\d+) epoch \d+ loss (\S+) \(mask")
    runs = []
    try:
        for workers, max_iters, resumes, launcher in (
                (None, CLI_ITERS, False, TORCHRUN), (None, CLI_RESUMED_ITERS, True, TORCHRUN),
                (2, CLI_RESUMED_ITERS, False, [sys.executable])):
            run_dir = os.path.join(tmp, f"loader_threads_{workers or 'as_configured'}")
            os.makedirs(run_dir, exist_ok=True)
            run_cfg = copy.deepcopy(cfg)
            if workers:
                run_cfg["dataset"]["num_workers"] = workers
            cfg_path = os.path.join(run_dir, "pretrain_vit_small.yaml")
            with open(cfg_path, "w") as f:
                yaml.safe_dump(run_cfg, f)
            cmd = launcher + ["-m", "ccd_tpu_torch.cli.train", "-c", cfg_path,
                              "--synthetic", str(CLI_WORDS), "--max_iters", str(max_iters)]
            t0 = time.time()
            proc = subprocess.run(cmd, cwd=run_dir, env=env, capture_output=True, text=True,
                                  timeout=600)
            wall = time.time() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise SystemExit(f"train CLI exited with {proc.returncode}:\n{log[-4000:]}")
            rate = re.search(r"\(([0-9.]+) img/s with data loading\)", log)
            logged = [(datetime.strptime(t, "%Y-%m-%d %H:%M:%S,%f"), int(it), float(loss))
                      for t, it, loss in logged_line.findall(log)]
            ckpt = os.path.join(run_dir, "saved_models", cfg["global"]["name"],
                                f"ckpt_{max_iters:08d}.pt")
            resumed = f"resuming from checkpoint step {CLI_ITERS}" in log
            reader = re.search(r"LMDB reader: (\w+)", log)
            if rate is None or len(logged) < 2 or not all(np.isfinite([x[2] for x in logged])) \
                    or not os.path.isfile(ckpt) or resumed != resumes:
                raise SystemExit(f"train CLI to {max_iters}: no rate, a non-finite loss, no "
                                 f"checkpoint or a wrong resume ({resumed}):\n{log[-4000:]}")
            if reader is None or reader.group(1) != "native":
                raise SystemExit(f"train CLI: the dataset did not read through the native "
                                 f"LMDB reader ({reader and reader.group(0)}):\n{log[-4000:]}")
            torchrun = launcher is TORCHRUN
            world = torch.load(ckpt, map_location="cpu", weights_only=True)["world_size"]
            if (TORCHRUN_LINE in log) != torchrun or world != 1:
                raise SystemExit(f"train CLI: launched by {'torchrun' if torchrun else 'python'}"
                                 f" but its log and checkpoint (world size {world}) say "
                                 f"otherwise:\n{log[-4000:]}")
            (t_first, it_first, _), (t_last, it_last, _) = logged[0], logged[-1]
            runs.append({"launcher": "torchrun --nproc_per_node 1" if torchrun else "python",
                         "loader_threads": workers or int(cfg["dataset"]["num_workers"]),
                         "lmdb_reader": reader.group(1),
                         "tensorboard": tensorboard_report(
                             os.path.join(run_dir, "tensorboard", cfg["global"]["name"]), log,
                             PRETRAIN_TAGS),
                         "max_iters": max_iters, "resumed_from": CLI_ITERS if resumed else 0,
                         "images_per_s_with_loading": float(rate.group(1)),
                         "images_per_s_with_loading_after_first_dispatch":
                             batch * (it_last - it_first) / (t_last - t_first).total_seconds(),
                         "logged_losses": [x[2] for x in logged], "process_wall_s": wall,
                         "checkpoint": os.path.basename(ckpt)})
            if resumes:  # the finetune CLI starts from this run's teacher
                kept = os.path.join(keep_dir, "pretrain_" + os.path.basename(ckpt))
                os.replace(ckpt, kept)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "train_cli", "gpu": card, "config": "ccd_pretrain_vit_small.yaml",
          "words": CLI_WORDS, "batch": batch, "steps_per_dispatch": k, "runs": runs})
    return kept


def train_finetune_cli_phase(card: str, pretrain_checkpoint: str) -> dict:
    """``ccd_tpu_torch.cli.train_finetune`` under torchrun (one process over
    NCCL: the data-parallel path, each evaluation through the sharded
    runner, checkpoints from rank 0) on the shipped
    ``ccd_finetune_ard.yaml`` over synthetic LMDBs (the CLI's ``--synthetic``:
    FT_CLI_WORDS training words, a quarter as many test words), its backbone
    handed over from ``pretrain_checkpoint`` (the ``train`` CLI's teacher):
    FT_CLI_ITERS iterations in dispatches of 8 with an evaluation every
    FT_CLI_EVAL_ITERS, a checkpoint, the best payload and the evaluation log,
    then a second run in the same directory that resumes and goes on to
    FT_CLI_RESUMED_ITERS. The configuration is the shipped one but for
    ``show_iters`` = 8, ``eval_iters`` and the pretrain checkpoint's path.
    The weights are untrained, so the accuracy is read, not judged."""
    import re

    import yaml
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    k = int(cfg["training"]["steps_per_dispatch"])
    cfg["training"].update(show_iters=k, eval_iters=FT_CLI_EVAL_ITERS)
    cfg["model"]["pretrain_checkpoint"] = pretrain_checkpoint
    batch = int(cfg["dataset"]["train"]["batch_size"])
    tmp = tempfile.mkdtemp(prefix="ccd_chip_smoke_ft_cli_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(PKG_DIR)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    runs = []
    try:
        cfg_path = os.path.join(tmp, "finetune.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        run_dir = os.path.join(cfg["output_dir"], cfg["global"]["name"])
        for max_iters, resumes in ((FT_CLI_ITERS, False), (FT_CLI_RESUMED_ITERS, True)):
            cmd = TORCHRUN + ["-m", "ccd_tpu_torch.cli.train_finetune", "-c", cfg_path,
                              "--synthetic", str(FT_CLI_WORDS), "--max_iters", str(max_iters)]
            t0 = time.time()
            proc = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True,
                                  timeout=600)
            wall = time.time() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise SystemExit(f"train_finetune CLI exited with {proc.returncode}:\n"
                                 f"{log[-4000:]}")
            rate = re.search(r"\(([0-9.]+) img/s with data loading\)", log)
            losses = [float(x) for x in re.findall(r"train loss:(\S+) ", log)]
            accuracy = [float(x) for x in re.findall(r"total_accuracy: ([0-9.]+)", log)]
            ckpt = os.path.join(tmp, run_dir, f"ckpt_{max_iters:08d}.pt")
            best = os.path.join(tmp, run_dir, "best_accuracy.pt")
            with open(os.path.join(tmp, run_dir, "log_all_evaluation.txt")) as f:
                evaluations = f.read().count("total_accuracy:")
            resumed = f"resuming mid-run from ./saved_models/{cfg['global']['name']} " \
                      f"step {FT_CLI_ITERS}" in log
            handed_over = "Read pretrain vision model from" in log
            if rate is None or len(losses) != max_iters // k - (FT_CLI_ITERS // k if resumes
                                                                 else 0) \
                    or not all(np.isfinite(losses)) or not accuracy \
                    or not os.path.isfile(ckpt) or not os.path.isfile(best) \
                    or resumed != resumes or not handed_over or TORCHRUN_LINE not in log:
                raise SystemExit(f"train_finetune CLI to {max_iters}: no rate, a missing or "
                                 f"non-finite loss, no evaluation, checkpoint or best payload, "
                                 f"a wrong resume ({resumed}), no hand-off or not rank 0 of 1:\n"
                                 f"{log[-4000:]}")
            runs.append({"tensorboard": tensorboard_report(
                             os.path.join(tmp, "tensorboard", cfg["global"]["name"]), log,
                             FINETUNE_TAGS),
                         "max_iters": max_iters, "resumed_from": FT_CLI_ITERS if resumed else 0,
                         "images_per_s_with_loading": float(rate.group(1)),
                         "logged_losses": losses, "total_accuracy_lines": accuracy,
                         "evaluations_logged_so_far": evaluations, "process_wall_s": wall,
                         "checkpoint": os.path.basename(ckpt)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result = {"phase": "train_finetune_cli", "gpu": card, "config": "ccd_finetune_ard.yaml",
              "launcher": "torchrun --nproc_per_node 1",
              "words": FT_CLI_WORDS, "test_words": FT_CLI_WORDS // 4, "batch": batch,
              "steps_per_dispatch": k, "eval_iters": FT_CLI_EVAL_ITERS,
              "pretrain_checkpoint": os.path.basename(pretrain_checkpoint), "runs": runs}
    emit(result)
    return result


def _weight_bias(*prefixes) -> list:
    return [f"{p}.{n}" for p in prefixes for n in ("weight", "bias")]


def _bn_keys(prefix: str) -> list:
    return _weight_bias(prefix) + [f"{prefix}.{n}" for n in
                                   ("running_mean", "running_var", "num_batches_tracked")]


def _vit_keys(depth: int) -> list:
    keys = ["backbone.pos_embed", "backbone.cls_token"] + _weight_bias("backbone.patch_embed.proj")
    for i in range(depth):
        keys += _weight_bias(*(f"backbone.blocks.{i}.{m}" for m in
                               ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")))
    return keys + _weight_bias("backbone.norm", *(f"backbone.norm_seg.{i}" for i in range(3)))


def reference_recognizer_keys(depth: int = 12, n_layers: int = 6) -> list:
    """The names of the reference ``DINO_Finetune`` ``state_dict``, as the
    JAX package's export writes them
    (``ccd_tpu/checkpoints/torch_export.py::export_recognizer_state_dict``),
    for a ViT of ``depth`` blocks and an NRTR of ``n_layers`` layers."""
    keys = _vit_keys(depth) + _weight_bias("encoder.fc1", "encoder.fc2")
    keys += ["decoder.trg_word_emb.weight", "decoder.position_enc.position_table"]
    for i in range(n_layers):
        p = f"decoder.layer_stack.{i}."
        keys += _weight_bias(p + "norm1", p + "norm2", p + "norm3")
        keys += [f"{p}{attn}.{lin}.weight" for attn in ("self_attn", "enc_attn")
                 for lin in ("linear_q", "linear_k", "linear_v", "fc")]
        keys += _weight_bias(p + "mlp.w_1", p + "mlp.w_2")
    return keys + _weight_bias("decoder.layer_norm", "decoder.classifier")


def reference_pretrain_keys(depth: int = 12) -> dict:
    """The names of the reference ``ABIDINOModel`` student and teacher
    ``state_dict``s, as the JAX package's export writes them
    (``export_pretrain_state_dicts``): the SegHead's BatchNorm counters and
    the never-called ``conv_mla`` filler included."""
    head = _weight_bias("head.mlp.0", "head.mlp.2", "head.mlp.4") + \
        ["head.last_layer.weight_g", "head.last_layer.weight_v"]
    seg = []
    for i in (2, 3, 4):
        p = f"segmentation.mlahead.head{i}."
        seg += [p + "0.weight", *_bn_keys(p + "1"), p + "3.weight", *_bn_keys(p + "4")]
    for j in (1, 2):
        seg += _weight_bias(f"segmentation.unpool{j}.0") + _bn_keys(f"segmentation.unpool{j}.1")
    seg += _weight_bias("segmentation.cls")
    for name in ("mla_p2_1x1", "mla_p3_1x1", "mla_p4_1x1", "mla_p2", "mla_p3", "mla_p4"):
        seg += [f"segmentation.conv_mla.{name}.0.weight",
                *_bn_keys(f"segmentation.conv_mla.{name}.1")]
    return {"student": _vit_keys(depth) + seg + head, "teacher": _vit_keys(depth) + head}


def overfit_probe_phase(card: str) -> dict:
    """``cli.overfit_probe`` in process at the JAX tool's size (PROBE_WORDS
    words, PROBE_STEPS steps): first the tool's own model (vit_micro, fp32;
    gate: finite losses and a train word accuracy of at least
    PROBE_MIN_ACCURACY), then the shipped finetune configuration at full
    width (ViT-Small + 6-layer NRTR, bf16, dropout and drop path 0.1; gate:
    finite losses, the last below the first). The attention kernels'
    launches of each run are counted: per step one forward and one backward a
    ViT block, and one forward a block for the decode. Returns the
    full-width run's result (its model in evaluation mode) and the launches
    of both runs."""
    import io
    runs, launches_total = {}, collections.Counter()
    for name, argv, blocks, dtype in (("vit_micro", [], 3, torch.float32),
                                      ("full_width", ["-c", CONFIG], 12, torch.bfloat16)):
        reset_kernel_counts()
        buffer = io.StringIO()
        with contextlib.redirect_stdout(buffer), decoder_runs() as passes:
            result = overfit_probe.main(argv + ["--n", str(PROBE_WORDS),
                                                "--steps", str(PROBE_STEPS)])
        launches = kernel_counts()
        launches_total.update(launches)
        model, losses = result["model"], result["losses"]
        vit_norms, dec_norms = recognizer_norms(model)
        want = dict.fromkeys(launches, 0)
        want.update({"K1-fwd": blocks * (PROBE_STEPS + 1), "K1-bwd": blocks * PROBE_STEPS,
                     "LN-fwd": (vit_norms + dec_norms) * PROBE_STEPS + vit_norms
                     + dec_norms * model.decoder.max_seq_len * passes[0],
                     "LN-bwd": (vit_norms + dec_norms) * PROBE_STEPS})
        if model.dtype != dtype or len(model.backbone.blocks) != blocks or launches != want:
            raise SystemExit(f"overfit_probe {name}: not the expected model ({model.dtype}, "
                             f"{len(model.backbone.blocks)} blocks) or launches {launches} "
                             f"!= {want}")
        if len(losses) != PROBE_STEPS or not all(np.isfinite(losses)):
            raise SystemExit(f"overfit_probe {name}: missing or non-finite losses {losses}")
        if name == "vit_micro" and not result["accuracy"] >= PROBE_MIN_ACCURACY:
            raise SystemExit(f"overfit_probe vit_micro: train word accuracy "
                             f"{result['correct']}/{PROBE_WORDS} < {PROBE_MIN_ACCURACY} "
                             f"(JAX, CPU: {PROBE_JAX_CPU['correct']}/{PROBE_JAX_CPU['words']}); "
                             f"losses {losses[::PROBE_LOG_EVERY]}")
        if name == "full_width" and not losses[-1] < losses[0]:
            raise SystemExit(f"overfit_probe full width: the loss did not fall: "
                             f"{losses[::PROBE_LOG_EVERY]} ... {losses[-1]}")
        full = result
        runs[name] = {
            "model": "vit_micro + 6-layer NRTR (the JAX tool's)" if name == "vit_micro"
            else "ccd_finetune_ard.yaml: vit_small + 6-layer NRTR",
            "dtype": str(dtype).replace("torch.", ""),
            "loss_every_50_steps": {str(i): losses[i] for i in
                                    list(range(0, PROBE_STEPS, PROBE_LOG_EVERY)) + [PROBE_STEPS - 1]},
            "train_word_accuracy": f"{result['correct']}/{PROBE_WORDS}",
            "accuracy": result["accuracy"],
            "ms_per_step": 1e3 * result["seconds"] / PROBE_STEPS,
            "images_per_s": PROBE_WORDS * PROBE_STEPS / result["seconds"],
            "kernel_launches": {k: v for k, v in launches.items() if v},
            "first_predictions": [{"gt": w, "pred": p} for w, p in
                                  zip(result["words"][:5], result["predictions"][:5])]}
    emit({"phase": "overfit_probe", "gpu": card, "words": PROBE_WORDS, "steps": PROBE_STEPS,
          "lr": 1e-3, "warmup_iters": 20, "clip_grad": 5.0, "runs": runs,
          "jax_cpu_vit_micro": PROBE_JAX_CPU})
    return {"result": full, "launches": dict(launches_total)}


def interchange_phase(card: str, model, pretrain_checkpoint: str, out_dir: str) -> str:
    """The full-width probe's recognizer exported in the reference's layout
    (``save_recognizer_torch``, ``module.`` prefix) and the ``train`` CLI's
    kept checkpoint exported as a reference pretraining file
    (``save_pretrain_torch``); each read back through the port's loaders
    (``load_recognizer_params``; the teacher's backbone through
    ``load_pretrained_backbone``) into a freshly built recognizer. Every tensor
    must come back bit for bit, and each file's names must be those of the
    JAX package's export at these widths (written out in this script).
    Returns the recognizer file's path."""
    rec_path = os.path.join(out_dir, "probe_recognizer_reference.pth")
    save_recognizer_torch(model, rec_path, iteration=PROBE_STEPS, module_prefix=True)
    exported = torch.load(rec_path, map_location="cpu", weights_only=True)
    want = ["module." + k for k in reference_recognizer_keys()]
    live = model.state_dict()
    fresh, _ = build_recognizer(Config(CONFIG), device="cuda",
                                generator=torch.Generator().manual_seed(SEED + 1))
    load_recognizer_params(rec_path, fresh)
    back = fresh.state_dict()
    rec_mismatch = [k for k in live if not torch.equal(back[k], live[k])
                    or not torch.equal(exported["net"]["module." + k], live[k].cpu())]
    if len(want) != REFERENCE_KEY_COUNTS["recognizer"] or sorted(exported["net"]) != sorted(want) \
            or rec_mismatch or exported["iteration"] != PROBE_STEPS:
        raise SystemExit(f"interchange: recognizer names {len(exported['net'])} (want "
                         f"{len(want)}: {sorted(set(want) ^ set(exported['net']))[:8]}) or "
                         f"tensors not bit for bit: {rec_mismatch[:8]}")

    pre_path = os.path.join(out_dir, "pretrain_reference.pth")
    payload = torch.load(pretrain_checkpoint, map_location="cpu", weights_only=True)
    save_pretrain_torch(pretrain_checkpoint, None, pre_path, iteration=payload["iteration"])
    pre = torch.load(pre_path, map_location="cpu", weights_only=True)
    want_pre = reference_pretrain_keys()
    pre_mismatch = [f"{branch}/{k}" for branch in ("student", "teacher")
                    for k, v in payload[branch].items() if not torch.equal(pre[branch][k], v)]
    handed = build_recognizer(Config(CONFIG), device="cuda",
                              generator=torch.Generator().manual_seed(SEED + 2))[0]
    load_pretrained_backbone(pre_path, handed)
    backbone = handed.backbone.state_dict()
    pre_mismatch += [f"backbone/{k}" for k, v in backbone.items()
                     if not torch.equal(v.cpu(), payload["teacher"]["backbone." + k])]
    for branch in ("student", "teacher"):
        if len(want_pre[branch]) != REFERENCE_KEY_COUNTS[branch] \
                or sorted(pre[branch]) != sorted(want_pre[branch]):
            raise SystemExit(f"interchange: {branch} names "
                             f"{sorted(set(want_pre[branch]) ^ set(pre[branch]))[:8]}")
    if pre_mismatch or len(backbone) != len(_vit_keys(12)) - 1:  # all but the cls token
        raise SystemExit(f"interchange: pretraining tensors not bit for bit: {pre_mismatch[:8]} "
                         f"({len(backbone)} backbone tensors)")
    emit({"phase": "interchange", "gpu": card,
          "recognizer": {"from": "overfit_probe full width", "names": len(exported["net"]),
                         "module_prefix": True, "bit_equal_read_back": len(live),
                         "file_mb": os.path.getsize(rec_path) / 1e6},
          "pretrain": {"from": os.path.basename(pretrain_checkpoint),
                       "iteration": int(payload["iteration"]),
                       "names": {b: len(pre[b]) for b in ("student", "teacher")},
                       "added_by_export": {b: len(pre[b]) - len(payload[b])
                                           for b in ("student", "teacher")},
                       "bit_equal_payload_tensors": sum(len(payload[b])
                                                        for b in ("student", "teacher")),
                       "teacher_backbone_tensors_handed_over": len(backbone)},
          "names_as_the_jax_export": REFERENCE_KEY_COUNTS})
    return rec_path


@contextlib.contextmanager
def recorded_predictions(texts: list, seconds: list):
    """Inside, the evaluation runner's predict functions keep the strings they
    read, in order, and each call's time (host clock; a call ends in a read
    back to the host)."""
    make = runner.make_predict_fn

    def recording_make(*args, **kwargs):
        predict = make(*args, **kwargs)

        def recording(images):
            t0 = time.time()
            out = predict(images)
            seconds.append(time.time() - t0)
            texts.extend(out)
            return out
        return recording
    runner.make_predict_fn = recording_make
    try:
        yield
    finally:
        runner.make_predict_fn = make


def write_probe_lmdb(path: str, n: int) -> list:
    """The probe's ``n`` words and images (``overfit_probe.probe_data``) as
    a reference-layout LMDB, PNG-encoded; returns the words."""
    import cv2
    words, images = overfit_probe.probe_data(n)
    with LmdbWriter(path) as writer:
        for i, (word, image) in enumerate(zip(words, images), start=1):
            ok, png = cv2.imencode(".png", cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
            if not ok:
                raise SystemExit(f"parity_eval: PNG encoding of probe image {i} failed")
            writer.put(f"image-{i:09d}".encode(), png.tobytes())
            writer.put(f"label-{i:09d}".encode(), word.encode())
        writer.put(b"num-samples", str(n).encode())
    return words


def parity_eval_phase(card: str, probe: dict, pth: str) -> int:
    """``cli.parity_eval.main`` in process on the probe's exported recognizer
    at batch 288, over two LMDBs under benchmark names: ``IIIT5k_probe``
    (the probe's words and images) and ``SVT_probe`` (PARITY_OTHER_WORDS
    other words). The baseline is a direct ``evaluate_benchmarks`` of the
    probe's model. Gates: exit 0, the weighted accuracy equal to the direct
    one, the strings read equal image by image, 12 forward attention
    launches a batch, and exit 1 with the baseline moved by PARITY_MOVED
    points. Returns the harness run's kernels' launches."""
    import io
    model = probe["result"]["model"]
    config = Config(CONFIG)
    tmp = tempfile.mkdtemp(prefix="ccd_chip_smoke_parity_")
    try:
        evaluation = os.path.join(tmp, "evaluation")
        roots = [os.path.join(evaluation, "IIIT5k_probe"), os.path.join(evaluation, "SVT_probe")]
        words = write_probe_lmdb(roots[0], PROBE_WORDS)
        if words != probe["result"]["words"]:
            raise SystemExit("parity_eval: IIIT5k_probe does not hold the probe's words")
        write_synthetic_lmdb(roots[1], PARITY_OTHER_WORDS, seed=1)
        direct_texts, direct_s = [], []
        with recorded_predictions(direct_texts, direct_s):
            results, direct = runner.evaluate_benchmarks(
                model, roots, batch_size=BATCH, max_seq_len=config.decoder_max_seq_len,
                charset_type=config.dataset_charset_type or "DICT90",
                case_sensitive=bool(config.dataset_eval_case_sensitive),
                names=["IIIT5k", "SVT"])
        baseline = {str(r["name"]): 100.0 * float(r["cwr"]) for r in results}
        files = {}
        for name, base in (("baseline", baseline),
                           ("moved", dict(baseline, IIIT5k=baseline["IIIT5k"] + PARITY_MOVED))):
            files[name] = os.path.join(tmp, f"{name}.json")
            with open(files[name], "w") as f:
                json.dump(base, f)
        argv = ["--pth", pth, "--test_root", evaluation, "-c", CONFIG,
                "--batch_size", str(BATCH)]

        def harness(baseline_file: str, texts: list, seconds: list, out=None):
            buffer = io.StringIO()
            code, returned = 0, None
            with contextlib.redirect_stdout(buffer), contextlib.redirect_stderr(buffer), \
                    recorded_predictions(texts, seconds):
                try:
                    returned = parity_eval.main(argv + ["--baseline", baseline_file] +
                                                (["--out", out] if out else []))
                except SystemExit as e:
                    code = e.code
            return code, returned, buffer.getvalue()

        texts, seconds = [], []
        artifact_path = os.path.join(tmp, "parity.json")
        reset_kernel_counts()
        t0 = time.time()
        with decoder_runs() as passes:
            code, returned, log = harness(files["baseline"], texts, seconds, artifact_path)
        wall = time.time() - t0
        launches = kernel_counts()
        n_images = PROBE_WORDS + PARITY_OTHER_WORDS
        n_batches = -(-PROBE_WORDS // BATCH) + -(-PARITY_OTHER_WORDS // BATCH)
        vit_norms, dec_norms = recognizer_norms(model)
        want = dict.fromkeys(launches, 0)
        want["K1-fwd"] = 12 * n_batches
        want["LN-fwd"] = vit_norms * n_batches + dec_norms * model.decoder.max_seq_len * passes[0]
        if code != 0 or returned is None or "PARITY OK" not in log:
            raise SystemExit(f"parity_eval: exit {code} on its own baseline:\n{log[-3000:]}")
        rows, weighted, _ok = returned
        if weighted != direct or texts != direct_texts or launches != want:
            raise SystemExit(f"parity_eval: weighted {weighted!r} vs direct {direct!r}, "
                             f"{sum(a != b for a, b in zip(texts, direct_texts))} strings "
                             f"differ, launches {launches} (want {want})")
        with open(artifact_path) as f:
            artifact = json.load(f)
        moved_code, _, moved_log = harness(files["moved"], [], [])
        if moved_code != 1 or "PARITY FAIL" not in moved_log:
            raise SystemExit(f"parity_eval: exit {moved_code} with the baseline moved by "
                             f"{PARITY_MOVED}:\n{moved_log[-3000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "parity_eval", "gpu": card, "config": "ccd_finetune_ard.yaml",
          "checkpoint": "the full-width probe's export (module. prefix)", "batch": BATCH,
          "benchmarks": {r["benchmark"]: {"words": r["words"], "word_acc_pct": r["word_acc_pct"]}
                         for r in rows},
          "weighted_acc": weighted, "direct_weighted_acc": direct, "bit_identical": True,
          "strings_equal": len(texts), "exit_code": code, "moved_baseline_exit_code": moved_code,
          "moved_by_pct": PARITY_MOVED, "artifact_device": artifact["device"],
          "kernel_launches": {"K1-fwd": launches["K1-fwd"], "LN-fwd": launches["LN-fwd"]},
          "batches": n_batches, "decoder_passes_on_the_host": passes[0],
          "images_per_s_inference": n_images / sum(seconds),
          "images_per_s_direct_inference": n_images / sum(direct_s),
          "harness_wall_s": wall, "images_per_s_harness_wall": n_images / wall})
    return launches


def kmeans_centroids_float64(gray: np.ndarray, iters: int = 16):
    """The k-means' Lloyd steps in float64 on (B, H, W): (B, 1) c0 and c1."""
    x = gray.reshape(gray.shape[0], -1).astype(np.float64)
    lo, hi = x.min(1, keepdims=True), x.max(1, keepdims=True)
    c0, c1 = lo + 0.25 * (hi - lo), lo + 0.75 * (hi - lo)
    for _ in range(iters):
        a = np.abs(x - c1) < np.abs(x - c0)
        n1 = a.sum(1, keepdims=True)
        s1 = (x * a).sum(1, keepdims=True)
        c0 = np.where(x.shape[1] - n1 > 0, (x.sum(1, keepdims=True) - s1)
                      / np.maximum(x.shape[1] - n1, 1), c0)
        c1 = np.where(n1 > 0, s1 / np.maximum(n1, 1), c1)
    return c0, c1


def generate_masks_phase(card: str) -> None:
    """``cli.generate_masks.main`` in process over the ``train`` CLI's
    synthetic LMDB (CLI_WORDS rendered words, written here by the same call
    as ``cli/train.py --synthetic``), at ``--batch`` MASK_BATCH on the card
    and once on the CPU. Gate: the two mask LMDBs equal byte for byte, or
    differing only on images whose 64 x 256 k-means masks (recomputed here,
    batched as the CLI batches them) differ on pixels at the centroids'
    midpoint (at most MASK_MAX_DIFF_SHARE of them, each within MASK_TIE_RTOL).
    ``PretrainDataset(mask=True)`` must read a non-empty mask for every sample.
    Reports masks per second, the k-means' time per batch on the card, and
    the mean IoU of the k-means masks against the rendered ground truth."""
    import io

    import cv2
    tmp = tempfile.mkdtemp(prefix="ccd_chip_smoke_masks_")
    try:
        root = os.path.join(tmp, "training", "SYNTH")
        truth_root = os.path.join(tmp, "Mask")
        write_synthetic_lmdb(root, CLI_WORDS, seed=3, with_mask_lmdb=True,
                             mask_path=mask_env_path(root, truth_root))
        mask_roots = {"cuda": os.path.join(tmp, "masks_cuda"),
                      "cpu": os.path.join(tmp, "masks_cpu")}
        walls, items = {}, {}
        for device, mask_root in mask_roots.items():
            t0 = time.time()
            with contextlib.redirect_stdout(io.StringIO()):
                written = generate_masks.main(["--src", os.path.join(tmp, "training"),
                                               "--mask_root", mask_root,
                                               "--batch", str(MASK_BATCH), "--device", device])
            walls[device] = time.time() - t0
            out = os.path.join(mask_root, "SYNTH")
            if written != {out: CLI_WORDS}:
                raise SystemExit(f"generate_masks {device}: wrote {written}")
            with LmdbReader(out) as reader:
                items[device] = dict(reader.items())
        differing_keys = sorted(k for k in items["cuda"] if items["cuda"][k] != items["cpu"].get(k))
        if sorted(items["cuda"]) != sorted(items["cpu"]) or len(items["cuda"]) != CLI_WORDS + 1:
            raise SystemExit("generate_masks: the card's and the CPU's LMDBs hold other keys")

        # the k-means as the CLI batches it, on both devices
        with LmdbReader(root) as reader:
            grays = np.stack([cv2.resize(cv2.imdecode(np.frombuffer(
                reader.get(f"image-{i:09d}".encode()), np.uint8), cv2.IMREAD_GRAYSCALE),
                (256, 64)).astype(np.float32) for i in range(1, CLI_WORDS + 1)])
        with LmdbReader(mask_env_path(root, truth_root)) as reader:
            truth = [cv2.imdecode(np.frombuffer(reader.get(f"mask-{i:09d}".encode()), np.uint8),
                                  cv2.IMREAD_GRAYSCALE) > 127 for i in range(1, CLI_WORDS + 1)]
        card_masks, cpu_masks = [], []
        for b in range(0, CLI_WORDS, MASK_BATCH):
            batch = torch.from_numpy(grays[b:b + MASK_BATCH])
            on_card = batch.cuda()
            card_masks.append(kmeans_foreground_mask(on_card).cpu().numpy())
            cpu_masks.append(kmeans_foreground_mask(batch).numpy())
        kmeans_ms = time_ms(lambda: kmeans_foreground_mask(on_card), reps=10, warmup=2)
        differ = np.concatenate(card_masks) != np.concatenate(cpu_masks)
        c0, c1 = kmeans_centroids_float64(grays)
        mid = np.broadcast_to(((c0 + c1) / 2)[:, :, None], grays.shape)
        off_midpoint = np.abs(grays - mid)[differ] > MASK_TIE_RTOL * np.abs(mid[differ])
        images_differing = {f"mask-{i + 1:09d}".encode() for i in np.nonzero(differ.any((1, 2)))[0]}
        if differ.mean() > MASK_MAX_DIFF_SHARE or off_midpoint.any() \
                or not set(differing_keys) <= images_differing:
            raise SystemExit(f"generate_masks: card and CPU masks differ on {int(differ.sum())} "
                             f"pixels ({int(off_midpoint.sum())} off the midpoint), "
                             f"{len(differing_keys)} PNGs")

        ious = []
        for i, gt in enumerate(truth):
            got = cv2.imdecode(np.frombuffer(items["cuda"][f"mask-{i + 1:09d}".encode()],
                                             np.uint8), cv2.IMREAD_GRAYSCALE) > 127
            ious.append((got & gt).sum() / max((got | gt).sum(), 1))
        ds = PretrainDataset(path=root, is_training=False, mask=True,
                             mask_path=mask_roots["cuda"])
        empty = [i for i in range(len(ds)) if not ds[i][1].sum() > 0]
        if ds.mask_env is None or len(ds) != CLI_WORDS or empty or len(truth) != CLI_WORDS:
            raise SystemExit(f"generate_masks: PretrainDataset read {len(ds)} samples, "
                             f"{len(empty)} with an empty mask")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "generate_masks", "gpu": card, "images": CLI_WORDS, "batch": MASK_BATCH,
          "source": "cli/train.py --synthetic's LMDB (1024 words, seed 3, 48 x 160)",
          "masks_per_s": {d: CLI_WORDS / w for d, w in walls.items()},
          "kmeans_ms_per_batch_on_card": kmeans_ms,
          "identical_lmdbs": not differing_keys, "differing_pngs": len(differing_keys),
          "differing_pixels_64x256": int(differ.sum()),
          "mean_iou_vs_rendered_truth": float(np.mean(ious)),
          "min_iou_vs_rendered_truth": float(np.min(ious)),
          "pretrain_dataset_nonempty_masks": CLI_WORDS})


def calibrate_phase(card: str) -> dict:
    """``cli.calibrate`` in process at CALIBRATE_ITERS calls per row: its
    rows and the measured peaks; the launch counts are read around it."""
    import io
    buffer = io.StringIO()
    with contextlib.redirect_stdout(buffer):
        result = calibrate.main(["--iters", str(CALIBRATE_ITERS)])
    launches = kernel_counts()
    if not launches["K1b-fwd"] > 0 or not launches["K1b-bwd"] > 0 or not launches["K1-fwd"] > 0:
        raise SystemExit(f"calibrate: an attention row ran no kernel: {launches}")
    emit({"phase": "calibrate", "gpu": card, "kernel_launches": launches,
          **{k: v for k, v in result.items() if k != "kernel_launches"}})
    return dict(result, launches=launches)


def forward_resources() -> list:
    """Registers and local (spill) bytes per thread, shared memory per block
    and resident blocks per SM of the forward kernels, for each head dim and
    tile height they are built for: bf16 (128- and 64-row tiles) and fp32
    (64-row tiles)."""
    return [dict(head_dim=d, rows=rows, dtype="bfloat16", **forward_kernel_attributes(d, rows))
            for d in (64, 32) for rows in (128, 64)] + fp32_forward_resources()


def fp32_forward_resources() -> list:
    """The same for the fp32 forward kernel (64-row tiles)."""
    return [dict(head_dim=d, rows=64, dtype="float32",
                 **forward_kernel_attributes(d, 64, torch.float32)) for d in (64, 32)]


def backward_resources() -> list:
    """The same for each backward kernel (dq, dk/dv), head dim and type it
    is built for (64-row tiles throughout)."""
    return [dict(kernel=kernel, dtype=str(dtype).replace("torch.", ""), head_dim=d, rows=64,
                 **backward_kernel_attributes(d, dtype, kernel))
            for kernel in ("dq", "dkdv") for d in (64, 32)
            for dtype in (torch.bfloat16, torch.float32)]


def ce_backward_resources() -> list:
    """The same for the fused CE's backward kernel, in each type, on its
    16-byte and its scalar path."""
    return [dict(dtype=str(dtype).replace("torch.", ""), path="16-byte" if vector else "scalar",
                 **ce_backward_attributes(dtype, vector))
            for dtype in (torch.bfloat16, torch.float32) for vector in (True, False)]


def bilateral_resources() -> list:
    """The same for the bilateral kernel, for each static max radius."""
    return [dict(max_radius=r, **bilateral_attributes(r)) for r in range(6)]


def sass_counts(library: str, kernel_part: str) -> dict | None:
    """Instructions of the kernel whose mangled name holds ``kernel_part`` in
    the built ``csrc/<library>.cu`` (``cuobjdump -sass``): all of them, the
    special-function unit's (MUFU) and the fp32 pipe's (FADD, FMUL, FFMA);
    None where the toolkit has no cuobjdump."""
    import re
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "-sass", _build.build_library(library)], capture_output=True,
                          text=True, check=True).stdout
    for block in sass.split("Function : ")[1:]:
        if kernel_part not in block.split("\n", 1)[0]:
            continue
        ops = re.findall(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", block)
        return {"instructions": len(ops), "mufu": ops.count("MUFU"),
                "fp32": sum(ops.count(op) for op in ("FADD", "FMUL", "FFMA"))}
    return None


def kernel_entry(name, source, replaces, launches, head, variants, **extra):
    return dict({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches, "max_abs_err": head["max_abs_err"],
                 "tol": head.get("tol", head.get("tol_rel")), "shape": head["shape"],
                 "dtype": head["dtype"], "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
                 "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                 "library_ms": head["library_ms"], "variants": variants}, **extra)


def parse_args(argv):
    import argparse
    parser = argparse.ArgumentParser(
        description="Build the port's kernels, hold each against its plain version on the "
                    "card and drive every main path (no arguments), or run only the phases "
                    "named by --only.")
    parser.add_argument("--only", action="append", choices=ONLY_PHASES,
                        help="run only this phase after the build (repeatable): the fp32 "
                             "attention cases of the kernels phase, the fp32 ViT-Tiny step, "
                             "the greedy decode's CUDA graphs against the eager decode, the "
                             "LayerNorm kernels' checks and times, or the training steps' "
                             "augmentation graphs against the eager chains")
    parser.add_argument("--kernels-from", metavar="DIR",
                        help="with --only: run each phase also with the attention kernels "
                             "built from DIR/ccd_tpu_torch/csrc (a checkout of another commit, "
                             "e.g. the parent unpacked by git archive), in turns with this "
                             "tree's")
    args = parser.parse_args(argv)
    if args.kernels_from and not args.only:
        parser.error("--kernels-from needs --only")
    return args


ONLY_PHASES = ("attention_fp32", "fp32_step", "decode_graph", "layer_norm", "augment_graph")


def only_phases(card: str, phases, other) -> None:
    """The phases named, each with this tree's attention kernels and, where
    ``other`` names a checkout, in turns with its kernels (other, this, this,
    other for the step; other, this for the kernels' cases)."""
    def run(phase, kernels):
        reset_kernel_counts()
        if phase == "attention_fp32":
            attention_fp32_phase(card, kernels)
        else:
            fp32_step_phase(card, kernels)

    def with_other(phase):
        with attention_kernels_from(other):
            run(phase, other)

    for phase in phases:
        if phase == "decode_graph":  # no attention kernel in the decoder
            decode_graph_phase(card)
        elif phase == "augment_graph":  # nor in the augmentation
            augment_graph_phase(card)
        elif phase == "layer_norm":
            layer_norm_phase(card)
        elif other is None:
            run(phase, "this tree")
        elif phase == "attention_fp32":
            with_other(phase)
            run(phase, "this tree")
        else:
            with_other(phase)
            run(phase, "this tree")
            run(phase, "this tree")
            with_other(phase)


def main(argv=()) -> None:
    args = parse_args(list(argv))
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this script needs a GPU")
    card = smi()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout
    release = next((ln.strip() for ln in nvcc.splitlines() if "release" in ln), "unknown")
    for mod in ("yaml", "PIL", "cv2"):
        __import__(mod)  # the data stack; a missing module fails here
    from ccd_tpu_torch.data import synthetic
    # the rendered words' face: where DejaVu is missing PIL's built-in font
    # stands in, and the words' strokes (and so the masks' overlap with the
    # rendered truth) are thinner
    font = getattr(synthetic._font(), "path", None)
    font = font if isinstance(font, str) else "PIL's built-in default font (no DejaVu)"
    emit({"phase": "environment", "gpu": card, "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": release,
          "synthetic_words_font": font})
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products stay fp32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    libs = _build.build_libraries(KERNEL_LIBRARIES)  # one nvcc each, all started together
    for name in KERNEL_LIBRARIES:
        _build.load_library(name)
    emit({"phase": "build",
          "libraries": [os.path.relpath(lib, os.path.dirname(PKG_DIR)) for lib in libs],
          "seconds": time.time() - t0})
    if args.only:
        only_phases(card, args.only, args.kernels_from)
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return

    # ---- every kernel against its plain version, at the main paths' shapes
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    fp32_fwd, fp32_bwd, fp32_flash = attention_fp32_checks(gen)
    fwd = [check_attention(EVAL_SHAPE, bf16, True, gen),
           check_attention(TRAIN_SHAPE, bf16, True, gen),
           check_attention(BASE_SHAPE, bf16, True, gen),
           check_attention(TINY_SHAPE, bf16, True, gen),
           check_attention(SMALL_SHAPE, bf16, True, gen),
           check_attention(EVAL_SHAPE, bf16, False, gen),
           check_attention(PROBE_SHAPE, bf16, True, gen),
           # K and V stream through shared memory: the forward takes any S
           check_attention(LONG_SHAPE, bf16, True, gen)] + fp32_fwd
    bwd = [check_attention_bwd(shape, bf16, with_bias, gen)
           for shape in (TRAIN_SHAPE, SMALL_SHAPE) for with_bias in (True, False)]
    bwd.append(check_attention_bwd(EVAL_SHAPE, bf16, True, gen))  # the finetune step's shape
    bwd += [check_attention_bwd(BASE_SHAPE, bf16, True, gen),
            check_attention_bwd(TINY_SHAPE, bf16, True, gen),
            check_attention_bwd(PROBE_SHAPE, bf16, True, gen)]
    # Q and dO (or K and V) stream through shared memory: the backward takes
    # any S, and 64-row tiles where S % 128 != 0
    bwd += [check_attention_bwd(LONG_SHAPE, bf16, True, gen),
            check_attention_bwd(ODD_TILES_SHAPE, bf16, True, gen)] + fp32_bwd
    lse_forward = forward_lse_check(EVAL_SHAPE, gen)
    flash = [check_flash(FOLDED_SHAPE, bf16, gen), check_flash((8, 64, 32), bf16, gen),
             check_flash((2 * PRETRAIN_BATCH, 256, 6, 64), bf16, gen),
             check_flash((1, LONG, 64), bf16, gen)] + fp32_flash
    flash_fwd, flash_bwd = [c[0] for c in flash], [c[1] for c in flash]
    rows, width = 2 * PRETRAIN_BATCH * 26, 65536
    ce = [check_fused_ce(rows, width, bf16, True, gen),
          check_fused_ce(rows, width, f32, True, gen),
          check_fused_ce(2 * VIT_BASE_BATCH * 26, width, bf16, True, gen),  # ViT-Base's rows
          check_fused_ce(rows, 8192, bf16, True, gen)]       # the convergence demo's out_dim
    ce += [check_fused_ce(2 * 7 * 26, k, dtype, swap, gen)   # K = 1001: the scalar path
           for k in (1000, 1001) for dtype in (bf16, f32) for swap in (True, False)]
    ce.append(check_fused_ce(7, 100, f32, False, gen))       # odd rows without swap_halves
    norms = layer_norm_checks(gen)
    ce_fwd, ce_bwd = [c[0] for c in ce], [c[1] for c in ce]
    bil = [check_bilateral((PRETRAIN_BATCH, 32, 128, 3), gen),
           check_bilateral((VIT_BASE_BATCH, 32, 128, 3), gen),          # ViT-Base's batch
           check_bilateral((PRETRAIN_BATCH, 32, 128, 3), gen, max_radius=2, rad2=[4.0]),
           check_bilateral((3, 17, 45, 3), gen),                 # edge tiles in both axes
           # rad2 that no integer radius squares: the tap set is d² <= rad2
           check_bilateral((PRETRAIN_BATCH, 32, 128, 3), gen, rad2=[2.0, 8.0, 12.5]),
           check_bilateral((3, 17, 45, 3), gen, rad2=[2.0, 8.0, 12.5]),
           check_bilateral((PRETRAIN_BATCH, 32, 128, 3), gen, max_radius=0, rad2=[4.0])]

    zeros = lambda *shape, dtype=bf16: torch.zeros(shape, device="cuda", dtype=dtype)
    # S, D; both directions take S = LONG (checked above)
    bad_attention = [(1, 100, 3 * 64), (1, 64, 3 * 48)]
    bad_flash = [(1, 100, 64), (1, 64, 48)]
    refused = {
        "K1-fwd": count_refusals("packed attention", [
            (lambda sh=sh: mha_packed_bias(zeros(*sh), None, 1.0, 1)) for sh in bad_attention]),
        "K1-bwd": count_refusals("packed attention backward", [
            (lambda sh=sh: mha_packed_bias_bwd(zeros(*sh), None, zeros(sh[0], sh[1], sh[2] // 3),
                                               1.0, 1)) for sh in bad_attention]),
        "K1b-fwd": count_refusals("flash attention", [
            (lambda sh=sh: flash_attention(zeros(*sh), zeros(*sh), zeros(*sh), 1.0))
            for sh in bad_flash]),
        "K1b-bwd": count_refusals("flash attention backward", [
            (lambda sh=sh: flash_attention_bwd(zeros(*sh), zeros(*sh), zeros(*sh), zeros(*sh),
                                               1.0)) for sh in bad_flash]),
        "K2": count_refusals("fused CE", [
            lambda: fused_dino_row_ce(zeros(4, 64), zeros(4, 64, dtype=f32), zeros(1, 64)),
            lambda: fused_dino_row_ce(zeros(3, 64), zeros(3, 64), zeros(1, 64), swap_halves=True),
            lambda: fused_dino_row_ce(zeros(4, 64, dtype=torch.float16),
                                      zeros(4, 64, dtype=torch.float16), zeros(1, 64)),
            lambda: fused_dino_row_ce(zeros(4, 64), zeros(4, 32), zeros(1, 64))]),
        "K3": count_refusals("bilateral", [
            lambda: bilateral_filter_fused(zeros(2, 8, 8, 4, dtype=f32), zeros(2, dtype=f32),
                                           zeros(2, dtype=f32), zeros(2, dtype=f32), 2),
            lambda: bilateral_filter_fused(zeros(2, 8, 8, 3), zeros(2), zeros(2), zeros(2), 2),
            lambda: bilateral_filter_fused(zeros(2, 8, 8, 3, dtype=f32), torch.ones(2),
                                           zeros(2, dtype=f32), zeros(2, dtype=f32), 2),
            lambda: bilateral_filter_fused(zeros(2, 8, 8, 3, dtype=f32), zeros(2, dtype=f32),
                                           zeros(2, dtype=f32), zeros(2, dtype=f32), 6)])}
    emit({"phase": "kernel_checks", "gpu": card, "refused_unsupported": refused,
          "forward_lse": lse_forward,
          "passed": {"K1-fwd": len(fwd), "K1-bwd": len(bwd), "K1b-fwd": len(flash_fwd),
                     "K1b-bwd": len(flash_bwd), "K2-fwd": len(ce_fwd), "K2-bwd": len(ce_bwd),
                     "K3": len(bil), "LN-fwd": len(norms["forward"]),
                     "LN-bwd": len(norms["backward"])},
          "refused_unsupported_layer_norm": norms["refused"]})  # numbers: the kernels line

    # ---- the main paths, launch counts set to 0 just before each and read just after
    reset_kernel_counts()
    calib = calibrate_phase(card)
    calib_launches = calib["launches"]
    reset_kernel_counts()
    eval_launches = evaluation_path(card)
    decode_graph_phase(card)
    augment_graph_phase(card)
    reset_kernel_counts()
    train_launches = pretrain_path(card)
    reset_kernel_counts()
    ft_launches = finetune_path(card)
    reset_kernel_counts()
    base_launches = vit_base_pretrain_path(card)
    reset_kernel_counts()
    sev2_launches = severity_2_pretrain_step(card)
    reset_kernel_counts()
    abinet_launches = abinet_finetune_step(card)
    reset_kernel_counts()
    fp32_launches = fp32_step_phase(card)
    opt_launches = optimizers_phase(card)      # counts set to 0 before each optimizer's run
    remat_launches = remat_phase(card)         # and before each of its two runs
    attention_launches = last_selfattention_phase(card)
    dp_launches = data_parallel_phase(card)   # counts set to 0 before each of its steps
    tp_launches = tensor_parallel_phase(card)  # and before each of its runs, in each process
    augmentation_chains(card)
    native_reader_phase(card)
    keep = tempfile.mkdtemp(prefix="ccd_chip_smoke_keep_")
    try:
        kept = train_cli_phase(card, keep)
        train_finetune_cli_phase(card, kept)
        probe = overfit_probe_phase(card)   # counts set to 0 before each of its two runs
        parity_launches = parity_eval_phase(card, probe,
                                            interchange_phase(card, probe["result"]["model"],
                                                              kept, keep))
        generate_masks_phase(card)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    convergence_short_phase(card)

    # the K1b bounds once more at the copy rate the calibration measured
    measured_rate = calib["measured_copy_gb_per_s"] * 1e9
    for head in flash_fwd + flash_bwd:
        head["bound_ms_at_measured_copy_rate"] = roofline(
            head["bytes"], head["flops"], getattr(torch, head["dtype"]), measured_rate)[0]
    by_path = {"pretrain": train_launches, "finetune": ft_launches,
               "pretrain_vit_base": base_launches, "pretrain_severity_2": sev2_launches,
               "finetune_abinet": abinet_launches, "fp32_step": fp32_launches,
               "pretrain_sgd_lars": opt_launches,
               "pretrain_remat": remat_launches, **dp_launches, **tp_launches}
    k1_fwd = {"evaluation": eval_launches["K1-fwd"], "calibrate": calib_launches["K1-fwd"],
              "last_selfattention": attention_launches["K1-fwd"],
              **{path: n["K1-fwd"] for path, n in by_path.items()},
              "overfit_probe": probe["launches"]["K1-fwd"],
              "parity_eval": parity_launches["K1-fwd"]}
    ln_fwd = {"evaluation": eval_launches["LN-fwd"],
              "last_selfattention": attention_launches["LN-fwd"],
              **{path: n["LN-fwd"] for path, n in by_path.items()},
              "overfit_probe": probe["launches"]["LN-fwd"],
              "parity_eval": parity_launches["LN-fwd"]}
    ln_bwd = {**{path: n["LN-bwd"] for path, n in by_path.items()},
              "overfit_probe": probe["launches"]["LN-bwd"]}
    k1_bwd = {**{path: n["K1-bwd"] for path, n in by_path.items()},
              "overfit_probe": probe["launches"]["K1-bwd"]}
    k2_fwd, k2_bwd, k3 = ({path: n[k] for path, n in by_path.items() if n[k]}
                          for k in ("K2-fwd", "K2-bwd", "K3"))
    resources, bwd_resources = forward_resources(), backward_resources()
    emit({"kernels": [
        kernel_entry("K1-fwd packed_attention_forward (mha_packed_bias)",
                     "ccd_tpu_torch/csrc/packed_attention.cu",
                     "ccd_tpu/ops/flash_attention.py:217", sum(k1_fwd.values()), fwd[0], fwd,
                     launches_by_path=k1_fwd, resources=resources),
        kernel_entry("K1-bwd packed_attention_backward (mha_packed_bias_bwd)",
                     "ccd_tpu_torch/csrc/packed_attention_bwd.cu",
                     "ccd_tpu/ops/flash_attention.py:241", sum(k1_bwd.values()), bwd[0], bwd,
                     launches_by_path=k1_bwd, resources=bwd_resources),
        kernel_entry("K1b-fwd flash_attention_forward (flash_attention, mha)",
                     "ccd_tpu_torch/csrc/packed_attention.cu",
                     "ccd_tpu/ops/flash_attention.py:80", calib_launches["K1b-fwd"],
                     flash_fwd[0], flash_fwd,
                     launches_by_path={"calibrate": calib_launches["K1b-fwd"]},
                     bound_ms_at_measured_copy_rate=flash_fwd[0]["bound_ms_at_measured_copy_rate"],
                     measured_copy_gb_per_s=calib["measured_copy_gb_per_s"],
                     resources=resources),
        kernel_entry("K1b-bwd flash_attention_backward (flash_attention_bwd)",
                     "ccd_tpu_torch/csrc/packed_attention_bwd.cu",
                     "ccd_tpu/ops/flash_attention.py:97", calib_launches["K1b-bwd"],
                     flash_bwd[0], flash_bwd,
                     launches_by_path={"calibrate": calib_launches["K1b-bwd"]},
                     bound_ms_at_measured_copy_rate=flash_bwd[0]["bound_ms_at_measured_copy_rate"],
                     measured_copy_gb_per_s=calib["measured_copy_gb_per_s"],
                     resources=bwd_resources),
        kernel_entry("K2-fwd fused_dino_ce_forward (fused_dino_row_ce)",
                     "ccd_tpu_torch/csrc/fused_dino_ce.cu",
                     "ccd_tpu/ops/fused_dino_ce.py:147", sum(k2_fwd.values()),
                     ce_fwd[0], ce_fwd, launches_by_path=k2_fwd,
                     device_ms=ce_fwd[0]["device_ms"]),
        kernel_entry("K2-bwd fused_dino_ce_backward (fused_dino_row_ce, backward)",
                     "ccd_tpu_torch/csrc/fused_dino_ce.cu",
                     "ccd_tpu/ops/fused_dino_ce.py:215", sum(k2_bwd.values()),
                     ce_bwd[0], ce_bwd, launches_by_path=k2_bwd,
                     device_ms=ce_bwd[0]["device_ms"], resources=ce_backward_resources()),
        kernel_entry("K3 bilateral_filter_forward (bilateral_filter_fused)",
                     "ccd_tpu_torch/csrc/bilateral.cu",
                     "ccd_tpu/data/aug_ops.py:995", sum(k3.values()), bil[0], bil,
                     launches_by_path=k3,
                     # the host's launches above; each replay launches its capture's
                     graph_replays_by_path={path: by_path[path]["augment-replay"]
                                            for path in k3},
                     device_ms=bil[0]["device_ms"], wrapper_call_ms=bil[0]["wrapper_call_ms"],
                     resources=bilateral_resources(),
                     # max radius 5: 81 taps for each of a thread's 4 pixels
                     sass_max_radius_5=sass_counts("bilateral", "bilateral_kernelILi5E"),
                     tap_evaluations_per_thread_max_radius_5=81 * 4),
        kernel_entry("LN-fwd layer_norm_forward (layer_norm)", "ccd_tpu_torch/csrc/layer_norm.cu",
                     "none: XLA's LayerNorm", sum(ln_fwd.values()), norms["forward"][0],
                     norms["forward"], launches_by_path=ln_fwd,
                     device_ms=norms["forward"][0]["device_ms"], resources=norms["resources"]),
        kernel_entry("LN-bwd layer_norm_backward (layer_norm, backward)",
                     "ccd_tpu_torch/csrc/layer_norm.cu", "none: XLA's LayerNorm gradient",
                     sum(ln_bwd.values()), norms["backward"][1], norms["backward"],
                     launches_by_path=ln_bwd, device_ms=norms["backward"][1]["device_ms"])]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    pretrain_step_mod.graphed_augment = counted_graphed_augment
    if len(sys.argv) == 5 and sys.argv[1] == TP_WORKER_FLAG:
        tensor_parallel_worker(int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
    else:
        main(sys.argv[1:])
