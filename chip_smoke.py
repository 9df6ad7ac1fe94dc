#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU, ``nvcc`` and nothing outside the repository.
It builds the CUDA kernels of ``ccd_tpu_torch`` from their sources, holds
each against its plain PyTorch version on the card, then drives the port's
main path — the recognizer's evaluation (ViT-Small + 6-layer NRTR greedy
decode, bf16, batch 288, the shipped ``ccd_finetune_ard.yaml``) over
synthetic LMDBs through ``evaluate_benchmarks`` as the CLI calls it — and
checks that the path went through the kernels and that its output agrees
with a run whose attention is the plain version. Weights are random, from a
seed. Every phase that fails ends the run with a non-zero exit code.

Prints one JSON object per phase, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
from ccd_tpu_torch.builders import build_recognizer
from ccd_tpu_torch.config import Config
from ccd_tpu_torch.data.dataset import SupervisedDataset, build_dataset
from ccd_tpu_torch.data.pipeline import DataLoader
from ccd_tpu_torch.data.synthetic import write_synthetic_lmdb
from ccd_tpu_torch.evaluation import runner
from ccd_tpu_torch.ops import _build
from ccd_tpu_torch.ops.flash_attention import mha_packed_bias, mha_packed_bias_plain

# published peaks of one H100 SXM (dense): device memory and tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,  # bf16 tensor cores
              torch.float32: 67e12}    # fp32 outside the tensor cores (no TF32 here)

SEED = 0
BATCH = 288
N_FULL, N_RAGGED = 1152, 100           # four full batches, and a ragged set
PKG_DIR = os.path.dirname(os.path.abspath(ccd_tpu_torch.__file__))
CONFIG = os.path.join(PKG_DIR, "configs", "ccd_finetune_ard.yaml")

# |kernel - plain| on O(1) outputs. bf16: both round p and the output to bf16
# (ulp 2^-8 relative, 2^-7 absolute just below 2), at different points of the
# softmax normalisation. fp32: same products, summed in another order.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# End to end, kernel run against plain-attention run, bf16, random weights:
# per-step probabilities (each <= 1, mostly ~1/92) compared up to the first
# step where the two runs' greedy tokens part (after it their inputs differ).
TOL_PROBS = 2e-2
# Untrained weights give near-uniform probabilities, so top-2 near-ties are
# common and bf16 rounding flips some; a flip changes every later step of its
# row. A run through a wrong kernel agrees on about 1/92 of the positions.
MIN_TOKEN_AGREEMENT = 0.5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median of ``reps`` single calls timed with CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def attention_bound(b, s, c, h, dtype, with_bias):
    """Least time the card could take: each input read once, each output
    written once, over the memory rate; 4*S*S*D flop per head and batch row
    over the peak rate of the type."""
    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = (b * s * 3 * c + (3 * c if with_bias else 0) + b * s * c) * elem
    flops = 4 * s * s * (c // h) * h * b
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
    biased = qkv if bias is None else qkv + bias
    q, k, v = biased.view(b, s, 3, h, c // h).permute(2, 0, 3, 1, 4)
    heavy = b * s * c > 1 << 24
    bound_ms, bound_by = attention_bound(b, s, c, h, dtype, with_bias)
    return {
        "shape": list(shape), "dtype": str(dtype).replace("torch.", ""), "bias": with_bias,
        "max_abs_err": err, "tol": TOL[dtype],
        "kernel_ms": time_ms(lambda: mha_packed_bias(qkv, bias, scale, h)),
        "plain_ms": time_ms(lambda: mha_packed_bias_plain(qkv, bias, scale, h),
                            reps=3 if heavy else 10, warmup=1),
        # one library call on ready-made q, k, v views; used nowhere in the port
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


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


def device_busy(fn):
    """(wall ms, summed device-kernel ms, top kernels) of one call under
    torch.profiler; the kernel sum is None when the trace holds no device time."""
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
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    if not rows:
        return wall_ms, None, []
    rows.sort(reverse=True)
    top = [{"kernel": k[:60], "ms": ms, "calls": n} for ms, n, k in rows[:6]]
    return wall_ms, sum(r[0] for r in rows), top


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this script needs a GPU")
    card = smi()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout
    release = next((ln.strip() for ln in nvcc.splitlines() if "release" in ln), "unknown")
    for mod in ("yaml", "PIL", "cv2"):
        __import__(mod)  # the data stack; a missing module fails here
    emit({"phase": "environment", "gpu": card, "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": release})
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products stay fp32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    lib = _build.build_library("packed_attention")
    _build.load_library("packed_attention")
    emit({"phase": "build", "library": os.path.relpath(lib, os.path.dirname(PKG_DIR)),
          "seconds": time.time() - t0})

    # ---- every kernel against its plain version, at the main path's shapes
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    main_shape = (BATCH, 256, 384, 6)
    variants = [check_attention(main_shape, torch.bfloat16, True, gen),
                check_attention(main_shape, torch.float32, True, gen),
                check_attention((4, 256, 64, 2), torch.bfloat16, True, gen),
                check_attention((4, 256, 64, 2), torch.float32, True, gen),
                check_attention(main_shape, torch.bfloat16, False, gen)]
    # what the kernel does not take is refused, not computed some other way
    refused = 0
    for shape in [(1, 100, 3 * 64), (1, 64, 3 * 48), (1, 4096, 3 * 64)]:  # S, D, shared memory
        try:
            mha_packed_bias(torch.zeros(shape, device="cuda", dtype=torch.bfloat16), None, 1.0, 1)
        except (ValueError, RuntimeError):
            refused += 1
    if refused != 3:
        raise SystemExit(f"packed attention: {refused} of 3 unsupported shapes were refused")
    emit({"phase": "kernel_checks", "gpu": card, "refused_unsupported": refused,
          "checks": variants})

    # ---- the main path at full width
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

        mha_packed_bias.launches = 0
        t0 = time.time()
        results, weighted = evaluate()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = mha_packed_bias.launches

        n_batches = sum(-(-n // BATCH) for n in (N_FULL, N_RAGGED))
        if launches != 12 * n_batches:
            raise SystemExit(f"main path: {launches} kernel launches, expected "
                             f"{12 * n_batches} (12 per batch, {n_batches} batches)")
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
            tokens, _ = model.backbone(x)
            enc = model.encoder(tokens)
            split = {"vit_ms": time_ms(lambda: model.backbone(x), reps=5, warmup=1),
                     "encoder_ms": time_ms(lambda: model.encoder(tokens), reps=5, warmup=1),
                     "decode_ms": time_ms(lambda: model.decoder.decode_greedy(enc), reps=5,
                                          warmup=1),
                     "batch_ms": time_ms(lambda: runner.decode(model, images), reps=5, warmup=1)}
        # how busy the card is during one batch (the profiler slows the host side)
        prof_wall, busy, top = device_busy(lambda: runner.decode(model, images))
        split.update({"profiled_batch_wall_ms": prof_wall, "profiled_device_busy_ms": busy,
                      "profiled_device_idle_share": None if busy is None
                      else 1.0 - busy / prof_wall, "profiled_top_kernels": top})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    emit({"phase": "main_path", "gpu": card, "config": "ccd_finetune_ard.yaml",
          "arch": "vit_small + 6-layer NRTR", "dtype": "bfloat16", "batch": BATCH,
          "images": N_FULL + N_RAGGED, "batches": n_batches, "kernel_launches": launches,
          "images_per_s_inference": (N_FULL + N_RAGGED) / infer_s,
          "images_per_s_with_loading": (N_FULL + N_RAGGED) / wall,
          **split, "max_abs_prob_diff_vs_plain": worst, "tol_probs": TOL_PROBS,
          "token_agreement_vs_plain": share, "min_token_agreement": MIN_TOKEN_AGREEMENT,
          "total_accuracy": weighted})

    head = variants[0]
    emit({"kernels": [{
        "name": "K1-fwd packed_attention_forward (mha_packed_bias)", "route": "cuda",
        "source": "ccd_tpu_torch/csrc/packed_attention.cu",
        "replaces": "ccd_tpu/ops/flash_attention.py:217",
        "launches": launches, "max_abs_err": head["max_abs_err"], "tol": head["tol"],
        "shape": head["shape"], "dtype": head["dtype"],
        "ms": head["kernel_ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "variants": variants}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
