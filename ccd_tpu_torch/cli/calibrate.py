#!/usr/bin/env python
"""What the card delivers on the framework's own shapes: the denominators of
an honest roofline claim (counterpart of ``tools/tpu_calibrate.py``).

Rows, at the JAX tool's shapes:

* square bf16 matrix products at 2048, 4096 and 8192, and the model's GEMMs
  (the ViT-Small fc1, fc2 and qkv projections at 128 x 256 tokens, the DINO
  head's last layer (3328, 256) x (256, 65536)): ``torch.matmul``, since the
  card's cuBLAS rate is what they measure;
* an elementwise pass over 128 MB and the BSHD <-> BHSD transpose pair;
* the attention kernels: ``flash fwd`` through ``flash_attention`` on folded
  (768, 256, 64) q, k, v (K1b-fwd), ``flash fwd+bwd`` through autograd (K1b-fwd
  and K1b-bwd), and ``packed fwd`` through ``mha_packed`` on the
  (128, 256, 3, 6, 64) projection (K1-fwd);
* exact (erf) and tanh GELU at (32768, 1536).

Each row is timed with CUDA events around K back-to-back calls after a
warm-up, and printed with its TFLOP/s and GB/s (operations and bytes counted
from the shapes: each input read once, each output written once). The last
line is one JSON object with every row, the measured matrix-product peak
(the best square product) and copy rate (the elementwise pass), the card's
name and power limit, and the attention kernels' launch counts, which must
not be zero: the attention rows have to run the port's kernels.

Usage:
  python -m ccd_tpu_torch.cli.calibrate [--iters K] [--device cuda|cpu] [--small]

Runs on the GPU unless ``--device cpu`` is given; ``--small`` shrinks every
shape (a CPU run at those shapes checks the tool's paths, not the card).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence

FULL = dict(squares=(2048, 4096, 8192),
            gemms=(("fc1", 32768, 384, 1536), ("fc2", 32768, 1536, 384),
                   ("qkv", 32768, 384, 1152), ("dino_last", 3328, 256, 65536)),
            copy=(64, 1024, 1024), bshd=(128, 256, 6, 64), flash=(768, 256, 64),
            packed=(128, 256, 3, 6, 64), act=(32768, 1536))
SMALL = dict(squares=(64, 128),
             gemms=(("fc1", 256, 32, 128), ("fc2", 256, 128, 32),
                    ("qkv", 256, 32, 96), ("dino_last", 52, 16, 512)),
             copy=(4, 64, 64), bshd=(2, 64, 2, 32), flash=(8, 64, 32),
             packed=(2, 64, 3, 2, 32), act=(256, 64))


def _parse_arguments(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=50, help="back-to-back calls per row")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--small", action="store_true", help="tiny shapes (for a CPU check)")
    return p.parse_args(argv)


def _card(device) -> Dict[str, Optional[str]]:
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    import torch
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    line = out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else ""
    return {"name": torch.cuda.get_device_name(device),
            "power_limit": line.split(",")[-1].strip() if line else None}


def _timer(device, iters: int) -> Callable[[Callable[[], object]], float]:
    """Seconds per call of ``fn`` over ``iters`` back-to-back calls after two
    warm-up calls: CUDA events on the card, the host clock on the CPU."""
    import torch

    def timed(fn) -> float:
        for _ in range(2):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            return start.elapsed_time(end) / 1e3 / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters

    return timed


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the JSON object it prints last."""
    args = _parse_arguments(argv)
    import torch
    import torch.nn.functional as F

    from ccd_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd,
                                                   mha_packed, mha_packed_bias)
    from ccd_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    shapes = SMALL if args.small else FULL
    timed = _timer(device, args.iters)
    gen = torch.Generator(device=device).manual_seed(0)
    bf16 = torch.bfloat16
    rand = lambda *shape: torch.rand(shape, device=device, generator=gen).to(bf16)
    card = _card(device)
    rows: List[dict] = []

    def row(name: str, fn, flops: float = 0.0, nbytes: float = 0.0) -> None:
        seconds = timed(fn)
        entry = {"name": name, "us": seconds * 1e6,
                 "tflop_per_s": flops / seconds / 1e12 if flops else None,
                 "gb_per_s": nbytes / seconds / 1e9 if nbytes else None}
        rows.append(entry)
        msg = f"{name:44s} {entry['us']:9.1f} us"
        if flops:
            msg += f"  {entry['tflop_per_s']:6.1f} TFLOP/s"
        if nbytes:
            msg += f"  {entry['gb_per_s']:7.1f} GB/s"
        print(msg, flush=True)

    print(f"# device: {card['name']}, power limit {card['power_limit']}, "
          f"{args.iters} calls per row", flush=True)
    counters = lambda: {"K1b-fwd flash_attention": flash_attention.launches,
                        "K1b-bwd flash_attention_bwd": flash_attention_bwd.launches,
                        "K1-fwd mha_packed_bias": mha_packed_bias.launches}
    before = counters()

    # -- tensor-core peak: square products
    squares = []
    for n in shapes["squares"]:
        a, w = rand(n, n), rand(n, n)
        row(f"matmul {n}^3 bf16", lambda a=a, w=w: torch.matmul(a, w), flops=2 * n ** 3)
        squares.append(rows[-1])
    # -- the model's products
    for name, m, k, n in shapes["gemms"]:
        a, w = rand(m, k), rand(k, n)
        row(f"{name} ({m},{k})x({k},{n}) bf16", lambda a=a, w=w: torch.matmul(a, w),
            flops=2 * m * k * n, nbytes=2 * (m * k + k * n + m * n))
    # -- memory system
    big = rand(*shapes["copy"])
    row(f"elementwise {big.numel() * 2 / 2 ** 20:.0f}MB bf16 (copy bound)",
        lambda: big * 1.0001, nbytes=2 * 2 * big.numel())
    copy_row = rows[-1]
    t = rand(*shapes["bshd"])
    row(f"transpose BSHD<->BHSD {t.numel() * 2 / 1e6:.0f}MB x2",
        lambda: t.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3) * 1.0001,
        nbytes=2 * 2 * 2 * t.numel())
    # -- the attention kernels
    bh, s, d = shapes["flash"]
    q, k, v, do = (rand(bh, s, d) for _ in range(4))
    scale = d ** -0.5
    attn_flops, attn_bytes = 4 * bh * s * s * d, 2 * 4 * bh * s * d
    row(f"flash fwd ({bh} bh, {s}, {d})", lambda: flash_attention(q, k, v, scale),
        flops=attn_flops, nbytes=attn_bytes)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    row(f"flash fwd+bwd ({bh} bh, {s}, {d})",
        lambda: torch.autograd.grad(flash_attention(qg, kg, vg, scale), (qg, kg, vg), do),
        flops=attn_flops + 10 * bh * s * s * d, nbytes=attn_bytes + 2 * 7 * bh * s * d)
    b, sp, _, h, dp = shapes["packed"]
    qkv = rand(b, sp, 3 * h * dp)
    row(f"packed fwd ({b}, {sp}, 3, {h}, {dp})", lambda: mha_packed(qkv, dp ** -0.5, h),
        flops=4 * b * h * sp * sp * dp, nbytes=2 * 4 * b * sp * h * dp)
    # -- activations
    act = rand(*shapes["act"])
    m, n = shapes["act"]
    row(f"gelu exact (erf) ({m},{n}) bf16", lambda: F.gelu(act), nbytes=2 * 2 * act.numel())
    row(f"gelu tanh approx ({m},{n}) bf16", lambda: F.gelu(act, approximate="tanh"),
        nbytes=2 * 2 * act.numel())
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    launches = {k: v - before[k] for k, v in counters().items()}
    result = {"device": card["name"], "power_limit": card["power_limit"],
              "iters": args.iters, "small": bool(args.small), "rows": rows,
              "measured_matmul_peak_tflop_per_s": max(r["tflop_per_s"] for r in squares),
              "measured_copy_gb_per_s": copy_row["gb_per_s"], "kernel_launches": launches}
    if device.type == "cuda" and not all(launches.values()):
        raise SystemExit(f"calibrate: an attention row did not run its kernel: {launches}")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
