"""The LayerNorms a cell's batch or step makes, counted from its configuration,
and their kernels found by name in a trace: the yardstick of the
``layernorm_roofline`` metrics. It reads nothing of the program but the
trace's kernel names.

Norms, each over the last axis (a ViT of ``depth`` blocks has two a block and
a final one; the NRTR decoder three a layer and a final one):

* recognition, a batch: the ViT's over (B N, C) and, at each of the
  ``max_seq_len`` greedy steps, the decoder's over (B, d_model);
* finetuning, a step: the same ViT norms and the decoder's over
  (B max_seq_len, d_model), each forward and backward;
* pretraining, a step: the student's over both views, (2B N, C), with its
  three seg taps, forward and backward (their forward again for each block
  with ``remat``); the teacher's forward over the same rows.

Only norms whose outputs are read count: the recognizer and the teacher have
no seg head, so their taps are work the reference never does.

Bytes, in the configuration's compute dtype: a forward reads x and writes y
and reads the fp32 weight and bias; a backward reads x and dy and writes dx,
reads the weight and writes the two fp32 gradients. Operations: 8 fp32 an
element forward, 14 backward (they never bound it).

Kernels by name: the program's own LayerNorm kernels, or ATen's where it
has none. ATen's kernels alone leave out the casts to fp32 and back that
surround them in a program that computes the norm in fp32 from bf16.
"""

from __future__ import annotations

from typing import Optional

from portbench import flops, roofline

KERNEL_NAMES = ("layer_norm", "LayerNorm", "GammaBetaBackward")
FLOPS_FWD, FLOPS_BWD = 8, 14


def is_layer_norm(name: str) -> bool:
    return any(part in name for part in KERNEL_NAMES)


def norm_bytes(rows: int, width: int, dtype: str, backward: bool) -> int:
    e = roofline.ELEMENT_BYTES[dtype]
    if backward:
        return rows * width * 3 * e + 3 * width * 4
    return rows * width * 2 * e + 2 * width * 4


def norms(cfg: dict, mix: dict) -> list:
    """``(count, rows, width, backward)`` of each kind of norm a batch
    (recognition) or a step (training) makes."""
    width, depth, _ = flops.ARCHS[cfg["arch"]]
    gh, gw = flops.grid(cfg["patch_size"])
    batch = int(mix["batch"])
    vit = 2 * depth + 1
    if mix["driver"] == "pretrain":
        rows = 2 * batch * gh * gw
        student = vit + 3
        recompute = 2 * depth if cfg.get("remat") else 0
        return [(2 * student - 3 + recompute, rows, width, False), (student, rows, width, True)]
    d = cfg["decoder"]
    decoder = 3 * d["n_layers"] + 1
    tokens = batch * gh * gw
    if mix["driver"] == "eval":
        return [(vit, tokens, width, False),
                (decoder * d["max_seq_len"], batch, d["d_model"], False)]
    rows = batch * d["max_seq_len"]
    return [(vit, tokens, width, b) for b in (False, True)] + \
        [(decoder, rows, d["d_model"], b) for b in (False, True)]


def bound_s(cfg: dict, mix: dict) -> float:
    """The least time the card could take for a batch's or a step's norms."""
    dtype = cfg["compute_dtype"]
    total_ms = 0.0
    for count, rows, width, backward in norms(cfg, mix):
        ops = (FLOPS_BWD if backward else FLOPS_FWD) * rows * width
        total_ms += count * roofline.roofline(norm_bytes(rows, width, dtype, backward), ops,
                                              "float32")[0]
    return total_ms / 1e3


def roofline_percent(reading, unit: str) -> Optional[float]:
    """The norms' bound over the device time of the LayerNorm kernels, for
    the ``unit``s (batches or steps) of the traced segment."""
    tr = reading.trace
    seconds = sum(d for _, d, n, _ in tr.device if is_layer_norm(n)) / 1e6
    n = tr.work.get(unit)
    if seconds <= 0 or not n:
        return None
    return 100.0 * bound_s(reading.ctx.cfg, reading.ctx.mix) * n / seconds
