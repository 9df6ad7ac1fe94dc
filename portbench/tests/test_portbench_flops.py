"""The yardstick: FLOPs tied to a hand count at a tiny configuration, and
the attention bounds to the port's kernel table (PERF.md, K1 rows)."""

import json
import os

import pytest

from portbench import flops, roofline

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_vit_micro_by_hand():
    # vit_micro: C = 64, 3 blocks, patch 4 -> N = 8 * 32 = 256 tokens
    n, c = 256, 64
    qkv, scores, pv, proj = 2 * n * c * 192, 2 * n * n * c, 2 * n * n * c, 2 * n * c * c
    mlp = 2 * n * c * 256 + 2 * n * 256 * c
    embed = 2 * n * 48 * c
    assert flops.vit("vit_micro", 4) == embed + 3 * (qkv + scores + pv + proj + mlp)


def test_head_by_hand():
    c, out = 64, 1024
    row = 2 * (64 * 2048 + 2048 * 2048 + 2048 * 256 + 256 * out)
    assert flops.pool_and_head("vit_micro", 4, out) == 2 * 26 * 256 * c + 26 * row


def test_recognizer_decode_by_hand():
    d = {"max_seq_len": 2, "d_model": 8, "n_head": 1, "d_k": 4, "d_v": 4, "d_inner": 6,
         "n_layers": 1}
    # cache of 3 positions, 256 encoder tokens of width 512, 5 classes
    step = 2 * 8 * 12 + 2 * 3 * 8 + 2 * 4 * 8 + 2 * 8 * 4 + 2 * 256 * 8 + 2 * 4 * 8 \
        + 2 * 2 * 8 * 6
    kv = 2 * 256 * 512 * 8
    assert flops.decoder_greedy(d, 5, 256) == kv + 2 * step + 2 * 2 * 8 * 5


def test_full_configurations():
    pre = json.load(open(os.path.join(HERE, "configs", "ccd-vit_small-pretrain.json")))
    ard = json.load(open(os.path.join(HERE, "configs", "ccd-vit_small-ard.json")))
    assert flops.vit("vit_small", 4) == pytest.approx(12.089e9, rel=1e-4)
    assert flops.pretrain_image(pre) == pytest.approx(114.72e9, rel=1e-3)
    assert flops.finetune_image(ard) == pytest.approx(43.72e9, rel=1e-3)
    assert flops.eval_image(ard) == pytest.approx(14.57e9, rel=1e-3)


@pytest.mark.parametrize("fn,shape,ms", [
    (roofline.attention_bound, (288, 256, 384, 6), 0.0676),      # K1-fwd, evaluation
    (roofline.attention_bound, (128, 256, 384, 6), 0.0300),      # K1-fwd, ViT-Small training
    (roofline.attention_bound, (96, 256, 512, 8), 0.0300),       # K1-fwd, ViT-Base
    (roofline.attention_bound, (128, 256, 192, 3), 0.0150),      # K1-fwd, ViT-Tiny
    (roofline.attention_bwd_bound, (128, 256, 384, 6), 0.0526),  # K1-bwd, ViT-Small training
    (roofline.attention_bwd_bound, (288, 256, 384, 6), 0.1183),  # K1-bwd, finetuning
])
def test_attention_bounds_match_the_kernel_table(fn, shape, ms):
    bound, by = fn(*shape, "bfloat16", True)
    assert bound == pytest.approx(ms, abs=5e-5) and by == "bytes"
