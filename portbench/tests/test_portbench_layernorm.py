"""The LayerNorm yardstick (``portbench/layernorm.py``) and its readers: the
norms and bytes of each cell counted by hand, and what the readers take
from a trace made by hand: the program's kernels or ATen's, and nothing
where the trace holds neither."""

import json
import os
from types import SimpleNamespace

import pytest

from portbench import harness, layernorm
from portbench.tracing import Trace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE = 3.35e12


def cell(config: str, traffic: str):
    with open(os.path.join(HERE, "configs", config + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", traffic + ".json")) as f:
        mix = json.load(f)
    return cfg, mix


def test_recognition_batch_by_hand():
    cfg, mix = cell("ccd-vit_small-ard", "eval-b1024")
    # 25 ViT norms over 1024 x 256 tokens of 384 (bf16 in and out, fp32 w and b);
    # 25 steps x 19 decoder norms over 1024 rows of 512
    want = (25 * (1024 * 256 * 384 * 4 + 384 * 8) + 25 * 19 * (1024 * 512 * 4 + 512 * 8)) / RATE
    assert layernorm.bound_s(cfg, mix) == pytest.approx(want, rel=1e-12)
    assert want * 1e3 == pytest.approx(3.303, abs=1e-3)


def test_pretraining_step_by_hand():
    cfg, mix = cell("ccd-vit_small-pretrain", "pretrain-b256")
    rows = 2 * 256 * 256
    # student 25 + 3 taps forward and backward, teacher 25 forward (no taps)
    want = (53 * (rows * 384 * 4 + 384 * 8) + 28 * (rows * 384 * 6 + 384 * 12)) / RATE
    assert layernorm.bound_s(cfg, mix) == pytest.approx(want, rel=1e-12)
    remat = layernorm.bound_s(dict(cfg, remat=True), mix)
    assert remat == pytest.approx(want + 24 * (rows * 384 * 4 + 384 * 8) / RATE, rel=1e-12)


def test_finetuning_step_by_hand():
    cfg, mix = cell("ccd-vit_small-ard", "finetune-b288")
    vit, dec = 288 * 256, 288 * 25
    want = (25 * (vit * 384 * 4 + 384 * 8) + 25 * (vit * 384 * 6 + 384 * 12)
            + 19 * (dec * 512 * 4 + 512 * 8) + 19 * (dec * 512 * 6 + 512 * 12)) / RATE
    assert layernorm.bound_s(cfg, mix) == pytest.approx(want, rel=1e-12)


OURS = "void (anonymous namespace)::layer_norm_fwd_kernel<__nv_bfloat16, __nv_bfloat16, 2>(...)"
ATEN = ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>(...)",
        "void at::native::(anonymous namespace)::layer_norm_grad_input_kernel<float, float>(...)",
        "void at::native::(anonymous namespace)::GammaBetaBackwardCUDAKernel_32x32<float>(...)")
OTHER = "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda>(...)"


def reading(names_us, work, config="ccd-vit_small-ard", traffic="eval-b1024"):
    cfg, mix = cell(config, traffic)
    device = [(float(i), us, n, None) for i, (n, us) in enumerate(names_us)]
    tr = Trace(device=device, ranges=[], host_ops=[], window=(0.0, 1e6), work=work)
    return SimpleNamespace(trace=tr, window={"metrics": {}}, ctx=SimpleNamespace(cfg=cfg, mix=mix))


def test_eval_reader_over_the_programs_kernels():
    cfg, mix = cell("ccd-vit_small-ard", "eval-b1024")
    r = reading([(OURS, 2000.0), (OURS, 3000.0), (OTHER, 9000.0)], {"batches": 2})
    got = harness.reader("layernorm_roofline.eval").read(r)
    assert got == pytest.approx(100 * layernorm.bound_s(cfg, mix) * 2 / 5e-3)


def test_train_reader_over_atens_kernels():
    cfg, mix = cell("ccd-vit_small-pretrain", "pretrain-b256")
    r = reading([(ATEN[0], 10000.0), (ATEN[1], 4000.0), (ATEN[2], 1000.0), (OTHER, 5000.0)],
                {"steps": 1, "images": 256}, "ccd-vit_small-pretrain", "pretrain-b256")
    got = harness.reader("layernorm_roofline.train").read(r)
    assert got == pytest.approx(100 * layernorm.bound_s(cfg, mix) / 15e-3)


@pytest.mark.parametrize("name,unit", [("layernorm_roofline.eval", "batches"),
                                       ("layernorm_roofline.train", "steps")])
def test_nothing_to_read(name, unit):
    assert harness.reader(name).read(reading([(OTHER, 100.0)], {unit: 3})) is None
    assert harness.reader(name).read(reading([], {unit: 3})) is None
    assert harness.reader(name).read(reading([(OURS, 100.0)], {})) is None
