"""The port's LayerNorm op (``ops/layer_norm.py``) on the CPU, and the ViT's
``norm_seg`` taps computed only where a seg head reads them.

* The op's CPU path is the chain the port ran before the kernel,
  ``F.layer_norm(x.float(), ...).to(dtype)``, bit for bit, forward and the
  gradients of x, the weight and the bias.
* The kernel's input checks refuse what the kernels do not take.
* The wrapper's path on the card (the autograd Function, the saved
  statistics, the counters) run here with its two launches replaced by the
  kernels' arithmetic written in torch: held to the chain within fp32
  summation order (1e-5 relative to the largest value; the output rounded to
  bf16 is held to one bf16 ulp).
* The recognizer's and the pretraining teacher's tokens are the same bits
  without the taps; the student still gets its three.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ccd_tpu_torch.models import CCDRecognizer
from ccd_tpu_torch.models.layers import LayerNorm
from ccd_tpu_torch.models.pretrain import CCDPretrainModel
from ccd_tpu_torch.ops import layer_norm as ln

from _torch_port import MICRO_DECODER, seeded_images

DTYPES = (torch.bfloat16, torch.float32)
WIDTHS = (64, 192, 384, 512)


def _inputs(c, dtype, seed, rows=(3, 7)):
    """x of (3, 7, C) (21 rows: an odd count), off-centre and scaled per row,
    weight and bias near 1 and 0, all from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*rows, c)) * rng.uniform(0.5, 3.0, size=(*rows, 1)) \
        + rng.normal(size=(*rows, 1))
    w = 1.0 + 0.1 * rng.normal(size=c)
    b = 0.1 * rng.normal(size=c)
    return (torch.tensor(x, dtype=torch.float32).to(dtype),
            torch.tensor(w, dtype=torch.float32), torch.tensor(b, dtype=torch.float32))


def _chain(x, w, b, eps, out_dtype):
    """The chain ``models/layers.py::LayerNorm`` ran before the kernel."""
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps).to(out_dtype)


def _grads(fn, x, w, b, dy):
    x, w, b = (t.detach().clone().requires_grad_() for t in (x, w, b))
    fn(x, w, b).backward(dy)
    return x.grad, w.grad, b.grad


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("out_dtype", DTYPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cpu_path_is_the_chain_bit_for_bit(dtype, out_dtype, c, eps):
    x, w, b = _inputs(c, dtype, seed=c)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(c)).to(out_dtype)
    want = _chain(x, w, b, eps, out_dtype)
    got = ln.layer_norm(x, w, b, eps, out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)
    module = LayerNorm(c, eps, out_dtype)
    with torch.no_grad():
        module.weight.copy_(w)
        module.bias.copy_(b)
    assert torch.equal(module(x), want)
    grads = _grads(lambda *a: ln.layer_norm(*a, eps, out_dtype), x, w, b, dy)
    grads_want = _grads(lambda *a: _chain(*a, eps, out_dtype), x, w, b, dy)
    for g, g_want in zip(grads, grads_want):
        assert g.dtype == g_want.dtype and torch.equal(g, g_want)


def _aligned(shape, dtype):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("case", [
    "float16 input", "float16 output", "width 100", "width 1032", "width 0",
    "transposed input", "misaligned input", "bfloat16 weight", "weight of another width",
    "no bias", "non-contiguous weight"])
def test_kernel_checks_refuse_what_the_kernels_do_not_take(case):
    x, w, b = _aligned((4, 64), torch.bfloat16), _aligned(64, torch.float32), \
        _aligned(64, torch.float32)
    out = torch.bfloat16
    if case == "float16 input":
        x = x.half()
    elif case == "float16 output":
        out = torch.float16
    elif case in ("width 100", "width 1032", "width 0"):
        c = int(case.split()[1])
        x, w, b = _aligned((4, c), torch.bfloat16), _aligned(c, torch.float32), \
            _aligned(c, torch.float32)
    elif case == "transposed input":
        x = _aligned((64, 64), torch.bfloat16).t()
    elif case == "misaligned input":
        x = _aligned(4 * 64 + 1, torch.bfloat16)[1:].view(4, 64)
    elif case == "bfloat16 weight":
        w = w.bfloat16()
    elif case == "weight of another width":
        w = _aligned(72, torch.float32)
    elif case == "no bias":
        b = None
    elif case == "non-contiguous weight":
        w = _aligned(128, torch.float32)[::2]
    with pytest.raises((TypeError, ValueError)):
        ln.check_kernel_inputs(x, w, b, out)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_checks_take_the_main_paths_operands(dtype):
    for c in WIDTHS + (8, 1024):
        x, w, b = _inputs(c, dtype, seed=1)
        ln.check_kernel_inputs(x.contiguous(), w, b, torch.bfloat16)
        ln.check_kernel_inputs(x.reshape(-1, c)[5:], w, b, torch.float32)  # 16-byte rows


def test_other_devices_refused():
    x = torch.zeros((2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ln.layer_norm(x, torch.zeros(64, device="meta"), torch.zeros(64, device="meta"),
                      1e-6, torch.float32)


class FakeLaunches:
    """The two C launches replaced by the kernels' arithmetic in torch (fp32
    statistics from the row; dx = rstd (g - mean(g) - xh mean(g xh)) with
    g = dy w; dw, db summed over the rows), so the card's path of the wrapper
    runs on CPU tensors. Records what each launch was handed."""

    def __init__(self):
        self.forward, self.forward_blocks, self.backward = [], [], []

    def launch_forward(self, x, weight, bias, y, stats, eps, blocks):
        self.forward.append(None if stats is None else tuple(stats.shape))
        self.forward_blocks.append(blocks)
        xf = x.float()
        m = xf.mean(-1, keepdim=True)
        r = torch.rsqrt(((xf - m) ** 2).mean(-1, keepdim=True) + eps)
        y.copy_(((xf - m) * r * weight + bias).to(y.dtype))
        if stats is not None:
            stats.copy_(torch.stack([m[..., 0], r[..., 0]]))

    def launch_backward(self, x, dy, weight, stats, dx, partial, grads, blocks):
        self.backward.append((tuple(partial.shape), blocks))
        mean, rstd = stats[0, ..., None], stats[1, ..., None]
        xh = (x.float() - mean) * rstd
        d = dy.float()
        g = d * weight
        dx.copy_((rstd * (g - g.mean(-1, keepdim=True)
                          - xh * (g * xh).mean(-1, keepdim=True))).to(dx.dtype))
        c = x.shape[-1]
        grads.copy_(torch.stack([(d * xh).reshape(-1, c).sum(0), d.reshape(-1, c).sum(0)]))


@pytest.fixture
def fake(monkeypatch):
    f = FakeLaunches()
    monkeypatch.setattr(ln, "_launch_forward", f.launch_forward)
    monkeypatch.setattr(ln, "_launch_backward", f.launch_backward)
    monkeypatch.setattr(ln, "_blocks", lambda x, out_dtype, backward:
                        min(-(-(x.numel() // x.shape[-1]) // 4), 3))
    return f


def _close(got, want, dtype):
    """Within fp32 summation order: 1e-5 of the largest value; after a
    rounding to bf16, one bf16 ulp of the value (of 2^-10 at the least)."""
    got, want = got.float(), want.float()
    if dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -10))) - 7)
        assert bool(((got - want).abs() <= ulp).all())
    else:
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("out_dtype", DTYPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_card_path_plumbing(fake, dtype, out_dtype):
    eps = 1e-6
    x, w, b = _inputs(384, dtype, seed=2)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)).to(out_dtype)
    launches, bwd_launches = ln.layer_norm.launches, ln.layer_norm.bwd_launches
    with torch.no_grad():
        y = ln._on_card(x, w, b, eps, out_dtype)
    assert fake.forward == [None]  # no statistics saved without a gradient
    _close(y, _chain(x, w, b, eps, out_dtype), out_dtype)
    grads = _grads(lambda *a: ln._on_card(*a, eps, out_dtype), x, w, b, dy)
    assert fake.forward[1] == (2, 3, 7) and fake.backward == [((2, 3, 384), 3)]
    assert fake.forward_blocks == [3, 3]
    assert ln.layer_norm.launches == launches + 2
    assert ln.layer_norm.bwd_launches == bwd_launches + 1
    for got, want, t in zip(grads, _grads(lambda *a: _chain(*a, eps, out_dtype), x, w, b, dy),
                            (dtype, torch.float32, torch.float32)):
        assert got.dtype == want.dtype
        _close(got, want, t)


def test_card_path_gradients_only_where_wanted(fake):
    x, w, b = _inputs(64, torch.bfloat16, seed=3)
    w.requires_grad_()
    ln._on_card(x, w, b, 1e-5, torch.bfloat16).float().sum().backward()
    assert w.grad is not None and x.grad is None and b.grad is None


def test_grid_from_kernel_attributes(monkeypatch):
    """A launch's blocks: a block's rows (a warp a row, from the kernel's
    threads) up to the card's resident blocks (blocks an SM times the SMs),
    asked once a width, pair of types, direction and card."""
    asked = []

    def attributes(c, dtype, out_dtype, backward=False):
        asked.append((c, dtype, out_dtype, backward))
        return {"blocks_per_sm": 5 if backward else 8, "threads": 128}

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(ln, "_grids", {})
    monkeypatch.setattr(ln, "kernel_attributes", attributes)
    monkeypatch.setattr(ln, "_device", lambda x: ln._SAME)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props)
    bf = torch.bfloat16
    assert ln._blocks(torch.empty(37, 384, dtype=bf), bf, False) == 10
    assert ln._blocks(torch.empty(8192, 384, dtype=bf), bf, False) == 8 * 132
    assert ln._blocks(torch.empty(8192, 384, dtype=bf), bf, True) == 5 * 132
    assert ln._blocks(torch.empty(2, 64, 384, dtype=bf), bf, True) == 32
    assert asked == [(384, bf, bf, False), (384, bf, bf, True)]
    ln._blocks(torch.empty(8, 384, dtype=bf), torch.float32, False)
    assert asked[-1] == (384, bf, torch.float32, False) and len(asked) == 3


def _count_norms(model):
    calls = []
    hooks = [m.register_forward_hook(lambda m, i, o, name=name: calls.append(name))
             for name, m in model.named_modules() if isinstance(m, LayerNorm)]
    return calls, hooks


@pytest.mark.parametrize("training", [False, True])
def test_recognizer_tokens_unchanged_without_taps(training):
    model = CCDRecognizer(arch="vit_micro", **MICRO_DECODER)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.train(training)
    x = torch.from_numpy(seeded_images(5, (2, 32, 128, 3)))
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    with torch.no_grad():
        tokens_with, taps = model.backbone(x, g1)
        calls, hooks = _count_norms(model.backbone)
        tokens = model.extract_feat(x, g2)
    for h in hooks:
        h.remove()
    assert len(taps) == 3 and torch.equal(tokens, tokens_with)
    assert not any(name.startswith("norm_seg") for name in calls)
    assert len(calls) == 2 * len(model.backbone.blocks) + 1


def test_teacher_skips_the_taps_and_the_student_keeps_them():
    student = CCDPretrainModel(arch="vit_micro", out_dim=256, with_seg_head=True)
    teacher = CCDPretrainModel(arch="vit_micro", out_dim=256, with_seg_head=False)
    student.reset_parameters(torch.Generator().manual_seed(0))
    teacher.load_state_dict(student.state_dict(), strict=False)
    x = torch.from_numpy(seeded_images(6, (2, 32, 128, 3)))
    student.eval()
    teacher.eval()
    with torch.no_grad():
        tokens, taps = teacher.backbone(x)  # with the taps, as before
        calls, hooks = _count_norms(teacher.backbone)
        region_f, none = teacher.encode(x)
        for h in hooks:
            h.remove()
        s_region_f, s_taps = student.encode(x)
    assert none == [] and len(calls) == 2 * len(teacher.backbone.blocks) + 1
    assert torch.equal(region_f, tokens.reshape(region_f.shape))
    assert torch.equal(s_region_f, region_f) and len(s_taps) == 3
    for got, want in zip(s_taps, taps):
        assert got.shape == (2, 8, 32, 64) and torch.equal(got, want)


def test_c_signatures_match_the_source():
    """The ctypes argument lists the wrapper declares are the C entries' own
    (read from ``csrc/layer_norm.cu``): a pointer, an int or a float each. A
    list that is off passes its arguments to the wrong parameters, which no
    test here can run."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(ln.__file__), os.pardir, "csrc",
                            "layer_norm.cu")).read()
    found = {}
    for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        found[name] = "".join("p" if "*" in a else "f" if "float" in a else "i"
                              for a in args.split(","))
    assert {name: found.get(name) for name in ln._SIGNATURES} == ln._SIGNATURES
    # ops/_build.py::kernel_attributes passes ints, then the output pointer
    assert found["layer_norm_attributes"] == "iiiip"
