"""The port's random initialisation against the JAX package's ``init``.

At ``vit_tiny`` with the convergence demo's decoder (3 layers, width 256)
and the demo's DINO head (``out_dim`` 8192, SegHead on the student), every
tensor that JAX's ``init`` draws at random is drawn by the port's
``reset_parameters`` too, and each is held to its JAX twin (after the name
mapping of ``checkpoints/from_jax.py``): the standard deviation within 3 %,
and the largest |x| within the initialiser's bound. The initialisers:

* ``truncated``: JAX's ``truncated_normal(stddev=0.02, lower=-2, upper=2)``
  (every Dense, the pos-embed table, ``last_layer_v``): no correction for
  the truncation, std 0.8796 * 0.02, |x| <= 0.04;
* ``lecun``: Flax's ``lecun_normal`` (the patch projection, the SegHead
  convolutions): std sqrt(1 / fan_in), |x| <= 2 sqrt(1 / fan_in) / 0.8796;
* ``uniform``: the SegHead's transposed convolutions, |x| <= sqrt(1 / fan_in);
* ``embedding``: the NRTR embedding, normal(1), no bound.

Seeds do not cross frameworks, so the draws differ and only their
statistics are compared. A tensor of fewer than POOL entries (the SegHead's
classifier has 2304, the patch projection 9216) would leave 1-2 % of
sampling noise in each side's std, so its std is taken over more draws of
the same initialiser on its shape: the port's sampler (``trunc_normal_``,
``lecun_normal_``, or the uniform / normal draw its ``reset_parameters``
makes) under more generators, JAX's initialiser (as its module declares it)
under more keys, until each side holds POOL entries.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccd_tpu.models import CCDPretrainModel as JaxPretrainModel
from ccd_tpu.models import CCDRecognizer as JaxCCDRecognizer
from ccd_tpu_torch.checkpoints.from_jax import (pretrain_state_dicts_from_jax,
                                                recognizer_state_dict_from_jax)
from ccd_tpu_torch.models import CCDRecognizer
from ccd_tpu_torch.models.layers import lecun_normal_, trunc_normal_
from ccd_tpu_torch.models.pretrain import CCDPretrainModel

DEMO_DECODER = dict(decoder_n_layers=3, decoder_d_embedding=256, decoder_n_head=8,
                    decoder_d_model=256, decoder_d_inner=1024, decoder_d_k=32, decoder_d_v=32,
                    max_seq_len=25)
OUT_DIM = 8192
STD_RTOL = 0.03
POOL = 1 << 15
TRUNC_STD = 0.02
UNIT_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated at +-2


def _initialiser(name: str) -> str:
    if name == "decoder.trg_word_emb.weight":
        return "embedding"
    if ".unpool" in name:
        return "uniform"
    if name == "backbone.patch_embed.proj.weight" or name.startswith("segmentation."):
        return "lecun"
    return "truncated"


def _fan_in(value: np.ndarray, name: str) -> int:
    if value.ndim == 4:  # torch layout: (out, in, kh, kw); transposed: (in, out, kh, kw)
        i = 0 if ".unpool" in name else 1
        return value.shape[i] * value.shape[2] * value.shape[3]
    return value.shape[1]


def _bound(kind: str, value: np.ndarray, name: str) -> float:
    if kind == "truncated":
        return 2.0 * TRUNC_STD
    fan_in = _fan_in(value, name)
    if kind == "lecun":
        return 2.0 * math.sqrt(1.0 / fan_in) / UNIT_TRUNC_STD
    if kind == "uniform":
        return math.sqrt(1.0 / fan_in)
    return math.inf


def _jax_initialiser(kind: str):
    init = jax.nn.initializers
    return {"truncated": init.truncated_normal(TRUNC_STD, lower=-2.0, upper=2.0),
            "lecun": init.lecun_normal(),
            "uniform": init.variance_scaling(1 / 3, "fan_in", "uniform"),
            "embedding": init.normal(1.0)}[kind]


def _jax_pooled(name: str, value: np.ndarray, draws: int) -> np.ndarray:
    """``value`` and ``draws - 1`` more draws of its initialiser, on a
    (fan_in, rest) shape: the fan-in is what the initialisers read."""
    fan_in = _fan_in(value, name) if value.ndim == 4 else value.shape[-1]
    fn = _jax_initialiser(_initialiser(name))
    more = [np.asarray(fn(jax.random.PRNGKey(100 + i), (fan_in, value.size // fan_in)))
            for i in range(draws - 1)]
    return np.concatenate([value.ravel()] + [m.ravel() for m in more])


def _port_pooled(name: str, value: np.ndarray, draws: int) -> np.ndarray:
    """``value`` and ``draws - 1`` more draws of the port's sampler for it."""
    kind, more = _initialiser(name), []
    for i in range(draws - 1):
        g = torch.Generator().manual_seed(100 + i)
        t = torch.empty(value.shape)
        if kind == "truncated":
            trunc_normal_(t, TRUNC_STD, g)
        elif kind == "lecun":
            lecun_normal_(t, _fan_in(value, name), g)
        elif kind == "uniform":
            bound = _bound(kind, value, name)
            t.uniform_(-bound, bound, generator=g)
        else:
            t.normal_(0.0, 1.0, generator=g)
        more.append(t.numpy().ravel())
    return np.concatenate([value.ravel()] + more)


@pytest.fixture(scope="module")
def tensors():
    """{name: (jax value, port value, jax pooled draws, port pooled draws)}
    of every tensor JAX draws at random."""
    jrec = JaxCCDRecognizer(arch="vit_tiny", **DEMO_DECODER)
    # Flax's init jitted: a fraction of the time of its eager init here
    rec_params = jax.jit(functools.partial(jrec.init, train_mode=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 128, 3)), jnp.zeros((1, 25), jnp.int32))["params"]
    jpre = JaxPretrainModel(arch="vit_tiny", out_dim=OUT_DIM, with_seg_head=True,
                            norm_last_layer=False)
    variables = jax.jit(jpre.init)(jax.random.PRNGKey(1), jnp.zeros((1, 32, 128, 3)),
                                   jnp.zeros((1, 26, 32, 128)))
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, jax.device_get(tree))
    want = {f"recognizer.{k}": v.numpy()
            for k, v in recognizer_state_dict_from_jax(as_np(rec_params)).items()}
    student, _ = pretrain_state_dicts_from_jax(as_np(variables["params"]),
                                               as_np(variables["batch_stats"]),
                                               as_np(variables["params"]))
    want.update({f"student.{k}": v.numpy() for k, v in student.items()})

    rec = CCDRecognizer(arch="vit_tiny", **DEMO_DECODER)
    rec.reset_parameters(torch.Generator().manual_seed(0))
    pre = CCDPretrainModel(arch="vit_tiny", out_dim=OUT_DIM, with_seg_head=True,
                           norm_last_layer=False)
    pre.reset_parameters(torch.Generator().manual_seed(1))
    got = {f"recognizer.{k}": v.detach().numpy() for k, v in rec.state_dict().items()}
    got.update({f"student.{k}": v.detach().numpy() for k, v in pre.state_dict().items()})
    assert set(got) == set(want)
    out = {}
    for k, v in want.items():
        if v.std() > 0:
            draws, local = -(-POOL // v.size), k.split(".", 1)[1]
            out[k] = (v, got[k], _jax_pooled(local, v, draws), _port_pooled(local, got[k], draws))
    return out


def test_every_random_tensor_is_held(tensors):
    kinds = {}
    for name in tensors:
        kinds.setdefault(_initialiser(name.split(".", 1)[1]), []).append(name)
    assert set(kinds) == {"truncated", "lecun", "uniform", "embedding"}
    # the decoder's sinusoid table, biases, scales and running statistics are
    # constants: none of them is drawn
    assert not any(n.endswith(("bias", "running_mean", "running_var")) for n in tensors)
    assert min(v.size for v, *_ in tensors.values()) == 2304


@pytest.mark.parametrize("kind", ["truncated", "lecun", "uniform", "embedding"])
def test_std_and_bound_match_jax_init(tensors, kind):
    held = 0
    for name, (want, got, want_pooled, got_pooled) in tensors.items():
        local = name.split(".", 1)[1]
        if _initialiser(local) != kind:
            continue
        assert got.shape == want.shape and want_pooled.size == got_pooled.size >= POOL, name
        np.testing.assert_allclose(got_pooled.std(), want_pooled.std(), rtol=STD_RTOL,
                                   err_msg=name)
        assert abs(float(got_pooled.mean())) <= 0.05 * float(want_pooled.std()), name
        bound = _bound(kind, want, local)
        assert np.abs(want).max() <= bound * (1 + 1e-6), f"{name}: the JAX side's bound"
        assert np.abs(got).max() <= bound * (1 + 1e-6), name
        held += 1
    assert held > 0


def test_truncated_std_is_uncorrected(tensors):
    """JAX's ``truncated_normal(0.02)``: std 0.8796 * 0.02 = 0.01759, not
    0.02 (the port drew 0.0200 before it followed JAX here)."""
    want, got, *_ = tensors["recognizer.backbone.blocks.0.mlp.fc1.weight"]
    np.testing.assert_allclose(got.std(), TRUNC_STD * UNIT_TRUNC_STD, rtol=STD_RTOL)
    np.testing.assert_allclose(want.std(), TRUNC_STD * UNIT_TRUNC_STD, rtol=STD_RTOL)
