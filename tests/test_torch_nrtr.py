"""The port's NRTR decoder against the JAX package, fp32, CPU.

Tolerance 1e-4 absolute on logits and on per-step probabilities: fp32 sums in
another order (three Linears here, one packed matmul there) through two
layers. Greedy tokens must be identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccd_tpu.models.nrtr import NRTRDecoder as JaxNRTRDecoder
from ccd_tpu_torch.checkpoints.from_jax import nrtr_state_dict_from_jax
from ccd_tpu_torch.models.nrtr import NRTRDecoder, sinusoid_table

from _torch_port import perturbed_numpy_tree, to_jnp

CFG = dict(n_layers=2, d_embedding=64, n_head=2, d_k=32, d_v=32, d_model=64,
           d_inner=64, max_seq_len=6)
ENC_WIDTH = 512  # the recognizer's encoder output, whatever d_model is


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    enc = rng.normal(size=(3, 256, ENC_WIDTH)).astype(np.float32)
    targets = rng.integers(0, 91, size=(3, 6)).astype(np.int32)
    targets[0, 4:] = 92  # padded tail
    jmodel = JaxNRTRDecoder(**CFG)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(enc),
                         jnp.asarray(targets), train_mode=True)["params"]
    tree = perturbed_numpy_tree(params, seed=1)
    # sharpen the classifier so greedy argmaxes are well separated
    tree["classifier"]["kernel"] = tree["classifier"]["kernel"] * 20.0
    tmodel = NRTRDecoder(**CFG, d_enc=ENC_WIDTH).eval()
    tmodel.load_state_dict(nrtr_state_dict_from_jax(tree), strict=True)
    return jmodel, to_jnp(tree), tmodel, enc, targets


def test_sinusoid_table_matches():
    from ccd_tpu.models.nrtr import sinusoid_table as jax_table
    np.testing.assert_array_equal(sinusoid_table(200, 64), jax_table(200, 64))


def test_forward_train_matches_jax(pair):
    jmodel, jparams, tmodel, enc, targets = pair
    ref, ref_attn = jax.jit(lambda p, e, t: jmodel.apply(
        {"params": p}, e, t, method=JaxNRTRDecoder.forward_train))(
        jparams, jnp.asarray(enc), jnp.asarray(targets))
    with torch.no_grad():
        out, attn = tmodel.forward_train(torch.from_numpy(enc),
                                         torch.from_numpy(targets).long())
    assert out.shape == (3, 6, 92)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn), atol=1e-5)


@pytest.fixture(scope="module")
def greedy(pair):
    jmodel, jparams, tmodel, enc, _ = pair
    ref = jax.jit(lambda p, e: jmodel.apply(
        {"params": p}, e, method=JaxNRTRDecoder.decode_greedy))(jparams, jnp.asarray(enc))
    with torch.no_grad():
        out = tmodel.decode_greedy(torch.from_numpy(enc))
    return np.asarray(ref), out.numpy()


def test_decode_greedy_probabilities_match_jax(greedy):
    ref, out = greedy
    assert out.shape == (3, 6, 92) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)


def test_decode_greedy_tokens_equal_jax(greedy):
    ref, out = greedy
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


def test_kv_cache_changes_nothing(pair, greedy):
    """decode_greedy equals the argmax path of a teacher-forced full recompute
    in the port: feed [BOS, tokens so far, PAD...] through forward_train at
    every step, as the reference loop does."""
    _, _, tmodel, enc, _ = pair
    _, out = greedy
    t_enc = torch.from_numpy(enc)
    b, steps = out.shape[:2]
    seq = torch.full((b, steps + 1), tmodel.padding_idx, dtype=torch.long)
    seq[:, 0] = tmodel.start_idx
    with torch.no_grad():
        for t in range(steps):
            logits, _ = tmodel.forward_train(t_enc, seq)
            probs = torch.softmax(logits[:, t].float(), -1)
            np.testing.assert_allclose(probs.numpy(), out[:, t], atol=1e-5)
            seq[:, t + 1] = probs.argmax(-1)
    np.testing.assert_array_equal(seq[:, 1:].numpy(), out.argmax(-1))


def test_early_stop_b1_equals_greedy_up_to_the_stop(pair, monkeypatch):
    """With random weights greedy need not emit id 91, so the token that
    greedy emits at step 2 is declared the end token for this test."""
    _, _, tmodel, enc, _ = pair
    t_enc = torch.from_numpy(enc[:1])
    with torch.no_grad():
        full = tmodel.decode_greedy(t_enc)
    toks = full.argmax(-1)[0]
    stop_tok = int(toks[2])
    monkeypatch.setattr(NRTRDecoder, "end_token_id", property(lambda self: stop_tok))
    with torch.no_grad():
        early = tmodel.decode_greedy_early_stop(t_enc)
    stop = int((toks == stop_tok).nonzero()[0])
    assert stop + 1 < full.shape[1], "the stop must come before the last step"
    np.testing.assert_array_equal(early[:, :stop + 1].numpy(), full[:, :stop + 1].numpy())
    assert float(early[:, stop + 1:].abs().max()) == 0.0
