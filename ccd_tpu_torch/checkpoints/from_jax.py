"""Weights carried across: the JAX package's parameter tree, or a reference
CCD ``.pth``, into the port's ``state_dict``.

The port's modules use the reference's parameter names
(``backbone.blocks.{i}.attn.qkv.weight``, ``decoder.layer_stack.{i}...``), so
a released ``{'net': state_dict}`` checkpoint loads by name. A tree of the JAX
package's ``CCDRecognizer`` (nested dicts of numpy arrays) is renamed and
transposed here: Flax ``(in, out)`` kernels become ``(out, in)``, the NHWC
patch-conv kernel ``(kh, kw, in, out)`` becomes ``(out, in, kh, kw)``, module
names ``blocks_i`` / ``layer_i`` / ``norm_seg_i`` become ``blocks.i`` /
``layer_stack.i`` / ``norm_seg.i``. Only numpy is seen here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# keys the reference state_dict carries and the port has no use for: a
# cls_token parameter that is never prepended, and the sinusoid buffer that
# the port recomputes
_DROPPED_KEYS = ("backbone.cls_token", "decoder.position_enc.position_table")


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _put(sd: Dict[str, np.ndarray], prefix: str, leaf: Mapping[str, Any],
         transpose_kernel=None) -> None:
    """Write one Flax Dense/Conv/LayerNorm leaf under torch naming."""
    if "kernel" in leaf:
        k = _np(leaf["kernel"])
        sd[f"{prefix}.weight"] = transpose_kernel(k) if transpose_kernel else k.T
        if "bias" in leaf:
            sd[f"{prefix}.bias"] = _np(leaf["bias"])
    elif "scale" in leaf:  # LayerNorm
        sd[f"{prefix}.weight"] = _np(leaf["scale"])
        sd[f"{prefix}.bias"] = _np(leaf["bias"])
    else:
        raise KeyError(f"{prefix}: neither 'kernel' nor 'scale' in {sorted(leaf)}")


def _vit(p: Mapping[str, Any], prefix: str, sd: Dict[str, np.ndarray]) -> None:
    """``VisionTransformer`` tree -> reference names under ``prefix``."""
    sd[f"{prefix}pos_embed"] = _np(p["pos_embed"])
    _put(sd, f"{prefix}patch_embed.proj", p["patch_embed"]["proj"],
         lambda k: k.transpose(3, 2, 0, 1))
    depth = sum(1 for k in p if k.startswith("blocks_"))
    for i in range(depth):
        bp, b = f"{prefix}blocks.{i}.", p[f"blocks_{i}"]
        _put(sd, f"{bp}norm1", b["norm1"])
        _put(sd, f"{bp}norm2", b["norm2"])
        _put(sd, f"{bp}attn.qkv", b["attn"]["qkv"])
        _put(sd, f"{bp}attn.proj", b["attn"]["proj"])
        _put(sd, f"{bp}mlp.fc1", b["mlp"]["fc1"])
        _put(sd, f"{bp}mlp.fc2", b["mlp"]["fc2"])
    _put(sd, f"{prefix}norm", p["norm"])
    n_taps = sum(1 for k in p if k.startswith("norm_seg_"))
    for i in range(n_taps):
        _put(sd, f"{prefix}norm_seg.{i}", p[f"norm_seg_{i}"])


def _nrtr(p: Mapping[str, Any], prefix: str, sd: Dict[str, np.ndarray]) -> None:
    """``NRTRDecoder`` tree -> reference names under ``prefix``."""
    sd[f"{prefix}trg_word_emb.weight"] = _np(p["trg_word_emb"]["embedding"])
    n_layers = sum(1 for k in p if k.startswith("layer_") and k != "layer_norm")
    for i in range(n_layers):
        lp, l = f"{prefix}layer_stack.{i}.", p[f"layer_{i}"]
        for nm in ("norm1", "norm2", "norm3"):
            _put(sd, f"{lp}{nm}", l[nm])
        for attn in ("self_attn", "enc_attn"):
            for lin in ("linear_q", "linear_k", "linear_v", "fc"):
                _put(sd, f"{lp}{attn}.{lin}", l[attn][lin])
        _put(sd, f"{lp}mlp.w_1", l["mlp"]["w_1"])
        _put(sd, f"{lp}mlp.w_2", l["mlp"]["w_2"])
    _put(sd, f"{prefix}layer_norm", p["layer_norm"])
    _put(sd, f"{prefix}classifier", p["classifier"])


def _to_torch(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def vit_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``VisionTransformer`` tree -> the port's ViT ``state_dict``."""
    sd: Dict[str, np.ndarray] = {}
    _vit(params, "", sd)
    return _to_torch(sd)


def nrtr_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``NRTRDecoder`` tree -> the port's decoder ``state_dict``."""
    sd: Dict[str, np.ndarray] = {}
    _nrtr(params, "", sd)
    return _to_torch(sd)


def recognizer_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``CCDRecognizer`` parameter tree (nested dicts of
    numpy arrays: ``backbone`` / ``encoder`` / ``decoder``) -> a ``state_dict``
    that the port's ``CCDRecognizer`` loads with ``strict=True``."""
    sd: Dict[str, np.ndarray] = {}
    _vit(params["backbone"], "backbone.", sd)
    _put(sd, "encoder.fc1", params["encoder"]["fc1"])
    _put(sd, "encoder.fc2", params["encoder"]["fc2"])
    _nrtr(params["decoder"], "decoder.", sd)
    return _to_torch(sd)


def clean_recognizer_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference-style recognizer ``state_dict`` made ready for a strict
    load: the ``module.`` prefix of a ``DataParallel`` save is stripped and
    the two keys the port has no use for are dropped by name."""
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k not in _DROPPED_KEYS:
            out[k] = v
    return out
