"""Weights carried across: the JAX package's parameter tree, or a reference
CCD ``.pth``, into the port's ``state_dict``.

The port's modules use the reference's parameter names
(``backbone.blocks.{i}.attn.qkv.weight``, ``decoder.layer_stack.{i}...``), so
a released ``{'net': state_dict}`` checkpoint loads by name. A tree of the JAX
package's ``CCDRecognizer`` (nested dicts of numpy arrays) is renamed and
transposed here: Flax ``(in, out)`` kernels become ``(out, in)``, the NHWC
patch-conv kernel ``(kh, kw, in, out)`` becomes ``(out, in, kh, kw)``, module
names ``blocks_i`` / ``layer_i`` / ``norm_seg_i`` become ``blocks.i`` /
``layer_stack.i`` / ``norm_seg.i``. The pretraining model's heads follow the
reference's ``Sequential`` numbering: DINOHead ``mlp_j`` -> ``mlp.{0,2,4}``
(with ``use_bn``: ``mlp_j`` / ``bn_j`` -> ``mlp.{0,3,6}`` / ``mlp.{1,4}``),
``last_layer_g``/``last_layer_v`` -> ``last_layer.weight_g``/``weight_v``;
SegHead ``head{i}.conv1/bn1/conv2/bn2`` -> ``mlahead.head{i}.{0,1,3,4}``,
``unpool{j}_conv``/``unpool{j}_bn`` -> ``unpool{j}.{0,1}``, with the Flax
``batch_stats`` (mean, var) as the BatchNorm buffers. Only numpy is seen here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

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


def _bn(sd: Dict[str, np.ndarray], prefix: str, params: Mapping[str, Any],
        stats: Mapping[str, Any]) -> None:
    """A Flax BatchNorm's params and batch_stats (mean, var) under torch naming."""
    _put(sd, prefix, params)
    sd[f"{prefix}.running_mean"] = _np(stats["mean"])
    sd[f"{prefix}.running_var"] = _np(stats["var"])


def _dino_head(p: Mapping[str, Any], prefix: str, sd: Dict[str, np.ndarray],
               stats: Optional[Mapping[str, Any]] = None) -> None:
    """``DINOHead`` tree (and, with ``use_bn``, its ``batch_stats``) ->
    reference names (Sequential mlp + weight_norm): ``mlp_j`` -> ``mlp.{2j}``
    without BatchNorm; ``mlp_j`` -> ``mlp.{3j}`` and ``bn_j`` -> ``mlp.{3j+1}``
    with it."""
    nlayers = sum(1 for k in p if k.startswith("mlp_"))
    use_bn = any(k.startswith("bn_") for k in p)
    if use_bn and stats is None:
        raise ValueError(f"{prefix or 'DINOHead'}: the head has BatchNorms (bn_*) but no "
                         "batch_stats were given")
    stride = 3 if use_bn else 2
    for j in range(nlayers):
        _put(sd, f"{prefix}mlp.{stride * j}", p[f"mlp_{j}"])
        if use_bn and j < nlayers - 1:
            _bn(sd, f"{prefix}mlp.{stride * j + 1}", p[f"bn_{j}"], stats[f"bn_{j}"])
    sd[f"{prefix}last_layer.weight_g"] = _np(p["last_layer_g"]).reshape(-1, 1)
    sd[f"{prefix}last_layer.weight_v"] = _np(p["last_layer_v"]).T


def _seg_head(p: Mapping[str, Any], stats: Mapping[str, Any], prefix: str,
              sd: Dict[str, np.ndarray]) -> None:
    """``SegHead`` params + batch_stats -> reference names."""
    conv = lambda k: k.transpose(3, 2, 0, 1)             # (kh,kw,in,out) -> (out,in,kh,kw)
    conv_transpose = lambda k: k.transpose(2, 3, 0, 1)   # (kh,kw,in,out) -> (in,out,kh,kw)
    for i in (2, 3, 4):
        hp, h, hs = f"{prefix}mlahead.head{i}.", p[f"head{i}"], stats[f"head{i}"]
        _put(sd, f"{hp}0", h["conv1"], conv)
        _bn(sd, f"{hp}1", h["bn1"], hs["bn1"])
        _put(sd, f"{hp}3", h["conv2"], conv)
        _bn(sd, f"{hp}4", h["bn2"], hs["bn2"])
    for j in (1, 2):
        _put(sd, f"{prefix}unpool{j}.0", p[f"unpool{j}_conv"], conv_transpose)
        _bn(sd, f"{prefix}unpool{j}.1", p[f"unpool{j}_bn"], stats[f"unpool{j}_bn"])
    _put(sd, f"{prefix}cls", p["cls"], conv)


def _to_torch(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    # a copy: the source may be a read-only view of a device array
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


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


def dino_head_state_dict_from_jax(params: Mapping[str, Any],
                                  batch_stats: Optional[Mapping[str, Any]] = None
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``DINOHead`` tree (and its ``batch_stats`` with
    ``use_bn``) -> the port's DINOHead ``state_dict``."""
    sd: Dict[str, np.ndarray] = {}
    _dino_head(params, "", sd, batch_stats)
    return _to_torch(sd)


def seg_head_state_dict_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                                 ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``SegHead`` params and ``batch_stats`` -> the port's
    SegHead ``state_dict`` (running statistics included)."""
    sd: Dict[str, np.ndarray] = {}
    _seg_head(params, batch_stats, "", sd)
    return _to_torch(sd)


def pretrain_state_dicts_from_jax(student_params: Mapping[str, Any],
                                  student_stats: Mapping[str, Any],
                                  teacher_params: Mapping[str, Any]
                                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The JAX package's pretraining state (student params ``backbone`` /
    ``segmentation`` / ``head``, student ``batch_stats``, teacher params
    ``backbone`` / ``head``) -> (student, teacher) ``state_dict``s that the
    port's ``CCDPretrainModel``s load with ``strict=True``."""
    student: Dict[str, np.ndarray] = {}
    _vit(student_params["backbone"], "backbone.", student)
    _seg_head(student_params["segmentation"], student_stats["segmentation"],
              "segmentation.", student)
    _dino_head(student_params["head"], "head.", student)
    teacher: Dict[str, np.ndarray] = {}
    _vit(teacher_params["backbone"], "backbone.", teacher)
    _dino_head(teacher_params["head"], "head.", teacher)
    return _to_torch(student), _to_torch(teacher)


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
