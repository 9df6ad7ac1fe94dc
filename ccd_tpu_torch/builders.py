"""Config -> model builders and checkpoint loaders shared by the entry points."""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch

from ccd_tpu_torch.checkpoints.from_jax import clean_recognizer_state_dict
from ccd_tpu_torch.config import Config
from ccd_tpu_torch.convertor import AttnConvertor
from ccd_tpu_torch.models.pretrain import CCDPretrainModel
from ccd_tpu_torch.models.recognizer import CCDRecognizer
from ccd_tpu_torch.utils.device import resolve_device


def compute_dtype(config: Config) -> torch.dtype:
    name = getattr(config, "compute_dtype", None) or "float32"
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(name)]


def build_recognizer(config: Config, device: Union[str, torch.device] = "cuda",
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[CCDRecognizer, AttnConvertor]:
    """DINO_Finetune equivalent (dino_vision.py:135-183): the convertor's
    num_classes/start/padding ids override the config decoder block.

    The model is initialised on the CPU under ``generator`` (seed 0 when
    None), so the same seed gives the same weights whatever the device, then
    moved to ``device`` in eval mode. ``device='cuda'`` without a card raises.
    """
    device = resolve_device(device)
    arch = str(config.arch).replace("deit", "vit")
    convertor = AttnConvertor(dict_type=config.dataset_charset_type or "DICT90",
                              max_seq_len=config.decoder_max_seq_len,
                              with_unknown=True)
    model = CCDRecognizer(
        arch=arch,
        patch_size=config.patch_size,
        drop_path_rate=config.drop_path_rate,
        decoder_n_layers=config.decoder_n_layers,
        decoder_d_embedding=config.decoder_d_embedding,
        decoder_n_head=config.decoder_n_head,
        decoder_d_k=config.decoder_d_k,
        decoder_d_v=config.decoder_d_v,
        decoder_d_model=config.decoder_d_model,
        decoder_d_inner=config.decoder_d_inner,
        num_classes=convertor.num_classes(),
        max_seq_len=config.decoder_max_seq_len,
        start_idx=convertor.start_idx,
        padding_idx=convertor.padding_idx,
        dtype=compute_dtype(config),
    )
    model.reset_parameters(generator or torch.Generator().manual_seed(0))
    return model.to(device).eval(), convertor


def build_pretrain_models(config: Config, device: Union[str, torch.device] = "cuda",
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[CCDPretrainModel, CCDPretrainModel]:
    """Student (with SegHead + drop path) and teacher (plain), train.py:62-91.
    ``config.remat`` recomputes the student's blocks in the backward; the
    teacher, which takes no gradient, never does (ccd_tpu/builders.py:53-63).

    Both are initialised on the CPU under ``generator`` (seed 0 when None),
    student first, then moved to ``device``; ``init_pretrain_state`` makes the
    teacher a copy of the student. ``device='cuda'`` without a card raises.
    """
    device = resolve_device(device)
    arch = str(config.arch).replace("deit", "vit")
    dtype = compute_dtype(config)
    student = CCDPretrainModel(
        arch=arch, patch_size=config.patch_size,
        drop_path_rate=config.drop_path_rate, out_dim=config.out_dim,
        use_bn_in_head=bool(config.use_bn_in_head),
        norm_last_layer=bool(config.norm_last_layer), with_seg_head=True,
        remat=bool(config.remat), dtype=dtype)
    teacher = CCDPretrainModel(
        arch=arch, patch_size=config.patch_size, drop_path_rate=0.0,
        out_dim=config.out_dim, use_bn_in_head=bool(config.use_bn_in_head),
        norm_last_layer=True, with_seg_head=False, dtype=dtype)
    generator = generator or torch.Generator().manual_seed(0)
    student.reset_parameters(generator)
    teacher.reset_parameters(generator)
    return student.to(device), teacher.to(device)


def load_recognizer_params(path: str, model: CCDRecognizer) -> CCDRecognizer:
    """Load finetune weights into ``model`` from a torch pickle: a reference
    CCD checkpoint ``{'net': state_dict, ...}`` (with or without the
    ``module.`` prefix) or a bare ``state_dict`` as ``torch.save`` writes one
    of this package's models. Every key but the two the port has no use for
    must match (strict). Orbax directories are the JAX package's format and
    are not read here."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["net"] if isinstance(ckpt, dict) and "net" in ckpt else ckpt
    model.load_state_dict(clean_recognizer_state_dict(sd), strict=True)
    return model


def is_torch_checkpoint(path: str) -> bool:
    return os.path.isfile(path) and path.endswith((".pth", ".pt", ".bin"))


def _latest_manager_file(path: str) -> Optional[str]:
    """The newest ``ckpt_<step>.pt`` of a CheckpointManager directory, or None."""
    from ccd_tpu_torch.checkpoints.torch_io import CheckpointManager
    if not os.path.isdir(path):
        return None
    manager = CheckpointManager(path)
    step = manager.latest_step()
    return None if step is None else manager.path(step)


def load_pretrained_backbone(path: str, model: CCDRecognizer,
                             branch: str = "teacher") -> CCDRecognizer:
    """Copy a pretraining checkpoint's ``branch`` backbone (the teacher, as
    the reference hands it over, ``train_finetune.py:191-200``) into
    ``model.backbone``, in place. ``path`` is a file or a CheckpointManager
    directory of this package's ``train`` CLI (``pretrain_state_payload``:
    ``{'student', 'teacher', ...}`` state_dicts), or a reference CCD ``.pth``
    of the same layout with DDP ``module.`` prefixes; the backbone's names are
    the reference's, so this is a prefix strip and a strict load."""
    file = _latest_manager_file(path) or path
    if not is_torch_checkpoint(file):
        raise FileNotFoundError(f"{path}: neither a checkpoint directory nor a "
                                ".pth/.pt/.bin file")
    ckpt = torch.load(file, map_location="cpu", weights_only=True)
    sd = ckpt[branch] if branch in ckpt else ckpt
    prefix = "backbone."
    backbone = {}
    for name, value in sd.items():
        name = name[len("module."):] if name.startswith("module.") else name
        if name.startswith(prefix) and name != "backbone.cls_token":
            backbone[name[len(prefix):]] = value
    model.backbone.load_state_dict(backbone, strict=True)
    return model


def load_finetune_payload(path: str, map_location=None) -> Optional[dict]:
    """A FULL finetune train-state payload ``{net, opt_state, iteration,
    best_accuracy}`` (``finetune_state_payload``) from a payload file or the
    newest checkpoint of a CheckpointManager directory: the
    ``restart_from_checkpoint`` counterpart (``train_finetune.py:237-256``).
    Returns None when ``path`` holds no such payload (a reference ``.pth``
    holds weights only: :func:`load_recognizer_params` reads those)."""
    import pickle

    from ccd_tpu_torch.checkpoints.torch_io import load_payload
    file = _latest_manager_file(path) or path
    if not is_torch_checkpoint(file):
        return None
    try:
        tree = load_payload(file, map_location)
    except (pickle.UnpicklingError, RuntimeError):  # not a payload this package wrote
        return None
    if not isinstance(tree, dict) or not {"net", "opt_state", "iteration"} <= set(tree):
        return None
    return tree
