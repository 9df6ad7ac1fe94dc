"""Config -> model builders shared by the entry points."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ccd_tpu_torch.checkpoints.from_jax import clean_recognizer_state_dict
from ccd_tpu_torch.config import Config
from ccd_tpu_torch.convertor import AttnConvertor
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
