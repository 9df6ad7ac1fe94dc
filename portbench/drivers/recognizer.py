"""The recognizer of a configuration, on either side, with the benchmark's
weights."""

from __future__ import annotations

import torch

from portbench.weights import load_weights


def build_recognizer(side, cfg: dict, device: torch.device, dtype: torch.dtype, seed: int):
    """(model in training mode, convertor): the configuration's ViT, MLP
    encoder and NRTR decoder, the convertor's class ids."""
    d = cfg["decoder"]
    convertor = side.AttnConvertor(dict_type=cfg["dataset"]["charset_type"],
                                   max_seq_len=d["max_seq_len"], with_unknown=True)
    with torch.device(device):
        model = side.CCDRecognizer(
            arch=cfg["arch"], patch_size=cfg["patch_size"], drop_path_rate=cfg["drop_path_rate"],
            decoder_n_layers=d["n_layers"], decoder_d_embedding=d["d_embedding"],
            decoder_n_head=d["n_head"], decoder_d_k=d["d_k"], decoder_d_v=d["d_v"],
            decoder_d_model=d["d_model"], decoder_d_inner=d["d_inner"],
            num_classes=convertor.num_classes(), max_seq_len=d["max_seq_len"],
            start_idx=convertor.start_idx, padding_idx=convertor.padding_idx, dtype=dtype)
    model = model.to(device)  # tables the constructor made on the host
    load_weights(model, seed)
    return model.train(), convertor
