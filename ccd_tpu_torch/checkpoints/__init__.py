from ccd_tpu_torch.checkpoints.from_jax import (clean_recognizer_state_dict,
                                                dino_head_state_dict_from_jax,
                                                nrtr_state_dict_from_jax,
                                                pretrain_state_dicts_from_jax,
                                                recognizer_state_dict_from_jax,
                                                seg_head_state_dict_from_jax,
                                                vit_state_dict_from_jax)
from ccd_tpu_torch.checkpoints.torch_export import save_pretrain_torch, save_recognizer_torch

__all__ = ["recognizer_state_dict_from_jax", "vit_state_dict_from_jax",
           "nrtr_state_dict_from_jax", "clean_recognizer_state_dict",
           "dino_head_state_dict_from_jax", "seg_head_state_dict_from_jax",
           "pretrain_state_dicts_from_jax", "save_recognizer_torch", "save_pretrain_torch"]
