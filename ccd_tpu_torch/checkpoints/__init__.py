from ccd_tpu_torch.checkpoints.from_jax import (clean_recognizer_state_dict,
                                                nrtr_state_dict_from_jax,
                                                recognizer_state_dict_from_jax,
                                                vit_state_dict_from_jax)

__all__ = ["recognizer_state_dict_from_jax", "vit_state_dict_from_jax",
           "nrtr_state_dict_from_jax", "clean_recognizer_state_dict"]
