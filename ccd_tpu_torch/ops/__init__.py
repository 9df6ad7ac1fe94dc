from ccd_tpu_torch.ops.activations import gelu
from ccd_tpu_torch.ops.flash_attention import (mha_packed, mha_packed_bias,
                                               mha_packed_bias_plain)
from ccd_tpu_torch.ops.image import resize_bicubic

__all__ = ["gelu", "resize_bicubic", "mha_packed", "mha_packed_bias",
           "mha_packed_bias_plain"]
