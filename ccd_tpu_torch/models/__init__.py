from ccd_tpu_torch.models.vit import VisionTransformer, vit_tiny, vit_small, vit_base, VIT_ARCHS
from ccd_tpu_torch.models.heads import MlpEncoder
from ccd_tpu_torch.models.nrtr import NRTRDecoder
from ccd_tpu_torch.models.recognizer import CCDRecognizer

__all__ = [
    "VisionTransformer", "vit_tiny", "vit_small", "vit_base", "VIT_ARCHS",
    "MlpEncoder", "NRTRDecoder", "CCDRecognizer",
]
