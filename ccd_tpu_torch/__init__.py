"""ccd_tpu_torch — PyTorch/CUDA port of the ccd_tpu framework (TongkunGuan/CCD).

The package mirrors ``ccd_tpu`` module for module: a reader finds the
counterpart of ``ccd_tpu/<path>.py`` at ``ccd_tpu_torch/<path>.py``. Plain
tensor code is PyTorch; the fused kernels are hand-written CUDA C++ for
Hopper under ``csrc/``, built at first use. Ported so far: the recognizer's
evaluation path (ViT backbone -> Mlp encoder -> NRTR greedy decode ->
benchmark accuracy).
"""

__version__ = "0.1.0"
