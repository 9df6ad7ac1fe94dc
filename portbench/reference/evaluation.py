"""The recognizer's evaluation entry (a copy of the port's
``evaluation/runner.py::decode``)."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@torch.no_grad()
def decode(model, images: torch.Tensor, test_speed: bool = False) -> torch.Tensor:
    """uint8 (N, H, W, 3) on the model's device -> per-step softmax (N, T, C-1)."""
    x = images.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return model((x - mean) / std, train_mode=False, test_speed=test_speed)
