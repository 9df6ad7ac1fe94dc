"""Evaluation runner: greedy-decode predict fn + benchmark-suite runner.

Parity target: ``test.py:150-218`` + ``TextAccuracy.compute`` — per-benchmark
word accuracy over LMDB evaluation sets with a weighted total. Counterpart of
``ccd_tpu/evaluation/runner.py``. The decode is the KV-cached loop (vs the
reference's 25x full-decoder re-run). PyTorch runs eagerly, so a ragged final
batch is decoded at its own size: the JAX runner's padding to a fixed set of
batch sizes exists to bound recompiles and has no counterpart here.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ccd_tpu_torch.convertor import AttnConvertor
from ccd_tpu_torch.data.dataset import SupervisedDataset, build_dataset
from ccd_tpu_torch.data.pipeline import DataLoader
from ccd_tpu_torch.evaluation.accuracy import TextAccuracy

# ImageNet statistics the images are normalised with (Dino/dataset: Normalize)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@torch.no_grad()
def decode(model, images: torch.Tensor, test_speed: bool = False) -> torch.Tensor:
    """uint8 (N, H, W, 3) on the model's device -> per-step softmax (N, T, C-1)."""
    x = images.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return model((x - mean) / std, train_mode=False, test_speed=test_speed)


def make_predict_fn(model, convertor: AttnConvertor, test_speed: bool = False
                    ) -> Callable[[np.ndarray], List[str]]:
    """Build ``fn(uint8 images (N, H, W, 3)) -> list[str]`` (greedy decode) on
    the device the model's parameters are on.

    ``test_speed=True`` routes through the early-exit decode
    (``forward_test_speed``, ``Dino/decoder/nrtr_decoder.py:177-203``).
    """
    device = next(model.parameters()).device

    def predict(images: np.ndarray) -> List[str]:
        batch = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        probs = decode(model, batch, test_speed).float().cpu().numpy()
        indexes, _scores = convertor.tensor2idx(probs)
        return convertor.idx2str(indexes)

    return predict


def evaluate_benchmarks(model, test_roots: Sequence[str],
                        batch_size: int = 288, max_seq_len: int = 25,
                        charset_type: str = "DICT90",
                        case_sensitive: bool = False,
                        num_workers: int = 4,
                        names: Optional[Sequence[str]] = None,
                        test_speed: bool = False,
                        loader_cache: Optional[dict] = None,
                        ) -> Tuple[List[Dict[str, float]], float]:
    """Run the 11-benchmark-style eval; returns (per-set metrics, weighted acc).

    One process evaluates every benchmark in full (sharding over processes
    arrives with multi-GPU evaluation). ``names`` label the results in place
    of the roots. ``loader_cache``: pass the same dict across periodic
    evaluations (the finetune loop does) to reuse each benchmark's dataset
    and loader, one per (root, batch, max_seq_len, charset, workers): the
    LMDB is opened and scanned once per run instead of once per evaluation.
    The model decodes in evaluation mode and is left in the mode it was
    found in.
    """
    was_training = model.training
    model.eval()
    try:
        convertor = AttnConvertor(dict_type=charset_type, max_seq_len=max_seq_len,
                                  with_unknown=True)
        predict = make_predict_fn(model, convertor, test_speed)
        results = []
        total_acc = 0.0
        total_words = 0.0
        for i, root in enumerate(test_roots):
            key = (str(root), batch_size, max_seq_len, charset_type, num_workers)
            loader = None if loader_cache is None else loader_cache.get(key)
            if loader is None:
                ds = build_dataset(SupervisedDataset, [root], is_training=False,
                                   convertor=convertor, max_seq_len=max_seq_len)
                loader = DataLoader(ds, batch_size=batch_size, shuffle=False,
                                    drop_last=False, num_workers=num_workers)
                if loader_cache is not None:
                    loader_cache[key] = loader
            acc = TextAccuracy(case_sensitive=case_sensitive)
            acc.compute(predict, ((images, texts) for images, _targets, texts in loader))
            res = acc.result()
            res["name"] = names[i] if names else str(root)
            results.append(res)
            total_acc += res["cwr"] * res["words"]
            total_words += res["words"]
    finally:
        model.train(was_training)
    weighted = total_acc / max(total_words, 1.0)
    return results, weighted
