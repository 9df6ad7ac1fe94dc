"""Host-side LMDB image datasets.

Parity targets: ``Dino/dataset/dataset.py`` (base LMDB reader: image-%09d /
label-%09d keys + num-samples, parallel mask LMDB with path derived by
splitting on 'training', corrupted-image resampling, aspect or plain resize,
data_portion subsampling) and ``Dino/dataset/dataset_pretrain.py`` (supervised
reader converting labels to padded target tensors at load time).

Split of responsibilities: the host does only decode + resize + label
encoding (cheap, C-accelerated via cv2); normalization (and, for training,
augmentation) runs batched on the device. Datasets therefore return uint8
images.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np

from ccd_tpu_torch.convertor import AttnConvertor
from ccd_tpu_torch.data.lmdb import LmdbReader


def mask_env_path(data_path: str, mask_root: str) -> Optional[str]:
    """Derive the mask-LMDB path: mask_root + suffix after 'training'
    (dataset.py:57-58)."""
    parts = str(data_path).split("training")
    if len(parts) < 2:
        return None
    return mask_root + parts[1]


class LmdbImageDataset:
    """Base LMDB reader: decoded RGB image resized to (img_h, img_w)."""

    def __init__(self, path: str, is_training: bool = True, img_h: int = 32,
                 img_w: int = 128, data_portion: float = 1.0, mask: bool = False,
                 mask_path: str = "", min_pixels: int = 6, multiscales: bool = False,
                 seed: int = 0, **_unused):
        self.path = path
        self.name = os.path.basename(os.path.normpath(path))
        self.is_training = is_training
        self.img_h, self.img_w = img_h, img_w
        self.use_mask = mask
        self.min_pixels = min_pixels
        self.multiscales = multiscales
        self._rng = random.Random(seed)

        self.env = LmdbReader(path)
        self.mask_env = None
        if mask and mask_path:
            mpath = mask_env_path(path, mask_path)
            try:
                self.mask_env = LmdbReader(mpath)
            except Exception:
                print(f"{path}: no mask lmdb at {mpath}")

        n = int(self.env.get(b"num-samples"))
        self.use_portion = is_training and data_portion != 1.0
        if self.use_portion:
            self.length = int(data_portion * n)
            self.optional_ind = np.random.RandomState(seed).permutation(n)[: self.length]
        else:
            self.length = n

    def __len__(self) -> int:
        return self.length

    def _decode_image(self, buf: bytes) -> Optional[np.ndarray]:
        arr = np.frombuffer(buf, np.uint8)
        img = cv2.imdecode(arr, cv2.IMREAD_COLOR)
        if img is None:
            return None
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def _next_index(self) -> int:
        idx = self._rng.randint(0, len(self) - 1)
        return idx

    def get_raw(self, idx: int) -> Optional[Tuple[np.ndarray, Optional[np.ndarray], bytes]]:
        """Fetch (rgb_image, mask_or_None, label_bytes) for 0-based idx,
        resampling on corruption (dataset.py:86-98,155-166)."""
        for _attempt in range(20):
            real = int(self.optional_ind[idx]) if self.use_portion else idx
            img_buf = self.env.get(f"image-{real + 1:09d}".encode())
            label = self.env.get(f"label-{real + 1:09d}".encode()) or b""
            img = self._decode_image(img_buf) if img_buf else None
            bad = img is None or (self.is_training and
                                  (img.shape[0] <= self.min_pixels or
                                   img.shape[1] <= self.min_pixels))
            if bad:
                if not self.is_training:
                    return None
                idx = self._next_index()
                continue
            mask = None
            if self.mask_env is not None:
                mbuf = self.mask_env.get(f"mask-{real + 1:09d}".encode())
                if mbuf is not None:
                    marr = np.frombuffer(mbuf, np.uint8)
                    mask = cv2.imdecode(marr, cv2.IMREAD_GRAYSCALE)
                if mask is None:
                    mask = np.zeros((img.shape[0], img.shape[1]), np.uint8)
            return img, mask, label
        return None

    def resize_multiscales(self, img: np.ndarray,
                           border_type=cv2.BORDER_CONSTANT) -> np.ndarray:
        """Aspect-preserving (or random-ratio while training) resize + pad
        (resize_multiscales, dataset.py:100-125)."""
        import math

        def _resize_ratio(img, ratio, fix_h=True):
            if ratio * self.img_w < self.img_h:
                trg_h = self.img_h if fix_h else int(ratio * self.img_w)
                trg_w = self.img_w
            else:
                trg_h, trg_w = self.img_h, int(self.img_h / ratio)
            img = cv2.resize(img, (trg_w, trg_h))
            pad_h, pad_w = (self.img_h - trg_h) / 2, (self.img_w - trg_w) / 2
            top, bottom = math.ceil(pad_h), math.floor(pad_h)
            left, right = math.ceil(pad_w), math.floor(pad_w)
            return cv2.copyMakeBorder(img, top, bottom, left, right, border_type)

        if self.is_training and self._rng.random() < 0.5:
            hh = self._rng.randint(self.img_h, self.img_h)
            ww = self._rng.randint(self.img_h, self.img_w)
            return _resize_ratio(img, hh / ww)
        return _resize_ratio(img, img.shape[0] / img.shape[1])

    def resize(self, img: np.ndarray) -> np.ndarray:
        if self.multiscales:
            return self.resize_multiscales(img, cv2.BORDER_REPLICATE)
        return cv2.resize(img, (self.img_w, self.img_h))


class SupervisedDataset(LmdbImageDataset):
    """Finetune/test reader: (resized uint8 image, padded target ids, text)."""

    def __init__(self, *args, convertor: Optional[AttnConvertor] = None,
                 max_seq_len: int = 25, charset_type: str = "DICT90", **kwargs):
        super().__init__(*args, **kwargs)
        self.convertor = convertor or AttnConvertor(
            dict_type=charset_type, max_seq_len=max_seq_len, with_unknown=True)

    def __getitem__(self, idx: int
                    ) -> Optional[Tuple[np.ndarray, np.ndarray, str]]:
        datum = self.get_raw(idx)
        if datum is None:
            return None
        img, _, label = datum
        text = label.decode("utf-8", errors="replace")
        image = self.resize(img)
        target = self.convertor.str2tensor([text])[0]
        return image, target, text


class ConcatDataset:
    """Concatenation delegating attribute lookups to the first child
    (MyConcatDataset, Dino/utils/utils.py:314-316)."""

    def __init__(self, datasets: Sequence):
        assert datasets, "need at least one dataset"
        self.datasets = list(datasets)
        self._offsets = np.cumsum([len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int):
        ds_i = int(np.searchsorted(self._offsets, idx, side="right"))
        prev = 0 if ds_i == 0 else int(self._offsets[ds_i - 1])
        return self.datasets[ds_i][idx - prev]

    def __getattr__(self, item):
        return getattr(self.datasets[0], item)


def scan_dataset_roots(roots: Sequence[str]) -> List[str]:
    """Recursively expand each root into its LMDB leaf directories
    (train.py:399-425's directory scan)."""
    leaves: List[str] = []

    def visit(p: str):
        subfolders = [f.path for f in os.scandir(p) if f.is_dir()]
        lmdb_here = os.path.exists(os.path.join(p, "data.mdb"))
        if subfolders and not lmdb_here:
            for s in sorted(subfolders):
                visit(s)
        else:
            leaves.append(p)

    for r in roots:
        visit(r)
    return leaves


def build_dataset(ds_cls, roots: Sequence[str], is_training: bool, **kwargs):
    leaves = scan_dataset_roots(roots)
    datasets = [ds_cls(path=p, is_training=is_training, **kwargs) for p in leaves]
    return datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)
