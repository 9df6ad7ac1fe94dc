#!/usr/bin/env python
"""Offline glyph-mask generation into LMDB (parity: mask_create/generate_mask.py
+ merge.py; counterpart of ``tools/generate_masks.py``).

Reads image LMDBs, computes the 2-means foreground mask of every image, and
writes a parallel mask LMDB (``mask-%09d`` keys, PNG-encoded, then
``num-samples``) that ``PretrainDataset(mask=True, mask_path=<mask_root>)``
reads. The k-means runs batched on the device
(``ops/kmeans_mask.py::kmeans_foreground_mask``); the host decodes and
encodes PNGs. One read back to the host per batch (the masks going to PNG)
is the only synchronisation.

Usage:
  python -m ccd_tpu_torch.cli.generate_masks --src <lmdb dir> [<lmdb dir> ...] \\
      --mask_root <out root> [--batch 256] [--device cuda|cpu]

Each source's mask path is derived like the reference's (the suffix after
'training' appended to ``--mask_root``; a source without 'training' in its
path goes to ``<mask_root>/<basename>``); one output environment per source,
so no merge step is needed. Runs on the GPU unless ``--device cpu`` is given;
asking for the GPU on a machine without one is an error.
"""

from __future__ import annotations

import argparse
import io
import os
from typing import Optional, Sequence

# the common size the images are batched at for the k-means
BATCH_H, BATCH_W = 64, 256


def _parse_arguments(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--src", nargs="+", required=True)
    p.add_argument("--mask_root", required=True)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns ``{mask env path: number of masks written}``."""
    args = _parse_arguments(argv)
    import cv2
    import numpy as np
    import torch
    from PIL import Image

    from ccd_tpu_torch.data.dataset import mask_env_path, scan_dataset_roots
    from ccd_tpu_torch.data.lmdb import LmdbReader, LmdbWriter
    from ccd_tpu_torch.ops.kmeans_mask import kmeans_foreground_mask
    from ccd_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    written = {}
    for src in scan_dataset_roots(args.src):
        out = mask_env_path(src, args.mask_root) or os.path.join(
            args.mask_root, os.path.basename(os.path.normpath(src)))
        print(f"{src} -> {out}")
        batch_imgs, batch_meta = [], []
        with LmdbReader(src) as reader, LmdbWriter(out) as writer:
            n = int(reader.get(b"num-samples"))

            def flush():
                if not batch_imgs:
                    return
                grays = torch.from_numpy(np.stack(batch_imgs)).to(device)
                masks = kmeans_foreground_mask(grays).cpu().numpy()  # the batch's one host read
                for m, (key, oh, ow) in zip(masks, batch_meta):
                    m = cv2.resize(m, (ow, oh), interpolation=cv2.INTER_NEAREST)
                    buf = io.BytesIO()
                    Image.fromarray((m * 255).astype(np.uint8)).save(buf, format="PNG")
                    writer.put(key, buf.getvalue())
                batch_imgs.clear()
                batch_meta.clear()

            done = 0
            for i in range(1, n + 1):
                img_buf = reader.get(f"image-{i:09d}".encode())
                if img_buf is None:
                    continue
                gray = cv2.imdecode(np.frombuffer(img_buf, np.uint8), cv2.IMREAD_GRAYSCALE)
                if gray is None:
                    continue
                oh, ow = gray.shape
                batch_imgs.append(cv2.resize(gray, (BATCH_W, BATCH_H)).astype(np.float32))
                batch_meta.append((f"mask-{i:09d}".encode(), oh, ow))
                if len(batch_imgs) >= args.batch:
                    flush()
                    done += args.batch
                    if done % (args.batch * 20) == 0:
                        print(f"  {done}/{n}")
            flush()
            writer.put(b"num-samples", str(n).encode())
        print(f"  wrote {n} masks")
        written[out] = n
    return written


if __name__ == "__main__":
    main()
