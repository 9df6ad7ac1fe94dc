"""Batching + prefetching input pipeline.

Stands in for torch DataLoader + DistributedSampler (train.py:435-444) over
the pure-Python LMDB datasets: a thread pool fetches and collates numpy
batches ahead of the consumer, with per-process sharding (each process reads
its slice of the global sample stream, like DistributedSampler's
rank-strided split).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np


def collate_filter_none(samples: Sequence) -> Optional[tuple]:
    """Drop None samples, stack fields (collate_fn_filter_none,
    dataset.py:215-217). Returns None if everything was filtered."""
    samples = [s for s in samples if s is not None]
    if not samples:
        return None
    fields = list(zip(*samples))
    out = []
    for f in fields:
        if isinstance(f[0], np.ndarray) or np.isscalar(f[0]):
            out.append(np.stack([np.asarray(x) for x in f]))
        else:
            out.append(list(f))  # e.g. raw text strings
    return tuple(out)


class EpochSampler:
    """Shuffled, rank-sharded, drop-last index sampler (DistributedSampler)."""

    def __init__(self, length: int, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self.length = length
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count

    def epoch_indices(self, epoch: int) -> np.ndarray:
        if self.shuffle:
            order = np.random.RandomState(self.seed + epoch).permutation(self.length)
        else:
            order = np.arange(self.length)
        shard = order[self.process_index::self.process_count]
        if self.drop_last:
            n = (len(shard) // self.batch_size) * self.batch_size
            shard = shard[:n]
        return shard

    def batches_per_epoch(self) -> int:
        shard_len = (self.length + self.process_count - 1 - self.process_index) // self.process_count
        if self.drop_last:
            return shard_len // self.batch_size
        return (shard_len + self.batch_size - 1) // self.batch_size


class DataLoader:
    """Threaded prefetching loader over an indexable dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4,
                 prefetch: int = 4, seed: int = 0, process_index: int = 0,
                 process_count: int = 1,
                 collate: Callable = collate_filter_none):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.collate = collate
        self.sampler = EpochSampler(len(dataset), batch_size, shuffle, drop_last,
                                    seed, process_index, process_count)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return self.sampler.batches_per_epoch()

    def _fetch_batch(self, idxs: np.ndarray):
        return self.collate([self.dataset[int(i)] for i in idxs])

    def __iter__(self) -> Iterator[tuple]:
        indices = self.sampler.epoch_indices(self._epoch)
        n_batches = len(indices) // self.batch_size if self.sampler.drop_last \
            else (len(indices) + self.batch_size - 1) // self.batch_size
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_batches)]

        if self.num_workers <= 1:
            for bidx in batches:
                b = self._fetch_batch(bidx)
                if b is not None:
                    yield b
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        in_q: "queue.Queue" = queue.Queue()
        for i, bidx in enumerate(batches):
            in_q.put((i, bidx))
        results = {}
        lock = threading.Lock()
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    i, bidx = in_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = self._fetch_batch(bidx)
                except BaseException as e:
                    # a dataset exception must surface in the consumer, not
                    # silently kill the thread (which would leave __iter__
                    # blocked on out_q.get() forever) — torch's DataLoader
                    # likewise propagates worker errors to the caller
                    out_q.put((None, e))
                    return
                out_q.put((i, batch))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            next_i = 0
            received = 0
            while received < len(batches):
                i, batch = out_q.get()
                if i is None:  # worker error sentinel — re-raise here
                    raise batch
                received += 1
                with lock:
                    results[i] = batch
                while next_i in results:
                    b = results.pop(next_i)
                    next_i += 1
                    if b is not None:
                        yield b
        finally:
            stop.set()
