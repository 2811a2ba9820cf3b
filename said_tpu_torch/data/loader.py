"""Host-side data loader: indices → collated batches, and a prefetch thread.

The port's copy of ``said_tpu.data.loader`` (numpy only, so the same seed
gives the same batches): sequential iteration, a shuffle, and the
with-replacement sampler the reference trains with
(``RandomSampler(replacement=True)``, script/train.py:525-529). One
process: the datasets preload to RAM.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        sampler_replacement: bool = False,
        collate_fn: Optional[Callable] = None,
        seed: int = 0,
        drop_last: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler_replacement = sampler_replacement
        self.collate_fn = collate_fn or (lambda items: items)
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        n = len(self.dataset)
        if self.sampler_replacement:
            indices = self.rng.integers(0, n, size=n)
        elif self.shuffle:
            indices = self.rng.permutation(n)
        else:
            indices = np.arange(n)

        for start in range(0, n, self.batch_size):
            batch_idx = indices[start : start + self.batch_size]
            if self.drop_last and len(batch_idx) < self.batch_size:
                break
            yield self.collate_fn([self.dataset[int(i)] for i in batch_idx])


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Iterate ``iterable`` on a background thread, keeping up to
    ``depth`` items ready, so windowing and collation overlap the card's
    work on the previous step. An exception in the producer re-raises at
    the consumer's next pull. Leaving the generator early (``break``, an
    exception, garbage collection) closes it: the producer stops and the
    queue is drained, so the thread exits."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(pair) -> bool:
        # bounded put that gives up once the consumer is gone
        while not stop.is_set():
            try:
                q.put(pair, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            for item in iterable:
                if not _put((True, item)):
                    return
        except BaseException as e:  # handed to the consumer, which re-raises it
            _put((False, e))
        else:
            _put((False, None))

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            ok, val = q.get()
            if not ok:
                if val is not None:
                    raise val
                return
            yield val
    finally:
        stop.set()
        try:  # unblock a producer parked on a full queue
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
