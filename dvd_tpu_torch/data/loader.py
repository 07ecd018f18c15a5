"""Threaded prefetching batch loader (port of ``dvd_tpu/data/loader.py``).

Replaces the reference's ``Loader(DataLoader)`` + per-worker numpy
reseeding (``utils_data/loaders.py:7-81``): a thread pool decodes/augments
samples ahead of consumption and assembles numpy batches; per-sample RNG
seeds derive deterministically from (epoch, index, seed), which is both
reproducible and free of the duplicated-augmentation-RNG bug the reference
works around.

An exception in loading a sample (an unreadable file) is raised from the
consumer's next batch; ``dvd_tpu``'s loader lets it end the producer
thread and leaves the consumer waiting for a batch that never comes.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Sequence

import numpy as np


class _Failure:
    """An exception of the producer thread, on its way to the consumer."""

    def __init__(self, exc: Exception):
        self.exc = exc


class PrefetchLoader:
    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 seed: int = 0, keys: Sequence[str] = (),
                 shuffle: bool = True, depth: int = 2,
                 drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1):
        """``batch_size`` is the per-process batch.  Under data-parallel
        training each process takes a ``process_index``-strided slice of
        the (identically seeded, hence identical) global epoch order —
        the reference shards by MPI rank the same way
        (``image_datasets.py:31-33``, ``dist_util`` world split); until
        the port has DDP they are 0 and 1."""
        self.ds = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.keys = keys
        self.shuffle = shuffle
        self.depth = depth
        self.drop_last = drop_last
        if not (0 <= process_index < process_count):
            raise ValueError((process_index, process_count))
        self.process_index = process_index
        self.process_count = process_count
        if drop_last:
            # with fewer local samples than a batch, drop_last yields zero
            # batches per epoch and the producer would spin through epochs
            # while the consumer blocks on q.get() forever — fail loudly
            n_local = len(range(process_index, len(dataset), process_count))
            if n_local < batch_size:
                raise ValueError(
                    f"process {process_index}/{process_count} holds "
                    f"{n_local} samples < batch_size {batch_size}; "
                    "shrink the batch or grow the dataset")

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = 0
        pool = ThreadPoolExecutor(self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item):
            # bounded put that keeps observing `stop`: a plain q.put would
            # park this thread forever once the consumer is gone, and
            # shutting the pool down under it raised "cannot schedule new
            # futures after shutdown" from the next submit
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def producer():
            try:
                produce()
            except Exception as exc:  # raised by the consumer
                put(_Failure(exc))

        def produce():
            nonlocal epoch
            while not stop.is_set():
                rng = np.random.RandomState(self.seed + epoch)
                order = np.arange(len(self.ds))
                if self.shuffle:
                    rng.shuffle(order)
                order = order[self.process_index::self.process_count]
                n = len(order)
                end = n - n % self.batch_size if self.drop_last else n
                for s in range(0, end, self.batch_size):
                    if stop.is_set():
                        return
                    idx = order[s:s + self.batch_size]
                    futs = [
                        pool.submit(self.ds.__getitem__, int(i),
                                    self.seed + epoch * 1000003 + int(i))
                        for i in idx
                    ]
                    items = [f.result() for f in futs]
                    keys = self.keys or list(items[0].keys())
                    put({k: np.stack([it[k] for it in items]) for k in keys})
                epoch += 1

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, _Failure):
                    raise item.exc
                yield item
        finally:
            stop.set()
            # drain so a producer parked in q.put can observe stop, then
            # join it BEFORE the executor shutdown — the producer must
            # never touch a shut-down pool
            try:
                while th.is_alive():
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        pass
                    th.join(timeout=0.05)
                pool.shutdown(wait=False, cancel_futures=True)
            except (AttributeError, TypeError):
                # generator finalized at interpreter teardown: module
                # globals (queue, concurrent.futures internals) may
                # already be None — the daemon threads die with the
                # process anyway
                pass
