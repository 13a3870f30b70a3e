"""Prefetching batch loader (the JAX package's data/loader.py): items from a
thread pool, batches assembled one step ahead of the consumer, per-epoch
shuffle, ``drop_last`` for the train split (train.py:387-404)."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray, Dict[str, List[str]]]


def _collate(items: List) -> Batch:
    ori = [it[0] for it in items]
    img = np.stack([it[1] for it in items])
    mask = np.stack([it[2] for it in items])
    ids = {"img_id": [it[3]["img_id"] for it in items]}
    try:
        ori = np.stack(ori)
    except ValueError:
        pass  # ragged original sizes: keep the list
    return ori, img, mask, ids


class BatchLoader:
    """Iterable over collated numpy batches with background prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 3, seed: int = 101,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(int(num_workers), 1)
        self.prefetch = max(int(prefetch), 1)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        batches = []
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            batches.append(chunk)
        return batches

    def __iter__(self) -> Iterator[Batch]:
        batches = self._index_batches()
        if not batches:
            return
        q: "queue.Queue[Any]" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            while not stop.is_set():  # bounded put that gives up when the consumer left
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                for chunk in batches:
                    if stop.is_set():
                        break
                    items = list(pool.map(self.dataset.__getitem__, chunk))
                    if not put_or_stop(_collate(items)):
                        return
            put_or_stop(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                yield batch
        finally:
            stop.set()
            while t.is_alive():  # drain so the producer can exit
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
