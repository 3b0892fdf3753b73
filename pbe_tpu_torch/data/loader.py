"""Host-side batching/prefetching data loader and the YAML data module (the
port's own copies of ``DataLoader`` and ``DataModuleConfig`` from
``pbe_tpu/data/loader.py``).

Decode/augment is PIL/numpy (GIL-releasing), so a thread pool + a bounded
prefetch queue keeps the device fed without process-spawn overhead;
per-epoch order is a seeded permutation so runs are reproducible.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator

import numpy as np

from pbe_tpu_torch import config as config_lib


def _stack(samples: list[dict]) -> dict:
    out = {}
    for k in samples[0]:
        v0 = samples[0][k]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack([s[k] for s in samples])
        else:
            out[k] = [s[k] for s in samples]
    return out


class DataLoader:
    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 8,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 4,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng((self.seed, self._epoch)).permutation(n)
        self._epoch += 1

        batches = [
            order[i:i + self.batch_size]
            for i in range(0, n - (self.batch_size - 1 if self.drop_last else 0),
                           self.batch_size)
        ]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, idxs))
                        q.put(_stack(samples))
            except BaseException as e:  # raised again on the consumer's thread
                q.put(e)
                return
            q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    # a sample that fails to load ends the iteration with
                    # its error instead of leaving the consumer waiting
                    raise batch
                yield batch
        finally:
            stop.set()


@dataclasses.dataclass
class DataModuleConfig:
    """v1.yaml ``data.params``-compatible constructor (the reference's
    main.DataModuleFromConfig surface, main.py:98-183): each split's dataset
    is built from its ``target``/``params`` and batched by a DataLoader
    (the train split shuffled)."""

    batch_size: int = 4
    train: dict | None = None
    validation: dict | None = None
    test: dict | None = None
    wrap: bool = False
    num_workers: int = 8
    num_val_workers: int | None = None

    def _loader(self, cfg: dict | None, shuffle: bool) -> DataLoader | None:
        if cfg is None:
            return None
        ds = config_lib.instantiate_from_config(cfg)
        return DataLoader(ds, self.batch_size, shuffle=shuffle, num_workers=self.num_workers)

    def train_dataloader(self):
        return self._loader(self.train, shuffle=True)

    def val_dataloader(self):
        return self._loader(self.validation, shuffle=False)

    def test_dataloader(self):
        return self._loader(self.test, shuffle=False)
