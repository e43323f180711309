"""Host-side data loader: worker threads, bounded prefetch, copies to the
device.

PyTorch counterpart of sdn3d_tpu/data/loader.py, itself a re-expression
of the reference's forked DataLoader (semantic/lib/utils/data/
dataloader.py:34-100) and its pin-memory thread: worker THREADS decode and
augment (numpy releases the GIL; the native host library does the pixel
work), a bounded pipeline gives prefetch, and with a `device` each batch
is collated into pinned host tensors by its worker and copied to the card
without blocking the consumer (`non_blocking=True`).  Without a device
the batches are the collated numpy arrays; with the CPU as device they
are CPU tensors.

Also covers derender3d/data_loader.py:17-40 (zero-fill collate across
heterogeneous hybrid batches) and the WeightedRandomSampler used for
kitti-full (data_loader.py:43-82).  For one dataset and seed the index
order is the JAX package's (numpy RandomState draws).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch


def zero_fill_collate(items: Sequence[Dict[str, np.ndarray]]
                      ) -> Dict[str, np.ndarray]:
    """Stack dict items; keys missing from an item are zero-filled with the
    shape/dtype of a present value (derender3d/data_loader.py:17-40 —
    hybrid datasets yield different key sets per source)."""
    keys = {}
    for it in items:
        for k, v in it.items():
            if k not in keys:
                keys[k] = np.asarray(v)
    out = {}
    for k, proto in keys.items():
        rows = [np.asarray(it[k]) if k in it
                else np.zeros_like(proto) for it in items]
        out[k] = np.stack(rows)
    return out


def hybrid_weights(lengths: Sequence[int],
                   weights: Optional[Sequence[float]] = None) -> np.ndarray:
    """Per-sample weights of the weighted-concat hybrid dataset
    (datasets.py:175-190): weight_i / len_i for each sample of dataset i
    (JAX data/kitti.hybrid_weights)."""
    if weights is None:
        weights = [1.0] * len(lengths)
    return np.concatenate([
        w * np.ones(n) / n for n, w in zip(lengths, weights)])


class HybridDataset:
    """Weighted concat of datasets (derender3d/datasets.py:175-190):
    indexable like one dataset; get_weights() yields the per-item
    WeightedRandomSampler weights (weight_ds / len_ds per item)."""

    def __init__(self, datasets, weights=None):
        self.datasets = list(datasets)
        self.weights = list(weights) if weights is not None \
            else [1.0] * len(self.datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, index: int):
        i = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return self.datasets[i][int(index - self._offsets[i])]

    def get_weights(self) -> np.ndarray:
        return hybrid_weights([len(d) for d in self.datasets], self.weights)


class WeightedSampler:
    """Infinite with-replacement weighted index stream
    (torch WeightedRandomSampler semantics)."""

    def __init__(self, weights: Sequence[float], seed: int = 0):
        w = np.asarray(weights, np.float64)
        self._p = w / w.sum()
        self._rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[int]:
        n = len(self._p)
        while True:
            yield int(self._rng.choice(n, p=self._p))


class EpochSampler:
    """Shuffled (or sequential) single-epoch index stream."""

    def __init__(self, length: int, shuffle: bool = True, seed: int = 0):
        self.length = length
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[int]:
        idx = np.arange(self.length)
        if self.shuffle:
            self._rng.shuffle(idx)
        return iter(int(i) for i in idx)


class PrefetchLoader:
    """Threaded batch loader with bounded prefetch.

    dataset: indexable returning dict[str, np.ndarray];
    sampler: iterable of indices (finite = one epoch, infinite = stream);
    device: None (host numpy batches) or a torch device: the worker
    collates into tensors (pinned for a CUDA device) and the consumer
    copies them with non_blocking=True, so the copy overlaps the card's
    work.  `wait_s` accumulates the consumer's seconds blocked on the
    next batch.
    """

    def __init__(self, dataset, batch_size: int, sampler=None,
                 num_workers: int = 4, prefetch: int = 2,
                 collate: Callable = zero_fill_collate,
                 device=None, drop_last: bool = True,
                 shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.collate = collate
        self.device = None if device is None else torch.device(device)
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.wait_s = 0.0
        self._epoch = 0                   # per-__iter__ reshuffle salt

    def _batches_of_indices(self, sampler):
        buf = []
        for i in sampler:
            buf.append(i)
            if len(buf) == self.batch_size:
                yield list(buf)
                buf.clear()
        if buf and not self.drop_last:
            yield list(buf)

    def _host_batch(self, idxs):
        """Collate (in a worker thread); tensors, pinned for the card,
        when there is a device."""
        batch = self.collate([self.dataset[i] for i in idxs])
        if self.device is None:
            return batch
        pin = self.device.type == "cuda"
        return {k: (torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                    if pin else torch.from_numpy(np.ascontiguousarray(v)))
                for k, v in batch.items()}

    def __iter__(self):
        # a fresh default sampler per epoch, salted so epochs reshuffle
        # (torch DataLoader semantics); explicit samplers own their state
        epoch = self._epoch
        self._epoch += 1
        sampler = self.sampler if self.sampler is not None else \
            EpochSampler(len(self.dataset), self.shuffle,
                         self.seed + epoch)

        # Bounded IN-FLIGHT pipeline: `budget` caps the total number of
        # batches anywhere between the feeder and the consumer (queued +
        # decoding + decoded-but-unordered + ready), so an infinite
        # sampler streams lazily and decoded batches cannot pile up in
        # host memory beyond prefetch + num_workers.
        budget = threading.Semaphore(self.prefetch + self.num_workers)
        idx_q: "queue.Queue" = queue.Queue()
        out_q: "queue.Queue" = queue.Queue()
        DONE = object()
        lock = threading.Lock()
        cond = threading.Condition(lock)
        results: Dict[int, tuple] = {}
        state = {"fed": 0, "done_feeding": False}
        stop = threading.Event()   # consumer abandoned the iterator

        def feeder():
            j = 0
            for idxs in self._batches_of_indices(sampler):
                budget.acquire()
                if stop.is_set():
                    break
                idx_q.put((j, idxs))
                j += 1
                with lock:
                    state["fed"] = j
            with lock:
                state["done_feeding"] = True
                cond.notify_all()
            for _ in range(self.num_workers):
                idx_q.put(DONE)

        def worker():
            while True:
                item = idx_q.get()
                if item is DONE:
                    return
                j, idxs = item
                try:
                    payload = ("ok", self._host_batch(idxs))
                except BaseException as e:   # propagate, don't deadlock
                    payload = ("err", e)
                with lock:
                    results[j] = payload
                    cond.notify_all()

        def orderer():
            j = 0
            while True:
                with lock:
                    while j not in results and not (
                            state["done_feeding"]
                            and j >= state["fed"]):
                        cond.wait()
                    if j not in results:
                        break
                    payload = results.pop(j)
                out_q.put(payload)
                j += 1
            out_q.put(("done", None))

        threads = [threading.Thread(target=fn, daemon=True)
                   for fn in [feeder] + [worker] * self.num_workers
                   + [orderer]]
        for t in threads:
            t.start()

        try:
            while True:
                t0 = time.perf_counter()
                kind, payload = out_q.get()
                self.wait_s += time.perf_counter() - t0
                if kind == "done":
                    return
                if kind == "err":
                    raise RuntimeError(
                        "PrefetchLoader worker failed") from payload
                budget.release()
                batch = payload
                if self.device is not None and self.device.type != "cpu":
                    batch = {k: v.to(self.device, non_blocking=True)
                             for k, v in batch.items()}
                yield batch
        finally:
            # Shutdown on ANY exit — epoch end, consumer break/close
            # (GeneratorExit lands here), or the worker-error re-raise:
            # wake the feeder (one release is enough; it re-checks `stop`
            # on every trip), let workers drain to their DONE tokens, and
            # wake the orderer so no thread or in-flight batch outlives
            # the iteration.
            stop.set()
            budget.release()
            with lock:
                cond.notify_all()
            for t in threads:
                t.join(timeout=30.0)
