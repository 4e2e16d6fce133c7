"""Host-side data loading: sharded sampling, prefetching loader, round-robin
multi-dataset interleaving.

Copy of `slowtv_monodepth_tpu/data/loader.py` (numpy and the standard
library only), the replacement for the reference's torch DataLoader stack:

- `ShardedSampler` = `DistributedSampler` equivalent (per-epoch seeded
  shuffle, per-host contiguous striding, ref `src/tools/parsers.py:191-199`):
  under multi-host data parallelism each host loads only its shard.
- `DataLoader` = prefetching batch iterator over a `BaseDataset`. Items load
  concurrently in a thread pool (image decode in cv2/PIL/numpy releases the
  GIL) or — `worker_mode='process'` — in forked worker processes that inherit
  the dataset without pickling (the torch-DataLoader-workers equivalent for
  hosts where decode is GIL-bound); either way batches collate to stacked
  numpy NHWC arrays ready for the device.
- `ConcatDataLoader` = round-robin interleaving so every batch is
  single-dataset (shapes differ across datasets; ref `src/utils/loader.py:
  10-35`, rationale `src/tools/parsers.py:161-163`).
"""
from __future__ import annotations

import functools
import itertools
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np

__all__ = ['ShardedSampler', 'DataLoader', 'ConcatDataLoader']

# Process-mode worker state: registered in the PARENT before the fork so
# workers inherit the dataset through copy-on-write memory — the dataset
# itself is never pickled (mmap-backed PackDB readers aren't picklable; only
# the per-item (x, y, m) results cross the process boundary). Keyed per
# loader: `ConcatDataLoader` keeps several loaders' pools alive concurrently
# and `ProcessPoolExecutor` forks workers LAZILY at submit time, so a
# single-slot global would let a late fork in loader A's pool inherit loader
# B's dataset. A worker always holds a registry superset containing its own
# loader's key (registration happens before its pool exists).
_WORKER_DS: dict = {}
_DS_KEYS = itertools.count()


def _worker_init(counter, base_seed: int) -> None:
    """Decorrelate forked workers' aug RNG (torch worker_init equivalent).

    Every fork inherits the parent's global `random`/`np.random` state, so
    without reseeding all workers would draw IDENTICAL flip/jitter/support
    sequences. Each worker takes a unique id from the shared counter and
    seeds as `base_seed + id` (base varies per epoch via the sampler).
    """
    import random
    with counter.get_lock():
        wid = counter.value
        counter.value += 1
    random.seed(base_seed + wid)
    np.random.seed((base_seed + wid) % 2 ** 32)


def _worker_getitem(key: int, j: int):
    return _WORKER_DS[key][j]


class ShardedSampler:
    """Per-epoch seeded shuffling + striding over hosts.

    :param n: Dataset length.
    :param shuffle: Reshuffle each epoch (seeded by `seed + epoch`).
    :param seed: Base seed (the reference seeds each dataset differently).
    :param shard_id/num_shards: This host's stride in the global order.
    :param drop_last: Trim so every shard has equal length.
    """

    def __init__(self, n: int, shuffle: bool = True, seed: int = 42,
                 shard_id: int = 0, num_shards: int = 1, drop_last: bool = True):
        self.n = n
        self.shuffle = shuffle
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.num_shards
        return (self.n + self.num_shards - 1) // self.num_shards

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        if not self.drop_last and self.n % self.num_shards:
            pad = self.num_shards - self.n % self.num_shards
            order = np.concatenate([order, order[:pad]])
        order = order[self.shard_id::self.num_shards]
        if self.drop_last:
            order = order[:len(self)]
        return iter(order.tolist())


class DataLoader:
    """Prefetching batch loader over a `BaseDataset`.

    :param dataset: Dataset with `__getitem__` -> (x, y, m) and `collate_fn`.
    :param batch_size: Per-host batch size.
    :param shuffle: Shuffle per epoch (via the sampler).
    :param drop_last: Drop the trailing partial batch.
    :param num_workers: Thread-pool width (0 = synchronous).
    :param prefetch: Batches to keep in flight.
    :param seed/shard_id/num_shards: Sampler configuration.
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = True, num_workers: int = 4, prefetch: int = 2,
                 seed: int = 42, shard_id: int = 0, num_shards: int = 1,
                 sampler: Optional[ShardedSampler] = None,
                 worker_mode: str = 'thread'):
        if worker_mode not in ('thread', 'process'):
            raise ValueError(f"worker_mode must be thread|process (got '{worker_mode}')")
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.worker_mode = worker_mode
        self.prefetch = max(prefetch, 1)
        self.sampler = sampler or ShardedSampler(
            len(dataset), shuffle=shuffle, seed=seed,
            shard_id=shard_id, num_shards=num_shards, drop_last=drop_last)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[list]:
        idxs = list(self.sampler)
        for i in range(0, len(idxs), self.batch_size):
            chunk = idxs[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def __iter__(self):
        if self.num_workers <= 0:
            for chunk in self._batches():
                yield self.dataset.collate_fn([self.dataset[j] for j in chunk])
            return

        # Pipeline: a feeder thread keeps `prefetch` collated batches in a
        # bounded queue; items within a batch load concurrently in the pool.
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _finish(futs):
            return self.dataset.collate_fn([f.result() for f in futs])

        # Process mode submits the module-level fetch keyed to THIS
        # iteration's registry entry (workers read the forked-in dataset);
        # submitting the bound method would pickle the whole dataset per item.
        ds_key = next(_DS_KEYS)
        fetch = (functools.partial(_worker_getitem, ds_key)
                 if self.worker_mode == 'process' else self.dataset.__getitem__)

        def feeder(pool):
            try:
                pending = []
                for chunk in self._batches():
                    pending.append([pool.submit(fetch, j) for j in chunk])
                    while len(pending) > self.prefetch:
                        if stop.is_set():
                            return
                        q.put(_finish(pending.pop(0)))
                for futs in pending:
                    if stop.is_set():
                        return
                    q.put(_finish(futs))
                q.put(None)
            except BaseException as e:  # Surface worker errors to the consumer.
                q.put(e)

        if self.worker_mode == 'process':
            # Register BEFORE creating the pool so every fork of it (even the
            # lazy ones at later submits) inherits this loader's entry.
            import multiprocessing as mp
            _WORKER_DS[ds_key] = self.dataset
            ctx = mp.get_context('fork')
            base_seed = self.sampler.seed + 7919 * self.sampler.epoch
            pool_cm = ProcessPoolExecutor(
                max_workers=self.num_workers, mp_context=ctx,
                initializer=_worker_init,
                initargs=(ctx.Value('i', 0), base_seed))
        else:
            pool_cm = ThreadPoolExecutor(max_workers=self.num_workers)

        try:
            with pool_cm as pool:
                t = threading.Thread(target=feeder, args=(pool,), daemon=True)
                t.start()
                try:
                    while True:
                        out = q.get()
                        if out is None:
                            break
                        if isinstance(out, BaseException):
                            raise out
                        yield out
                finally:
                    stop.set()
                    # Drain so the feeder's blocking put can observe `stop`.
                    while not q.empty():
                        q.get_nowait()
                    t.join(timeout=5)
        finally:
            # This pool can no longer fork, so the parent-side entry is done
            # (children's forked copies are unaffected by the pop).
            _WORKER_DS.pop(ds_key, None)


class ConcatDataLoader:
    """Round-robin interleaving of per-dataset loaders (ref
    `src/utils/loader.py:10-35`): every batch is single-dataset, epoch length
    is `n_datasets x min(len(dl))` so all datasets contribute equally."""

    def __init__(self, loaders: Sequence[DataLoader]):
        if not loaders:
            raise ValueError('Must provide at least one loader.')
        self.loaders = list(loaders)

    def set_epoch(self, epoch: int) -> None:
        for dl in self.loaders:
            dl.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loaders) * min(len(dl) for dl in self.loaders)

    def __iter__(self):
        iters = [iter(dl) for dl in self.loaders]
        n = min(len(dl) for dl in self.loaders)
        for _ in range(n):
            for it in iters:
                yield next(it)
