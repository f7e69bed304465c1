"""Thread-prefetched batching loader with per-host sharding (counterpart
of parallelwavegan_tpu/data/loader.py:21-216, numpy code copied and held
equal to it by the tests).

Epoch-shuffled index sampling (``default_rng(seed + epoch)``), Collater
batching with a per-batch child generator ``default_rng((seed, shard,
seq))``, ``drop_last``, rows repeated to keep the batch size, and a
background prefetch thread (or a pool of ``num_workers`` threads) that
stops when the consumer does. One addition: ``start_seq`` skips the index
batches of the first ``start_seq`` steps without loading them, so a
resumed run sees the batches the uninterrupted run would have seen (the
JAX package restarts the stream, an approximate resume).
"""

from __future__ import annotations

import inspect
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class DataLoader:
    """Iterate fixed-shape batches forever (or per-epoch).

    Args:
        dataset: indexable dataset of numpy items.
        collater: callable(list_of_items) -> dict of numpy arrays.
        batch_size: per-host batch size.
        shuffle: reshuffle indices each epoch.
        drop_last: drop the trailing incomplete batch (required for static
            shapes; always True in training).
        shard_index / num_shards: per-host sharding of the index stream.
        prefetch: number of batches to keep ready in the background.
        num_workers: concurrent whole-batch assembly threads (config key
            ``num_workers``, reference train.py:1348). Measured guidance:
            page-cached h5py reads are GIL-bound, so threads only pay off
            for genuinely slow IO (network filesystems); with the default
            in-RAM item cache one thread sustains ~2.5k batches/s at
            16x8192, so the default of 1 is right for local data.
    """

    def __init__(
        self,
        dataset,
        collater,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
        prefetch: int = 2,
        num_workers: int = 1,
    ):
        self.dataset = dataset
        self.collater = collater
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.prefetch = prefetch
        self.num_workers = max(1, int(num_workers))
        self._pool = (
            ThreadPoolExecutor(self.num_workers) if self.num_workers > 1 else None
        )
        try:
            self._collater_takes_rng = "rng" in inspect.signature(
                collater
            ).parameters
        except (TypeError, ValueError):
            self._collater_takes_rng = False
        self.epoch = 0
        self.start_seq = 0

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        return idx[self.shard_index :: self.num_shards]

    @staticmethod
    def _top_up(batch: dict, target: int) -> dict:
        """Repeat rows so every batch keeps the STATIC batch size.

        With ``remove_short_samples: false`` the Collater drops items
        shorter than the crop at batch time; a varying leading dim forces
        a jit recompile per distinct B and desynchronizes multi-host
        lockstep (different hosts drop different counts). Row repetition
        keeps shapes static; the weighting bias is O(1/B), comparable to
        the reference's smaller-batch mean.
        """
        if not isinstance(batch, dict) or not batch:
            return batch  # custom collaters may return other structures
        b = len(next(iter(batch.values())))
        if b == target:
            return batch
        idx = np.resize(np.arange(b), target)
        return {k: np.asarray(v)[idx] for k, v in batch.items()}

    def epoch_batches(self, epoch: int):
        """Yield the batches of one epoch (no prefetch; for eval loops)."""
        idx = self._epoch_indices(epoch)
        n = len(idx)
        end = n - (n % self.batch_size) if self.drop_last else n
        for i in range(0, end, self.batch_size):
            rows = idx[i : i + self.batch_size]
            if self._pool is not None:
                items = list(self._pool.map(self.dataset.__getitem__, rows))
            else:
                items = [self.dataset[j] for j in rows]
            yield self._top_up(self.collater(items), len(rows))

    @property
    def batches_per_epoch(self) -> int:
        n = len(self._epoch_indices(0))
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    @property
    def min_batches_across_shards(self) -> int:
        """Per-epoch batch count guaranteed on EVERY shard (shard sizes
        differ by at most one item). Multi-host eval iterates exactly this
        many batches per process so global collectives stay in lockstep."""
        return (len(self.dataset) // self.num_shards) // self.batch_size

    def _batch_index_stream(self):
        """Yield (seq, per-batch index array) pairs forever."""
        epoch = self.epoch
        seq = 0
        while True:
            idx = self._epoch_indices(epoch)
            n = len(idx)
            end = n - (n % self.batch_size) if self.drop_last else n
            if end <= 0:
                raise RuntimeError(
                    f"dataset yields no complete batch: shard has {n} "
                    f"items < batch_size={self.batch_size} (reduce "
                    "batch_size or add data)"
                )
            for i in range(0, end, self.batch_size):
                if seq >= self.start_seq:
                    yield seq, idx[i : i + self.batch_size]
                seq += 1
            epoch += 1
            self.epoch = epoch

    def _build_batch(self, seq, rows):
        items = [self.dataset[j] for j in rows]
        if self._collater_takes_rng:
            # per-batch child generator: thread-safe + seed-deterministic;
            # shard_index in the key so hosts draw INDEPENDENT crop/noise
            # streams (same (seed, seq) on every host would duplicate the
            # noise tensor across the global batch's shards)
            batch = self.collater(
                items,
                np.random.default_rng((self.seed, self.shard_index, seq)),
            )
        else:
            batch = self.collater(items)
        return self._top_up(batch, len(rows))

    def __iter__(self):
        """Infinite prefetched batch stream (training).

        With ``num_workers > 1`` whole batches are assembled concurrently
        in the pool (reads AND collation overlap — numpy/h5py release the
        GIL on bulk copies); results are consumed in submission order so
        the stream stays deterministic for a fixed seed.
        """
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            try:
                stream = self._batch_index_stream()
                if self._pool is None:
                    for seq, rows in stream:
                        batch = self._build_batch(seq, rows)
                        while not stop.is_set():
                            try:
                                q.put(batch, timeout=0.5)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
                else:
                    inflight: queue.Queue = queue.Queue()
                    for _ in range(self.num_workers):
                        inflight.put(
                            self._pool.submit(self._build_batch, *next(stream))
                        )
                    while not stop.is_set():
                        batch = inflight.get().result()
                        inflight.put(
                            self._pool.submit(self._build_batch, *next(stream))
                        )
                        while not stop.is_set():
                            try:
                                q.put(batch, timeout=0.5)
                                break
                            except queue.Full:
                                continue
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
