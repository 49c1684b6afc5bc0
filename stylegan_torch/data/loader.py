"""Threaded, prefetching batch loader (the port's copy of
``stylegan_tpu/data/loader.py``) and the host-to-card prefetch.

`DataLoader` replaces the reference's torch DataLoader worker processes
(data/__init__.py:32-52): a thread pool decodes and resizes images while the
card runs the previous step, and a small queue keeps decoded batches ready.
It is the JAX package's code unchanged, so for the same dataset, seed, epoch
and shard the batches are bitwise equal.  The trainer builds a new loader per
depth, with that depth's batch size, as the reference does (GAN.py:739).

Multi-host hooks: pass (shard_index, num_shards) to give each host a disjoint
stripe of every epoch's permutation (deterministic from the epoch seed).

`device_prefetch` replaces the JAX package's, whose ``jax.device_put`` is
asynchronous by nature: each batch is copied into a pinned host buffer and
sent to the card with ``non_blocking=True`` on a side stream, `size` batches
ahead of the consumer (`PinnedRing`).
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch


class _ProducerError:
    """Exception carrier from the producer thread to the consuming iterator."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class DataLoader:
    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 shard_index: int = 0, num_shards: int = 1,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.prefetch = prefetch
        self._epoch = 0
        self.conditional = getattr(dataset, "labels", None) is not None

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        rs = np.random.RandomState((self.seed, self._epoch))
        idx = rs.permutation(n) if self.shuffle else np.arange(n)
        return idx[self.shard_index::self.num_shards]

    def __iter__(self) -> Iterator:
        indices = self._epoch_indices()
        nb = len(self)
        if nb == 0:
            return
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]
        epoch_rng_base = np.random.RandomState(
            (self.seed, self._epoch, 7919)).randint(0, 2 ** 31)

        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def load_batch(bi, batch_idx):
            imgs, labels = [], []
            for j, di in enumerate(batch_idx):
                # RandomState seeds must be < 2**32; wrap (large datasets at
                # small batch sizes push bi*100003 past 2**32 otherwise)
                rng = np.random.RandomState(
                    (epoch_rng_base + bi * 100003 + j) % (2 ** 32))
                item = self.dataset.get(int(di), rng)
                if self.conditional:
                    img, lab = item
                    labels.append(lab)
                else:
                    img = item
                imgs.append(img)
            x = np.stack(imgs).astype(np.float32)
            if self.conditional:
                return x, np.asarray(labels, dtype=np.int32)
            return x

        def put_or_stop(item) -> bool:
            """Bounded put that keeps observing the stop flag (a blocking
            q.put would deadlock the producer forever if the consumer
            abandons the iterator mid-epoch)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                futures = []
                for bi, b in enumerate(batches):
                    if stop.is_set():
                        return
                    futures.append(pool.submit(load_batch, bi, b))
                    # keep a bounded window of in-flight decode jobs
                    while len(futures) > self.num_workers + self.prefetch:
                        if not put_or_stop(futures.pop(0).result()):
                            return
                for f in futures:
                    if not put_or_stop(f.result()):
                        return
                put_or_stop(None)
            except Exception as e:  # surface decode errors to the consumer
                put_or_stop(_ProducerError(e))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, _ProducerError):
                    raise item.exc
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)
            # advance even when the iterator is abandoned mid-epoch, so the
            # next epoch gets a fresh permutation and augmentation stream
            self._epoch += 1


def get_data_loader(dataset, batch_size: int, num_workers: int,
                    **kw) -> DataLoader:
    """Factory mirroring reference data/__init__.py:32-52."""
    return DataLoader(dataset, batch_size, num_workers=num_workers,
                      shuffle=True, drop_last=True, **kw)


class PinnedRing:
    """Pinned host buffers for the batches in flight to one card, reused
    from batch to batch: allocating pinned memory (cudaHostAlloc) for a
    25 MB-1.6 GB batch costs milliseconds to hundreds of them.  One ring
    per loader, since a loader's batches keep one shape; a batch of another
    shape replaces its slot's buffers.  A slot is refilled only after the
    copy that last read it has completed (its event), so the next batch
    never overwrites reals still in flight."""

    def __init__(self, device, slots: int = 3):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self._slots = [None] * slots    # [host tensors, event of last copy]
        self._next = 0

    def send(self, arrays):
        """Start the copy of `arrays` (numpy) to the card on the side stream;
        returns (device tensors, the copy's event)."""
        k = self._next
        self._next = (k + 1) % len(self._slots)
        slot = self._slots[k]
        if slot is None or [tuple(h.shape) for h in slot[0]] != \
                [a.shape for a in arrays]:
            host = [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                                pin_memory=True) for a in arrays]
            slot = self._slots[k] = [host, torch.cuda.Event()]
        else:
            slot[1].synchronize()
        for h, a in zip(slot[0], arrays):
            h.copy_(torch.from_numpy(a))
        with torch.cuda.stream(self.stream):
            out = [h.to(self.device, non_blocking=True) for h in slot[0]]
            slot[1].record(self.stream)
        return out, slot[1]


def device_prefetch(iterator, device, size: int = 2,
                    ring: Optional[PinnedRing] = None):
    """Yield the batches of `iterator` (numpy arrays, or tuples of them) as
    tensors on `device`.

    On CUDA the host-to-card copy of each batch runs on `ring`'s side stream
    (a ring of its own when None is given), `size` batches ahead of
    consumption; the consumer's current stream waits on a batch's copy
    before it may read it, and each tensor is recorded on that stream so
    that the caching allocator does not hand its memory to another tensor
    while the consumer still uses it.  On the CPU the batches are yielded in
    order as tensors sharing the arrays' memory, with nothing else done."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            if isinstance(batch, tuple):
                yield tuple(torch.from_numpy(np.asarray(b)) for b in batch)
            else:
                yield torch.from_numpy(np.asarray(batch))
        return
    if ring is None:
        ring = PinnedRing(device, size + 1)

    def ready(item):
        tensors, event, is_tuple = item
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(event)
        for t in tensors:
            t.record_stream(consumer)
        return tuple(tensors) if is_tuple else tensors[0]

    pending = collections.deque()
    for batch in iterator:
        is_tuple = isinstance(batch, tuple)
        arrays = [np.ascontiguousarray(b)
                  for b in (batch if is_tuple else (batch,))]
        pending.append((*ring.send(arrays), is_tuple))
        if len(pending) >= size:
            yield ready(pending.popleft())
    while pending:
        yield ready(pending.popleft())
