"""DataLoader — port of `paddle_tpu/io/dataloader.py` (reference:
`python/paddle/io/reader.py:216`).

num_workers>0 with use_shared_memory=True starts worker PROCESSES that push
collated numpy batches through a native C++ shared-memory ring per worker
(`io/csrc/shm_ring.cc` — the reference's mmap_allocator + C++ blocking-queue
path); the main process pops in round-robin order and makes the Tensors on
the expected place (the card, unless `set_device("cpu")`).  Without shared
memory (or if the ring does not build, or the dataset doesn't pickle) a
prefetch thread keeps `prefetch_factor` batches in flight, as in the
reference; `shm_ring.available()` says which route a loader takes.
num_workers=0 runs synchronously in-process, like the reference.

Workers are SPAWNED, never forked: a forked child of a process with a CUDA
context cannot use CUDA, and CUDA never starts in a worker (batches cross
the ring as numpy).  Each worker imports torch.  Like the reference on spawn
platforms, scripts using num_workers>0 must guard their entry point with
`if __name__ == "__main__":`, and the dataset's class must import in the
child.
"""
from __future__ import annotations

import itertools
import multiprocessing as _mp
import os
import queue as _queue
import threading
import traceback

import numpy as np

from ..core.tensor import Tensor
from .dataset import IterableDataset
from .sampler import BatchSampler

_worker_info = None


def get_worker_info():
    return _worker_info


class WorkerInfo:
    def __init__(self, id, num_workers, dataset, seed=0):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, Tensor):
        return np.stack([s.numpy() for s in batch])
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn([b[i] for b in batch]) for i in range(len(sample))]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return np.asarray(batch)


def _to_tensors(batch, places=None):
    """Collated numpy -> Tensors on the expected place (`places` is
    accepted and ignored, as in the reference)."""
    if isinstance(batch, np.ndarray):
        return Tensor(batch)
    if isinstance(batch, (list, tuple)):
        return [_to_tensors(b, places) for b in batch]
    if isinstance(batch, dict):
        return {k: _to_tensors(v, places) for k, v in batch.items()}
    if isinstance(batch, Tensor):
        return batch
    return Tensor(np.asarray(batch))


def _mp_worker_main(wid, num_workers, dataset, collate_fn, worker_init_fn,
                    ring_name, assigned):
    """Spawned worker entry: build assigned batches, push through the shm ring.

    Module-level (not a bound method) so only these picklable fields cross the
    spawn boundary — an unpicklable places/batch_sampler on the DataLoader
    itself must not reach Process.start()."""
    from .shm_ring import ShmRing
    global _worker_info
    _worker_info = WorkerInfo(wid, num_workers, dataset)
    ring = None
    try:
        ring = ShmRing(ring_name, create=False)
        if worker_init_fn:
            worker_init_fn(wid)
        for indices in assigned:
            batch = [dataset[i] for i in indices]
            ring.put(collate_fn(batch))
    except BaseException:
        if ring is not None:
            try:
                ring.put({"__dataloader_worker_error__":
                          traceback.format_exc()})
            except Exception:
                pass
    finally:
        if ring is not None:
            ring.close_producer()
        os._exit(0)


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True,
                 prefetch_factor=2, use_shared_memory=True, timeout=0,
                 worker_init_fn=None, persistent_workers=False):
        self.dataset = dataset
        self.places = places
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, int(num_workers))
        self.prefetch_factor = prefetch_factor
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.use_shared_memory = use_shared_memory
        self._iterable_ds = isinstance(dataset, IterableDataset)
        if self._iterable_ds:
            self.batch_size = batch_size
            self.batch_sampler = None
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        else:
            if batch_size is None:
                self.batch_sampler = None
                self.batch_size = None
            else:
                self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                                  batch_size=batch_size,
                                                  drop_last=drop_last)
                self.batch_size = batch_size

    def __len__(self):
        if self._iterable_ds:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    # ---- single-process iteration ----
    def _iter_sync(self):
        if self._iterable_ds:
            global _worker_info
            _worker_info = WorkerInfo(0, 1, self.dataset)
            if self.worker_init_fn:
                self.worker_init_fn(0)
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield _to_tensors(self.collate_fn(batch), self.places)
        elif self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield _to_tensors(self.dataset[i], self.places)
        else:
            for indices in self.batch_sampler:
                batch = [self.dataset[i] for i in indices]
                yield _to_tensors(self.collate_fn(batch), self.places)

    # ---- threaded prefetch (overlap host work with device compute) ----
    def _iter_prefetch(self):
        q: _queue.Queue = _queue.Queue(maxsize=self.prefetch_factor * max(self.num_workers, 1))
        sentinel = object()
        err = []

        def producer():
            try:
                if self._iterable_ds or self.batch_sampler is None:
                    for item in self._iter_sync():
                        q.put(item)
                else:
                    for indices in self.batch_sampler:
                        batch = [self.dataset[i] for i in indices]
                        q.put(_to_tensors(self.collate_fn(batch), self.places))
            except BaseException as e:  # surface worker errors in main thread
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        if err:
            raise err[0]

    _ring_counter = itertools.count()

    def _iter_multiprocess(self):
        from .shm_ring import TIMEOUT, ShmRing
        nw = self.num_workers
        batches = list(self.batch_sampler)
        cap = max(16 << 20, (self.prefetch_factor or 2) * 8 << 20)
        # unique per iterator: concurrent iterators/loaders must not collide
        # (ring_create clobbers an existing segment of the same name)
        tag = f"pt_dl_{os.getpid()}_{next(DataLoader._ring_counter)}"
        rings = [ShmRing(f"{tag}_{w}", capacity=cap) for w in range(nw)]
        # spawn, not fork: the parent's CUDA context does not survive a
        # fork; spawned children import fresh (dataset must pickle —
        # __iter__ pre-checks and falls back to the threaded path otherwise)
        ctx = _mp.get_context("spawn")
        procs = []
        try:
            for w in range(nw):
                assigned = batches[w::nw]
                p = ctx.Process(target=_mp_worker_main,
                                args=(w, nw, self.dataset, self.collate_fn,
                                      self.worker_init_fn, rings[w].name,
                                      assigned),
                                daemon=True)
                p.start()
                procs.append(p)
            timeout_ms = int(self.timeout * 1000) if self.timeout else -1
            for i in range(len(batches)):
                ring = rings[i % nw]
                proc = procs[i % nw]
                while True:
                    # bounded poll so a dead worker (OOM-kill, attach failure)
                    # surfaces as an error instead of an infinite hang
                    obj = ring.get(timeout_ms=1000 if timeout_ms < 0
                                   else min(1000, timeout_ms))
                    if obj is not TIMEOUT:
                        break
                    if not proc.is_alive() and ring.size() == 0:
                        raise RuntimeError(
                            f"DataLoader worker {i % nw} died "
                            f"(exitcode={proc.exitcode})")
                    if timeout_ms >= 0:
                        timeout_ms -= 1000
                        if timeout_ms <= 0:
                            raise TimeoutError(
                                f"DataLoader worker {i % nw} timed out after "
                                f"{self.timeout}s")
                if isinstance(obj, dict) and "__dataloader_worker_error__" in obj:
                    raise RuntimeError("DataLoader worker failed:\n"
                                       + obj["__dataloader_worker_error__"])
                yield _to_tensors(obj, self.places)
        finally:
            for p in procs:
                p.terminate()
                p.join(timeout=5)
            for r in rings:
                r.free()

    def _picklable_for_workers(self):
        # must mirror the exact _mp_worker_main payload: nothing else of the
        # DataLoader crosses the spawn boundary
        import pickle as _pickle
        try:
            _pickle.dumps((self.dataset, self.collate_fn,
                           self.worker_init_fn))
            return True
        except Exception:
            return False

    def __iter__(self):
        if self.num_workers == 0:
            return self._iter_sync()
        if self.use_shared_memory and not self._iterable_ds \
                and self.batch_sampler is not None:
            from .shm_ring import available
            if available() and self._picklable_for_workers():
                return self._iter_multiprocess()
        return self._iter_prefetch()
