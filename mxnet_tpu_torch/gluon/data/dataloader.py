"""DataLoader (the port of ``mxnet_tpu/gluon/data/dataloader.py``).

Batches are made on the host: samples, transforms and the batchify
function run under ``cpu()`` (inline with ``num_workers=0``, in a
thread pool, or in spawned worker processes), and each batch's arrays
then move to the context that was current when the iteration began (the
card by default). ``pin_memory=True`` puts a batch bound for the card
in page-locked host memory first, so its copy to the card does not
block the host (``pin_device_id`` is taken for the reference's
signature: torch's page-locked memory serves every card). A background
prefetcher keeps ``prefetch`` batches in flight (``2 * num_workers`` by
default) and records the consumer's wait for each as
``io.dataloader.batch_wait``.

Process workers (``thread_pool=False``) are spawned, never forked: the
parent holds a CUDA context that a fork would clone. A worker is
started with no visible card (``CUDA_VISIBLE_DEVICES`` empty) and
builds its batches under ``cpu()``; the dataset and the batchify
function reach it pickled, once, through a shared-memory segment the
loader holds until it closes (a pickle passed as the pool's
``initargs`` would go through each worker's start-up pipe, and a large
dataset would start the workers one after another), and each batch
comes back as numpy arrays in ``multiprocessing.shared_memory``
segments that the parent copies out and unlinks. A dataset that a
spawned worker cannot import (one defined in an interactive
``__main__``) leaves the batch unmade, and the loader raises the
reference's error after ``timeout`` seconds; it does not fall back to
threads.

``bucketing=`` pads a short last batch up to its bucket and marks the
pad on the leaves (``bucketing.mark_pad``), as in the reference.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as onp
import torch

from ... import bucketing as _bucketing
from ... import telemetry
from ..._bounded_worker import BoundedQueueWorker
from ...base import resolve_dtype
from ...context import cpu, current_context
from ...ndarray.ndarray import NDArray
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (parity: default_batchify_fn)."""
    from ...numpy import array
    if isinstance(data[0], NDArray):
        from ...numpy import stack
        return stack(data)
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    data = onp.asarray(data)
    return array(data, dtype=data.dtype)


def default_mp_batchify_fn(data):
    return default_batchify_fn(data)


class _Prefetcher(BoundedQueueWorker):
    """Background batch producer (the shutdown contract is
    ``_bounded_worker.BoundedQueueWorker``'s)."""

    def __init__(self, it, depth):
        super().__init__(depth, name="DataLoaderPrefetcher")
        self._it = it
        self.start()

    def run(self):
        try:
            for item in self._it:
                if not self._put(item):
                    return
        except Exception as e:  # propagate into consumer
            if not self._put(e):
                return
        self._put(self._DONE)

    def __iter__(self):
        try:
            while True:
                t0 = telemetry.clock()
                item = self._get()
                if item is self._DONE:
                    return
                telemetry.duration_since("io.dataloader.batch_wait", t0)
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            self.stop()


# ---------------------------------------------------------------------------
# process workers
# ---------------------------------------------------------------------------
_W_DATASET = None
_W_BATCHIFY = None


def _proc_worker_init(blob_name, blob_size):
    import pickle
    from multiprocessing import shared_memory
    from ...context import Context
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    Context._default_ctx.value = cpu()
    global _W_DATASET, _W_BATCHIFY
    blob = shared_memory.SharedMemory(name=blob_name)
    try:
        _W_DATASET, _W_BATCHIFY = pickle.loads(blob.buf[:blob_size])
    finally:
        blob.close()


def _tree_to_host(obj):
    """A batch as a picklable host tree (NDArray leaves as numpy)."""
    if isinstance(obj, NDArray):
        return obj.asnumpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_to_host(x) for x in obj)
    return obj


def _leaf_to_shm(arr):
    from multiprocessing import resource_tracker, shared_memory
    shm = shared_memory.SharedMemory(create=True, size=max(1, arr.nbytes))
    view = onp.ndarray(arr.shape, arr.dtype, buffer=shm.buf)
    view[...] = arr
    name = shm.name
    # the parent owns the segment: this process's tracker must not
    # unlink it when the worker exits
    try:
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:  # noqa: BLE001 - the tracker's API is semi-private
        pass
    shm.close()
    return ("__shm__", name, arr.shape, str(arr.dtype))


def _tree_to_shm(obj):
    if isinstance(obj, onp.ndarray) and obj.nbytes > 0:
        return _leaf_to_shm(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_to_shm(x) for x in obj)
    return obj


def _proc_make_batch(indices):
    samples = [_W_DATASET[i] for i in indices]
    host = _tree_to_host(_W_BATCHIFY(samples))
    try:
        return _tree_to_shm(host)
    except Exception:  # noqa: BLE001 - fall back to pipe pickling
        return host


def _is_shm(obj):
    return isinstance(obj, tuple) and len(obj) == 4 and obj[0] == "__shm__"


def _tree_from_shm(obj, pin):
    """A worker's batch as host NDArrays (pinned when ``pin``); the
    consumed segments are unlinked."""
    if _is_shm(obj):
        from multiprocessing import shared_memory
        _, name, shape, dtype = obj
        shm = shared_memory.SharedMemory(name=name)
        try:
            view = onp.ndarray(shape, dtype, buffer=shm.buf)
            return _host_nd(view, pin)
        finally:
            shm.close()
            shm.unlink()
    if isinstance(obj, onp.ndarray):
        return _host_nd(obj, pin)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_from_shm(x, pin) for x in obj)
    return obj


def _host_nd(arr, pin):
    """An owned host NDArray copy of the numpy ``arr``, pinned when
    ``pin`` (64-bit types narrowed as ``mx.np.array`` narrows them): one
    copy, from ``arr`` (a shared-memory view) straight into the
    tensor."""
    arr = onp.ascontiguousarray(arr)
    out = torch.empty(arr.shape, dtype=resolve_dtype(arr.dtype, values=arr),
                      pin_memory=pin)
    out.copy_(torch.from_numpy(arr))
    return NDArray(out, ctx=cpu())


def _tree_unlink_shm(obj):
    """Release the segments of a batch nobody consumed."""
    if _is_shm(obj):
        from multiprocessing import shared_memory
        try:
            shm = shared_memory.SharedMemory(name=obj[1])
            shm.close()
            shm.unlink()
        except FileNotFoundError:
            pass
        return
    if isinstance(obj, (list, tuple)):
        for x in obj:
            _tree_unlink_shm(x)


def _leading_dim(tree):
    """The batch size of a batch: the leading dim of its first NDArray
    leaf (None when it has none)."""
    if isinstance(tree, NDArray):
        return tree.shape[0] if tree.ndim else None
    if isinstance(tree, (list, tuple)):
        for x in tree:
            n = _leading_dim(x)
            if n is not None:
                return n
    return None


def _pin_tree(obj):
    if isinstance(obj, NDArray):
        t = obj._data
        if t.device.type == "cpu" and not t.is_pinned():
            return _bucketing.mark_pad(NDArray(t.pin_memory(), ctx=obj.ctx),
                                       _bucketing.get_pad(obj))
        return obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pin_tree(x) for x in obj)
    return obj


def _deliver(obj, ctx):
    """The batch's NDArrays on ``ctx`` (a copy from pinned memory does
    not block the host); pad marks carry over."""
    if isinstance(obj, NDArray):
        dev = ctx.torch_device
        t = obj._data
        if t.device == dev:
            return obj
        out = NDArray(t.to(dev, non_blocking=t.is_pinned()), ctx=ctx)
        return _bucketing.mark_pad(out, _bucketing.get_pad(obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_deliver(x, ctx) for x in obj)
    return obj


class DataLoader:
    def __init__(self, dataset: Dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0, pin_memory=False,
                 pin_device_id=0, prefetch=None, thread_pool=True,
                 timeout=120, try_nopython=None, bucketing=None):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        policy = _bucketing.as_policy(bucketing)
        if policy is not None and batch_size is not None:
            policy = policy.clamped(batch_size)
        self._bucketing = policy

        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None or
              last_batch is not None):
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._skip_next = 0
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._thread_pool = thread_pool
        self._timeout = timeout
        self._pool = None
        self._proc_pool = None
        self._blob = None
        if self._num_workers > 0 and thread_pool:
            self._pool = ThreadPoolExecutor(max_workers=self._num_workers)
        # the process pool starts at the first __iter__: spawning is
        # slow and pickles the dataset once

    def _pin_for(self, ctx):
        return self._pin_memory and ctx.device_type == "gpu"

    def _sample(self, i):
        with cpu():
            return self._dataset[i]

    def _make_batch(self, indices, pin):
        with cpu():
            if self._pool is not None:
                samples = list(self._pool.map(self._sample, indices))
            else:
                samples = [self._dataset[i] for i in indices]
            batch = self._bucket_pad(self._batchify_fn(samples),
                                     len(indices))
        return _pin_tree(batch) if pin else batch

    def _bucket_pad(self, batch, n_real):
        """Pad a short batch's leaves (those with ``n_real`` rows) up to
        the bucket, marking the pad for the loss mask."""
        if self._bucketing is None or not n_real:
            return batch
        target = self._bucketing.bucket(n_real)
        if target <= n_real:
            return batch
        telemetry.counter("io.dataloader.bucket_pad")

        def pad(obj):
            if isinstance(obj, NDArray):
                if obj.ndim and obj.shape[0] == n_real:
                    padded, _ = _bucketing.pad_leaves([obj], target, n_real)
                    return padded[0]
                return obj
            if isinstance(obj, (list, tuple)):
                return type(obj)(pad(x) for x in obj)
            return obj

        return pad(batch)

    def _ensure_proc_pool(self):
        """Start the process workers (at the first epoch, or earlier when
        called: they take seconds to import the package)."""
        if self._proc_pool is None:
            import multiprocessing as mp
            import pickle
            from multiprocessing import shared_memory
            ctx = mp.get_context("spawn")
            data = pickle.dumps((self._dataset, self._batchify_fn))
            self._blob = shared_memory.SharedMemory(create=True,
                                                    size=max(1, len(data)))
            self._blob.buf[:len(data)] = data
            # the workers start with no card visible: set for the spawn
            # (a child inherits the environment), restored after it
            prev = os.environ.get("CUDA_VISIBLE_DEVICES")
            os.environ["CUDA_VISIBLE_DEVICES"] = ""
            try:
                self._proc_pool = ctx.Pool(
                    self._num_workers, initializer=_proc_worker_init,
                    initargs=(self._blob.name, len(data)))
            finally:
                if prev is None:
                    del os.environ["CUDA_VISIBLE_DEVICES"]
                else:
                    os.environ["CUDA_VISIBLE_DEVICES"] = prev
        return self._proc_pool

    def _proc_iter(self, pin):
        return self._proc_iter_inner(self._indices_iter(), pin)

    def _proc_iter_inner(self, batches, pin):
        """A process-worker epoch: a window of ``prefetch`` batches in
        flight, rebuilt in order."""
        from collections import deque
        pool = self._ensure_proc_pool()
        depth = max(self._prefetch, self._num_workers)
        pending = deque()

        def submit():
            try:
                idxs = next(batches)
            except StopIteration:
                return False
            pending.append(pool.apply_async(_proc_make_batch,
                                            (list(idxs),)))
            return True

        for _ in range(depth):
            if not submit():
                break
        try:
            while pending:
                t0 = telemetry.clock()
                try:
                    res = pending.popleft().get(self._timeout)
                except Exception as e:
                    if type(e).__name__ == "TimeoutError":
                        raise RuntimeError(
                            f"process DataLoader batch not ready "
                            f"after {self._timeout}s. Likely causes: "
                            f"the dataset/batchify_fn class is not "
                            f"importable in a spawned worker (define "
                            f"it at module top level, not __main__/"
                            f"REPL), or one batch genuinely exceeds "
                            f"the timeout (pass timeout=N).") from e
                    raise
                telemetry.duration_since("io.dataloader.batch_wait", t0)
                submit()
                tree = _tree_from_shm(res, pin)
                if self._bucketing is not None:
                    tree = self._bucket_pad(tree, _leading_dim(tree))
                yield tree
        finally:
            # an abandoned epoch: reap the segments of batches in flight
            for fut in pending:
                try:
                    _tree_unlink_shm(fut.get(5))
                except Exception:  # noqa: BLE001 - best-effort reap
                    pass

    def skip_batches(self, n: int):
        """Arm a fast-forward: the next epoch skips its first ``n``
        sampler batches without loading them (the sampler's draws are
        still made); a remainder longer than the epoch carries on."""
        n = int(n)
        if n < 0:
            raise ValueError(f"skip_batches needs n >= 0, got {n}")
        self._skip_next += n
        return n

    def _indices_iter(self):
        """The sampler's batches with an armed ``skip_batches`` applied,
        claimed when the iterator is made."""
        skip, self._skip_next = self._skip_next, 0

        def gen(skip):
            for idxs in self._batch_sampler:
                if skip > 0:
                    skip -= 1
                    continue
                yield idxs
            if skip > 0:
                self._skip_next += skip

        return gen(skip)

    def __iter__(self):
        ctx = current_context()
        pin = self._pin_for(ctx)
        if self._num_workers > 0 and not self._thread_pool:
            source = self._proc_iter(pin)
        else:
            source = (self._make_batch(b, pin) for b in self._indices_iter())
            if self._prefetch > 0:
                source = iter(_Prefetcher(source, self._prefetch))
        return (_deliver(batch, ctx) for batch in source)

    def __len__(self):
        return len(self._batch_sampler)

    def close(self):
        """Stop the worker threads or processes."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        if self._proc_pool is not None:
            self._proc_pool.terminate()
            self._proc_pool.join()
            self._proc_pool = None
        if self._blob is not None:
            self._blob.close()
            self._blob.unlink()
            self._blob = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
