"""Multi-buffered host -> device feeding.

Port of the JAX package's ``data/pipeline.py``. The reference hides host
latency behind torch DataLoader workers (``train_img_horo.py:292-302``);
here a prefetch ring does it: background threads pull host batches from any
iterator, optionally transform them on the host, and copy them to the
device ahead of the consumer, so the card does not wait on the host.

With ``workers > 1`` several host batches are read and copied at once.
Delivery order is preserved, so a stream stays deterministic for a fixed
host iterator; on a failure the batches sequenced before it are still
delivered (the prefix a single worker would give), then the error is
raised.

On a CUDA device each batch goes through a pinned host buffer and an
asynchronous copy on the prefetcher's own copy stream, which ends with an
event. The consumer's stream waits on that event before it reads the
batch, and the batch's memory is recorded as used on the consumer's stream,
so the caching allocator does not hand it out again while the consumer's
work is queued. A pinned buffer is refilled only after the event of its
last copy has completed. On the CPU a batch is a tensor copy of the host
array, through the same ordered queue.

A batch is a pytree (``torch.utils._pytree``: tuples, namedtuples, lists,
dicts) of arrays; ``None`` leaves pass through. Its arrays arrive under
JAX's dtype rule with 64-bit types off, so a float64 batch lands as
float32, as from the JAX package's prefetcher. With a ``mesh``, each leaf's
leading axis is sharded over ``mesh_axis`` and only this rank's rows are
copied: the counterpart of the JAX prefetcher's ``sharding``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from stainlib_tpu_torch.parallel.mesh import shard_rows


# Host arrays arrive as JAX's ``device_put`` delivers them with 64-bit types
# off (its default): each 64-bit type narrowed to its 32-bit counterpart.
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32,
           np.dtype(np.complex128): np.complex64}


def _host_array(a):
    """``a`` as a numpy array under JAX's dtype rule; None stays None."""
    if a is None:
        return None
    a = np.asarray(a)
    to = _NARROW.get(a.dtype)
    return a if to is None else a.astype(to)


def _tensors(batch) -> list:
    return [t for t in tree_leaves(batch) if t is not None]


class _PinnedSlot:
    """Pinned host buffers for one batch's leaves, and the event of the
    last copy out of them."""

    def __init__(self):
        self.buffers: list = []
        self.event: Optional[torch.cuda.Event] = None

    def buffer(self, i: int, a: np.ndarray) -> torch.Tensor:
        """Pinned buffer ``i``, shaped and typed like ``a``."""
        dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
        while len(self.buffers) <= i:
            self.buffers.append(None)
        buf = self.buffers[i]
        if buf is None or buf.shape != a.shape or buf.dtype != dtype:
            buf = torch.empty(a.shape, dtype=dtype, pin_memory=True)
            self.buffers[i] = buf
        return buf


class DevicePrefetcher:
    """Wraps a host batch iterator with an N-deep device-side buffer."""

    _DONE = object()

    def __init__(self, host_iter: Iterator, depth: int = 4,
                 transform: Optional[Callable] = None, workers: int = 1,
                 device="cuda", mesh=None, mesh_axis: str = "data"):
        """``transform(batch) -> array(s)`` runs on a host thread;
        ``workers`` host threads overlap reading and copying; ``device``
        is where the batches land (a CUDA device unless the caller asks
        for the CPU); with ``mesh`` (a ``DeviceMesh``) each leaf's rows at
        this rank's coordinate on ``mesh_axis`` are all that is copied.
        A batch comes out as tensors of the same structure."""
        self._rows = None if mesh is None else (
            lambda a: a[shard_rows(mesh, mesh_axis, a.shape)])
        self._device = torch.device(device)
        if self._device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device={str(device)!r} but PyTorch sees no CUDA "
                    "device; pass device='cpu' to run on the CPU")
            if self._device.index is None:
                self._device = torch.device("cuda", torch.cuda.current_device())
            self._copy_stream = torch.cuda.Stream(self._device)
            self._slots: queue.Queue = queue.Queue()
            for _ in range(max(workers, 1) + 1):
                self._slots.put(_PinnedSlot())
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._iter = iter(host_iter)
        self._iter_lock = threading.Lock()
        self._seq = 0
        self._emit = threading.Condition()
        self._next_emit = 0
        self._stopped = False
        self._err_seq = float("inf")  # first failing sequence number
        self._active = max(workers, 1)

        def worker():
            seq = None
            try:
                while True:
                    seq = None  # reset: an iterator error has no seq of its own
                    with self._iter_lock:
                        if self._stopped:
                            return
                        # Record the slot this next() fills BEFORE calling
                        # it: an iterator raise is then pinned to this
                        # position even if the shared iterator yields again
                        # to another worker afterwards (keeps the
                        # same-prefix-as-single-worker guarantee).
                        seq = self._seq
                        try:
                            batch = next(self._iter)
                        except StopIteration:
                            return
                        except BaseException:
                            self._seq += 1  # the error consumes the slot
                            raise
                        self._seq += 1
                    item = self._put_to_device(batch, transform)
                    with self._emit:
                        # Batches sequenced BEFORE the first failure still
                        # emit (the consumer sees the same prefix as a
                        # single-worker run); only later ones are dropped.
                        while (self._next_emit != seq
                               and not (self._stopped
                                        and seq > self._err_seq)):
                            self._emit.wait()
                        if self._stopped and seq > self._err_seq:
                            return
                        self._q.put(item)
                        self._next_emit += 1
                        self._emit.notify_all()
            except BaseException as e:  # surfaced on the consumer side
                with self._emit:
                    if self._err is None:
                        self._err = e
                    fail_at = seq if seq is not None else self._seq
                    self._err_seq = min(self._err_seq, fail_at)
                    self._stopped = True
                    self._emit.notify_all()
            finally:
                with self._emit:
                    self._active -= 1
                    finish = self._active == 0
                if finish:
                    self._q.put(self._DONE)

        self._threads = [threading.Thread(target=worker, daemon=True)
                         for _ in range(self._active)]
        for t in self._threads:
            t.start()

    def _host(self, a):
        """A leaf as the host array to copy: this rank's rows of it."""
        a = _host_array(a)
        return a if a is None or self._rows is None else self._rows(a)

    def _put_to_device(self, batch, transform):
        """(tensors, event): the batch on the device, and the event that
        completes its copy (None on the CPU)."""
        if transform is not None:
            batch = transform(batch)
        batch = tree_map(self._host, batch)
        if self._device.type != "cuda":
            return tree_map(lambda a: None if a is None else
                            torch.from_numpy(np.array(a)), batch), None
        slot = self._slots.get()
        try:
            if slot.event is not None:
                slot.event.synchronize()  # its last copy has left the buffer
            leaves = iter(range(len(_tensors(batch))))

            def copy(a):
                if a is None:
                    return None
                pinned = slot.buffer(next(leaves), a)
                np.copyto(pinned.numpy(), a)
                out = torch.empty(a.shape, dtype=pinned.dtype,
                                  device=self._device)
                out.copy_(pinned, non_blocking=True)
                return out

            with torch.cuda.device(self._device), \
                    torch.cuda.stream(self._copy_stream):
                batch = tree_map(copy, batch)
                slot.event = torch.cuda.Event()
                slot.event.record(self._copy_stream)
            return batch, slot.event
        finally:
            self._slots.put(slot)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in _tensors(batch):
                t.record_stream(stream)
        return batch
