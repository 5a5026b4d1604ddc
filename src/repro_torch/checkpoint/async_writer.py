"""Threaded checkpoint writes: copy to the host now, disk I/O later.

Counterpart of `repro.checkpoint.async_writer`. The serving layer publishes
model snapshots every few rounds; blocking a publication on an npz write
would stall both the trainer and (through the publication lock) the
predictor. `AsyncCheckpointer` splits `save_checkpoint` in two: ``save``
copies the tree to the host at the moment of the call — every tensor, and
every noise generator's state, since the trainer goes on drawing — so the
caller may keep advancing its state at once; the npz write runs on one
background thread. A bounded queue applies backpressure instead of letting
pending host copies pile up; an error of the writer thread surfaces on the
caller's thread at the next `save`, `wait` or `close`.

>>> import tempfile, torch
>>> from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
>>> d = tempfile.mkdtemp()
>>> ck = AsyncCheckpointer(d)
>>> ck.save(4, {"theta": torch.ones((2, 3))})
>>> ck.close()                              # flushes pending writes
>>> restored = restore_checkpoint(d, {"theta": torch.zeros((2, 3))}, step=4)
>>> bool((restored["theta"] == 1.0).all())
True
"""
from __future__ import annotations

import queue
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.store import save_checkpoint

__all__ = ["AsyncCheckpointer"]

_SENTINEL = object()


def _host_copy(node: Any) -> Any:
    """A copy of a tree that no later device work or draw can change:
    tensors copied to the host, generators copied with their state, numpy
    arrays copied; NamedTuples (engine states), dicts, lists and tuples
    rebuilt around the copies."""
    if isinstance(node, torch.Tensor):
        return node.detach().to("cpu", copy=True)
    if isinstance(node, torch.Generator):
        gen = torch.Generator(device=node.device)
        gen.set_state(node.get_state())
        return gen
    if isinstance(node, np.ndarray):
        return node.copy()
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*map(_host_copy, node))
    if isinstance(node, dict):
        return {k: _host_copy(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(map(_host_copy, node))
    return node


class AsyncCheckpointer:
    """Background-thread `save_checkpoint` with bounded backpressure."""

    def __init__(self, directory: str, max_pending: int = 2):
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.directory = directory
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._error: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="repro-torch-async-ckpt")
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _SENTINEL:
                    return
                step, host_tree = item
                save_checkpoint(self.directory, step, host_tree)
            except Exception as err:         # surfaced on the caller thread
                self._error = err
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint write to {self.directory} failed") from err

    def save(self, step: int, tree: Any) -> None:
        """Copy ``tree`` to the host NOW; enqueue the write. Blocks only when
        ``max_pending`` writes are already queued (backpressure)."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self._raise_pending()
        self._q.put((step, _host_copy(tree)))

    def wait(self) -> None:
        """Block until every enqueued write hit disk; re-raise failures."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """Flush pending writes and stop the worker (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._q.put(_SENTINEL)
        self._thread.join()
        self._raise_pending()

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
