"""Fault-tolerant checkpointing (port of ``repro/train/checkpoint.py``): the
software analogue of the paper's non-volatile write.

A checkpoint is a directory ``<tag>_<step:08d>`` holding ``arrays.npz``
and ``manifest.json``.  It is written into a ``.tmp_*`` directory, the
manifest fsynced, then renamed into place: a reader sees a whole
checkpoint or none.  ``keep`` bounds the published checkpoints of a tag;
stale ``.tmp_*`` directories of a writer killed mid-write are swept at
construction; ``purge`` drops a whole family of tags by prefix.

State is a tree of dicts, lists and tuples whose leaves are tensors, numpy
arrays or numbers.  ``save`` copies every leaf to host memory before it
returns, so a caller may go on mutating its tensors in place (a KV cache
written by the next decode step, a page pool reset) while an asynchronous
write is in flight.  bfloat16 has no numpy dtype: its bit patterns are
stored as uint16 and restored through the template's dtype.  An async
write that fails re-raises at :meth:`Checkpointer.wait` or at the next
:meth:`Checkpointer.save` as :class:`CheckpointWriteError`.

DTensor leaves (a trainer over a mesh) are saved as full arrays, in the
same format: every rank gathers them (all ranks call ``save`` together),
rank 0 alone writes, and :meth:`Checkpointer.wait` ends with a barrier,
so no rank reads a checkpoint before it is published.  A restore
re-distributes each stored array to its template leaf's placements on the
template's mesh, which is what elastic remesh stands on.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Optional

import numpy as np
import torch


def _leaves(tree, prefix: str = ""):
    """(key path, leaf) pairs in a fixed order: dict keys sorted, list and
    tuple entries by index; paths join keys with '/'."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _to_host(leaf) -> np.ndarray:
    """A host copy of one leaf that no later in-place write can reach (a
    DTensor's full array)."""
    if torch.is_tensor(leaf):
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {k: _to_host(v) for k, v in _leaves(tree)}


def _from_host(arr: np.ndarray, like, device):
    """``arr`` in the type of the template leaf ``like``: a tensor of its
    dtype on ``device`` (None: on ``like``'s device, the CPU for a meta
    leaf; a DTensor ``like``: distributed to its placements on its mesh),
    a numpy array of its dtype, or a Python number."""
    if _is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor

        full = _from_host(arr, like.to_local(), device)
        return distribute_tensor(full, like.device_mesh, like.placements)
    if torch.is_tensor(like):
        # np.ascontiguousarray would make a 0-d array 1-d
        arr = np.require(arr, requirements="C")
        if like.dtype == torch.bfloat16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr).to(like.dtype)
        if device is None:   # a meta template describes, it holds nothing
            device = "cpu" if like.device.type == "meta" else like.device
        return t.to(device)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr)
    return arr


def _unflatten(template, flat: dict[str, np.ndarray], device, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, device,
                              f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_unflatten(v, flat, device,
                          f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(template)]
        return type(template)(out)
    return _from_host(flat[prefix], template, device)


class CheckpointWriteError(RuntimeError):
    """An async checkpoint write failed after ``save()`` already returned."""


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False       # a distributed save awaits its barrier
        self.last_bytes = 0         # array bytes of the latest save
        os.makedirs(directory, exist_ok=True)
        # a writer killed mid-write leaves a .tmp_* directory that was never
        # published (the rename never ran) and escapes keep-k GC
        for name in os.listdir(directory):
            if name.startswith(".tmp_"):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, extra: dict | None = None,
             tag: str = "ckpt") -> str:
        """Returns the final path (renamed into place once written).  The
        state is copied to host before this returns."""
        self.wait()  # one in-flight save at a time
        distributed = any(_is_dtensor(v) for _, v in _leaves(state))
        flat = _flatten(state)
        self.last_bytes = sum(a.nbytes for a in flat.values())
        final = os.path.join(self.dir, f"{tag}_{step:08d}")
        if distributed:
            self._barrier = True
            if torch.distributed.get_rank() != 0:
                return final

        def _write():
            tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
            try:
                np.savez(os.path.join(tmp, "arrays.npz"), **flat)
                manifest = dict(step=step, time=time.time(),
                                n_arrays=len(flat), tag=tag,
                                extra=extra or {})
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):  # same-step overwrite
                    old = final + ".old"
                    shutil.rmtree(old, ignore_errors=True)
                    os.rename(final, old)
                    os.rename(tmp, final)  # atomic publish
                    shutil.rmtree(old, ignore_errors=True)
                else:
                    os.rename(tmp, final)  # atomic publish
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            self._gc(tag)

        if self.async_save:
            # a daemon thread's exception would otherwise only reach
            # threading's excepthook: the caller would take the write as
            # durable.  Keep it; wait() or the next save() re-raises it.
            def _run():
                try:
                    _write()
                except Exception as e:  # repro-lint: disable=RL003 — re-raised by wait()
                    self._error = e

            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()
        else:
            _write()
        return final

    def wait(self):
        """Block until the in-flight save completes; raise if it failed.
        After a save of DTensors every rank meets at a barrier here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            torch.distributed.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointWriteError(
                f"async checkpoint write failed: {err!r}") from err

    # -- restore --------------------------------------------------------------
    def latest_step(self, tag: str = "ckpt") -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith(f"{tag}_") and not name.startswith("."):
                p = os.path.join(self.dir, name, "manifest.json")
                if os.path.exists(p):  # only fully published checkpoints
                    steps.append(int(name.split("_")[-1]))
        return max(steps) if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                tag: str = "ckpt", device=None):
        """Returns (step, state) or (None, None) when nothing is there.
        ``template`` supplies the tree's structure and leaf types (shapes
        come from the stored arrays); each tensor lands on ``device``, or
        with no ``device`` on its template leaf's device (a trainer on the
        card restores onto the card; a meta leaf restores onto the
        CPU)."""
        step = step if step is not None else self.latest_step(tag)
        if step is None:
            return None, None
        path = os.path.join(self.dir, f"{tag}_{step:08d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return step, _unflatten(template, flat, device)

    def manifest(self, step: int, tag: str = "ckpt") -> dict:
        path = os.path.join(self.dir, f"{tag}_{step:08d}", "manifest.json")
        with open(path) as f:
            return json.load(f)

    def purge(self, prefix: str) -> int:
        """Remove every published checkpoint whose name starts with
        ``prefix`` (a family of derived tags goes with its stem); returns
        how many.  Waits for an in-flight save first."""
        self.wait()
        n = 0
        for name in list(os.listdir(self.dir)):
            if name.startswith(prefix) and not name.startswith("."):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)
                n += 1
        return n

    def _gc(self, tag: str):
        entries = sorted(
            n for n in os.listdir(self.dir)
            if n.startswith(f"{tag}_") and not n.startswith("."))
        for name in entries[: max(0, len(entries) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)
