"""Sharded, prefetching host data pipeline (port of
``repro/data/pipeline.py``).

Every batch is a pure function of (step, micro, host), so a restart
replays identically and any host can compute another host's shard.  The
host index and count default to the reference's ``jax.process_index()``
and ``jax.process_count()``: hosts (nodes), not ranks.  Under ``torchrun``
that is ``GROUP_RANK`` and the world over ``LOCAL_WORLD_SIZE``; ranks
spawned on one machine are one host, which addresses the whole global
batch (a trainer over a mesh splits it over its ranks).
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Any, Callable, Optional

import torch


def _host_and_count() -> tuple[int, int]:
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return int(os.environ.get("GROUP_RANK", 0)), world // local


class Pipeline:
    def __init__(self, batch_fn: Callable[[int, int], Any], *,
                 accum_steps: int = 1, prefetch: int = 2,
                 host_index: Optional[int] = None,
                 n_hosts: Optional[int] = None):
        """batch_fn(step, micro) -> GLOBAL batch dict of numpy arrays; the
        pipeline slices this host's shard and prefetches ahead."""
        host, count = _host_and_count()
        self.batch_fn = batch_fn
        self.accum = accum_steps
        self.host = host if host_index is None else host_index
        self.n_hosts = count if n_hosts is None else n_hosts
        self.prefetch = prefetch
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _shard(self, batch):
        def slc(x):
            per = x.shape[0] // self.n_hosts
            return x[self.host * per: (self.host + 1) * per]
        return {k: slc(v) for k, v in batch.items()}

    def _producer(self, start_step: int):
        step, micro = start_step, 0
        while not self._stop.is_set():
            item = self._shard(self.batch_fn(step, micro))
            while not self._stop.is_set():
                try:
                    self._q.put(((step, micro), item), timeout=0.1)
                    break
                except queue.Full:
                    continue
            micro += 1
            if micro == self.accum:
                micro, step = 0, step + 1

    def start(self, start_step: int = 0):
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._producer, args=(start_step,), daemon=True)
        self._thread.start()
        return self

    def __next__(self):
        return self._q.get()

    def stop(self):
        """Stop the producer and drop what it prefetched."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
