"""Request-level serving engine for CNN plans (port of the CNN half of
``repro/launch/engine.py``, single device).

Requests are grouped by image shape into padding buckets; a bucket
flushes at ``max_batch`` or when its oldest request has waited
``flush_deadline_s``.  Ragged buckets pad up to the next power of two with
copies of row 0.  Dispatch is pipelined: bucket *i* is launched, bucket
*i+1* is staged (pinned host buffer, ``non_blocking`` copy) while it
runs, and bucket *i-1* is harvested (``.cpu()``, which waits for it).

Contract: a request's result does not depend on its batchmates — the
serve forward is per-sample (per-sample norm statistics, per-row kernels).
The kernels' integer accumulators are batch-invariant, and on the CPU
every float op is too, so there a request's logits are bit-identical alone
and batched (``tests/test_torch_api.py``).  On the card the float ops
around the kernels are library reductions and convolutions whose
summation order may change with the batch size, so ``chip_smoke.py``
holds alone-vs-batched to equal argmax and a stated tolerance.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch


class QueueFull(RuntimeError):
    """Backpressure: the queue holds ``max_pending`` requests."""


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    payload: Any
    t_submit: float


@dataclasses.dataclass(frozen=True)
class Result:
    rid: int
    value: np.ndarray
    t_submit: float
    t_done: float
    batch: int    # real co-batched requests in the dispatch
    padded: int   # dispatched batch after padding

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclasses.dataclass
class Bucket:
    key: Any
    requests: list


class BucketBatcher:
    """Group requests by shape key, flush on ``max_batch`` or deadline."""

    def __init__(self, max_batch: int = 8, flush_deadline_s: float = 0.005):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.flush_deadline_s = flush_deadline_s
        self._open: dict[Any, list] = {}
        self._opened_at: dict[Any, float] = {}

    def pending(self) -> int:
        return sum(len(v) for v in self._open.values())

    def add(self, req: Request, key: Any, now: float) -> Optional[Bucket]:
        """Queue one request; returns the bucket if this filled it."""
        q = self._open.setdefault(key, [])
        if not q:
            self._opened_at[key] = now
        q.append(req)
        if len(q) >= self.max_batch:
            return self._close(key)
        return None

    def take_expired(self, now: float) -> list[Bucket]:
        keys = [k for k, t in self._opened_at.items()
                if now - t >= self.flush_deadline_s and self._open.get(k)]
        return [self._close(k) for k in keys]

    def take_all(self) -> list[Bucket]:
        return [self._close(k) for k in list(self._open) if self._open[k]]

    def _close(self, key: Any) -> Bucket:
        reqs = self._open.pop(key)
        self._opened_at.pop(key, None)
        return Bucket(key, reqs)


def _collate(payloads, pad_to: int, dtype) -> np.ndarray:
    """Stack payloads into a (pad_to, ...) batch; padded rows copy row 0."""
    x = np.stack([np.asarray(p, dtype) for p in payloads])
    if pad_to > len(payloads):
        x = np.concatenate(
            [x, np.broadcast_to(x[:1], (pad_to - len(payloads),) + x.shape[1:])])
    return x


def _pow2_ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _params_device(params) -> torch.device:
    for p in params:
        for v in p.values():
            if torch.is_tensor(v):
                return v.device
    raise ValueError("plan params hold no tensor")


class CNNRunner:
    """Batched CNN serve forward over a compiled plan (image (H, W, C) ->
    logits row)."""

    def __init__(self, plan):
        if plan.params is None:
            raise ValueError("structure-only plan (params=None) cannot serve")
        self.plan = plan
        self.device = _params_device(plan.params)

    def shape_key(self, payload) -> tuple:
        return ("cnn",) + tuple(np.shape(payload))

    def collate(self, payloads, pad_to: int) -> np.ndarray:
        return _collate(payloads, pad_to, np.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.core.plan import plan_forward

        return plan_forward(self.plan, x)


class ServeEngine:
    """Coalesce independent requests into batched dispatches on the plan
    params' device."""

    def __init__(self, runner, *, max_batch: int = 8,
                 flush_deadline_s: float = 0.005, max_pending: int = 4096,
                 clock: Callable[[], float] = time.perf_counter):
        self.runner = runner
        self.clock = clock
        self.max_pending = max_pending
        self.batcher = BucketBatcher(max_batch, flush_deadline_s)
        self._ready: deque[Bucket] = deque()
        self._results: dict[int, Result] = {}
        self._next_rid = 0
        self.device = runner.device
        self.stats = dict(dispatches=0, requests=0, padded_rows=0)

    # -- queue side ---------------------------------------------------------

    def _queued(self) -> int:
        return (self.batcher.pending()
                + sum(len(b.requests) for b in self._ready))

    def submit(self, payload, t_submit: float | None = None) -> int:
        """Enqueue one request; returns its rid.  Raises QueueFull when
        ``max_pending`` requests are already waiting."""
        if self._queued() >= self.max_pending:
            raise QueueFull(f"{self.max_pending} requests pending")
        rid = self._next_rid
        self._next_rid += 1
        now = self.clock()
        bucket = self.batcher.add(
            Request(rid, payload, now if t_submit is None else t_submit),
            self.runner.shape_key(payload), now)
        if bucket is not None:
            self._ready.append(bucket)
        return rid

    def pump(self) -> None:
        """Dispatch full buckets plus any whose flush deadline expired."""
        self._ready.extend(self.batcher.take_expired(self.clock()))
        if self._ready:
            self._execute(list(self._ready))
            self._ready.clear()

    def _flush_all(self) -> None:
        self._ready.extend(self.batcher.take_all())
        if self._ready:
            self._execute(list(self._ready))
            self._ready.clear()

    def drain(self) -> list[Result]:
        """Flush everything, run to idle, return results ordered by rid."""
        self._flush_all()
        out = [self._results[rid] for rid in sorted(self._results)]
        self._results.clear()
        return out

    def serve(self, payloads) -> list[Result]:
        """Closed-loop convenience: submit all, drain, results in order."""
        for p in payloads:
            try:
                self.submit(p)
            except QueueFull:
                self._flush_all()
                self.submit(p)
        return self.drain()

    # -- device side --------------------------------------------------------

    def _pad_to(self, n: int) -> int:
        return min(_pow2_ceil(n), self.batcher.max_batch)

    def _stage(self, bucket: Bucket):
        """Start the host->device copy of one bucket: from a pinned host
        buffer with ``non_blocking`` on the card, so it overlaps compute."""
        padded = self._pad_to(len(bucket.requests))
        host = torch.from_numpy(
            self.runner.collate([r.payload for r in bucket.requests], padded))
        if self.device.type == "cuda":
            dev = host.pin_memory().to(self.device, non_blocking=True)
        else:
            dev = host.to(self.device)
        return bucket, padded, dev

    def _execute(self, buckets: list[Bucket]) -> None:
        """Launch bucket i, stage bucket i+1, harvest bucket i-1: at most
        two buckets in flight."""
        staged = self._stage(buckets[0]) if buckets else None
        inflight = None
        for i in range(len(buckets)):
            bucket, padded, dev = staged
            out = self.runner.forward(dev)
            staged = self._stage(buckets[i + 1]) if i + 1 < len(buckets) else None
            if inflight is not None:
                self._harvest(*inflight)
            inflight = (bucket, padded, out)
        if inflight is not None:
            self._harvest(*inflight)

    def _harvest(self, bucket: Bucket, padded: int,
                 out: torch.Tensor) -> None:
        host = out.cpu().numpy()  # waits for this bucket's kernels
        n = len(bucket.requests)
        t_done = self.clock()
        for i, req in enumerate(bucket.requests):
            self._results[req.rid] = Result(req.rid, host[i], req.t_submit,
                                            t_done, n, padded)
        self.stats["dispatches"] += 1
        self.stats["requests"] += n
        self.stats["padded_rows"] += padded - n
