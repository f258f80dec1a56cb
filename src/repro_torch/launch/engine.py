"""Request-level serving engines (port of ``repro/launch/engine.py``):
the bucket engine for CNN plans and LMs (on one device, or data-parallel
over a serving mesh), and the continuous-batching LM engine over a paged
KV cache.

Requests are grouped by shape (image shape; prompt length and horizon)
into padding buckets; a bucket
flushes at ``max_batch`` or when its oldest request has waited
``flush_deadline_s``.  Ragged buckets pad up to the next power of two with
copies of row 0.  Dispatch is pipelined: bucket *i* is launched, bucket
*i+1* is staged (pinned host buffer, ``non_blocking`` copy) while it
runs, and bucket *i-1* is harvested (``.cpu()``, which waits for it).

Contract (CNN): a request's result does not depend on its batchmates —
the serve forward is per-sample (per-sample norm statistics, per-row
kernels).
The kernels' integer accumulators are batch-invariant, and on the CPU
every float op is too, so there a request's logits are bit-identical alone
and batched (``tests/test_torch_api.py``).  On the card the float ops
around the kernels are library reductions and convolutions whose
summation order may change with the batch size, so ``chip_smoke.py``
holds alone-vs-batched to equal argmax and a stated tolerance.

Data parallel (``ServeEngine(mesh=)``, ``launch.mesh.make_serve_mesh``):
the engine holds one replica of the runner's plan or params on each
device of the mesh, pads every bucket to a multiple of the device count,
splits it evenly, stages each shard on its device and runs each
replica's forward on its own shard (``distributed.sharding.
data_parallel``), gathering the outputs in order: the reference's
``shard_map`` over the ``data`` axis, the datacenter counterpart of the
paper's independent sub-array windows.  Each shard's per-tensor
reductions (an LM's activation scales) see that shard alone, as under
``shard_map``.

LM serving: :class:`LMRunner` turns one bucket of equal-length prompts
into prefill + greedy decode (``launch/serve.py``); with the default
per-tensor activation scales a request's levels depend on its bucket, as
in the reference.  :class:`ContinuousLMEngine` keeps one persistent batch
of decode slots over a paged KV pool, admits and retires requests between
steps, and forces per-row scales, so there a request's tokens do not
depend on its batchmates.  With ``checkpoint_dir`` it commits an epoch
checkpoint every ``epoch_steps`` decode steps and, polled by a
``FaultPlan`` (``faults``), survives a power loss by rebooting cold and
resuming from its last commit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.kv_pages import PagePool, PoolExhausted, pages_needed
from repro_torch.launch.trace import TRACER


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
    t_start: float = 0.0  # when the engine began computing this request
    # top-2 logit margin of each greedy pick (ContinuousLMEngine with
    # record_margins=True), else None
    margins: Optional[np.ndarray] = None
    # the dispatch that served it (ServeEngine): the identifier of its
    # bucket's spans in ``launch.trace.TRACER``; -1 elsewhere
    dispatch: int = -1

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    @property
    def queue_wait_s(self) -> float:
        """Submit -> first compute (bucket dispatch / slot admission)."""
        return max(self.t_start - self.t_submit, 0.0)

    @property
    def service_s(self) -> float:
        """First compute -> harvest."""
        return self.t_done - self.t_start


@dataclasses.dataclass
class Bucket:
    key: Any
    requests: list
    t_closed: Optional[float] = None   # when it stopped taking requests


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
            return self._close(key, now)
        return None

    def take_expired(self, now: float) -> list[Bucket]:
        keys = [k for k, t in self._opened_at.items()
                if now - t >= self.flush_deadline_s and self._open.get(k)]
        return [self._close(k, now) for k in keys]

    def take_all(self, now: float) -> list[Bucket]:
        return [self._close(k, now) for k in list(self._open)
                if self._open[k]]

    def _close(self, key: Any, now: float) -> Bucket:
        reqs = self._open.pop(key)
        self._opened_at.pop(key, None)
        return Bucket(key, reqs, now)


def _collate(payloads, pad_to: int, dtype) -> np.ndarray:
    """Stack payloads into a (pad_to, ...) batch; padded rows copy row 0."""
    x = np.stack([np.asarray(p, dtype) for p in payloads])
    if pad_to > len(payloads):
        x = np.concatenate(
            [x, np.broadcast_to(x[:1], (pad_to - len(payloads),) + x.shape[1:])])
    return x


def _pow2_ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def lm_fingerprint(params, cfg, **geometry) -> str:
    """Stable short hash of what an LM engine's checkpoints depend on,
    where no compiled plan names the weights: the config, the serving
    ``geometry``, every parameter leaf's path, shape and dtype, and the
    bytes of its first and last 64 elements (one copy to host).  With a
    plan, ``params`` is its fingerprint (a string, hashed as is).  An
    engine refuses a checkpoint whose hash differs."""
    h = hashlib.sha256(repr((cfg, sorted(geometry.items()))).encode())
    samples = []

    def walk(path, v):
        if isinstance(v, dict):
            for k in sorted(v):
                walk(f"{path}/{k}", v[k])
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{path}/{i}", x)
        elif torch.is_tensor(v):
            h.update(f"{path}:{tuple(v.shape)}:{v.dtype};".encode())
            flat = v.detach().reshape(-1)
            samples.extend(t.contiguous().view(torch.uint8)
                           for t in (flat[:64], flat[-64:]))
        else:
            h.update(f"{path}={v!r};".encode())

    walk("", params)
    if samples:
        # once per engine at set-up: hashes a few bytes of each weight
        h.update(torch.cat(samples).cpu().numpy().tobytes())  # repro-lint: disable=RL002
    return h.hexdigest()[:12]


def _tree_to(tree, device):
    """Every tensor leaf of a params tree copied to ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device) if torch.is_tensor(tree) else tree


class CNNRunner:
    """Batched CNN serve forward over a compiled plan (image (H, W, C) ->
    logits row)."""

    def __init__(self, plan):
        from repro_torch.core.plan import _tree_device

        if plan.params is None:
            raise ValueError("structure-only plan (params=None) cannot serve")
        self.plan = plan
        self.device = _tree_device(plan.params, None)
        if self.device is None:
            raise ValueError("plan params hold no tensor")

    def plan_fingerprint(self) -> str:
        """The served plan's fingerprint."""
        return self.plan.fingerprint()

    def shape_key(self, payload) -> tuple:
        return ("cnn",) + tuple(np.shape(payload))

    def collate(self, payloads, pad_to: int) -> np.ndarray:
        return _collate(payloads, pad_to, np.float32)

    def replica(self, device) -> "CNNRunner":
        """This runner with the plan's params on ``device`` (itself when
        they are there already)."""
        if torch.device(device) == self.device:
            return self
        return CNNRunner(dataclasses.replace(
            self.plan, params=_tree_to(self.plan.params, device)))

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        from repro_torch.core.plan import plan_forward

        return plan_forward(self.plan, x)


class LMRunner:
    """Batched LM generate (tokens (S_p,) -> generated tokens (S_d,)):
    prefill, cache growth and the greedy decode loop of
    ``launch/serve.py`` for one bucket.

    Payloads are a token array (horizon = ``new_tokens``) or a
    ``(tokens, new_tokens)`` tuple; the shape key holds prompt length and
    horizon, so mixed horizons land in distinct buckets.

    ``model_plan`` (a compiled LM ``ModelPlan``) supplies the params, and
    prefill and every decode step run inside its ``activate()``: the
    projections and attention dispatch through its tables."""

    def __init__(self, params, cfg, *, new_tokens: int, qmode: str = "serve",
                 plan=None, reference: bool = False, model_plan=None):
        from repro_torch.configs import SINGLE
        from repro_torch.launch.serve import make_prefill

        self.model_plan = model_plan
        if model_plan is not None:
            params = model_plan.params
        self.params = params
        self.cfg = cfg
        self.new_tokens = new_tokens
        self.qmode = qmode
        self.plan = plan or SINGLE
        self.reference = reference
        self.device = params["final_norm"].device
        self._prefill = make_prefill(params, cfg, self.plan, qmode, reference)
        self._generate: dict = {}   # (prompt_len, horizon) -> decode loop
        self._fp = None

    def plan_fingerprint(self) -> str:
        """The identity a bucket's decode checkpoints are tagged with: the
        model plan's fingerprint, else :func:`lm_fingerprint`."""
        if self._fp is None:
            self._fp = (self.model_plan.fingerprint()
                        if self.model_plan is not None else
                        lm_fingerprint(self.params, self.cfg, plan=self.plan,
                                       qmode=self.qmode,
                                       reference=self.reference))
        return self._fp

    def replica(self, device) -> "LMRunner":
        """This runner with its params (and model plan) on ``device``
        (itself when they are there already)."""
        if torch.device(device) == self.device:
            return self
        mp = self.model_plan
        if mp is not None:
            mp = dataclasses.replace(mp, params=_tree_to(mp.params, device))
        return LMRunner(_tree_to(self.params, device), self.cfg,
                        new_tokens=self.new_tokens, qmode=self.qmode,
                        plan=self.plan, reference=self.reference,
                        model_plan=mp)

    def _ctx(self):
        """The model plan's scoped dispatch tables (or nothing)."""
        return (self.model_plan.activate() if self.model_plan is not None
                else contextlib.nullcontext())

    @staticmethod
    def split_payload(payload) -> tuple:
        """Normalize a payload to ``(tokens, new_tokens | None)``."""
        if isinstance(payload, tuple):
            toks, nt = payload
            return np.asarray(toks, np.int32), int(nt)
        return np.asarray(payload, np.int32), None

    def shape_key(self, payload) -> tuple:
        toks, nt = self.split_payload(payload)
        return ("lm", int(toks.shape[-1]),
                self.new_tokens if nt is None else nt)

    def collate(self, payloads, pad_to: int) -> np.ndarray:
        return _collate([self.split_payload(p)[0] for p in payloads],
                        pad_to, np.int32)

    def forward(self, toks: torch.Tensor, key=None) -> torch.Tensor:
        """One bucket: (B, S_p) prompts -> (B, S_d) greedy tokens, the
        horizon from the bucket's shape ``key`` (default ``new_tokens``)."""
        from repro_torch.launch.serve import generate, make_generate

        new_tokens = self.new_tokens if key is None else key[2]
        shape = (toks.shape[1], new_tokens)
        if shape not in self._generate:
            self._generate[shape] = make_generate(
                self.params, self.cfg, self.plan, self.qmode, *shape,
                self.reference)
        with self._ctx():
            return generate(toks, new_tokens, self.cfg.vocab, self._prefill,
                            self._generate[shape])


class _SubmitRetryMixin:
    """Bounded-backoff admission (needs ``submit``/``pump`` and a seeded
    ``self._rng``)."""

    def submit_retry(self, payload, t_submit: float | None = None, *,
                     attempts: int = 6, base_s: float = 1e-3,
                     max_s: float = 0.25,
                     sleep: Callable[[float], None] = time.sleep) -> int:
        """:meth:`submit` with bounded exponential backoff on QueueFull:
        pump, sleep a jittered, growing delay, retry; re-raise QueueFull
        after ``attempts`` tries.  ``t_submit`` keeps charging the request
        from its true arrival."""
        for a in range(attempts):
            try:
                return self.submit(payload, t_submit=t_submit)
            except QueueFull:
                if a == attempts - 1:
                    raise
                self.pump()
                delay = min(base_s * (1 << a), max_s)
                sleep(delay * (0.5 + self._rng.uniform()))
        raise AssertionError("unreachable")


def _seeded_rng(retry_rng) -> np.random.RandomState:
    if isinstance(retry_rng, np.random.RandomState):
        return retry_rng
    return np.random.RandomState(0 if retry_rng is None else retry_rng)


class ServeEngine(_SubmitRetryMixin):
    """Coalesce independent requests into batched dispatches on the plan
    params' device, or data-parallel over ``mesh``: a sequence of devices
    (``launch.mesh.make_serve_mesh()``), one replica on each.  ``None``
    (the default) is the single-device path.  A mesh that names one card
    more than once (two replicas sharing its params, run one after the
    other) is a test layout for a one-card machine, not a serving mode."""

    def __init__(self, runner, *, max_batch: int = 8,
                 flush_deadline_s: float = 0.005, mesh=None,
                 max_pending: int = 4096, retry_rng=None,
                 clock: Callable[[], float] = time.perf_counter):
        self.runner = runner
        self.mesh = (None if mesh is None
                     else tuple(torch.device(d) for d in mesh))
        if self.mesh is not None:
            from repro_torch.distributed.sharding import data_parallel

            held = {}
            self._replicas = [held.setdefault(d, runner.replica(d))
                              for d in self.mesh]
            self._dp = data_parallel(lambda r, x, key: r.forward(x, key),
                                     self.mesh)
        self._rng = _seeded_rng(retry_rng)
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
        self._ready.extend(self.batcher.take_all(self.clock()))
        if self._ready:
            self._execute(list(self._ready))
            self._ready.clear()

    def drain(self) -> list[Result]:
        """Flush everything, run to idle, return results ordered by rid."""
        with TRACER.span("engine.drain"):
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
        # capped at max_batch; with a mesh, rounded up to a multiple of the
        # device count (which may exceed max_batch: every device gets rows)
        padded = min(_pow2_ceil(n), self.batcher.max_batch)
        n_data = 1 if self.mesh is None else len(self.mesh)
        return -(-padded // n_data) * n_data

    def _stage(self, bucket: Bucket):
        """Number the bucket's dispatch and start its host->device copy:
        from a pinned host buffer with ``non_blocking`` on the card, so it
        overlaps compute; with a mesh, each shard to its device."""
        from repro_torch.distributed.sharding import split_batch

        dispatch = TRACER.new_dispatch()
        with TRACER.span("engine.stage", dispatch):
            padded = self._pad_to(len(bucket.requests))
            host = torch.from_numpy(self.runner.collate(
                [r.payload for r in bucket.requests], padded))
            devices = self.mesh or (self.device,)
            if any(d.type == "cuda" for d in devices):
                host = host.pin_memory()
            if self.mesh is not None:
                dev = split_batch(host, self.mesh)
            else:
                dev = host.to(self.device, non_blocking=True)
        return bucket, padded, dev, dispatch

    def _forward(self, dev, key, dispatch: int) -> torch.Tensor:
        TRACER.dispatch = dispatch
        try:
            if self.mesh is None:
                return self.runner.forward(dev, key)
            return self._dp(self._replicas, dev, key)
        finally:
            TRACER.dispatch = -1

    def _execute(self, buckets: list[Bucket]) -> None:
        """Launch bucket i, stage bucket i+1, harvest bucket i-1: at most
        two buckets in flight."""
        staged = self._stage(buckets[0]) if buckets else None
        inflight = None
        for i in range(len(buckets)):
            bucket, padded, dev, dispatch = staged
            t_start = self.clock()
            if bucket.t_closed is not None:
                TRACER.wait("engine.ready_wait", bucket.t_closed, t_start,
                            dispatch)
            out = self._forward(dev, bucket.key, dispatch)
            staged = self._stage(buckets[i + 1]) if i + 1 < len(buckets) else None
            if inflight is not None:
                self._harvest(*inflight)
            inflight = (bucket, padded, out, t_start, dispatch)
        if inflight is not None:
            self._harvest(*inflight)

    def _harvest(self, bucket: Bucket, padded: int, out: torch.Tensor,
                 t_start: float, dispatch: int) -> None:
        with TRACER.span("engine.harvest", dispatch):
            with TRACER.span("engine.harvest.wait", dispatch):
                host = out.cpu().numpy()  # repro-lint: disable=RL002 — the harvest waits
            n = len(bucket.requests)
            t_done = self.clock()
            for i, req in enumerate(bucket.requests):
                # positional: a bucket builds a thousand of these
                self._results[req.rid] = Result(
                    req.rid, host[i], req.t_submit, t_done, n, padded,
                    t_start, None, dispatch)
            self.stats["dispatches"] += 1
            self.stats["requests"] += n
            self.stats["padded_rows"] += padded - n


# ---------------------------------------------------------------------------
# Continuous batching over a paged KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Pending:
    """A submitted request waiting for a slot and pages."""
    rid: int
    tokens: np.ndarray
    new_tokens: int
    t_submit: float


@dataclasses.dataclass
class _Slot:
    """One in-flight request occupying a decode slot."""
    rid: int
    t_submit: float
    t_start: float
    tokens: np.ndarray      # prompt tokens (S_p,)
    new_tokens: int
    pages: list             # page indices owned by this request
    pos: int                # next KV position to write (tokens inserted)
    emitted: list           # generated tokens so far (first from prefill)
    last_tok: int           # last generated token (next decode input)
    margins: list           # top-2 logit margin of each pick (if recorded)


def _top2_margin(row: np.ndarray) -> float:
    top = np.partition(row, -2)[-2:]
    return float(top[1] - top[0])


class ContinuousLMEngine(_SubmitRetryMixin):
    """Step-granular continuous batching over a paged KV cache.

    One persistent batch of ``num_slots`` decode slots.  A waiting request
    joins a free slot between steps (FIFO, no skip-ahead), reserving its
    whole extent ``pages_needed(prompt + horizon)`` of pages up front; its
    prompt streams into its pages in ``chunk``-token pieces at batch 1;
    it retires when it reaches its horizon and frees its pages.  The model
    runs at exactly two shapes, ``(1, chunk)`` and ``(num_slots, 1)``,
    plus a page reset (``program_shapes`` records them).  ``submit``
    raises :class:`QueueFull` past ``max_pending`` waiting requests and
    ValueError for a request that could never fit.

    Per-slot numerics are independent of batchmates: the constructor
    forces ``act_scale_mode="row"`` for quantized serve configs, and paged
    attention uses per-slot scales over ``ppos``-masked pages, so a
    request's tokens are bit-identical alone and batched under the same
    chunk schedule.  ``reference=True`` runs the attention kernels' plain
    versions (the oracle); ``record_margins=True`` keeps each greedy
    pick's top-2 logit margin in ``Result.margins``.

    Power-intermittency resilience: with ``checkpoint_dir`` the engine
    commits an epoch checkpoint every ``epoch_steps`` decode steps — the
    page pools (copied to host before the commit returns, so the next
    in-place step cannot reach them) plus the whole host schedule (page
    table, allocator free list, slots, waiting queue, finished results).
    A ``PowerLoss`` or ``DeviceDrop`` polled from ``faults`` (a
    ``FaultPlan``, at each prefill chunk and each decode step) wipes
    everything volatile and resumes from the last commit; the schedule is
    deterministic, so the resumed run is bit-identical to an uninterrupted
    one.  A new engine on the same ``checkpoint_dir`` adopts the state a
    previous one committed when its params, config and geometry hash to
    the same ``lm_fingerprint``; otherwise it starts clean.

    ``model_plan`` (a compiled LM ``ModelPlan``) supplies the params, and
    every step runs inside its ``activate()``; the checkpoint identity then
    hashes the plan's fingerprint with the geometry.
    """

    def __init__(self, params, cfg, *, num_slots: int = 4,
                 page_size: int = 16, num_pages: int = 64,
                 max_seq: int | None = None, new_tokens: int = 16,
                 chunk: int | None = None, plan=None, qmode: str = "serve",
                 max_pending: int = 4096, retry_rng=None,
                 deadline_s: float | None = None,
                 checkpoint_dir: str | None = None, epoch_steps: int = 4,
                 faults=None, reference: bool = False,
                 record_margins: bool = False, model_plan=None,
                 clock: Callable[[], float] = time.perf_counter):
        from repro_torch.configs import SINGLE
        from repro_torch.models import transformer as T

        if num_slots < 1:
            raise ValueError(f"need at least one slot, got {num_slots}")
        self.model_plan = model_plan
        if model_plan is not None:
            params = model_plan.params
        quant = cfg.quant
        if (qmode == "serve" and quant.engine != "fp" and quant.w_bits < 32
                and quant.act_scale_mode != "row"):
            # per-tensor absmax couples a row's levels to its batchmates,
            # which change every step here: per-row scales are required
            cfg = dataclasses.replace(
                cfg, quant=dataclasses.replace(quant, act_scale_mode="row"))
        self.cfg = cfg
        self.plan = plan or SINGLE
        self.qmode = qmode
        self.reference = reference
        self.record_margins = record_margins
        self.clock = clock
        self.num_slots = num_slots
        self.page_size = page_size
        self.new_tokens = new_tokens
        self.chunk = chunk or page_size
        self.max_seq = max_seq or page_size * num_pages
        self.max_pending = max_pending
        self.deadline_s = deadline_s
        self.faults = faults
        self._rng = _seeded_rng(retry_rng)
        self.table_pages = pages_needed(self.max_seq, page_size)
        self.num_pages = num_pages
        self.params = params
        self.device = params["final_norm"].device
        self._plan_fp = None     # set with checkpoint_dir
        self._layers = T.unstack_layers(params, cfg)
        self.dead_letters: list[dict] = []
        self._next_rid = 0
        self.program_shapes: set = set()
        self.stats = dict(dispatches=0, requests=0, padded_rows=0, steps=0,
                          admissions=0, retirements=0, prefill_chunks=0,
                          dead_lettered=0, commits=0, power_losses=0,
                          commit_s=0.0, commit_bytes=0)
        self._cold_start()
        self.epoch_steps = max(int(epoch_steps), 1)
        self.ckpt = None
        if checkpoint_dir is not None:
            from repro_torch.train.checkpoint import Checkpointer

            self.ckpt = Checkpointer(checkpoint_dir, keep=2,
                                     async_save=False)
            self._plan_fp = lm_fingerprint(
                params if model_plan is None else model_plan.fingerprint(),
                self.cfg, plan=self.plan, qmode=qmode,
                reference=reference, record_margins=record_margins,
                num_slots=num_slots, page_size=page_size,
                num_pages=num_pages, max_seq=self.max_seq, chunk=self.chunk)
            self._try_restore()  # adopt a previous engine's in-flight state

    def _cold_start(self) -> None:
        """Everything volatile, as at power-on: fresh pools on the device,
        an empty page table, allocator, slots, queue and results."""
        from repro_torch.models import transformer as T

        cache = T.init_paged_cache(self.cfg, self.plan, self.num_slots,
                                   self.num_pages, self.page_size,
                                   self.table_pages, device=self.device)
        self._pools = {k: cache["attn"][k] for k in ("pk", "pv", "ppos")}
        self.pool = PagePool(self.num_pages, self.page_size)
        self._table = np.full((self.num_slots, self.table_pages),
                              self.pool.null_page, np.int32)
        self._slots: list = [None] * self.num_slots
        self._waiting: deque[_Pending] = deque()
        self._results: dict[int, Result] = {}
        self._step = 0              # decode steps executed (the work clock)
        self._last_commit = None

    # -- device side ---------------------------------------------------------

    def _dispatch(self, table_rows: np.ndarray, toks: np.ndarray,
                  pos: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """One paged model step (pools updated in place) -> host logits
        (B, S, vocab)."""
        from repro_torch.models import transformer as T

        dev = self.device
        b = table_rows.shape[0]
        self.program_shapes.add(("run", b, toks.shape[1]))
        cache = {"attn": dict(self._pools,
                              table=torch.from_numpy(table_rows).to(dev))}
        ctx = (self.model_plan.activate() if self.model_plan is not None
               else contextlib.nullcontext())
        with ctx:
            logits, _ = T.paged_step(
                self.params, cache, torch.from_numpy(toks).to(dev),
                torch.from_numpy(pos).to(dev),
                torch.from_numpy(valid).to(dev), self.cfg, self.plan,
                qmode=self.qmode, layers=self._layers,
                reference=self.reference)
        self.stats["dispatches"] += 1
        # the step's logits feed the host-side sampler: the step's harvest
        return logits[:, :, :self.cfg.vocab].cpu().numpy()  # repro-lint: disable=RL002

    def _reset_pages(self, pages: list) -> None:
        """Mark freshly allocated pages never-written (ppos = -1), so stale
        positions of a prior tenant cannot unmask its keys."""
        self.program_shapes.add(("reset",))
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        self._pools["ppos"][:, idx] = -1

    # -- queue side ----------------------------------------------------------

    def _normalize(self, payload) -> tuple:
        toks, nt = LMRunner.split_payload(payload)
        return np.atleast_1d(toks).reshape(-1), (self.new_tokens if nt is None
                                                 else nt)

    def submit(self, payload, t_submit: float | None = None) -> int:
        """Enqueue one request (token array, or ``(tokens, new_tokens)``);
        returns its rid."""
        toks, nt = self._normalize(payload)
        total = len(toks) + nt
        if total > self.max_seq:
            raise ValueError(f"prompt+horizon = {total} exceeds max_seq "
                             f"= {self.max_seq}")
        if pages_needed(total, self.page_size) > self.pool.num_pages:
            raise ValueError(f"request needs "
                             f"{pages_needed(total, self.page_size)} pages; "
                             f"pool has {self.pool.num_pages}")
        if nt < 1:
            raise ValueError(f"new_tokens must be >= 1, got {nt}")
        if len(toks) < 1:
            raise ValueError("empty prompt")
        if len(self._waiting) >= self.max_pending:
            raise QueueFull(f"{self.max_pending} requests pending")
        rid = self._next_rid
        self._next_rid += 1
        now = self.clock()
        self._waiting.append(
            _Pending(rid, toks, nt, now if t_submit is None else t_submit))
        return rid

    # -- scheduler -----------------------------------------------------------

    def _free_slot(self):
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _admit(self) -> None:
        """FIFO admission while the head request's page reservation fits."""
        while self._waiting:
            slot_i = self._free_slot()
            if slot_i is None:
                return
            req = self._waiting[0]
            try:
                pages = self.pool.alloc(pages_needed(
                    len(req.tokens) + req.new_tokens, self.page_size))
            except PoolExhausted:
                return
            self._waiting.popleft()
            self._reset_pages(pages)
            self._table[slot_i, :] = self.pool.null_page
            self._table[slot_i, : len(pages)] = pages
            s = _Slot(req.rid, req.t_submit, self.clock(), req.tokens,
                      req.new_tokens, pages, 0, [], -1, [])
            self._slots[slot_i] = s
            self.stats["admissions"] += 1
            self._prefill(slot_i, s)

    def _emit(self, s: _Slot, row: np.ndarray) -> None:
        tok = int(np.argmax(row))
        s.emitted.append(tok)
        s.last_tok = tok
        if self.record_margins:
            s.margins.append(_top2_margin(row))

    def _prefill(self, slot_i: int, s: _Slot) -> None:
        """Stream the prompt into the slot's pages in fixed-size chunks
        (batch 1); the final chunk's logits give the first token."""
        c, s_p = self.chunk, len(s.tokens)
        table_row = self._table[slot_i: slot_i + 1]
        logits = None
        for c0 in range(0, s_p, c):
            self._poll("prefill")
            piece = s.tokens[c0: c0 + c]
            buf = np.zeros((1, c), np.int32)
            buf[0, : len(piece)] = piece
            logits = self._dispatch(table_row, buf,
                                    np.asarray([c0], np.int32),
                                    np.asarray([len(piece)], np.int32))
            self.stats["prefill_chunks"] += 1
        s.pos = s_p
        self._emit(s, logits[0, (s_p - 1) % c])
        if s.new_tokens <= 1:
            self._retire(slot_i)

    def _decode_step(self) -> None:
        """One step of the in-flight batch: every active slot inserts its
        last token and emits the next; finished slots retire."""
        active = [(i, s) for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return
        self._poll("decode")
        toks = np.zeros((self.num_slots, 1), np.int32)
        pos = np.zeros((self.num_slots,), np.int32)
        valid = np.zeros((self.num_slots,), np.int32)
        for i, s in active:
            toks[i, 0] = s.last_tok
            pos[i] = s.pos
            valid[i] = 1
        logits = self._dispatch(self._table, toks, pos, valid)
        self._step += 1
        self.stats["steps"] += 1
        self.stats["padded_rows"] += self.num_slots - len(active)
        for i, s in active:
            self._emit(s, logits[i, 0])
            s.pos += 1
            if len(s.emitted) >= s.new_tokens:
                self._retire(i)

    def _retire(self, slot_i: int) -> None:
        s = self._slots[slot_i]
        self._slots[slot_i] = None
        self.pool.free(s.pages)
        self._table[slot_i, :] = self.pool.null_page
        self._results[s.rid] = Result(
            s.rid, np.asarray(s.emitted[: s.new_tokens], np.int32),
            s.t_submit, self.clock(), 1, 1, t_start=s.t_start,
            margins=(np.asarray(s.margins[: s.new_tokens])
                     if self.record_margins else None))
        self.stats["retirements"] += 1
        self.stats["requests"] += 1

    def _reap_deadlines(self) -> None:
        if self.deadline_s is None:
            return
        now = self.clock()
        for i, s in enumerate(self._slots):
            if s is not None and now - s.t_submit > self.deadline_s:
                self._slots[i] = None
                self.pool.free(s.pages)
                self._table[i, :] = self.pool.null_page
                self.dead_letters.append(dict(
                    rid=s.rid, t_submit=s.t_submit,
                    emitted=list(s.emitted), reason="deadline"))
                self.stats["dead_lettered"] += 1

    # -- engine loop ---------------------------------------------------------

    def pump(self) -> None:
        """One scheduler tick: admit into free slots, commit a due epoch
        checkpoint, reap deadline overruns, run one decode step.  A
        kill-class fault wipes volatile state and resumes from the last
        commit."""
        from repro_torch.resilience.faults import DeviceDrop, PowerLoss

        try:
            self._admit()
            self._maybe_commit()
            self._reap_deadlines()
            self._decode_step()
        except (PowerLoss, DeviceDrop):
            self.stats["power_losses"] += 1
            self._reboot()

    def drain(self) -> list[Result]:
        """Run the scheduler to idle; returns accumulated results by rid."""
        while self._waiting or any(s is not None for s in self._slots):
            self.pump()
        out = [self._results[rid] for rid in sorted(self._results)]
        self._results.clear()
        return out

    def serve(self, payloads) -> list[Result]:
        """Closed loop: submit all, drain, results in order."""
        for p in payloads:
            while True:
                try:
                    self.submit(p)
                    break
                except QueueFull:
                    self.pump()
        return self.drain()

    def warm(self) -> "ContinuousLMEngine":
        """Run each of the engine's device programs (a prefill chunk, a
        decode step, a page reset) once, on one throwaway request, so the
        kernels are built before the first served one."""
        self.serve([(np.asarray([1], np.int32), 2)])
        return self

    # -- epoch checkpoints ---------------------------------------------------

    def _poll(self, site: str) -> None:
        if self.faults is not None:
            ev = self.faults.poll(site, dt=1.0)
            if ev is not None:
                self.faults.raise_for(ev)

    def _maybe_commit(self) -> None:
        if self.ckpt is None:
            return
        if (self._last_commit is not None
                and self._step - self._last_commit < self.epoch_steps):
            return
        extra = dict(
            step=self._step, next_rid=self._next_rid,
            plan_fp=str(self._plan_fp), table=self._table.tolist(),
            pool=self.pool.snapshot(),
            slots=[None if s is None else dict(
                rid=s.rid, t_submit=s.t_submit, t_start=s.t_start,
                tokens=[int(t) for t in s.tokens], new_tokens=s.new_tokens,
                pages=[int(p) for p in s.pages], pos=s.pos,
                emitted=list(s.emitted), last_tok=s.last_tok,
                margins=list(s.margins))
                for s in self._slots],
            waiting=[dict(rid=p.rid, tokens=[int(t) for t in p.tokens],
                          new_tokens=p.new_tokens, t_submit=p.t_submit)
                     for p in self._waiting],
            results={str(r.rid): dict(
                value=[int(v) for v in r.value], t_submit=r.t_submit,
                t_done=r.t_done, t_start=r.t_start,
                margins=(None if r.margins is None
                         else [float(m) for m in r.margins]))
                for r in self._results.values()},
            dead=list(self.dead_letters),
        )
        t0 = time.perf_counter()
        self.ckpt.save(self._step, self._pools, extra=extra, tag="cbe")
        self.stats["commit_s"] += time.perf_counter() - t0
        self.stats["commit_bytes"] += self.ckpt.last_bytes
        self._last_commit = self._step
        self.stats["commits"] += 1

    def _try_restore(self) -> bool:
        """Adopt the last committed state, its pools onto this engine's
        device (the cold pools are the template: dtypes only)."""
        step = self.ckpt.latest_step(tag="cbe")
        if step is None:
            return False
        extra = self.ckpt.manifest(step, tag="cbe")["extra"]
        if extra.get("plan_fp") != str(self._plan_fp):
            return False  # a foreign checkpoint: not this plan's KV
        _, self._pools = self.ckpt.restore(self._pools, step=step, tag="cbe",
                                           device=self.device)
        self._table = np.asarray(extra["table"], np.int32)
        self.pool.restore(extra["pool"])
        self._slots = [
            None if d is None else _Slot(
                d["rid"], d["t_submit"], d["t_start"],
                np.asarray(d["tokens"], np.int32), d["new_tokens"],
                list(d["pages"]), d["pos"], list(d["emitted"]),
                d["last_tok"], list(d["margins"]))
            for d in extra["slots"]]
        self._waiting = deque(
            _Pending(d["rid"], np.asarray(d["tokens"], np.int32),
                     d["new_tokens"], d["t_submit"])
            for d in extra["waiting"])
        self._results = {
            int(rid): Result(
                int(rid), np.asarray(d["value"], np.int32), d["t_submit"],
                d["t_done"], 1, 1, t_start=d["t_start"],
                margins=(None if d["margins"] is None
                         else np.asarray(d["margins"])))
            for rid, d in extra["results"].items()}
        self.dead_letters = list(extra["dead"])
        self._step = int(extra["step"])
        self._next_rid = int(extra["next_rid"])
        self._last_commit = self._step
        return True

    def _reboot(self) -> None:
        """Power came back: everything volatile (device pools, host
        schedule) is gone.  Start cold, then resume from the last commit
        if there is one; requests admitted or submitted after it are lost,
        as in a real brownout."""
        self._cold_start()
        if self.ckpt is not None:
            self._try_restore()


# ---------------------------------------------------------------------------
# Offered-load harness
# ---------------------------------------------------------------------------

def _percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else float("nan")


def warm_engine(engine, payloads):
    """Run the payloads once so a measurement sees a warm server (kernels
    built and loaded, allocator caches filled).  Bucket engines serve every
    padded bucket size 1, 2, 4, ..., max_batch."""
    if not hasattr(engine, "batcher"):  # ContinuousLMEngine
        engine.serve(list(payloads))
        return engine
    size = 1
    while True:
        engine.serve(payloads[: min(size, len(payloads))])
        if size >= engine.batcher.max_batch:
            return engine
        size = min(size * 2, engine.batcher.max_batch)


def run_offered_load(engine, payloads, rate_rps: float | None,
                     clock: Callable[[], float] = time.perf_counter) -> dict:
    """Drive the engine at a fixed offered rate (None = closed loop: all
    requests available at once).  Latency runs submit -> harvest, a
    behind-schedule arrival charged from its scheduled time."""
    engine.stats.update(dispatches=0, requests=0, padded_rows=0)
    t0 = clock()
    for i, p in enumerate(payloads):
        t_arrive = None
        if rate_rps is not None:
            t_arrive = t0 + i / rate_rps
            while clock() < t_arrive:
                engine.pump()
                time.sleep(2e-4)
        engine.submit_retry(p, t_submit=t_arrive)
        engine.pump()
    results = engine.drain()
    wall = clock() - t0
    lats = [r.latency_s for r in results]
    waits = [r.queue_wait_s for r in results]
    svc = [r.service_s for r in results]
    return dict(
        n_requests=len(results),
        offered_rps=(round(rate_rps, 1) if rate_rps is not None else "inf"),
        achieved_rps=round(len(results) / wall, 2),
        p50_ms=round(_percentile(lats, 50) * 1e3, 2),
        p99_ms=round(_percentile(lats, 99) * 1e3, 2),
        queue_p50_ms=round(_percentile(waits, 50) * 1e3, 2),
        queue_p99_ms=round(_percentile(waits, 99) * 1e3, 2),
        service_p50_ms=round(_percentile(svc, 50) * 1e3, 2),
        service_p99_ms=round(_percentile(svc, 99) * 1e3, 2),
        dispatches=engine.stats["dispatches"],
        mean_batch=round(engine.stats["requests"]
                         / max(engine.stats["dispatches"], 1), 2),
        padded_rows=engine.stats["padded_rows"],
        wall_s=round(wall, 4),
    )
