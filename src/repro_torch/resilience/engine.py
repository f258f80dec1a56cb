"""Fault-surviving serve engine: epoch decode, recovery, degradation (port
of ``repro/resilience/engine.py`` over the port's ``ServeEngine``).

* every dispatch is bracketed by :class:`~repro_torch.resilience.faults.
  FaultPlan` hook points (staging, prefill, each decode epoch, single-shot
  dispatch);
* the LM decode runs as K-step epochs (:class:`EpochLMRunner`) whose
  state commits through :class:`~repro_torch.resilience.checkpoints.
  DecodeCheckpointer` after each one: a kill mid-decode loses at most one
  epoch, never the prefill or earlier tokens;
* a killed bucket's requests are re-enqueued idempotently (same rid, same
  ``t_submit``, one result at most) behind bounded exponential backoff
  with jitter; a request out of retries or past its deadline lands in
  :attr:`ResilientServeEngine.dead_letters`;
* under repeated faults or a modeled energy budget the engine degrades to
  a pre-compiled lower-bit plan (:class:`~repro_torch.resilience.degrade.
  DegradePolicy`), and re-arms the primary after a clean streak.

The engine is per node (no mesh) and dispatches buckets one at a time.
Work is counted in ``stats`` in logical decode steps, so a chaos run's
counters are a function of the fault seed and the submit order: with the
same schedule and no degrade they equal the reference engine's.  A
degraded run's fault clock scales with the fallback's relative modeled
energy, which comes from the compile target's cost constants — the port's
are the H100's, so such a timeline differs from the reference's.
"""
from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from repro_torch.launch.engine import Bucket, LMRunner, Result, ServeEngine
from .checkpoints import DecodeCheckpointer
from .faults import (DEVICE_DROP, POWER_LOSS, SLOW_DISPATCH,
                     STAGING_CORRUPTION, DeviceDrop, FaultPlan, PowerLoss)

# logical work-clock charge (decode-step units) of the non-decode hooks:
# staging is a host copy, prefill one pass over the prompt
STAGING_DT = 0.25
PREFILL_DT = 1.0


class EpochLMRunner(LMRunner):
    """LM runner whose decode is cut into K-step checkpoint epochs.

    The engine calls :meth:`prefill` once and :meth:`epoch` per epoch,
    committing state between them.  An epoch runs the same decode step
    (``launch/serve.make_decode_step``) that ``LMRunner``'s decode loop
    runs, on the same state, so a fault-free run returns ``LMRunner``'s
    tokens on the same padded batch, and a faulted-and-resumed run
    returns the fault-free run's.  ``epoch_steps`` is the paper's
    checkpoint period P, in decode steps.
    """

    supports_epochs = True

    def __init__(self, params, cfg, *, new_tokens: int, epoch_steps: int = 4,
                 qmode: str = "serve", plan=None, reference: bool = False,
                 model_plan=None):
        super().__init__(params, cfg, new_tokens=new_tokens, qmode=qmode,
                         plan=plan, reference=reference,
                         model_plan=model_plan)
        if epoch_steps < 1:
            raise ValueError(f"epoch_steps must be >= 1, got {epoch_steps}")
        self.epoch_steps = int(epoch_steps)
        self._step = None

    def epoch_schedule(self, key=None) -> tuple:
        """Decode-step counts per epoch: K, K, ..., remainder (horizon from
        the bucket's shape ``key``, default ``new_tokens``)."""
        new_tokens = self.new_tokens if key is None else key[2]
        n, k = new_tokens - 1, self.epoch_steps
        return tuple([k] * (n // k) + ([n % k] if n % k else []))

    def prefill(self, key, toks: torch.Tensor):
        """(B, S_p) prompts -> (grown cache, first token (B, 1), pos)."""
        from repro_torch.launch.serve import greedy_token, grow_cache

        _, prompt_len, new_tokens = key
        with self._ctx():
            logits, cache = self._prefill(toks)
        cache = grow_cache(cache, prompt_len, prompt_len + new_tokens)
        return cache, greedy_token(logits, self.cfg.vocab), int(prompt_len)

    def epoch(self, key, cache, tok: torch.Tensor, pos: int, steps: int):
        """``steps`` decode steps -> (cache, tok, pos, chunk (B, steps)).
        The cache is written in place."""
        from repro_torch.launch.serve import make_decode_step

        if self._step is None:
            self._step = make_decode_step(self.params, self.cfg, self.plan,
                                          self.qmode, self.reference)
        toks = []
        with self._ctx():
            for _ in range(steps):
                cache, tok, _ = self._step(cache, tok, pos)
                pos += 1
                toks.append(tok)
        return cache, tok, pos, torch.cat(toks, dim=1)

    def decode_state_template(self, key, batch: int, emitted: int) -> dict:
        """The checkpoint state's structure and dtypes, from the config
        alone (on the meta device: nothing is allocated, nothing live is
        read; shapes come from the stored arrays)."""
        from repro_torch.models import transformer as T

        _, prompt_len, new_tokens = key
        meta = torch.device("meta")
        cache = T.init_cache(self.cfg, self.plan, batch,
                             prompt_len + new_tokens, device=meta)
        return dict(cache=cache,
                    tok=torch.zeros((batch, 1), dtype=torch.int32,
                                    device=meta),
                    pos=0,
                    toks=torch.zeros((batch, emitted), dtype=torch.int32,
                                     device=meta))


class ResilientServeEngine(ServeEngine):
    """A :class:`ServeEngine` that survives a ``FaultPlan``.

    Parameters (beyond the base engine's)
    -------------------------------------
    fault_plan:      the seeded fault schedule (None -> fault-free, the
                     same code path: the reference arm of bit-identity
                     checks).
    checkpoint_dir:  where decode epochs commit; None disables them (the
                     volatile P=0 baseline: a kill restarts from prefill).
    max_retries:     kills a request survives before dead-lettering.
    backoff_base_s / backoff_max_s: bounds of the jittered exponential
                     backoff of re-enqueued requests (gated by ``clock``).
    deadline_s:      per-request budget, submit -> dispatch start.
    degrade:         a :class:`DegradePolicy`; with ``fallbacks``, repeated
                     faults or a spent energy budget swap to the next
                     (lower-bit) runner; ``recover_after`` re-arms the
                     primary (``stats["recoveries"]``).
    fallbacks:       runners over pre-compiled degraded plans, best first.
    """

    def __init__(self, runner, *, fault_plan: FaultPlan | None = None,
                 checkpoint_dir: str | None = None, max_retries: int = 3,
                 backoff_base_s: float = 0.01, backoff_max_s: float = 1.0,
                 deadline_s: float | None = None, degrade=None,
                 fallbacks=(), slow_dispatch_s: float = 0.0, seed: int = 0,
                 mesh=None, **kw):
        if mesh is not None:
            raise ValueError(
                "ResilientServeEngine is the per-node intermittency story "
                "(paper §II-B3): mesh sharding is not supported — shard "
                "above the engine, one resilient engine per node")
        super().__init__(runner, **kw)
        self.faults = fault_plan if fault_plan is not None else FaultPlan(None)
        self.ckpt = (DecodeCheckpointer(checkpoint_dir)
                     if checkpoint_dir else None)
        self.max_retries = int(max_retries)
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.deadline_s = deadline_s
        self.policy = degrade
        self.slow_dispatch_s = slow_dispatch_s
        self._runners = [runner, *fallbacks]
        self._active = 0
        # energy-weighted fault clock: on a harvested supply the MTBF is a
        # mean energy between failures, so a dispatch's exposure scales
        # with the active plan's modeled energy (1.0 for the primary)
        self._energy_scale = 1.0
        self._rng = np.random.RandomState(seed)
        self._attempts: dict[int, int] = {}
        self._retry: list[tuple[float, object]] = []   # (eligible_at, Request)
        self.dead_letters: dict[int, str] = {}
        self.result_runner: dict[int, int] = {}        # rid -> runner index
        self.stats.update(
            faults=0, power_losses=0, device_drops=0, slow_dispatches=0,
            staging_retries=0, retries=0, dead_lettered=0, degrades=0,
            recoveries=0,
            prefills=0, resumes=0, epochs=0, commits=0, commit_s=0.0,
            commit_bytes=0,
            executed_steps=0, useful_steps=0, wasted_steps=0.0,
            energy_pj=0.0)

    # -- queue side: retries are pre-admitted work ---------------------------

    def _queued(self) -> int:
        return super()._queued() + len(self._retry)

    def _admit_retries(self, force: bool = False) -> None:
        """Move backoff-expired retries back into the batcher (the original
        Request objects: same rid, same t_submit)."""
        now = self.clock()
        still = []
        for eligible_at, req in self._retry:
            if force or eligible_at <= now:
                b = self.batcher.add(req, self.runner.shape_key(req.payload),
                                     now)
                if b is not None:
                    self._ready.append(b)
            else:
                still.append((eligible_at, req))
        self._retry = still

    def pump(self) -> None:
        self._admit_retries()
        super().pump()

    def drain(self) -> list[Result]:
        """Run to completion: every request completes or dead-letters.
        Backoff paces ``pump``; a drain force-admits the retries (the
        caller is the clock).  Terminates: every kill raises an attempt
        count bounded by ``max_retries``."""
        while True:
            self._admit_retries(force=True)
            self._flush_all()
            if (not self._retry and not self.batcher.pending()
                    and not self._ready):
                break
        out = [self._results[rid] for rid in sorted(self._results)]
        self._results.clear()
        return out

    # -- recovery ------------------------------------------------------------

    def _dead_letter(self, req, reason: str) -> None:
        if req.rid in self.dead_letters or req.rid in self._results:
            return
        self.dead_letters[req.rid] = reason
        self.stats["dead_lettered"] += 1
        self._attempts.pop(req.rid, None)

    def _requeue(self, bucket: Bucket) -> None:
        """Idempotent re-enqueue of a killed bucket: bounded retries,
        jittered exponential backoff, dead letter on exhaustion."""
        now = self.clock()
        survivors = []
        for req in bucket.requests:
            a = self._attempts.get(req.rid, 0) + 1
            self._attempts[req.rid] = a
            if a > self.max_retries:
                self._dead_letter(req,
                                  f"retries exhausted ({self.max_retries})")
                continue
            delay = min(self.backoff_base_s * (1 << (a - 1)),
                        self.backoff_max_s)
            delay *= 0.5 + self._rng.uniform()          # jitter [0.5, 1.5)
            self._retry.append((now + delay, req))
            self.stats["retries"] += 1
            survivors.append(req)
        if self.ckpt is not None and len(survivors) != len(bucket.requests):
            # the composition changed: the old tag can never resume
            self.ckpt.purge(self._bucket_tag(bucket))

    def _swap_to(self, index: int) -> None:
        self._active = index
        self.runner = self._runners[index]
        self.device = self.runner.device
        self._attempts.clear()   # a fresh retry budget at the new point
        self.policy.reset()
        if self.ckpt is not None:
            # every outstanding checkpoint names the retired plan
            self.ckpt.purge_all()

    def _maybe_degrade(self) -> None:
        if self.policy is None or self._active + 1 >= len(self._runners):
            return
        if not self.policy.should_degrade():
            return
        old = self.runner
        self._swap_to(self._active + 1)
        self._energy_scale *= self._relative_energy(old, self.runner)
        self.stats["degrades"] += 1

    def _maybe_recover(self) -> None:
        """Re-arm the primary once the policy's clean streak says fault
        pressure has passed (straight back to runner 0, unit energy
        scale)."""
        if self.policy is None or self._active == 0:
            return
        if not self.policy.should_recover():
            return
        self._swap_to(0)
        self._energy_scale = 1.0
        self.stats["recoveries"] += 1

    @staticmethod
    def _runner_plan(r):
        plan = getattr(r, "model_plan", None) or getattr(r, "plan", None)
        return plan if plan is not None and hasattr(plan, "layers") else None

    @classmethod
    def _relative_energy(cls, old, new) -> float:
        """The new plan's modeled energy per forward over the old's (1.0
        when either has no cost annotations)."""
        from repro_torch.core.plan import plan_energy_pj

        def _e(r):
            plan = cls._runner_plan(r)
            return plan_energy_pj(plan) if plan is not None else 0.0

        e_old, e_new = _e(old), _e(new)
        return e_new / e_old if e_old > 0 and e_new > 0 else 1.0

    # -- fault hooks ---------------------------------------------------------

    def _fault_gate(self, site: str, dt: float):
        """Poll the fault plan at one hook, ``dt`` charged through the
        energy-weighted clock; kill-class events raise."""
        ev = self.faults.poll(site, dt=dt * self._energy_scale)
        if ev is None:
            return None
        if ev.kind == SLOW_DISPATCH:
            self.stats["slow_dispatches"] += 1
            if self.slow_dispatch_s > 0:
                time.sleep(self.slow_dispatch_s)
            return ev
        if ev.kind in (POWER_LOSS, DEVICE_DROP):
            self.stats["wasted_steps"] += ev.offset
            FaultPlan.raise_for(ev)
        return ev

    # -- device side: synchronous, recoverable dispatch ----------------------

    def _execute(self, buckets: list[Bucket]) -> None:
        for bucket in buckets:
            self._run_bucket(bucket)

    def _run_bucket(self, bucket: Bucket) -> None:
        now = self.clock()
        live = []
        for req in bucket.requests:
            if (self.deadline_s is not None
                    and now - req.t_submit > self.deadline_s):
                self._dead_letter(req, "deadline")
            else:
                live.append(req)
        if len(live) != len(bucket.requests):
            if self.ckpt is not None:
                self.ckpt.purge(self._bucket_tag(bucket))
            if not live:
                return
            bucket = Bucket(bucket.key, live, bucket.t_closed)
        try:
            self._dispatch_bucket(bucket)
        except (PowerLoss, DeviceDrop) as f:
            self.stats["faults"] += 1
            self.stats["power_losses" if isinstance(f, PowerLoss)
                       else "device_drops"] += 1
            if self.policy is not None:
                self.policy.record_fault()
            self._requeue(bucket)
            self._maybe_degrade()

    def _dispatch_bucket(self, bucket: Bucket) -> None:
        padded = self._pad_to(len(bucket.requests))
        t_start = self.clock()
        dev = self._stage_checked(bucket, padded)
        if getattr(self.runner, "supports_epochs", False):
            host = self._run_epochs(bucket, padded, dev)
        else:
            self._fault_gate("dispatch", dt=1.0)
            # the answer goes back to its requests: this wait is the harvest
            host = self.runner.forward(dev, bucket.key).cpu().numpy()  # repro-lint: disable=RL002
            self.stats["executed_steps"] += 1
            self.stats["useful_steps"] += 1
        self._record_results(bucket, padded, host, t_start)

    def _stage_checked(self, bucket: Bucket, padded: int) -> torch.Tensor:
        """Collate + host->device with corruption detection: a
        ``staging_corruption`` event flips a byte of the staged copy; the
        checksum taken at collate time catches it and the intact host
        payloads are restaged."""
        payloads = [r.payload for r in bucket.requests]
        batch = self.runner.collate(payloads, padded)
        checksum = hashlib.sha1(np.ascontiguousarray(batch)).hexdigest()
        ev = self.faults.poll("staging", dt=STAGING_DT * self._energy_scale)
        if ev is not None:
            if ev.kind == STAGING_CORRUPTION:
                staged = batch.copy()
                flat = staged.reshape(-1).view(np.uint8)
                flat[self._rng.randint(flat.size)] ^= 0xFF
                if hashlib.sha1(np.ascontiguousarray(staged)).hexdigest() \
                        != checksum:
                    self.stats["staging_retries"] += 1
                    staged = self.runner.collate(payloads, padded)
                batch = staged
            else:
                FaultPlan.raise_for(ev)
        return torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)

    # -- epoch decode with checkpoints ---------------------------------------

    def _bucket_tag(self, bucket: Bucket) -> str:
        fp = getattr(self.runner, "plan_fingerprint", lambda: None)()
        return DecodeCheckpointer.tag(
            (r.rid for r in bucket.requests), bucket.key, fp,
            getattr(self.runner, "epoch_steps", 0))

    def _run_epochs(self, bucket: Bucket, padded: int,
                    dev: torch.Tensor) -> np.ndarray:
        r = self.runner
        key = bucket.key
        schedule = r.epoch_schedule(key)
        tag = self._bucket_tag(bucket) if self.ckpt is not None else None
        start_epoch, state = 0, None
        if tag is not None:
            restored = self.ckpt.restore(
                tag, lambda emitted: r.decode_state_template(key, padded,
                                                             emitted),
                device=r.device)
            if restored is not None:
                start_epoch, s = restored
                state = (s["cache"], s["tok"], s["pos"], s["toks"])
                self.stats["resumes"] += 1
        if state is None:
            self._fault_gate("prefill", dt=PREFILL_DT)
            cache, tok, pos = r.prefill(key, dev)
            state = (cache, tok, pos, tok)
            self.stats["prefills"] += 1
            if tag is not None:
                self._commit(tag, 0, state)
        for e in range(start_epoch, len(schedule)):
            steps = schedule[e]
            self._fault_gate("decode", dt=float(steps))
            cache, tok, pos, toks = state
            cache, tok, pos, chunk = r.epoch(key, cache, tok, pos, steps)
            state = (cache, tok, pos, torch.cat([toks, chunk], dim=1))
            self.stats["executed_steps"] += steps
            self.stats["epochs"] += 1
            if tag is not None:
                self._commit(tag, e + 1, state)
        host = state[3].cpu().numpy()  # repro-lint: disable=RL002 — the tokens' harvest
        self.stats["useful_steps"] += sum(schedule)
        if tag is not None:
            self.ckpt.purge(tag)
        return host

    def _commit(self, tag: str, epoch: int, state) -> None:
        cache, tok, pos, toks = state
        self.stats["commit_s"] += self.ckpt.commit(
            tag, epoch, dict(cache=cache, tok=tok, pos=pos, toks=toks),
            emitted=int(toks.shape[1]))
        self.stats["commit_bytes"] += self.ckpt.last_bytes
        self.stats["commits"] += 1

    # -- harvest -------------------------------------------------------------

    def _record_results(self, bucket: Bucket, padded: int, host: np.ndarray,
                        t_start: float) -> None:
        from repro_torch.core.plan import plan_energy_pj

        n = len(bucket.requests)
        t_done = self.clock()
        for i, req in enumerate(bucket.requests):
            self._results[req.rid] = Result(req.rid, host[i], req.t_submit,
                                            t_done, n, padded, t_start)
            self._attempts.pop(req.rid, None)
            self.result_runner[req.rid] = self._active
        self.stats["dispatches"] += 1
        self.stats["requests"] += n
        self.stats["padded_rows"] += padded - n
        plan = self._runner_plan(self.runner)
        energy = 0.0
        if plan is not None:
            energy = plan_energy_pj(plan) * padded
            self.stats["energy_pj"] += energy
        if self.policy is not None:
            self.policy.record_dispatch(energy)
            self._maybe_degrade()
            self._maybe_recover()
