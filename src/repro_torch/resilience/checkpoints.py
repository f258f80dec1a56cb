"""Crash-consistent decode epoch checkpoints (port of
``repro/resilience/checkpoints.py``).

The paper's NV-FA retains partial accumulation state through power loss
so a frame never restarts from scratch (§II-B3).  The serving analogue is
the decode epoch: greedy decode is cut into K-step epochs, and after each
one the bucket's whole decode state — KV cache, last token, position,
every token emitted so far — commits through the atomic
:class:`repro_torch.train.checkpoint.Checkpointer`.  A request killed
mid-decode resumes from its last committed epoch; K plays the role of the
paper's checkpoint period P.

Checkpoints are keyed by a composition tag: a hash of the bucket's
request ids, its shape key, the plan fingerprint and the epoch length.
Only a re-dispatch of the same requests under the same plan resumes one;
anything else hashes to another tag and restarts from prefill.

Restore reads nothing volatile: the state's structure comes from the
model config (``runner.decode_state_template``) and the emitted-token
count in the manifest, and the tensors land on the runner's device.
"""
from __future__ import annotations

import hashlib
import time

from repro_torch.train.checkpoint import Checkpointer


class DecodeCheckpointer:
    """Per-bucket epoch checkpoints over the atomic ``Checkpointer``.

    Writes are synchronous: the commit is the durability point the
    resilience contract counts on, and its measured time is the
    ``nv_write_us`` of the analytic model.
    """

    def __init__(self, directory: str, keep: int = 2):
        self.dir = directory
        self._ck = Checkpointer(directory, keep=keep, async_save=False)

    @staticmethod
    def tag(rids, shape_key, plan_fp, epoch_steps: int) -> str:
        blob = repr((tuple(rids), shape_key, plan_fp,
                     int(epoch_steps))).encode()
        return "dec" + hashlib.sha256(blob).hexdigest()[:16]

    def commit(self, tag: str, epoch: int, state: dict,
               emitted: int) -> float:
        """Durably commit one epoch's state; returns the write seconds
        (device-to-host copy included).

        ``epoch`` counts committed epochs: 0 after prefill, e+1 after
        decode epoch e.  ``emitted`` (tokens per request so far) goes into
        the manifest so restore can rebuild the token buffer's template.
        """
        t0 = time.perf_counter()
        self._ck.save(int(epoch), state, extra=dict(emitted=int(emitted)),
                      tag=tag)
        return time.perf_counter() - t0

    @property
    def last_bytes(self) -> int:
        """Array bytes of the latest commit."""
        return self._ck.last_bytes

    def latest(self, tag: str):
        return self._ck.latest_step(tag)

    def restore(self, tag: str, template_fn, device=None):
        """``(committed_epochs, state)`` for ``tag``, tensors on
        ``device`` (None: each on its template leaf's device, as
        ``train.checkpoint.Checkpointer.restore`` lands them), or None.
        ``template_fn(emitted) -> state`` supplies the structure from the
        model config, not from a live object."""
        step = self._ck.latest_step(tag)
        if step is None:
            return None
        emitted = int(self._ck.manifest(step, tag)["extra"]["emitted"])
        _, state = self._ck.restore(template_fn(emitted), step, tag,
                                    device=device)
        return step, state

    def purge(self, tag: str) -> int:
        """Drop every epoch of one completed or abandoned bucket."""
        return self._ck.purge(tag)

    def purge_all(self) -> int:
        """Drop everything (after a plan swap every outstanding checkpoint
        names the retired plan)."""
        return self._ck.purge("dec")
