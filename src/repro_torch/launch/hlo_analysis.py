"""Step analysis: collective bytes, flop and byte counts, roofline terms
(port of ``repro/launch/hlo_analysis.py``).

Two sources of counts:

* :func:`collective_stats` parses an optimized XLA HLO module's text, as
  the reference does (a plain text parser, kept so HLO dumps can still be
  read): a first pass sizes every instruction's result, a second sums the
  operand bytes of every collective.
* :class:`StepCounter` counts a PyTorch step as it runs (on meta tensors,
  DTensors on a fake mesh, or real tensors on a device): per-device
  flops (the counterpart of XLA's ``cost_analysis()["flops"]``), an
  unfused byte count and the collectives (the counterpart of
  :func:`collective_stats`, the same dict keys).  :func:`step_flops` and
  :func:`comm_stats` run one call under it.

:class:`Roofline` turns the per-device counts into three times at the
H100's peaks; :func:`model_flops_estimate` is the brief's 6·N·D / 2·N·D
over the active params (:func:`active_param_count`), and
:func:`recurrence_flops_correction` the reference's analytic count of
the RWKV recurrence.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "s4": 1, "u4": 1, "token": 0,
}

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_DEF_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(\([^)]*\)|\S+)\s+([\w\-]+)")


def _shape_bytes(type_str: str) -> int:
    """bytes of 'bf16[256,4096]' or a tuple '(f32[8], bf16[4,4])'."""
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_stats(hlo_text: str) -> dict[str, Any]:
    """Sum operand bytes of every collective in optimized HLO text."""
    sizes: dict[str, int] = {}
    per_kind: dict[str, int] = {k: 0 for k in COLLECTIVES}
    counts: dict[str, int] = {k: 0 for k in COLLECTIVES}
    lines = hlo_text.splitlines()
    for ln in lines:
        m = _DEF_RE.match(ln)
        if m:
            sizes[m.group(1)] = _shape_bytes(m.group(2))
    opnd_re = re.compile(r"%([\w\.\-]+)")
    for ln in lines:
        m = _DEF_RE.match(ln)
        if not m:
            continue
        op = m.group(3)
        kind = next((k for k in COLLECTIVES if op == k or op.startswith(k + ".")
                     or op.startswith(k + "-start")), None)
        if kind is None:
            continue
        # operands are inside the parens following the op name
        paren = ln[ln.index(op) + len(op):]
        args = paren[paren.find("(") + 1: _match_paren(paren)]
        total = 0
        for a in opnd_re.finditer(args):
            total += sizes.get(a.group(1), 0)
        if total == 0:  # fallback: use the result size
            total = sizes.get(m.group(1), 0)
        per_kind[kind] += total
        counts[kind] += 1
    return dict(bytes_by_kind=per_kind, counts=counts,
                total_bytes=sum(per_kind.values()))


def _match_paren(s: str) -> int:
    depth = 0
    for i, c in enumerate(s):
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                return i
    return len(s)


# ---------------------------------------------------------------------------
# Counting a PyTorch step
# ---------------------------------------------------------------------------

# torch's functional collectives (what DTensor issues) -> the HLO kinds
_C10D_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# ops that move no bytes: they allocate, or alias their input
_NO_BYTES = frozenset(("empty", "empty_strided", "empty_like", "detach",
                       "lift_fresh", "_to_copy_meta"))


def _register_int_mm() -> None:
    """``torch._int_mm`` (the LM's int8 serve GEMM) has no flop formula in
    torch: count it as ``mm``'s 2·M·N·K (once a process)."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    aten = torch.ops.aten
    if aten._int_mm not in flop_registry:
        register_flop_formula(aten._int_mm, get_raw=True)(
            flop_registry[aten.mm])


def tree_tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tree_tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in tree_tensors(x)]
    return []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_tensors(tree))


class StepCounter(TorchDispatchMode):
    """A context that counts the step run inside it, per device.

    ``flops``: torch's flop formulas (``torch.utils.flop_counter``: the
    matrix products, convolutions and attention ops; ``torch._int_mm``
    added as ``mm``) over the ops this rank runs.  Only local ops count:
    on a DTensor the mode passes the DTensor-level op on to DTensor and
    counts the ops it runs on the local shards, and it skips the ops
    DTensor runs on fake tensors to propagate shapes (counted too,
    ``FlopCounterMode`` reads each DTensor product about twice).  A port
    kernel's wrapper counts its call by the work of its plain version
    (``kernels._lib.counted``), whether the kernel or the plain version
    runs, and hides the ops inside it, so a step counts the same on the
    card (where the kernels run through ctypes, unseen by any mode) as on
    meta.  Elementwise ops count 0 flops (XLA counts them: its totals
    are the larger), and a Python loop counts every trip (XLA counts a
    loop body once).

    ``bytes_accessed``: the operand and result bytes of every op that is
    not a view or an allocation, as if each op read its inputs from and
    wrote its outputs to memory: an unfused upper count, where XLA's
    counts its fused program.

    ``comm_stats()``: per collective kind, counts (from
    ``CommDebugMode``) and operand bytes (the inputs of the functional
    collectives DTensor issues), in :func:`collective_stats`' keys.

    ``kernel_flops``: the flops each port kernel's wrapper counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.kernel_flops: dict[str, float] = {}
        self.kernel_calls: dict[str, int] = {}
        self._coll_bytes = {k: 0 for k in COLLECTIVES}
        self._hidden = 0
        self._comm = None

    def __enter__(self):
        from torch.distributed.tensor.debug import CommDebugMode

        from repro_torch.kernels import _lib

        _register_int_mm()
        if _lib.COUNTER[0] is not None:
            raise RuntimeError("StepCounter: a step counter is already active")
        self._comm = CommDebugMode()
        self._comm.__enter__()
        _lib.COUNTER[0] = self
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import _lib

        try:
            return super().__exit__(*exc)
        finally:
            _lib.COUNTER[0] = None
            self._comm.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional":
            kind = _C10D_KINDS.get(packet.__name__)
            if kind is not None:
                self._coll_bytes[kind] += _nbytes((args, kwargs))
            return out
        if self._hidden:
            return out
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        if not func.is_view and packet.__name__ not in _NO_BYTES:
            self.bytes_accessed += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    # -- kernels._lib.counted's side ---------------------------------------
    def kernel(self, name: str, flops: float, args):
        """Around one kernel wrapper call: count its work and its inputs'
        bytes, hide the ops inside."""
        @contextlib.contextmanager
        def hidden():
            self.flops += flops
            self.kernel_flops[name] = self.kernel_flops.get(name, 0.0) + flops
            self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
            self.bytes_accessed += sum(local_nbytes(t)
                                       for t in tree_tensors(args))
            self._hidden += 1
            try:
                yield
            finally:
                self._hidden -= 1
        return hidden()

    def kernel_output(self, out) -> None:
        self.bytes_accessed += sum(local_nbytes(t) for t in tree_tensors(out))

    def comm_stats(self) -> dict[str, Any]:
        """``{bytes_by_kind, counts, total_bytes}`` of the collectives the
        step issued (per device; counts from ``CommDebugMode``)."""
        counts = {k: 0 for k in COLLECTIVES}
        for op, n in self._comm.get_comm_counts().items():
            kind = _C10D_KINDS.get(getattr(op, "__name__", str(op)))
            if kind is not None:
                counts[kind] += n
        return dict(bytes_by_kind=dict(self._coll_bytes), counts=counts,
                    total_bytes=sum(self._coll_bytes.values()))


def local_nbytes(t) -> int:
    """Bytes of this rank's part of ``t`` (a DTensor's local shard)."""
    t = getattr(t, "_local_tensor", t)
    return t.numel() * t.element_size()


def step_flops(fn, *args, **kwargs) -> float:
    """Per-device flops of one ``fn(*args, **kwargs)`` (:class:`StepCounter`)."""
    with StepCounter() as c:
        fn(*args, **kwargs)
    return c.flops


def comm_stats(fn, *args, **kwargs) -> dict[str, Any]:
    """The collectives of one ``fn(*args, **kwargs)``, per device, in
    :func:`collective_stats`' keys (:class:`StepCounter`)."""
    with StepCounter() as c:
        fn(*args, **kwargs)
    return c.comm_stats()


# ---------------------------------------------------------------------------
# Roofline (NVIDIA H100 SXM5 data sheet: dense rates, 700 W)
# ---------------------------------------------------------------------------

PEAK_FLOPS_BF16 = 989e12     # per card
PEAK_FLOPS_INT8 = 1979e12    # per card (int8 tensor-core ops)
HBM_BW = 3.35e12             # bytes/s per card (HBM3)
# NVLink 4, bytes/s a direction per card.  A 16 x 16 mesh spans 32 nodes
# of 8 cards, where the links between nodes are slower: across nodes this
# is a lower bound on the collective time.
NVLINK_BW = 450e9


@dataclasses.dataclass
class Roofline:
    """Three-term roofline of a step from its per-device counts.

    The counts are per device, as XLA's ``cost_analysis()`` reports them
    for an SPMD program (true flops, 2·M·N·K for a product, and the
    operand bytes of the collectives): per-device values are already
    divided by the chips, so
        compute_s    = flops_dev / peak      (== flops_global / (chips*peak))
        memory_s     = bytes_dev / hbm_bw
        collective_s = coll_bytes_dev / nvlink_bw
    MODEL_FLOPS stays global (6*N*D) and is divided by chips when compared.
    """

    hlo_flops: float          # per device
    hlo_bytes: float          # per device
    collective_bytes: float   # per device
    chips: int
    model_flops: float = 0.0  # global (6*N*D / 2*N*D)

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = dict(compute=self.compute_s, memory=self.memory_s,
                     collective=self.collective_s)
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / counted flops (remat/redundancy waste indicator)."""
        if not self.hlo_flops:
            return 0.0
        return (self.model_flops / self.chips) / self.hlo_flops

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_frac(self) -> float:
        """Fraction of the step's lower bound spent on *useful* model math."""
        if self.bound_s == 0:
            return 0.0
        useful_s = (self.model_flops / self.chips) / PEAK_FLOPS_BF16
        return useful_s / self.bound_s

    def to_dict(self) -> dict[str, Any]:
        return dict(
            hlo_flops=self.hlo_flops, hlo_bytes=self.hlo_bytes,
            collective_bytes=self.collective_bytes, chips=self.chips,
            model_flops=self.model_flops,
            compute_s=self.compute_s, memory_s=self.memory_s,
            collective_s=self.collective_s, dominant=self.dominant,
            useful_flops_frac=self.useful_flops_frac,
            roofline_frac=self.roofline_frac,
        )


def active_param_count(cfg) -> float:
    """Matmul-bearing (active) params: embeddings excluded, unembed included,
    MoE counting only top-k + shared experts (brief: N_active)."""
    d = cfg.d_model
    hd = cfg.hd
    n = 0.0
    for kind in cfg.blocks_pattern:
        if kind in ("attn", "moe", "attn_local"):
            n += d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
            if kind == "moe":
                active = cfg.top_k + cfg.n_shared_experts
                n_mats = 3 if cfg.act == "swiglu" else 2
                n += active * n_mats * d * cfg.expert_d_ff + d * cfg.n_experts
            else:
                n += (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
        elif kind == "rec":
            W = cfg.lru_width or d
            n += 2 * d * W + 2 * W * W + W * d
            n += (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
        elif kind == "rwkv":
            n += 5 * d * d + 2 * d * cfg.d_ff + d * d
    n += d * cfg.padded_vocab  # unembed
    return n


def model_flops_estimate(cfg, cell) -> float:
    """Brief's convention: MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference),
    with N = active matmul params and D = processed tokens this step."""
    n_active = active_param_count(cfg)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    if cfg.n_patches and cell.kind != "decode":
        tokens += cell.global_batch * cfg.n_patches
    mult = 6 if cell.kind == "train" else 2
    return mult * n_active * tokens


def recurrence_flops_correction(cfg, cell) -> float:
    """The reference's analytic GLOBAL flops of the RWKV wkv recurrence,
    which XLA's cost model counts once (a loop body is not multiplied by
    its trip count): 6·tokens·H·K·V a layer forward, three times that in
    training.  RG-LRU needs none (its analysis form is the associative
    scan, counted whole)."""
    if cfg.family != "rwkv":
        return 0.0
    d = cfg.d_model
    H = d // cfg.rwkv_head_dim
    K = V = cfg.rwkv_head_dim
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    fwd = 6.0 * tokens * H * K * V * cfg.n_layers
    return fwd * (3.0 if cell.kind == "train" else 1.0)


def recurrence_flops_uncounted(cfg, cell) -> float:
    """The part of :func:`recurrence_flops_correction` that
    :class:`StepCounter` does not see, GLOBAL: everything but the state
    read-out ``einsum("bhk,bhkv->bhv")``, a batched product counted at
    2·H·K·V a token and layer (and, in training, its two backward
    products, 2·H·K·V each).  What stays is elementwise (the ``k ⊗ v``
    outer product, the decay, the bonus term)."""
    if cfg.family != "rwkv":
        return 0.0
    d = cfg.d_model
    H = d // cfg.rwkv_head_dim
    K = V = cfg.rwkv_head_dim
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    counted = 2.0 * tokens * H * K * V * cfg.n_layers
    counted *= 3.0 if cell.kind == "train" else 1.0
    return recurrence_flops_correction(cfg, cell) - counted
