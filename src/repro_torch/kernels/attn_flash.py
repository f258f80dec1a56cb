"""Quantized flash attention and paged attention (port of
``repro/kernels/attn_flash.py``).

Both compute attention whose score dot runs on affine-quantized integer
levels of q and k: with centred levels ``qc = lv_q - z_q``, ``kc = lv_k -
z_k`` the product ``qc . kc`` *is* the reference's rowsum-corrected
integer (``attn_flash.py:156-160``), and the logits are that integer times
``s_q s_k / sqrt(hd)``.  Softmax and P @ V stay float32.

* :func:`attn_flash` — contiguous prefill attention (KV already expanded
  for GQA), per-tensor scales.  CUDA kernel ``csrc/attn_flash.cu``
  (replaces ``attn_flash_pallas``); plain version :func:`attn_flash_plain`
  (the port of ``attn_flash_xla``).
* :func:`attn_paged` — attention through a page table over shared KV
  pools, per-slot scales, GQA head map.  CUDA kernel
  ``csrc/attn_paged.cu`` (replaces ``attn_paged_pallas``); plain version
  :func:`attn_paged_plain` (the port of ``attn_paged_xla``, which the
  reference names as its Pallas kernel's oracle).

Each dispatch entry launches its kernel for CUDA tensors, runs the plain
version for CPU tensors, and runs the plain version on any device when the
caller passes ``reference=True`` (an explicit request for the oracle, never
a fallback).  The reference computes the per-tensor and per-slot scales
and the q levels outside its ``pallas_call``; here the kernels compute
them on the card (``attn_flash`` in three launches, ``attn_paged`` in
two), with the plain version's arithmetic step by step, so the levels are
the same and no PyTorch op runs beside a launch.  The wrappers allocate
the outputs and scratch with ``torch.empty`` and do nothing else on the
device: they take contiguous, 16-byte aligned tensors and int32 index
tensors as they are, and raise on any other (never a silent copy).  The
launch plans, scratch and shared-memory layouts live in the ``.cu``
sources, which export their sizes.

Rows of the paged path whose query position is -1 (chunk padding, idle
decode slots) see every key masked.  ``attn_paged_xla`` softmaxes such a
row over all-``NEG_INF`` logits and returns the mean of the gathered V;
the Pallas body multiplies by the mask and returns 0.  The plain version
and the CUDA kernel here both give the XLA value (the kernel does not
multiply by the mask: a masked logit's weight ``exp(NEG_INF - m)`` is
exactly 0 once a row has any valid key), so the padding rows' hidden
states, which enter the next layer's per-slot ``s_q``, agree between the
kernel and its oracle.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _lib

FLASH = "attn_flash"
PAGED = "attn_paged"
NEG_INF = -1e30

# head dims csrc/attn_flash.cu is instantiated for (hubert-xlarge's 80,
# phi3-mini's 96, recurrentgemma's 256 besides the powers of two)
KERNEL_HEAD_DIMS = (32, 64, 80, 96, 128, 256)
# head dims csrc/attn_paged.cu is instantiated for: 256 is left to
# ops.paged_attn_bounds, whose float32 worst case refuses it (a 16-row
# block's two staged K and V tiles alone are 256 KB)
PAGED_HEAD_DIMS = (32, 64, 96, 128)
# shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT = 232448
# key slots of one staged csrc/attn_paged.cu tile (its KT)
PAGED_KT = 64
# query rows one attn_paged block aims at once a step has several rows
# (its BLOCK_ROWS)
PAGED_BLOCK_ROWS = 16


# ---------------------------------------------------------------------------
# Quantization helpers (per-tensor affine, the dense path's level scheme)
# ---------------------------------------------------------------------------

def attn_quant_scale(x: torch.Tensor, bits: int):
    """Per-tensor ``(scale, zero_point)``: ``z = 2^(bits-1)``, ``s =
    max|x| / z + 1e-12`` as a 0-d float32 tensor on ``x``'s device."""
    z = float(1 << (bits - 1))
    return torch.max(torch.abs(x)).float() / z + 1e-12, z


def _levels(x: torch.Tensor, s, bits: int) -> torch.Tensor:
    """``clip(round(x / s) + z, 0, 2^bits - 1)`` in float32."""
    z = float(1 << (bits - 1))
    n = float((1 << bits) - 1)
    return torch.clamp(torch.round(x.float() / s) + z, 0.0, n)


def flash_levels_exact(head_dim: int, q_bits: int, k_bits: int) -> bool:
    """The centred-level score dot is exact in float32 (the plain versions'
    float matmul) while ``2^(q_bits-1) 2^(k_bits-1) head_dim < 2^24``; the
    kernels' int32 accumulator is exact far beyond that."""
    return (1 << (q_bits - 1)) * (1 << (k_bits - 1)) * head_dim < (1 << 24)


def flash_error_bound(q: torch.Tensor, k: torch.Tensor, q_bits: int,
                      k_bits: int) -> float:
    """Worst-case absolute logit error against unquantized attention (a
    host-side helper for test tolerances: it reads two maxima)."""
    hd = q.shape[-1]
    qm = float(torch.max(torch.abs(q)))
    km = float(torch.max(torch.abs(k)))
    s_q = qm / (1 << (q_bits - 1)) + 1e-12
    s_k = km / (1 << (k_bits - 1)) + 1e-12
    return hd * (s_q * km + s_k * qm + s_q * s_k / 2) / (2 * math.sqrt(hd))


def _paged_slot_scales(q, pool_k, ppos, table, bits: int):
    """Per-slot ``(s_q, s_k)``, each (B,) float32: ``s_q[b]`` from slot b's
    query rows (padding rows included), ``s_k[b]`` from slot b's gathered
    K where ``ppos >= 0``, so stale pages cannot move a live slot's
    scale."""
    z = float(1 << (bits - 1))
    s_q = torch.amax(torch.abs(q).float(), dim=(1, 2, 3)) / z + 1e-12
    kg = torch.abs(pool_k[table]).float()            # (B, P, ps, Hkv, hd)
    valid = (ppos[table] >= 0)[..., None, None]
    s_k = torch.amax(torch.where(valid, kg, 0.0), dim=(1, 2, 3, 4)) / z + 1e-12
    return s_q, s_k


def _paged_expand_idx(n_q_real: int, n_q_padded: int, hkv: int,
                      device=None) -> torch.Tensor:
    """GQA head map: query head j reads KV head ``min(j // g, hkv - 1)``."""
    g = max(n_q_real // hkv, 1)
    return torch.clamp(torch.arange(n_q_padded, device=device) // g,
                       max=hkv - 1)


def _check_exact(hd: int, q_bits: int, k_bits: int, what: str) -> None:
    if not flash_levels_exact(hd, q_bits, k_bits):
        raise ValueError(f"{what} centred-level dot inexact at head_dim={hd}, "
                         f"q_bits={q_bits}, k_bits={k_bits}")


# ---------------------------------------------------------------------------
# Flash attention: plain version
# ---------------------------------------------------------------------------

def attn_flash_plain(q, k, v, *, causal: bool = True,
                     window: Optional[int] = None, q_bits: int = 8,
                     k_bits: int = 8, block_q: int = 512,
                     block_kv: int = 512) -> torch.Tensor:
    """Plain PyTorch version (the port of ``attn_flash_xla``): blocks of
    ``block_q`` query rows, each sweeping only the kv blocks its causal
    and window bounds reach, with the online softmax carried over them.

    q (B,Sq,H,hd); k,v (B,Skv,H,hd), KV expanded for GQA; positions are
    contiguous 0..S-1.  -> (B,Sq,H,hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    _check_exact(hd, q_bits, k_bits, "flash")
    s_q, z_q = attn_quant_scale(q, q_bits)
    s_k, z_k = attn_quant_scale(k, k_bits)
    qc = (_levels(q, s_q, q_bits) - z_q).permute(0, 2, 1, 3)
    kc = (_levels(k, s_k, k_bits) - z_k).permute(0, 2, 1, 3)
    vt = v.float().permute(0, 2, 1, 3)
    scale = s_q * s_k / math.sqrt(hd)
    bq, bk = min(block_q, Sq), min(block_kv, Skv)
    nk = -(-Skv // bk)
    out = torch.empty((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    for i in range(-(-Sq // bq)):
        q0, q1 = i * bq, min((i + 1) * bq, Sq)
        jhi = min(((i + 1) * bq - 1) // bk, nk - 1) if causal else nk - 1
        jlo = max((i * bq - (window - 1)) // bk, 0) if window else 0
        iq = torch.arange(q0, q1, device=q.device)
        m_run = torch.full((B, H, q1 - q0), NEG_INF, device=q.device)
        l_run = torch.zeros((B, H, q1 - q0), device=q.device)
        acc = torch.zeros((B, H, q1 - q0, hd), device=q.device)
        for j in range(jlo, jhi + 1):
            k0, k1 = j * bk, min((j + 1) * bk, Skv)
            s = torch.matmul(qc[:, :, q0:q1], kc[:, :, k0:k1].transpose(-1, -2))
            s = s * scale
            jk = torch.arange(k0, k1, device=q.device)
            msk = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                             device=q.device)
            if causal:
                msk &= jk[None, :] <= iq[:, None]
            if window:
                msk &= jk[None, :] > iq[:, None] - window
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None]) * msk
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(p, vt[:, :, k0:k1])
            m_run = m_new
        out[:, :, q0:q1] = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


# ---------------------------------------------------------------------------
# Flash attention: the kernel's wrapper
# ---------------------------------------------------------------------------

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_flash(q, k, v, q_bits, k_bits) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"attn_flash: needs q (B,Sq,H,hd), k and v "
                         f"(B,Skv,H,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2],
                                                k.shape[3]):
        raise ValueError("attn_flash: q and k differ in batch, heads or "
                         "head_dim (expand KV for GQA first)")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attn_flash: q, k, v must share float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[3] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attn_flash: head_dim {q.shape[3]} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if not (1 <= q_bits <= 8 and 1 <= k_bits <= 8):
        raise ValueError(f"attn_flash: bits must be 1..8, got {q_bits}, "
                         f"{k_bits}")


def _inv_sqrt(hd: int) -> float:
    """``1 / sqrt(hd)`` as PyTorch's CUDA division by a Python scalar forms
    it: the float32 reciprocal of the float32 square root."""
    return ctypes.c_float(1.0 / ctypes.c_float(math.sqrt(hd)).value).value


def _kernel_input(x: torch.Tensor, what: str, index: bool = False) -> int:
    """The device address of ``x`` as a kernel reads it: contiguous, and
    16-byte aligned (the kernels load 16 bytes at a time) or, for an index
    tensor, int32.  Raises rather than copy, so a call stays its
    kernels."""
    if index and x.dtype != torch.int32:
        raise TypeError(f"{what} must be int32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous (stride {x.stride()})")
    if not index and x.data_ptr() % 16:
        raise ValueError(f"{what} must start at a 16-byte aligned address")
    return x.data_ptr()


def _flash_cuda(q, k, v, causal, window, q_bits, k_bits) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    ptrs = [_kernel_input(x, f"attn_flash: {n}")
            for x, n in ((q, "q"), (k, "k"), (v, "v"))]
    ll = ctypes.c_longlong
    nbytes = _lib.launcher(FLASH, [ll], "scratch_bytes", ll)(k.numel())
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = _lib.launcher(FLASH, [p] * 5 + [i] * 9 + [ctypes.c_float, i, p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(*ptrs, out.data_ptr(), scratch.data_ptr(), B, Sq, Skv,
                     H, hd, int(causal), window or 0, q_bits, k_bits,
                     _inv_sqrt(hd), _KERNEL_DTYPES[q.dtype], stream)
    _lib.check_launch(FLASH, err)
    _lib.LAUNCHES[FLASH] += 1
    return out


def attn_flash(q, k, v, *, causal: bool = True, window: Optional[int] = None,
               q_bits: int = 8, k_bits: int = 8,
               reference: bool = False) -> torch.Tensor:
    """Quantized flash attention (the ``flash`` engine entry).  Shapes as
    :func:`attn_flash_plain`; a CUDA tensor launches ``csrc/attn_flash.cu``
    or raises."""
    if reference or q.device.type == "cpu":
        return attn_flash_plain(q, k, v, causal=causal, window=window,
                                q_bits=q_bits, k_bits=k_bits)
    if q.device.type != "cuda":
        raise ValueError(f"attn_flash: unsupported device {q.device}")
    _check_flash(q, k, v, q_bits, k_bits)
    _check_exact(q.shape[3], q_bits, k_bits, "flash")
    return _flash_cuda(q, k, v, causal, window, q_bits, k_bits)


# ---------------------------------------------------------------------------
# Paged attention: plain version
# ---------------------------------------------------------------------------

def attn_paged_plain(q, pool_k, pool_v, ppos, table, q_pos, *,
                     causal: bool = True, window: Optional[int] = None,
                     quantized: bool = False, bits: int = 8,
                     n_q_heads: Optional[int] = None) -> torch.Tensor:
    """Gather realization (the port of ``attn_paged_xla``).

    q (B,S,Hp,hd); pool_k/pool_v (NP+1,ps,Hkv,hd); ppos (NP+1,ps) int32;
    table (B,P) int32 page indices; q_pos (B,S) int32, -1 marking padding
    rows.  Logits are materialized at (B,Hp,S,P*ps).  -> q's dtype."""
    B, S, Hp, hd = q.shape
    _, ps, Hkv, _ = pool_k.shape
    P = table.shape[1]
    n_q = n_q_heads or Hp
    table = table.long()
    kg = pool_k[table].reshape(B, P * ps, Hkv, hd)
    vg = pool_v[table].reshape(B, P * ps, Hkv, hd)
    pos_g = ppos[table].reshape(B, P * ps)
    if quantized:
        _check_exact(hd, bits, bits, "paged")
        z = float(1 << (bits - 1))
        s_q, s_k = _paged_slot_scales(q, pool_k, ppos, table, bits)
        qc = _levels(q, s_q[:, None, None, None], bits) - z
        kc = _levels(kg, s_k[:, None, None, None], bits) - z
    else:
        qc, kc = q.float(), kg.float()
    if Hkv != Hp:
        idx = _paged_expand_idx(n_q, Hp, Hkv, q.device)
        kc = kc.index_select(2, idx)
        vg = vg.index_select(2, idx)
    logits = torch.einsum("bqhd,bshd->bhqs", qc, kc)
    if quantized:
        logits = logits * (s_q * s_k / math.sqrt(hd))[:, None, None, None]
    else:
        logits = logits / math.sqrt(hd)
    m = (pos_g >= 0)[:, None, None, :]
    if causal:
        m = m & (pos_g[:, None, None, :] <= q_pos[:, None, :, None])
    if window is not None:
        m = m & (pos_g[:, None, None, :] > q_pos[:, None, :, None] - window)
    logits = torch.where(m, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", p, vg.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Paged attention: the kernel's wrapper
# ---------------------------------------------------------------------------

def paged_group_heads(hp: int, hkv: int, n_q_heads: int) -> int:
    """The most query heads one KV head serves under the GQA head map (the
    last KV head also takes any padded query heads)."""
    g = max(n_q_heads // hkv, 1)
    return max(min(g, hp), hp - (hkv - 1) * g)


def paged_heads_per_block(nh: int, s: int) -> int:
    """Query heads one ``csrc/attn_paged.cu`` block serves: all ``nh`` of
    its KV head while their ``s`` rows each fit :data:`PAGED_BLOCK_ROWS`
    (a decode step: the heads share every page load), else as many as do,
    at least one (a prefill chunk: more blocks, fewer rows a warp)."""
    return max(1, min(nh, PAGED_BLOCK_ROWS // s))


@functools.lru_cache(maxsize=None)
def paged_plan(b: int, s: int, hp: int, hkv: int, hd: int, p: int,
               n_q: int, dtype: torch.dtype) -> tuple[int, tuple]:
    """``(scratch bytes, (query heads a block, head groups a KV head,
    pages a split, splits, shared memory bytes a block))``: the launch plan
    ``csrc/attn_paged.cu`` makes for this shape (``attn_paged_plan``;
    needs the built kernel)."""
    plan = (ctypes.c_int * 5)()
    i = ctypes.c_int
    fn = _lib.launcher(PAGED, [i] * 8 + [ctypes.POINTER(ctypes.c_int)],
                       "plan", ctypes.c_longlong)
    nbytes = fn(b, s, hp, hkv, hd, p, n_q, _KERNEL_DTYPES[dtype], plan)
    return nbytes, tuple(plan)


def paged_smem_bytes(rows: int, head_dim: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of one ``csrc/attn_paged.cu`` attention block
    serving ``rows`` = (its query heads) x S query rows, for
    pools of ``itemsize`` bytes an element: two staged tiles of
    :data:`PAGED_KT` key slots (raw K, V and positions), the current
    tile's K levels and the rows' q levels (rows padded by 16 bytes), the
    rows' accumulators and (m, l).  The layout is the kernel's
    ``smem_bytes``; this copy bounds feasibility where the kernel is not
    built (``ops.paged_attn_bounds``), and the card's tests hold it equal
    to :func:`paged_plan`'s."""
    pitch = head_dim + 16
    return (4 * PAGED_KT * head_dim * itemsize   # K and V tiles, two each
            + 2 * PAGED_KT * 4                   # their positions
            + PAGED_KT * pitch                   # the tile's K levels
            + rows * pitch                       # q levels
            + 4 * rows * head_dim                # accumulators
            + 8 * rows)                          # m, l


def _check_paged(q, pool_k, pool_v, ppos, table, q_pos, bits, n_q) -> None:
    B, S, Hp, hd = q.shape
    if pool_k.ndim != 4 or pool_v.shape != pool_k.shape:
        raise ValueError(f"attn_paged: pools must be (NP+1,ps,Hkv,hd), got "
                         f"{tuple(pool_k.shape)}, {tuple(pool_v.shape)}")
    if pool_k.shape[3] != hd or ppos.shape != pool_k.shape[:2]:
        raise ValueError("attn_paged: pool head_dim or ppos shape mismatch")
    if table.shape[0] != B or q_pos.shape != (B, S):
        raise ValueError(f"attn_paged: table {tuple(table.shape)} / q_pos "
                         f"{tuple(q_pos.shape)} do not match q {tuple(q.shape)}")
    if (q.dtype not in _KERNEL_DTYPES or pool_k.dtype != q.dtype
            or pool_v.dtype != q.dtype):
        raise TypeError(f"attn_paged: q and pools must share float32 or "
                        f"bfloat16, got {q.dtype}, {pool_k.dtype}, "
                        f"{pool_v.dtype}")
    if hd not in PAGED_HEAD_DIMS:
        raise ValueError(f"attn_paged: head_dim {hd} not in {PAGED_HEAD_DIMS}")
    if not 1 <= bits <= 8:
        raise ValueError(f"attn_paged: bits must be 1..8, got {bits}")


def _paged_cuda(q, pool_k, pool_v, ppos, table, q_pos, causal, window, bits,
                n_q) -> torch.Tensor:
    B, S, Hp, hd = q.shape
    _, ps, Hkv, _ = pool_k.shape
    P = table.shape[1]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    ptrs = [_kernel_input(x, f"attn_paged: {n}", index=ix) for x, n, ix in (
        (q, "q", False), (pool_k, "pool_k", False), (pool_v, "pool_v", False),
        (ppos, "ppos", True), (table, "table", True), (q_pos, "q_pos", True))]
    nbytes, plan = paged_plan(B, S, Hp, Hkv, hd, P, n_q, q.dtype)
    if plan[4] > SMEM_LIMIT:
        raise ValueError(f"attn_paged: a block needs {plan[4]} B of shared "
                         f"memory (> {SMEM_LIMIT})")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = _lib.launcher(PAGED, [p] * 8 + [i] * 11 + [ctypes.c_float, i, p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(*ptrs, scratch.data_ptr(), out.data_ptr(), B, S, Hp,
                     Hkv, hd, ps, P, n_q, int(causal), window or 0, bits,
                     _inv_sqrt(hd), _KERNEL_DTYPES[q.dtype], stream)
    _lib.check_launch(PAGED, err)
    _lib.LAUNCHES[PAGED] += 1
    return out


def attn_paged(q, pool_k, pool_v, ppos, table, q_pos, *,
               causal: bool = True, window: Optional[int] = None,
               quantized: bool = False, bits: int = 8,
               n_q_heads: Optional[int] = None,
               reference: bool = False) -> torch.Tensor:
    """Paged attention (the ``paged`` engine entry).  A quantized call on
    CUDA tensors launches ``csrc/attn_paged.cu`` or raises; an unquantized
    (fp) call is the gather realization on every device, as in the
    reference, whose Pallas kernel is the integer-levels path only."""
    n_q = n_q_heads or q.shape[2]
    if reference or not quantized or q.device.type == "cpu":
        return attn_paged_plain(q, pool_k, pool_v, ppos, table, q_pos,
                                causal=causal, window=window,
                                quantized=quantized, bits=bits, n_q_heads=n_q)
    if q.device.type != "cuda":
        raise ValueError(f"attn_paged: unsupported device {q.device}")
    _check_paged(q, pool_k, pool_v, ppos, table, q_pos, bits, n_q)
    _check_exact(q.shape[3], bits, bits, "paged")
    return _paged_cuda(q, pool_k, pool_v, ppos, table, q_pos, causal, window,
                       bits, n_q)
