"""The port's CUDA kernels on the card, held against their plain versions.

Every test here is marked ``gpu`` and skips without a CUDA device (decided
inside the fixture, never at import).  Unlike the other
``test_torch_*.py`` files this one does not import JAX: the machine with
the card has no JAX, and these tests compare the kernels with the port's
own plain versions, which the other files hold against the reference.
Run on the card with ``python -m pytest -q -m gpu tests/test_torch_gpu.py``.

Kernel and plain version must agree bit for bit, full epilogue included:
both round ``s*acc`` and ``t*rowsum`` separately in float32.  The
bit-plane kernels' outputs are integers (levels, packed words, int32
accumulators) and agree exactly, and every engine's svhn logits equal the
default engines' bit for bit.  The
attention kernels agree with their plain versions within 1e-5 x max|v| in
float32 (the same integer logits; exp and the sums run in another order),
plus one output rounding in bfloat16.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.core.quant import PAPER_CONFIGS  # noqa: E402
from repro_torch.kernels import _lib, ops  # noqa: E402
from repro_torch.kernels.bitgemm import (bitgemm_packed,  # noqa: E402
                                         bitgemm_packed_plain)
from repro_torch.kernels.bitgemm_mxu import (int8_matmul,  # noqa: E402
                                             int8_matmul_plain)
from repro_torch.kernels.conv_implicit import (conv_implicit,  # noqa: E402
                                               conv_implicit_plain)
from repro_torch.kernels.fused_qgemm import (fused_qgemm,  # noqa: E402
                                             fused_qgemm_plain)
from repro_torch.kernels.quantpack import (quantize_pack,  # noqa: E402
                                           quantize_pack_plain)
from repro_torch.models.cnn import init_cnn, svhn_cnn_spec  # noqa: E402
from repro_torch.kernels import attn_flash as A  # noqa: E402

# (w_bits, a_bits): the paper's W1A1, W1A4, W1A8 and W2A2
BITS = [(1, 1), (1, 4), (1, 8), (2, 2)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    return torch.device("cuda")


def _scales(wb, ab, rs):
    """Pinned (the output IS the accumulator) and a realistic pair."""
    pinned = (np.float32((1 << ab) - 1), np.float32(0.0))
    z_w = np.float32(0.5 if wb == 1 else ((1 << wb) - 1) / 2.0)
    return pinned, (np.float32(rs.uniform(0.01, 0.1)), z_w)


@pytest.mark.gpu
@pytest.mark.parametrize("wb,ab", BITS)
@pytest.mark.parametrize("m,k,n", [(5, 70, 9), (130, 600, 140),
                                   (8, 9216, 96), (800, 256, 512),
                                   (1, 48, 200), (17, 1000, 76),
                                   (8, 9216, 4096)])
def test_fused_kernel_matches_plain(cuda_device, m, k, n, wb, ab):
    """Odd shapes stage through registers (K or N not a multiple of 16),
    M = 1, 8, 17 take the 16-row tile, and (17, 1000, 76), (8, 9216, 96)
    and AlexNet fc5 (8, 9216, 4096) split K over a cluster (4, 8 and 8
    ways)."""
    rs = np.random.RandomState(m + ab)
    a = torch.from_numpy(rs.uniform(-0.2, 1.2, (m, k)).astype(np.float32))
    a_lv = torch.clamp(torch.round(torch.clamp(a, 0, 1) * ((1 << ab) - 1)),
                       0, (1 << ab) - 1).to(torch.uint8)
    w_lv = torch.from_numpy(rs.randint(0, 1 << wb, (k, n)).astype(np.uint8))
    a, a_lv, w_lv = (v.to(cuda_device) for v in (a, a_lv, w_lv))
    for sc in _scales(wb, ab, rs):
        for x, lv in ((a_lv, True), (a, False)):
            got = fused_qgemm(x, w_lv, *sc, a_bits=ab, w_bits=wb,
                              a_is_levels=lv)
            ref = fused_qgemm_plain(x, w_lv, *sc, a_bits=ab, w_bits=wb,
                                    a_is_levels=lv)
            torch.cuda.synchronize()
            assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("wb,ab", BITS)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv_kernel_matches_plain(cuda_device, wb, ab, stride, padding):
    rs = np.random.RandomState(ab * 7 + stride)
    # odd dims and Cin (register staging, one zero-padded 16-byte chunk),
    # Cout past one 64-channel tile, Cin = 24 (two chunks, the second half
    # padding) with Cout = 40, a 5x5 window on Cin = 96, and the 16- and
    # 128-pixel tiles of svhn conv5 and AlexNet conv1 at batch 8
    for b, h, w, cin, cout, k in ((2, 9, 7, 5, 7, 3), (3, 14, 14, 64, 130, 3),
                                  (2, 12, 11, 96, 64, 5),
                                  (2, 11, 13, 24, 40, 3),
                                  (8, 10, 10, 256, 256, 3),
                                  (8, 28, 28, 96, 256, 5)):
        x = torch.from_numpy(rs.randint(0, 1 << ab, (b, h, w, cin)).astype(
            np.uint8)).to(cuda_device)
        wl = torch.from_numpy(rs.randint(0, 1 << wb, (k * k * cin, cout))
                              .astype(np.uint8)).to(cuda_device)
        kw_args = dict(kh=k, kw=k, stride=stride, padding=padding, a_bits=ab,
                       w_bits=wb)
        for sc in _scales(wb, ab, rs):
            got = conv_implicit(x, wl, *sc, **kw_args)
            ref = conv_implicit_plain(x, wl, *sc, **kw_args)
            torch.cuda.synchronize()
            assert torch.equal(got, ref)


@pytest.mark.gpu
def test_wrappers_count_launches_only_for_the_kernel(cuda_device):
    x = torch.zeros((2, 6, 6, 4), dtype=torch.uint8, device=cuda_device)
    w = torch.zeros((36, 8), dtype=torch.uint8, device=cuda_device)
    _lib.reset_launches()
    conv_implicit(x, w, 1.0, 0.0, kh=3, kw=3, a_bits=4, w_bits=1)
    fused_qgemm(x.reshape(-1, 4), w[:4].contiguous(), 1.0, 0.0, a_bits=4,
                w_bits=1, a_is_levels=True)
    conv_implicit_plain(x, w, 1.0, 0.0, kh=3, kw=3, a_bits=4, w_bits=1)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES == {"fused_qgemm": 1, "conv_implicit": 1,
                             "attn_flash": 0, "attn_paged": 0,
                             "quantize_pack": 0, "bitgemm_packed": 0,
                             "int8_matmul": 0, "norm_act": 0, "dwconv": 0}


@pytest.mark.gpu
def test_cnn_kernels_one_device_op_per_call(cuda_device):
    """Each call of the two CNN kernels is one launch and nothing beside
    it: fused_qgemm's split-K combines in the same launch (a cluster)."""
    x = torch.randint(0, 256, (8, 10, 10, 256), dtype=torch.uint8,
                      device=cuda_device)
    wc = torch.randint(0, 2, (9 * 256, 256), dtype=torch.uint8,
                       device=cuda_device)
    a = torch.randint(0, 256, (8, 9216), dtype=torch.uint8,
                      device=cuda_device)
    wf = torch.randint(0, 2, (9216, 4096), dtype=torch.uint8,
                       device=cuda_device)
    assert _lib.count_device_ops(lambda: conv_implicit(
        x, wc, 0.04, 0.5, kh=3, kw=3, a_bits=8, w_bits=1)) == 1
    assert _lib.count_device_ops(lambda: fused_qgemm(
        a, wf, 0.04, 0.5, a_bits=8, w_bits=1, a_is_levels=True)) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(800, 256, 512), (100, 256, 512),
                                   (8, 9216, 4096), (1, 9216, 4096),
                                   (8, 4096, 4096), (1, 4096, 4096),
                                   (5, 70, 9), (130, 600, 140),
                                   (17, 1000, 76), (0, 0, 0)])
def test_fused_plan_export_equals_its_cpu_copy(cuda_device, m, k, n):
    from repro_torch.kernels.fused_qgemm import gemm_plan, kernel_plan

    assert kernel_plan(m, n, k) == gemm_plan(m, n, k)


@pytest.mark.gpu
def test_conv_launcher_refuses_a_foreign_layout(cuda_device):
    """The kernel sums its own shared memory for the layout it is given
    and refuses any other size, so the host's smem_layout (the plan's
    feasibility bound) cannot drift from the kernel unseen."""
    from repro_torch.kernels import conv_implicit as C

    x = torch.zeros((2, 10, 10, 32), dtype=torch.uint8, device=cuda_device)
    w = torch.zeros((9 * 32, 64), dtype=torch.uint8, device=cuda_device)
    out = torch.empty((2, 10, 10, 64), device=cuda_device)
    lay = C.smem_layout(10, 10, 32, 3, 3, 1, "SAME", 2, 64)
    stream = torch.cuda.current_stream().cuda_stream
    args = (2, 10, 10, 32, 64, 3, 3, 1, 10, 10, 1, 1)
    for bad in (lay._replace(smem_bytes=lay.smem_bytes + 16),
                lay._replace(cpitch=32), lay._replace(tm=48)):
        assert C._launcher()(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                             *args, *bad, 1.0, 0.0, stream) != 0
    assert C._launcher()(x.data_ptr(), w.data_ptr(), out.data_ptr(), *args,
                         *lay, 1.0, 0.0, stream) == 0
    torch.cuda.synchronize()


def _held_to_the_oracle(compiled, x, got, ref):
    """A compiled svhn forward ``got`` against the oracle's ``ref``
    (``reference=True``).  The conv kernels are held bit for bit: the
    forward with the norm's plain version in the kernel's place, whose
    statistics sum in the oracle's order, equals ``ref``.  The norm
    kernel's statistics sum in another order, so a level may flip at a .5
    boundary (``tests/test_torch_norm_act.py`` bounds the flips): ``got``
    keeps the oracle's argmax and lies within chip_smoke.py's alone vs
    batched tolerance of it, 0.1 x max|logit| (``LOGIT_TOL_FRAC``)."""
    from repro_torch.kernels import norm_act as N

    kernel = N.norm_act
    N.norm_act = N.norm_act_plain
    try:
        assert torch.equal(compiled.forward(x), ref)
    finally:
        N.norm_act = kernel
    assert torch.equal(got.argmax(-1), ref.argmax(-1))
    assert float((got - ref).abs().max()) <= 0.1 * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("qname", ["w1a4", "w1a8"])
def test_svhn_plan_on_card_equals_its_plain_versions(cuda_device, qname):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    compiled = api.build(svhn_cnn_spec(16), PAPER_CONFIGS[qname],
                         params=init_cnn(gen, svhn_cnn_spec(16))).compile(
        target="cuda", batch_hints=(4,))
    x = torch.rand((4, 40, 40, 3), generator=gen, device=cuda_device)
    engines = [lp.engine for lp in compiled.plan.layers]
    # at width 16 only conv5 is deep enough (K >= 512) for the implicit
    # kernel; conv1-4 and conv6 take the fused GEMM
    want = {"fused_qgemm": engines.count("fused"),
            "conv_implicit": engines.count("implicit")}
    assert want == {"fused_qgemm": 5, "conv_implicit": 1}
    want.update(attn_flash=0, attn_paged=0, quantize_pack=0,
                bitgemm_packed=0, int8_matmul=0, norm_act=7, dwconv=0)
    _lib.reset_launches()
    got = compiled.forward(x)
    assert _lib.LAUNCHES == want
    ref = compiled.forward(x, reference=True)
    assert _lib.LAUNCHES == want
    _held_to_the_oracle(compiled, x, got, ref)


@pytest.mark.gpu
def test_cnn_runner_stages_buckets_in_a_ring_of_pinned_buffers(cuda_device):
    """On the card a bucket is collated into one of three pinned buffers
    in turn, so the engine's ``pin_memory`` copies nothing, and buckets
    served through the ring (it wraps) equal the same batches' forwards."""
    from repro_torch.launch.engine import CNNRunner, ServeEngine

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    compiled = api.build(svhn_cnn_spec(16), PAPER_CONFIGS["w1a4"],
                         params=init_cnn(gen, svhn_cnn_spec(16))).compile(
        target="cuda", batch_hints=(4,))
    runner = CNNRunner(compiled.plan)
    rs = np.random.RandomState(6)
    imgs = [rs.uniform(0, 1, (40, 40, 3)).astype(np.float32)
            for _ in range(20)]
    ptrs = []
    for i in range(4):
        x = torch.from_numpy(runner.collate(imgs[i:i + 3], 4))
        assert x.is_pinned() and x.pin_memory().data_ptr() == x.data_ptr()
        np.testing.assert_array_equal(x.numpy()[3], imgs[i])
        ptrs.append(x.data_ptr())
    assert len(set(ptrs[:3])) == 3 and ptrs[3] == ptrs[0]
    res = ServeEngine(runner, max_batch=4).serve(imgs)
    got = np.stack([r.value for r in res])
    want = np.concatenate([compiled.forward(torch.from_numpy(
        np.stack(imgs[i:i + 4])).to(cuda_device)).cpu().numpy()
        for i in range(0, 20, 4)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_cnn_runner_collates_a_large_bucket_on_its_threads(cuda_device,
                                                           monkeypatch):
    """A bucket of two or more chunks is copied into the pinned ring by
    the ring's threads, each part in place: the buffer equals one
    ``np.stack`` of the rows, padding included."""
    from repro_torch.launch import engine

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    compiled = api.build(svhn_cnn_spec(16), PAPER_CONFIGS["w1a4"],
                         params=init_cnn(gen, svhn_cnn_spec(16))).compile(
        target="cuda", batch_hints=(8,))
    runner = engine.CNNRunner(compiled.plan)
    monkeypatch.setattr(engine, "COLLATE_CHUNK_BYTES", 1 << 12)
    rs = np.random.RandomState(8)
    imgs = [rs.uniform(0, 1, (40, 40, 3)).astype(np.float32)
            for _ in range(7)]
    submitted = []
    runner.collate(imgs[:1], 1)          # makes the ring
    submit = runner._staging.workers.submit
    monkeypatch.setattr(runner._staging.workers, "submit",
                        lambda *a, **k: submitted.append(1) or submit(*a, **k))
    x = runner.collate(imgs, 8)
    assert torch.from_numpy(x).is_pinned() and len(submitted) == 4
    np.testing.assert_array_equal(x, np.stack(imgs + imgs[:1]))


# ---------------------------------------------------------------------------
# bit-plane kernels: quantize_pack, bitgemm_packed, int8_matmul
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("m,k", [(5, 70), (3, 33), (130, 1), (800, 2304),
                                 (8, 9216),
                                 # svhn conv1-2's and AlexNet conv1's
                                 # patches at batch 8
                                 (12800, 576), (6272, 2400),
                                 # K % 32 == 0 with a last, partial tile
                                 (3, 96), (37, 320),
                                 # K % 32 != 0: a thread per word, its
                                 # loads 16 bytes wide (K = 48), 8 (40),
                                 # 4 (100: K % 16 != 0 for levels in) or
                                 # 4-byte floats and 1-byte levels (37:
                                 # K % 4 != 0 for floats in)
                                 (6, 48), (6, 40), (7, 100), (9, 37),
                                 # empty: no launch
                                 (0, 70), (5, 0), (0, 0)])
def test_quantize_pack_kernel_matches_plain(cuda_device, bits, m, k):
    """Every bit width; the staged tiles of K % 32 == 0, a last tile
    partly filled; tails of a row's last word (K % 32 != 0) and the load
    widths the kernel picks from K; the planes' tail bits are zero."""
    rs = np.random.RandomState(m * bits + k)
    n = (1 << bits) - 1
    a = rs.uniform(-0.3, 1.3, (m, k)).astype(np.float32)
    if m:
        a[0] = ((rs.randint(0, n + 1, k) + 0.5) / n).astype(np.float32)  # ties
    a = torch.from_numpy(a).to(cuda_device)
    lv, pk = quantize_pack(a, bits)
    ref_lv, ref_pk = quantize_pack_plain(a, bits)
    torch.cuda.synchronize()
    assert torch.equal(lv, ref_lv) and torch.equal(pk, ref_pk)
    lv2, pk2 = quantize_pack(ref_lv, bits)     # levels in
    torch.cuda.synchronize()
    assert lv2 is ref_lv and torch.equal(pk2, ref_pk)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [3, 8])
@pytest.mark.parametrize("form,offset", [("levels", 1), ("levels", 4),
                                         ("levels", 8), ("float", 4),
                                         ("float", 8), ("float", 12)])
@pytest.mark.parametrize("m,k", [(40, 576), (9, 37)])
def test_quantize_pack_kernel_takes_a_base_off_16_bytes(cuda_device, form,
                                                        offset, m, k, bits):
    """A contiguous view ``offset`` bytes into its storage is no 16-byte
    aligned base: the kernel loads it at the widest width that divides
    both the row and the base (no copy, no refusal) and still equals the
    plain version."""
    rs = np.random.RandomState(offset + k + bits)
    if form == "levels":
        flat = rs.randint(0, 1 << bits, m * k + offset).astype(np.uint8)
        skip = offset
    else:
        flat = rs.uniform(-0.3, 1.3, m * k + offset // 4).astype(np.float32)
        skip = offset // 4
    a = torch.from_numpy(flat).to(cuda_device)[skip:].view(m, k)
    assert a.is_contiguous() and a.data_ptr() % 16 == offset
    lv, pk = quantize_pack(a, bits)
    ref_lv, ref_pk = quantize_pack_plain(a, bits)
    torch.cuda.synchronize()
    assert torch.equal(lv, ref_lv) and torch.equal(pk, ref_pk)


@pytest.mark.gpu
@pytest.mark.parametrize("levels_in", [False, True])
@pytest.mark.parametrize("m,k", [(12800, 576), (9, 37)])
def test_quantize_pack_one_device_op_per_call(cuda_device, levels_in, m, k):
    """One launch a call and nothing beside it: the kernel writes every
    word of the planes, tails included, so there is no memset."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + k)
    a = torch.rand((m, k), generator=gen, device=cuda_device)
    if levels_in:
        a = quantize_pack_plain(a, 4)[0]
    assert _lib.count_device_ops(lambda: quantize_pack(a, 4)) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("ab,wb", [(1, 1), (4, 1), (8, 1), (2, 2), (3, 5),
                                   (8, 8)])
@pytest.mark.parametrize("m,k,n", [(5, 70, 9), (70, 1000, 130),
                                   (130, 33, 65), (8, 9216, 96),
                                   # the main path's word counts that are no
                                   # multiple of 4 or 8 (Kw 18, 75, 108),
                                   # N no multiple of 8
                                   (200, 576, 70), (33, 2400, 100),
                                   (40, 3456, 61),
                                   # AlexNet fc5's Kw = 288 at N = 4096: the
                                   # cluster split-K, at 16-row tiles and at
                                   # 32-row tiles short of one wave
                                   (1, 9216, 4096), (8, 9216, 4096),
                                   (33, 9216, 4096),
                                   # 64-row tiles at W1A1 (264 of them)
                                   (4224, 96, 256),
                                   # Kw = 0: the kernel writes the zeros
                                   (5, 0, 9)])
def test_bitgemm_packed_kernel_matches_plain(cuda_device, ab, wb, m, k, n):
    rs = np.random.RandomState(m + 7 * ab + wb)
    a = torch.from_numpy(rs.randint(0, 1 << ab, (m, k)).astype(np.uint8))
    w = torch.from_numpy(rs.randint(0, 1 << wb, (k, n)).astype(np.uint8))
    a, w = a.to(cuda_device), w.to(cuda_device)
    ap = quantize_pack_plain(a, ab)[1]
    wp = ops.pack_weight_planes(w, wb)
    got = bitgemm_packed(ap, wp, a_bits=ab, w_bits=wb)
    ref = bitgemm_packed_plain(ap, wp, a_bits=ab, w_bits=wb)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(ref.double(), a.double() @ w.double())


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(5, 70, 9), (130, 600, 140),
                                   (8, 9216, 96), (800, 256, 512),
                                   (33, 17, 3),
                                   # AlexNet fc5's shape: the cluster split-K
                                   (1, 9216, 4096), (8, 9216, 4096),
                                   # K with no 16-byte rows: the masked path
                                   (40, 31, 24), (70, 48, 33),
                                   # 64-row tiles split over K
                                   (800, 2304, 256),
                                   # K = 0: the kernel writes the zeros
                                   (5, 0, 9)])
def test_int8_matmul_kernel_matches_plain_signed(cuda_device, m, k, n):
    gen = torch.Generator(device=cuda_device).manual_seed(m + k)
    a = torch.randint(-128, 128, (m, k), generator=gen, dtype=torch.int8,
                      device=cuda_device)
    b = torch.randint(-128, 128, (k, n), generator=gen, dtype=torch.int8,
                      device=cuda_device)
    a[0] = -128
    b[:, 0] = -128
    got = int8_matmul(a, b)
    ref = int8_matmul_plain(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(3, 5), (40, 24)])
def test_int8_matmul_kernel_at_the_largest_exact_k(cuda_device, m, n):
    """The largest K that int8_exact admits, every operand -128: each
    output is 16384 K, one step below 2^31 overflow."""
    from repro_torch.kernels.bitgemm_mxu import int8_exact

    k = 1
    while int8_exact(k + 1):
        k += 1
    assert k == 131071
    a = torch.full((m, k), -128, dtype=torch.int8, device=cuda_device)
    b = torch.full((k, n), -128, dtype=torch.int8, device=cuda_device)
    got = int8_matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, int8_matmul_plain(a, b))
    assert int(got.min()) == int(got.max()) == 16384 * k


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["a", "b", "both"])
def test_int8_matmul_kernel_takes_a_base_one_byte_off(cuda_device, which):
    """A contiguous view one byte into its storage is no 16-byte aligned
    base: the kernel stages it through its masked path (no copy, no
    refusal) and still equals the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    m, k, n = 48, 576, 64

    def operand(rows, cols, off):
        flat = torch.randint(-128, 128, (rows * cols + 1,), generator=gen,
                             dtype=torch.int8, device=cuda_device)
        return flat[1:].view(rows, cols) if off else flat[:-1].view(rows,
                                                                      cols)

    a = operand(m, k, which in ("a", "both"))
    b = operand(k, n, which in ("b", "both"))
    assert a.is_contiguous() and b.is_contiguous()
    assert (a.data_ptr() % 16 != 0) == (which in ("a", "both"))
    got = int8_matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, int8_matmul_plain(a, b))


# the bit-plane kernels' main-path GEMMs at batch 8 (GEMM view M x K x N)
# and around them: svhn conv1-6, AlexNet conv1-4 and fc5/fc6
BIT_GEMMS = [(12800, 576, 64), (12800, 576, 128), (3200, 1152, 128),
             (3200, 1152, 256), (800, 2304, 256), (800, 256, 512),
             (6272, 2400, 256), (1568, 2304, 384), (1568, 3456, 384),
             (1568, 3456, 256), (8, 9216, 4096), (8, 4096, 4096),
             (1, 9216, 4096), (33, 4096, 4096), (5, 70, 9), (0, 0, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", BIT_GEMMS)
def test_int8_plan_export_equals_its_cpu_copy(cuda_device, m, k, n):
    from repro_torch.kernels.bitgemm_mxu import kernel_plan, matmul_plan

    assert kernel_plan(m, n, k) == matmul_plan(m, n, k)


@pytest.mark.gpu
@pytest.mark.parametrize("ab,wb", [(1, 1), (4, 1), (8, 8)])
@pytest.mark.parametrize("m,k,n", BIT_GEMMS)
def test_bitgemm_plan_export_equals_its_cpu_copy(cuda_device, m, k, n, ab,
                                                 wb):
    from repro_torch.kernels.bitgemm import kernel_plan, packed_plan

    kw = -(-k // 32)
    assert kernel_plan(m, n, kw, ab, wb) == packed_plan(m, n, kw, ab, wb)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,ab", [(8, 9216, 4096, 1),
                                      (12800, 576, 128, 4),
                                      (6272, 2400, 256, 1)])
def test_bitplane_kernels_one_device_op_per_call(cuda_device, m, k, n, ab):
    """One launch a call, split-K (fc5) included: the cluster combines the
    partials inside it, so no memset, workspace or second pass."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    a_lv = torch.randint(0, 1 << ab, (m, k), generator=gen,
                         dtype=torch.uint8, device=cuda_device)
    w_lv = torch.randint(0, 2, (k, n), generator=gen, dtype=torch.uint8,
                         device=cuda_device)
    ap = quantize_pack_plain(a_lv, ab)[1]
    wp = ops.pack_weight_planes(w_lv, 1)
    a8, w8 = a_lv.view(torch.int8), w_lv.view(torch.int8)
    assert _lib.count_device_ops(
        lambda: bitgemm_packed(ap, wp, a_bits=ab, w_bits=1)) == 1
    assert _lib.count_device_ops(lambda: int8_matmul(a8, w8)) == 1


@pytest.mark.gpu
def test_bitplane_wrappers_count_launches_only_for_the_kernel(cuda_device):
    a = torch.randint(0, 16, (40, 100), dtype=torch.uint8, device=cuda_device)
    w = torch.randint(0, 2, (100, 24), dtype=torch.uint8, device=cuda_device)
    _lib.reset_launches()
    for reference in (False, True):
        ops.bitgemm_faithful(a, w, 4, 1, reference=reference)
        ops.bitgemm_mxu(a, w, 4, 1, reference=reference)
        ops.bitgemm_mxu(a, w, 8, 1, reference=reference)   # 2 nibble groups
    torch.cuda.synchronize()
    assert _lib.LAUNCHES == {"fused_qgemm": 0, "conv_implicit": 0,
                             "attn_flash": 0, "attn_paged": 0,
                             "quantize_pack": 1, "bitgemm_packed": 1,
                             "int8_matmul": 3, "norm_act": 0, "dwconv": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["faithful", "int8", "int8_planewise",
                                    "planes", "packed", "f32dot"])
@pytest.mark.parametrize("qname", ["w1a1", "w1a4", "w1a8"])
def test_svhn_engines_on_card_equal_default_engines(cuda_device, engine,
                                                    qname):
    """Every engine's svhn logits on the card equal its plain versions'
    and the default engines' (fused/implicit) bit for bit."""
    import dataclasses

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    spec = svhn_cnn_spec(32)
    params = init_cnn(gen, spec)
    x = torch.rand((4, 40, 40, 3), generator=gen, device=cuda_device)
    q = PAPER_CONFIGS[qname]
    default = api.build(spec, q, params=params).compile(
        target="cuda", batch_hints=(4,)).forward(x)
    compiled = api.build(spec, dataclasses.replace(q, engine=engine),
                         params=params).compile(target="cuda",
                                                batch_hints=(4,))
    _lib.reset_launches()
    got = compiled.forward(x)
    torch.cuda.synchronize()
    per_layer = {"faithful": {"quantize_pack": 1, "bitgemm_packed": 1},
                 "int8": {"int8_matmul": 2 if qname == "w1a8" else 1},
                 "int8_planewise": {"int8_matmul": q.a_bits}}.get(engine, {})
    want = {k: 6 * per_layer.get(k, 0) for k in _lib.LAUNCHES}
    want["norm_act"] = 7
    assert _lib.LAUNCHES == want
    _held_to_the_oracle(compiled, x, got,
                        compiled.forward(x, reference=True))
    assert torch.equal(got, default)


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------

def _attn_tol(v, dtype):
    vmax = float(v.float().abs().max())
    return vmax * (1e-5 if dtype == torch.float32 else 2 ** -7)


def _assert_bf16_elementwise(got, ref32, v):
    """Each bf16 output within one rounding of the plain version's float32
    result: |got - ref| <= 2^-7 |ref| + 1e-5 max|v|."""
    tol = 2 ** -7 * ref32.abs() + 1e-5 * float(v.float().abs().max())
    assert bool(((got.float() - ref32).abs() <= tol).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hd,causal,window,skv", [
    (2, 300, 3, 64, True, None, None), (1, 128, 2, 32, False, None, None),
    (1, 200, 2, 128, True, None, None), (2, 256, 15, 64, True, 100, None),
    # Sq not a multiple of the 64-row tile; Sq < Skv (non-causal); hd 32
    (1, 100, 2, 32, True, None, None), (1, 70, 2, 64, False, None, 200),
    (2, 130, 3, 32, True, 40, None),
    # hd 96 (phi3-mini): 3 score k-steps, 12 output column tiles
    (2, 300, 3, 96, True, None, None), (1, 70, 2, 96, False, None, 200),
    (1, 200, 2, 96, True, 64, None),
    # hd 80 (hubert-xlarge, non-causal): 3 score k-steps, the last half of
    # the third on zeroed Q columns; 10 output column tiles
    (2, 300, 3, 80, False, None, None), (1, 70, 2, 80, False, None, 200),
    (2, 300, 3, 80, True, None, None), (1, 200, 2, 80, True, 64, None),
    # hd 256 (recurrentgemma): two warps a row group, each half the
    # columns; float32 V in 32-key tiles
    (2, 300, 2, 256, True, None, None), (1, 70, 2, 256, False, None, 200),
    (1, 200, 2, 256, True, 64, None)])
def test_attn_flash_kernel_matches_plain(cuda_device, dtype, b, s, h, hd,
                                         causal, window, skv):
    gen = torch.Generator(device=cuda_device).manual_seed(s + hd)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda_device).to(dtype)
    k, v = (torch.randn((b, skv or s, h, hd), generator=gen,
                        device=cuda_device).to(dtype) for _ in range(2))
    got = A.attn_flash(q, k, v, causal=causal, window=window)
    ref = A.attn_flash(q, k, v, causal=causal, window=window, reference=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - ref.float()).abs().max()) <= _attn_tol(v, dtype)
    if dtype == torch.bfloat16:
        _assert_bf16_elementwise(got, A.attn_flash(
            q.float(), k.float(), v.float(), causal=causal, window=window,
            reference=True), v)


def _paged_case(device, gen, *, b, s, hp, hkv, hd, ps, np_, p, dtype,
                idle=0, pad_slot=None):
    """Stale pools, ragged tables padded with the null page, ppos written
    for each slot's live positions, slot 0's last row padding (-1).
    ``idle`` trailing slots have all-null tables and padding rows (idle
    decode slots); slot ``pad_slot`` keeps its pages but all its rows are
    padding."""
    pk = torch.randn((np_ + 1, ps, hkv, hd), generator=gen, device=device)
    pv = torch.randn((np_ + 1, ps, hkv, hd), generator=gen, device=device)
    pk[np_], pv[np_] = 0.0, 0.0
    ppos = torch.full((np_ + 1, ps), -1, dtype=torch.int32, device=device)
    table = torch.full((b, p), np_, dtype=torch.int32, device=device)
    q_pos = torch.full((b, s), -1, dtype=torch.int32, device=device)
    order = torch.randperm(np_, generator=torch.Generator().manual_seed(b))
    used = 0
    for i in range(b - idle):
        n_tok = s + (7 * i + 3) % (p * ps - s)
        own = order[used: used + -(-n_tok // ps)].tolist()
        used += len(own)
        table[i, :len(own)] = torch.tensor(own, dtype=torch.int32)
        pos = torch.arange(n_tok, dtype=torch.int32, device=device)
        ppos[torch.tensor(own, device=device)[pos.long() // ps],
             pos.long() % ps] = pos
        q_pos[i] = torch.arange(n_tok - s, n_tok, dtype=torch.int32)
    q_pos[0, -1] = -1
    if pad_slot is not None:
        q_pos[pad_slot] = -1
    q = torch.randn((b, s, hp, hd), generator=gen, device=device)
    return [x.to(dtype) for x in (q, pk, pv)] + [ppos, table, q_pos]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hp,hkv,hd,window,p,idle,pad_slot", [
    (8, 1, 15, 5, 64, None, 6, 0, None), (1, 16, 15, 5, 64, None, 6, 0, None),
    (3, 4, 3, 1, 32, None, 6, 0, None), (4, 2, 8, 2, 128, 9, 6, 0, None),
    # 128-page tables: 13 splits of 10 pages, the last of 8
    (8, 1, 15, 5, 64, None, 128, 1, None),
    # 201 pages in 51 splits of 4, the last of 1 page; hd 32
    (2, 3, 4, 4, 32, None, 201, 0, None),
    # an idle all-null-page slot and a slot whose rows are all padding
    (4, 2, 6, 2, 64, None, 9, 1, 1),
    # a window across many splits; hd 128 over several splits
    (8, 1, 15, 5, 64, 300, 128, 0, None), (2, 1, 8, 2, 128, 64, 40, 0, None),
    # 6 rows x 5 query heads a KV head: head groups of 2, 2 and 1
    (2, 6, 10, 2, 64, None, 9, 0, None),
    # hd 96 (phi3-mini, no GQA): a decode step and a prefill chunk
    (8, 1, 32, 32, 96, None, 18, 1, None),
    (1, 16, 32, 32, 96, None, 18, 0, None),
    (2, 3, 6, 2, 96, 20, 40, 0, None)])
def test_attn_paged_kernel_matches_plain(cuda_device, dtype, b, s, hp, hkv,
                                         hd, window, p, idle, pad_slot):
    gen = torch.Generator(device=cuda_device).manual_seed(b * 100 + s)
    q, pk, pv, ppos, table, q_pos = _paged_case(
        cuda_device, gen, b=b, s=s, hp=hp, hkv=hkv, hd=hd, ps=16,
        np_=b * max(p, 8) + 4, p=p, dtype=dtype, idle=idle, pad_slot=pad_slot)
    kw = dict(causal=True, window=window, quantized=True, n_q_heads=hp)
    got = A.attn_paged(q, pk, pv, ppos, table, q_pos, **kw)
    ref = A.attn_paged(q, pk, pv, ppos, table, q_pos, reference=True, **kw)
    torch.cuda.synchronize()
    valid = q_pos >= 0
    tol = _attn_tol(pv, dtype)
    assert float((got[valid].float() - ref[valid].float()).abs().max()) <= tol
    # padding rows: both average V over the gathered slots
    assert float((got[~valid].float() - ref[~valid].float()).abs().max()) <= tol
    if dtype == torch.bfloat16:
        _assert_bf16_elementwise(got, A.attn_paged(
            q.float(), pk.float(), pv.float(), ppos, table, q_pos,
            reference=True, **kw), pv)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,hp,hkv,p,want", [
    (8, 1, 15, 5, 18, (3, 1, 2, 9)),     # the main path's decode step
    (1, 16, 15, 5, 18, (1, 3, 1, 18)),   # its prefill chunk: 3 head groups
    (8, 1, 15, 5, 128, (3, 1, 10, 13)),  # 128-page tables: last split of 8
    (2, 1, 4, 4, 201, (1, 1, 4, 51)),    # the last split has 1 page
    (1, 1, 1, 1, 1, (1, 1, 1, 1))])
def test_attn_paged_plan(cuda_device, b, s, hp, hkv, p, want):
    """The kernel's launch plan: splits that cover the table with none
    empty, enough blocks to fill the card where the table allows it, the
    shared memory the CPU-side bound computes, and the scratch layout."""
    for dtype, hd in ((torch.bfloat16, 64), (torch.float32, 128),
                      (torch.bfloat16, 96)):
        nbytes, (hpb, ngroups, pps, nsplit, smem) = A.paged_plan(
            b, s, hp, hkv, hd, p, hp, dtype)
        assert (hpb, ngroups, pps, nsplit) == want
        assert (nsplit - 1) * pps < p <= nsplit * pps
        assert nsplit * hkv * ngroups * b >= min(p * hkv * ngroups * b, 264)
        assert hpb == A.paged_heads_per_block(
            A.paged_group_heads(hp, hkv, hp), s)
        itemsize = torch.empty((), dtype=dtype).element_size()
        assert smem == A.paged_smem_bytes(hpb * s, hd, itemsize)
        # kmax (b, p), qmax (b,), row counters (b, s, hp), and with splits
        # the partials (m, l) and acc of every row
        rows = b * s * hp
        assert nbytes == 4 * (b * p + b + rows + (
            rows * nsplit * (2 + hd) if nsplit > 1 else 0))


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [48, 256])
def test_attention_kernels_refuse_head_dims_they_do_not_take(cuda_device,
                                                            hd):
    """A head_dim without a kernel instance raises on the card (never the
    plain version): 48 for both kernels, 256 for the paged one (its
    shared-memory bound refuses it too)."""
    gen = torch.Generator(device=cuda_device).manual_seed(hd)
    q, pk, pv, ppos, table, q_pos = _paged_case(
        cuda_device, gen, b=2, s=1, hp=2, hkv=1, hd=hd, ps=16, np_=8, p=2,
        dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        A.attn_paged(q, pk, pv, ppos, table, q_pos, quantized=True)
    x = torch.randn((1, 64, 2, hd), device=cuda_device).bfloat16()
    if hd not in A.KERNEL_HEAD_DIMS:
        with pytest.raises(ValueError, match="head_dim"):
            A.attn_flash(x, x, x)
    ok, why = ops.paged_attn_bounds(ops.AttnShape(
        seq_q=1, seq_kv=32, heads=16, head_dim=256, page_size=16))
    assert not ok and "shared memory" in why


@pytest.mark.gpu
def test_attn_flash_scratch_bytes(cuda_device):
    # 2 x 264 float32 partial maxima (16-byte multiple), then K's levels
    fn = _lib.launcher("attn_flash", [ctypes.c_longlong], "scratch_bytes",
                       ctypes.c_longlong)
    for n in (0, 100, 2 * 2048 * 15 * 64):
        assert fn(n) == 4 * 2 * 264 + n


@pytest.mark.gpu
def test_attention_wrappers_refuse_inputs_they_would_copy(cuda_device):
    """On the card a wrapper launches on its inputs as they are: a
    transposed q, an int64 table or a misaligned pool raises."""
    q = torch.randn((1, 64, 2, 32), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        A.attn_flash(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    pq, pk, pv, ppos, table, q_pos = _paged_case(
        cuda_device, gen, b=2, s=1, hp=2, hkv=1, hd=32, ps=16, np_=8, p=2,
        dtype=torch.float32)
    kw = dict(quantized=True)
    with pytest.raises(TypeError, match="int32"):
        A.attn_paged(pq, pk, pv, ppos, table.long(), q_pos, **kw)
    skew = torch.empty(pk.numel() + 1, device=cuda_device)[1:].view(pk.shape)
    with pytest.raises(ValueError, match="aligned"):
        A.attn_paged(pq, skew, pv, ppos, table, q_pos, **kw)


@pytest.mark.gpu
def test_attention_kernels_device_ops_per_call(cuda_device):
    """A call is its kernels and nothing else on the device: at most three
    operations for attn_flash, two for attn_paged (the nodes of a CUDA
    graph captured from one call)."""
    q = torch.randn((1, 256, 2, 64), device=cuda_device).bfloat16()
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    pq, pk, pv, ppos, table, q_pos = _paged_case(
        cuda_device, gen, b=8, s=1, hp=15, hkv=5, hd=64, ps=16, np_=160,
        p=18, dtype=torch.bfloat16, idle=1)
    flash = lambda: A.attn_flash(q, q, q)  # noqa: E731
    paged = lambda: A.attn_paged(pq, pk, pv, ppos, table, q_pos,  # noqa: E731
                                 quantized=True)
    for fn, most in ((flash, 3), (paged, 2)):
        fn()
        assert 1 <= _lib.count_device_ops(fn) <= most


@pytest.mark.gpu
def test_attention_wrappers_count_launches_only_for_the_kernel(cuda_device):
    q = torch.randn((1, 64, 2, 32), device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    pq, pk, pv, ppos, table, q_pos = _paged_case(
        cuda_device, gen, b=2, s=1, hp=2, hkv=1, hd=32, ps=16, np_=8, p=2,
        dtype=torch.float32)
    _lib.reset_launches()
    A.attn_flash(q, q, q)
    A.attn_flash(q, q, q, reference=True)
    A.attn_paged(pq, pk, pv, ppos, table, q_pos, quantized=True)
    A.attn_paged(pq, pk, pv, ppos, table, q_pos, quantized=True,
                 reference=True)
    A.attn_paged(pq, pk, pv, ppos, table, q_pos, quantized=False)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["attn_flash"] == 1
    assert _lib.LAUNCHES["attn_paged"] == 1


@pytest.mark.gpu
def test_lm_smoke_serving_on_card_equals_plain_versions(cuda_device,
                                                        monkeypatch):
    """Both LM entry points on the card (a 2-layer model with SmolLM's
    head geometry and projection widths cuBLASLt's int8 product serves,
    float32): the flash prefill (threshold lowered to the prompt) and the
    continuous engine give the plain versions' greedy tokens and launch
    their kernels once per layer per dispatch."""
    import dataclasses

    from repro_torch.api import targets
    from repro_torch.configs import SINGLE, get_config
    from repro_torch.launch.engine import ContinuousLMEngine
    from repro_torch.launch.serve import serve_once
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import prequantize_params

    cfg = dataclasses.replace(get_config("smollm-360m").smoke(
        n_layers=2, d_model=320, n_heads=15, n_kv_heads=5, d_ff=640, vocab=64,
        head_dim=64), quant=PAPER_CONFIGS["w1a8"])
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = prequantize_params(T.init_lm(gen, cfg, SINGLE), cfg)
    prompts = torch.randint(0, 64, (2, 32), generator=gen, device=cuda_device,
                            dtype=torch.int32)
    monkeypatch.setattr(targets, "ATTN_FLASH_SEQ_MIN", 32)
    _lib.reset_launches()
    got, _ = serve_once(params, cfg, SINGLE, prompts, 4, "serve")
    assert _lib.LAUNCHES["attn_flash"] == cfg.n_layers
    ref, _ = serve_once(params, cfg, SINGLE, prompts, 4, "serve",
                        reference=True)
    assert torch.equal(got, ref)
    payloads = [(np.arange(1, 1 + n, dtype=np.int32) % 64, h)
                for n, h in ((5, 3), (9, 4), (3, 2))]
    _lib.reset_launches()
    eng = ContinuousLMEngine(params, cfg, num_slots=2, page_size=4,
                             num_pages=16, max_seq=16)
    res = eng.serve(payloads)
    assert _lib.LAUNCHES["attn_paged"] == cfg.n_layers * eng.stats["dispatches"]
    ref = ContinuousLMEngine(params, cfg, num_slots=2, page_size=4,
                             num_pages=16, max_seq=16,
                             reference=True).serve(payloads)
    for a, b in zip(res, ref):
        np.testing.assert_array_equal(a.value, b.value)


@pytest.mark.gpu
@pytest.mark.parametrize("qname", ["w1a1", "w1a8"])
def test_autotune_on_the_card_picks_a_candidate(cuda_device, qname):
    """``compile(autotune=True)`` on params on the card times every
    layer's candidates there (keys name ``cuda``), each verdict is one of
    them, and the plan's logits equal the heuristic plan's bit for bit."""
    from repro_torch.core import plan as P

    ops.clear_plan_state()
    spec = svhn_cnn_spec(16)
    params = init_cnn(torch.Generator(device="cuda").manual_seed(0), spec)
    q = PAPER_CONFIGS[qname]
    tuned = api.build(spec, q, params=params, img_hw=16).compile(
        batch_hints=(1, 8), autotune=True)
    heur = api.build(spec, q, params=params, img_hw=16).compile(
        batch_hints=(1, 8))
    assert tuned.plan.autotune
    assert all(k[-1] == "cuda" for k in tuned.plan.autotune)
    for lp in tuned.plan.layers:
        if lp.fp:
            continue
        assert lp.engine_source == "autotuned"
        for b, eng in lp.engines:
            conv = ops.ConvShape(lp.in_h, lp.in_w, lp.kh, lp.kw, lp.stride,
                                 lp.padding, batch=b)
            assert eng in ops.candidate_engines(
                b * lp.out_h * lp.out_w, lp.k, lp.cout, lp.a_bits,
                lp.w_bits, conv=conv)
    x = torch.rand((8, 16, 16, 3), generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda")
    assert torch.equal(P.plan_forward(tuned.plan, x),
                       P.plan_forward(heur.plan, x))
    ops.clear_plan_state()


@pytest.mark.gpu
def test_implicit_conv_takes_a_strided_input(cuda_device):
    """A full-window FC layer's input comes from ``resize_linear`` strided;
    the implicit engine (which autotune may pick there) gets contiguous
    levels and equals the fused engine bit for bit."""
    from repro_torch.core.conv_lowering import quant_conv2d_pre
    from repro_torch.models.cnn import resize_linear

    g = torch.Generator(device="cuda").manual_seed(0)
    x = resize_linear(torch.rand((8, 13, 13, 64), generator=g,
                                 device="cuda"), 6)
    assert not x.is_contiguous()
    w_lv = torch.randint(0, 2, (6 * 6 * 64, 96), generator=g, device="cuda",
                         dtype=torch.uint8)
    kw = dict(kh=6, kw=6, stride=1, padding="VALID", a_bits=8, w_bits=1,
              s_w=0.05, z_w=0.5)
    got = quant_conv2d_pre(x, w_lv, engine="implicit", **kw)
    assert torch.equal(got, quant_conv2d_pre(x, w_lv, engine="fused", **kw))


@pytest.mark.gpu
def test_checkpoint_restore_lands_on_the_card(cuda_device, tmp_path):
    """With no ``device`` a restore puts each leaf on its template leaf's
    device: a trainer on the card resumes on the card."""
    from repro_torch.train.checkpoint import Checkpointer

    ck = Checkpointer(str(tmp_path), async_save=False)
    state = dict(w=torch.arange(6.0, device=cuda_device).reshape(2, 3),
                 step=torch.tensor(3, dtype=torch.int32, device=cuda_device))
    ck.save(1, state)
    _, back = ck.restore(state)
    assert back["w"].device.type == "cuda"
    assert torch.equal(back["w"], state["w"])
    assert back["step"].shape == () and int(back["step"]) == 3
    _, host = ck.restore(state, device="cpu")
    assert host["w"].device.type == "cpu"


# ---------------------------------------------------------------------------
# several cards: per-device shared-memory opt-in, the data-parallel engine
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_smem_opt_in_is_per_card(cuda_device):
    """``conv_implicit``, ``bitgemm_packed``, ``attn_flash`` and
    ``attn_paged`` opt in to more than 48 KB of shared memory once per
    card (the attribute lives in each device's context): each launches on
    every visible card, under ``torch.cuda.device(i)``, equal to its plain
    version.  Needs two cards."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two cards: the opt-in is per device ({n} here)")
    for i in range(n):
        dev = torch.device("cuda", i)
        gen = torch.Generator(device=dev).manual_seed(i)
        with torch.cuda.device(dev):
            x = torch.randint(0, 16, (8, 10, 10, 256), generator=gen,
                              device=dev, dtype=torch.uint8)
            wl = torch.randint(0, 2, (9 * 256, 256), generator=gen,
                               device=dev, dtype=torch.uint8)
            kw = dict(kh=3, kw=3, stride=1, padding="SAME", a_bits=4,
                      w_bits=1)
            assert torch.equal(conv_implicit(x, wl, 0.05, 0.5, **kw),
                               conv_implicit_plain(x, wl, 0.05, 0.5, **kw))
            a = torch.randint(0, 2 ** 31 - 1, (4, 70, 16), generator=gen,
                              device=dev, dtype=torch.int32)
            w = torch.randint(0, 2 ** 31 - 1, (1, 130, 16), generator=gen,
                              device=dev, dtype=torch.int32)
            assert torch.equal(bitgemm_packed(a, w, a_bits=4, w_bits=1),
                               bitgemm_packed_plain(a, w, a_bits=4,
                                                    w_bits=1))
            q, k, v = (torch.randn((1, 200, 2, 256), generator=gen,
                                   device=dev) for _ in range(3))
            got = A.attn_flash(q, k, v, causal=True)
            ref = A.attn_flash(q, k, v, causal=True, reference=True)
            assert float((got - ref).abs().max()) <= _attn_tol(
                v, torch.float32)
            case = _paged_case(dev, gen, b=2, s=1, hp=4, hkv=2, hd=64,
                               ps=16, np_=20, p=6, dtype=torch.float32)
            pkw = dict(causal=True, quantized=True, n_q_heads=4)
            got = A.attn_paged(*case, **pkw)
            ref = A.attn_paged(*case, reference=True, **pkw)
            ok = case[5] >= 0
            assert float((got[ok] - ref[ok]).abs().max()) <= _attn_tol(
                case[2], torch.float32)
            torch.cuda.synchronize(dev)


@pytest.mark.gpu
def test_make_serve_mesh_is_none_on_one_card(cuda_device):
    """The serving mesh is every visible card, or None on one (the
    engine's single-device path), as the reference's."""
    from repro_torch.launch.mesh import make_serve_mesh

    n = torch.cuda.device_count()
    mesh = make_serve_mesh()
    if n == 1:
        assert mesh is None
    else:
        assert mesh == tuple(torch.device("cuda", i) for i in range(n))


@pytest.mark.gpu
def test_two_replica_cnn_engine_on_one_card(cuda_device):
    """``ServeEngine(mesh=(cuda:0, cuda:0))``: two replicas on one card
    (a test layout, not a serving mode).  Each 8-row dispatch runs as two
    4-row replica forwards, so its results equal the one-device engine's
    at ``max_batch=4`` bit for bit, with exactly twice a 4-row dispatch's
    kernel launches.  Against one device's 8-row dispatch the float ops
    around the kernels (cuDNN's fp first layer among them) may sum in
    another order: same argmax, within chip_smoke.py's alone-vs-batched
    tolerance, 0.1 x max|logit| (``LOGIT_TOL_FRAC``)."""
    from repro_torch.launch.engine import CNNRunner, ServeEngine

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    compiled = api.build(svhn_cnn_spec(16), PAPER_CONFIGS["w1a8"],
                         params=init_cnn(gen, svhn_cnn_spec(16))).compile(
        target="cuda", batch_hints=(1, 8))
    rs = np.random.RandomState(5)
    images = [rs.uniform(0, 1, (40, 40, 3)).astype(np.float32)
              for _ in range(16)]
    runner = CNNRunner(compiled.plan)
    four = ServeEngine(runner, max_batch=4)
    _lib.reset_launches()
    want = np.stack([r.value for r in four.serve(images[:4])])
    per_four = dict(_lib.LAUNCHES)
    assert per_four["conv_implicit"] + per_four["fused_qgemm"] > 0
    two = ServeEngine(runner, max_batch=8, mesh=(cuda_device, cuda_device))
    _lib.reset_launches()
    got = np.stack([r.value for r in two.serve(images[:8])])
    assert _lib.LAUNCHES == {k: 2 * v for k, v in per_four.items()}
    np.testing.assert_array_equal(
        got, np.concatenate([want, np.stack(
            [r.value for r in four.serve(images[4:8])])]))
    full = np.stack([r.value for r in two.serve(images)])
    alone = np.stack([r.value for r in four.serve(images)])
    np.testing.assert_array_equal(full, alone)
    one = np.stack([r.value for r in ServeEngine(runner, max_batch=8)
                    .serve(images)])
    assert (one.argmax(-1) == full.argmax(-1)).all()
    assert np.abs(one - full).max() <= 0.1 * np.abs(one).max()
