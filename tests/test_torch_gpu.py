"""The port's CUDA kernels on the card, held against their plain versions.

Every test here is marked ``gpu`` and skips without a CUDA device (decided
inside the fixture, never at import).  Unlike the other
``test_torch_*.py`` files this one does not import JAX: the machine with
the card has no JAX, and these tests compare the kernels with the port's
own plain versions, which the other files hold against the reference.
Run on the card with ``python -m pytest -q -m gpu tests/test_torch_gpu.py``.

Kernel and plain version must agree bit for bit, full epilogue included:
both round ``s*acc`` and ``t*rowsum`` separately in float32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.core.quant import PAPER_CONFIGS  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.conv_implicit import (conv_implicit,  # noqa: E402
                                               conv_implicit_plain)
from repro_torch.kernels.fused_qgemm import (fused_qgemm,  # noqa: E402
                                             fused_qgemm_plain)
from repro_torch.models.cnn import init_cnn, svhn_cnn_spec  # noqa: E402

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
                                   (8, 9216, 96), (800, 256, 512)])
def test_fused_kernel_matches_plain(cuda_device, m, k, n, wb, ab):
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
    # odd dims and Cin (byte staging path), Cout past one 64-channel tile
    # and a word-aligned Cin (word staging path), a 5x5 window
    for b, h, w, cin, cout, k in ((2, 9, 7, 5, 7, 3), (3, 14, 14, 64, 130, 3),
                                  (2, 12, 11, 96, 64, 5)):
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
    assert _lib.LAUNCHES == {"fused_qgemm": 1, "conv_implicit": 1}


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
    _lib.reset_launches()
    got = compiled.forward(x)
    assert _lib.LAUNCHES == want
    ref = compiled.forward(x, reference=True)
    assert _lib.LAUNCHES == want
    assert torch.equal(got, ref)
