"""The served CNN's norm-act kernel (``kernels/norm_act.py``,
``csrc/norm_act.cu``).

The CPU tests hold the wrapper, on its plain version, to the serve-mode
arithmetic ``models.cnn._norm_act`` ran before the kernel (written out
here as ``_before``), bit for bit; pin the launch plan ``plan_for``
chooses from an (H, W, C) map; and hold the executor's call, its oracle
and the training forward.  The ``gpu`` tests hold the kernel against the
plain version on the card: with statistics that sum exactly in any order
the output is the eager ops' bit for bit (``torch.rsqrt`` included);
otherwise only the statistics' summation order differs, so at most 1e-4
of levels may differ, each by one level, and the kernel's flips against
a float64 norm are at most the plain version's plus 1e-5.  This file does
not import JAX.  Run the card's share with
``python -m pytest -q -m gpu tests/test_torch_norm_act.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import plan as P  # noqa: E402
from repro_torch.core.quant import (W1A4, QuantConfig, clip01,  # noqa: E402
                                    quantize_activation)
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import norm_act as N  # noqa: E402
from repro_torch.launch.trace import TRACER  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

# the hidden layers' conv outputs of the benchmark's svhn net (width 20,
# 40x40 images): (H, W, C)
SVHN20 = [(40, 40, 20), (40, 40, 20), (40, 40, 40), (20, 20, 40),
          (20, 20, 80), (10, 10, 80), (10, 10, 160)]
# AlexNet's (alexnet_spec(), 224x224): its five convs and two 1x1 FCs
ALEXNET = [(56, 56, 96), (28, 28, 256), (14, 14, 384), (14, 14, 384),
           (14, 14, 256), (1, 1, 4096), (1, 1, 4096)]
# beyond a cluster of 8 (svhn's width at 128x128 images)
TWO_PASS = (128, 128, 40)
FP = QuantConfig(w_bits=32, a_bits=32, g_bits=32, engine="fp")


def _before(x, g, beta, quant, role, dims=(1, 2)):
    """``_norm_act`` as it was, serve mode (dims (1, 2)) and train mode
    (dims (0, 1, 2))."""
    mu = torch.mean(x, dim=dims, keepdim=True)
    var = torch.var(x, dim=dims, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + 1e-5) * g + beta
    x = clip01(x)
    if role == "last" or quant.engine == "fp":
        return x
    return quantize_activation(x, quant.a_bits)


def _inputs(shape, seed, device="cpu"):
    """A conv output with per-channel offsets and scales, and the layer's
    bias, g and beta."""
    rs = np.random.RandomState(seed)
    b, h, w, c = shape
    x = (rs.standard_normal(shape) * rs.uniform(0.2, 3.0, c)
         + rs.uniform(-1.0, 1.0, c))
    vecs = [rs.uniform(-0.5, 0.5, c), rs.uniform(0.1, 0.4, c),
            rs.uniform(0.3, 0.7, c)]
    return [torch.from_numpy(np.asarray(v, np.float32)).to(device)
            for v in (x, *vecs)]


def _bits(t):
    return t.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hwc", SVHN20 + [(1, 1, 160), (5, 7, 10),
                                          (3, 3, 6)])
@pytest.mark.parametrize("quant,role", [(W1A4, "mid"), (W1A4, "first"),
                                        (W1A4, "last"), (FP, "mid")])
def test_wrapper_on_cpu_is_the_serve_arithmetic_before_the_kernel(
        hwc, quant, role):
    """Both forms (quantizing; clip only, for role last or the fp engine),
    at the svhn layer shapes, a 1x1 map and C not a multiple of 4."""
    x, _, g, beta = _inputs((2, *hwc), sum(hwc))
    want = _before(x, g, beta, quant, role)
    bits = 32 if (role == "last" or quant.engine == "fp") else quant.a_bits
    assert torch.equal(_bits(N.norm_act(x, g, beta, None, bits)), _bits(want))
    assert torch.equal(_bits(cnn._norm_act(x, g, beta, quant, role)),
                       _bits(want))


@pytest.mark.parametrize("mode", ["serve", "train"])
@pytest.mark.parametrize("hwc", [(40, 40, 20), (1, 1, 160), (5, 7, 10)])
def test_bias_inside_equals_bias_added_before(mode, hwc):
    x, b, g, beta = _inputs((3, *hwc), 7)
    got = cnn._norm_act(x, g, beta, W1A4, "mid", mode, bias=b)
    assert torch.equal(_bits(got),
                       _bits(cnn._norm_act(x + b, g, beta, W1A4, "mid", mode)))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_calls_launch_nothing(device):
    x, b, g, beta = _inputs((2, 10, 10, 80), 3, device)
    before = dict(_lib.LAUNCHES)
    counters = dict(TRACER.counters)
    out = N.norm_act(x, g, beta, b, 4)
    assert out.shape == x.shape and out.device.type == device
    assert _lib.LAUNCHES == before and TRACER.counters == counters


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, b, g, beta = _inputs((2, 4, 4, 8), 1)
    with pytest.raises(ValueError):
        N.norm_act(x.transpose(1, 2), g, beta, b, 4)   # not contiguous
    with pytest.raises(ValueError):
        N.norm_act(x, g[:4], beta, b, 4)               # g of the wrong size
    with pytest.raises(TypeError):
        N.norm_act(x.double(), g, beta, b, 4)
    with pytest.raises(ValueError):
        N.norm_act(x[0], g, beta, b, 4)                # not (B, H, W, C)


@pytest.mark.parametrize("hwc,path,chunks", [
    *[(s, "resident", 2 if s == (40, 40, 40) else 1) for s in SVHN20],
    ((56, 56, 96), "resident", 6), ((28, 28, 256), "resident", 5),
    ((14, 14, 384), "resident", 2), ((14, 14, 256), "resident", 2),
    ((1, 1, 4096), "resident", 1), ((1, 1, 160), "resident", 1),
    ((5, 7, 10), "resident", 1), ((96, 96, 40), "resident", 8),
    (TWO_PASS, "two_pass", 43)])
def test_plan_is_a_function_of_the_map_alone(hwc, path, chunks):
    """The path and the cluster follow from (H, W, C); every plan keeps a
    thread's channels fixed (threads and slices span whole lcm(vec, C)
    floats), covers the slab with no empty slice, and fits a block's
    shared memory in the kernel's layout."""
    N.plan_for.cache_clear()
    plan = N.plan_for(*hwc)
    N.plan_for.cache_clear()
    assert N.plan_for(*hwc) == plan
    assert (plan.path, plan.chunks) == (path, chunks)
    h, w, c = hwc
    slab = h * w * c
    n_vec = slab // plan.vec
    assert plan.vec == (4 if slab % 4 == 0 else 1)
    assert (plan.vec * plan.threads) % c == 0
    assert (plan.vec * plan.chunk_vec) % c == 0
    assert plan.threads <= N.MAX_THREADS
    assert (plan.chunks - 1) * plan.chunk_vec < n_vec <= (
        plan.chunks * plan.chunk_vec)
    assert plan.smem_bytes == 4 * (plan.vec * plan.chunk_vec
                                   + 2 * plan.vec * plan.threads + 2 * c)
    assert plan.smem_bytes <= N.SMEM_LIMIT
    if path == "resident":
        assert plan.chunks <= N.MAX_CLUSTER


@pytest.mark.parametrize("batch,fit,groups", [
    (1024, 264, 256), (1024, 132, 128), (1024, 1024, 1024), (100, 264, 100),
    (1, 7, 1), (1000, 330, 250)])
def test_resident_grid_spreads_the_batch_evenly(batch, fit, groups):
    """As few rounds as ``fit`` clusters allow, every cluster of the grid
    serving the same number of samples, give or take one."""
    assert N.groups_for(batch, fit) == groups
    assert groups <= fit
    assert -(-batch // groups) == -(-batch // fit)


def test_plan_refuses_channels_a_block_cannot_keep_fixed():
    with pytest.raises(ValueError, match="threads a block"):
        N.plan_for(1, 1, 4097)     # odd C over 1024: 4097 threads
    with pytest.raises(ValueError):
        N.plan_for(0, 4, 8)


def _svhn_plan(width=8):
    spec = cnn.svhn_cnn_spec(width)
    params = cnn.init_cnn(torch.Generator().manual_seed(0), spec)
    for p in params:   # a bias, g and beta that move the levels
        p["b"] = torch.linspace(-0.3, 0.3, p["b"].numel())
        p["g"] = torch.linspace(0.5, 1.5, p["g"].numel())
        p["beta"] = torch.linspace(0.2, 0.6, p["beta"].numel())
    return spec, params, P.cnn_serve_layers(spec, W1A4, batch=2,
                                            img_hw=(16, 16))


def test_oracle_never_reaches_the_kernel(monkeypatch):
    """``execute_cnn_layers(reference=True)`` runs the plain norm; the
    program's forward calls the wrapper once a hidden layer, with the
    layer's bias."""
    spec, params, layers = _svhn_plan()
    x = torch.rand((2, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    want = P.execute_cnn_layers(layers, params, x, W1A4)
    calls = []

    def kernel(*args):
        calls.append(args)
        raise AssertionError("the oracle reached the kernel's wrapper")

    monkeypatch.setattr(N, "norm_act", kernel)
    assert torch.equal(P.execute_cnn_layers(layers, params, x, W1A4,
                                            reference=True), want)
    assert calls == []
    with pytest.raises(AssertionError, match="reached"):
        P.execute_cnn_layers(layers, params, x, W1A4)
    assert calls[0][3] is params[0]["b"] and calls[0][4] == W1A4.a_bits


def test_executor_calls_the_norm_once_a_hidden_layer_with_its_bias(
        monkeypatch):
    """The check's observation point: ``_norm_act`` returns each hidden
    layer's float output, 7 a forward, resolved at call time."""
    spec, params, layers = _svhn_plan()
    x = torch.rand((2, 16, 16, 3), generator=torch.Generator().manual_seed(2))
    orig, seen = cnn._norm_act, []

    def observed(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append((kwargs["bias"], out))
        return out

    monkeypatch.setattr(cnn, "_norm_act", observed)
    P.execute_cnn_layers(layers, params, x, W1A4)
    assert len(seen) == len(spec) - 1
    assert all(b is p["b"] for (b, _), p in zip(seen, params))
    n = (1 << W1A4.a_bits) - 1
    for _, out in seen:
        assert out.dtype == torch.float32
        assert bool(((out >= 0) & (out <= 1)).all())
        assert torch.equal(out * n, torch.round(out * n))


@pytest.mark.parametrize("quant,role", [(W1A4, "mid"), (W1A4, "last"),
                                        (FP, "mid")])
def test_training_forward_output_and_gradients_unchanged(quant, role):
    x, b, g, beta = _inputs((4, 6, 6, 12), 11)
    leaves = [t.clone().requires_grad_() for t in (x, g, beta)]
    want = _before(leaves[0] + b, leaves[1], leaves[2], quant, role,
                   dims=(0, 1, 2))
    up = torch.from_numpy(np.random.RandomState(0).standard_normal(
        x.shape).astype(np.float32))
    want_g = torch.autograd.grad(want, leaves, up)
    got_leaves = [t.clone().requires_grad_() for t in (x, g, beta)]
    got = cnn._norm_act(got_leaves[0], got_leaves[1], got_leaves[2], quant,
                        role, "train", bias=b)
    got_g = torch.autograd.grad(got, got_leaves, up)
    assert torch.equal(_bits(got.detach()), _bits(want.detach()))
    for a, e in zip(got_g, want_g):
        assert torch.equal(_bits(a), _bits(e))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    return torch.device("cuda")


def _levels(y, n):
    return torch.round(y * n).to(torch.int32)


def _float64_levels(x, b, g, beta, n):
    t = x.double() + b.double()
    mu = t.mean(dim=(1, 2), keepdim=True)
    var = t.var(dim=(1, 2), keepdim=True, correction=0)
    y = ((t - mu) / torch.sqrt(var + 1e-5) * g.double() + beta.double())
    return torch.round(y.clamp(0, 1) * n).to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1024, *s) for s in SVHN20]
                         + [(8, *s) for s in ALEXNET]
                         + [(2, *TWO_PASS), (64, 1, 1, 160), (16, 1, 1, 4096),
                            (6, 5, 7, 10), (5, 3, 3, 6)])
def test_kernel_matches_plain_on_card(cuda_device, shape):
    x, b, g, beta = _inputs(shape, shape[3] + shape[1],
                            cuda_device)
    n = (1 << W1A4.a_bits) - 1
    plan = N.plan_for(*shape[1:])
    counters = dict(TRACER.counters)
    _lib.reset_launches()
    got = N.norm_act(x, g, beta, b, W1A4.a_bits)
    clip = N.norm_act(x, g, beta, b, 32)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES[N.NAME] == 2
    key = f"kernels.norm_act.{plan.path}"
    assert TRACER.counters.get(key, 0) - counters.get(key, 0) == 2
    ref = N.norm_act_plain(x, g, beta, b, W1A4.a_bits)
    ref_clip = N.norm_act_plain(x, g, beta, b, 32)
    # the quantizing form, by levels
    lv, lv_ref = _levels(got, n), _levels(ref, n)
    diff = (lv - lv_ref).abs()
    # where the levels agree so do the bits, which the next layer's pool
    # reads (the eager ops' float32 reciprocal of n)
    assert torch.equal(_bits(got[diff == 0]), _bits(ref[diff == 0]))
    assert int(diff.max()) <= 1
    assert float((diff != 0).float().mean()) <= 1e-4
    lv64 = _float64_levels(x, b, g, beta, n)
    flips = float((lv != lv64).float().mean())
    flips_plain = float((lv_ref != lv64).float().mean())
    assert flips <= flips_plain + 1e-5
    # the clip-only form: the kernel no farther from a float64 norm than
    # twice the plain version
    t = x.double() + b.double()
    y64 = ((t - t.mean(dim=(1, 2), keepdim=True))
           / torch.sqrt(t.var(dim=(1, 2), keepdim=True, correction=0) + 1e-5)
           * g.double() + beta.double()).clamp(0, 1)
    err = float((clip.double() - y64).abs().max())
    err_plain = float((ref_clip.double() - y64).abs().max())
    assert err <= 2 * err_plain + 1e-7
    assert torch.equal(clip.clamp(0, 1), clip)


def _exact_inputs(shape, kmax, seed, device):
    """Inputs whose statistics sum exactly in any order: small integers
    times a power of two a channel (a map of a power-of-two H x W), bias
    too, so both sides see the same mean and variance."""
    rs = np.random.RandomState(seed)
    b, h, w, c = shape
    scale = 2.0 ** rs.randint(-3, 4, c)
    x = rs.randint(0, kmax + 1, shape) * scale
    bias = rs.randint(0, 4, c) * scale
    g = rs.uniform(-0.3, 0.3, c)
    beta = rs.uniform(0.3, 0.7, c)
    return [torch.from_numpy(np.asarray(v, np.float32)).to(device)
            for v in (x, bias, g, beta)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kmax", [((512, 8, 8, 20), 3),
                                        ((64, 16, 16, 256), 1)])
def test_kernel_rounds_as_the_eager_ops_given_the_same_statistics(
        cuda_device, shape, kmax):
    """With exact statistics the kernel's output is the eager ops' on the
    card bit for bit: ``torch.rsqrt``, the apply's order, the clamp and
    the quantizer, whose ``/ n`` by a Python number multiplies by the
    float32 reciprocal there (the levels are a true division's; their
    bits, which a 2x2 average pool's ties in the next layer read, are
    not).  (64, 16, 16, 256) is a cluster of 2."""
    x, b, g, beta = _exact_inputs(shape, kmax, shape[3], cuda_device)
    t = x + b
    t64 = t.double()
    n_pos = shape[1] * shape[2]        # a power of two: exact divisions
    mu = t64.sum(dim=(1, 2), keepdim=True) / n_pos
    var = ((t64 - mu) ** 2).sum(dim=(1, 2), keepdim=True) / n_pos
    mu32, var32 = mu.float(), var.float()
    assert torch.equal(mu32.double(), mu) and torch.equal(var32.double(), var)
    y = (((t - mu32) * torch.rsqrt(var32 + 1e-5)) * g + beta).clamp(0, 1)
    n = 15
    q = torch.round(y * n) / n
    assert torch.equal(_bits(N.norm_act(x, g, beta, b, 32)), _bits(y))
    assert torch.equal(_bits(N.norm_act(x, g, beta, b, 4)), _bits(q))


@pytest.mark.gpu
def test_kernel_device_ops_and_refused_plans(cuda_device):
    """One device operation a resident call, two on the two-pass path; the
    C launcher refuses a plan it does not lay out."""
    import ctypes

    x, b, g, beta = _inputs((8, 40, 40, 40), 0, cuda_device)
    assert _lib.count_device_ops(lambda: N.norm_act(x, g, beta, b, 4)) == 1
    big = _inputs((2, *TWO_PASS), 1, cuda_device)
    assert _lib.count_device_ops(
        lambda: N.norm_act(big[0], big[2], big[3], big[1], 4)) == 2
    plan = N.plan_for(40, 40, 40)
    out = torch.empty_like(x)
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    launch = _lib.launcher(N.NAME, [p] * 6 + [ll] * 3 + [i] * 7 + [f, p])
    stream = torch.cuda.current_stream().cuda_stream

    def call(pl, groups=8):
        return launch(x.data_ptr(), b.data_ptr(), g.data_ptr(),
                      beta.data_ptr(), out.data_ptr(), None, 8, 64000,
                      groups, 40, pl.vec, pl.threads, pl.chunks,
                      pl.chunk_vec, 0, pl.smem_bytes, 15.0, stream)

    for bad in (plan._replace(smem_bytes=plan.smem_bytes + 16),
                plan._replace(threads=plan.threads - 1),
                plan._replace(chunks=plan.chunks - 1),
                plan._replace(chunk_vec=plan.chunk_vec + 1)):
        assert call(bad) != 0
    assert call(plan, groups=0) != 0 and call(plan, groups=9) != 0
    assert call(plan, groups=3) == 0   # fewer clusters: more samples each
    torch.cuda.synchronize()
    assert torch.equal(out, N.norm_act(x, g, beta, b, 4))
    assert call(plan) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, N.norm_act(x, g, beta, b, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("hwc", [(10, 10, 80), (40, 40, 40), TWO_PASS])
def test_a_samples_output_does_not_depend_on_its_batch(cuda_device, hwc):
    """A sample's statistics sum in an order fixed by its map's plan
    alone, so its output is the same bit for bit alone, in a batch and at
    another row of it: the serving engines' replicas and retries, which
    regroup requests, rely on it."""
    x, b, g, beta = _inputs((24, *hwc), hwc[2], cuda_device)
    full = N.norm_act(x, g, beta, b, W1A4.a_bits)
    alone = N.norm_act(x[5:6].contiguous(), g, beta, b, W1A4.a_bits)
    moved = N.norm_act(x.flip(0).contiguous(), g, beta, b, W1A4.a_bits)
    torch.cuda.synchronize()
    assert torch.equal(_bits(alone[0]), _bits(full[5]))
    assert torch.equal(_bits(moved.flip(0)), _bits(full))


@pytest.mark.gpu
def test_svhn_forward_counts_a_resident_norm_a_hidden_layer(cuda_device):
    """The benchmark's svhn net at batch 1024: 7 norm_act launches a
    forward, every one on the resident path."""
    from repro_torch import api
    from repro_torch.configs.paper_cnn import SVHN_SPEC

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    compiled = api.build(SVHN_SPEC, W1A4,
                         params=cnn.init_cnn(gen, SVHN_SPEC)).compile(
        target="cuda", batch_hints=(1024,))
    x = torch.rand((1024, 40, 40, 3), generator=gen, device=cuda_device)
    compiled.forward(x)
    counters = dict(TRACER.counters)
    _lib.reset_launches()
    compiled.forward(x)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES[N.NAME] == 7
    moved = {k: v - counters.get(k, 0) for k, v in TRACER.counters.items()
             if k.startswith("kernels.norm_act.")}
    assert {k: v for k, v in moved.items() if v} == {
        "kernels.norm_act.resident": 7}
