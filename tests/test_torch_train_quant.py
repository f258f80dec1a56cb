"""The port's straight-through quantizers held against the reference's
gradients (``jax.grad``, jitted) on the CPU.

* the straight-through gradients of ``quantize_activation`` (inputs on
  the clip bounds 0 and 1 included: ``jax.grad`` of ``jnp.clip`` gives
  0.5 there, ``torch.clamp`` 1), ``quantize_weight`` at 1 and 2 bits
  (the k-bit form differentiates through ``max|tanh w|``) and
  ``fake_quant_act_signed``: equal to the reference's within 1e-6 x
  max|g| (the k-bit weight's ``tanh`` differs by ulps, Queue C), where
  the port before its straight-through repair gave zeros (through
  ``torch.round``) or a wrong gradient (through ``mean|w|``);
* ``quantize_gradient``'s noise-free backward equal to the reference's
  bit for bit; its noisy backward on at most 2^b levels and unbiased over
  seeds;
* forward values unchanged: equal to the serve forms bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jquant  # noqa: E402
from repro_torch.core import quant  # noqa: E402

from test_torch_train_cnn import one_torch_thread  # noqa: E402,F401

GRAD_TOL = 1e-6   # x max|g|


def _draw(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _port_grad(fn, x: np.ndarray, cot: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(x.copy()).requires_grad_()
    (g,) = torch.autograd.grad(fn(t), t, torch.from_numpy(cot))
    return g.numpy()


def _ref_grad(fn, x: np.ndarray, cot: np.ndarray) -> np.ndarray:
    f = jax.jit(lambda a, c: jax.grad(lambda z: jnp.sum(fn(z) * c))(a))
    return np.asarray(f(x, cot))


def _assert_grad_close(got, ref):
    tol = GRAD_TOL * max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def _act_input(seed):
    """Activations around [0, 1], a row of them exactly on the bounds."""
    x = _draw((6, 40), seed, 0.6) + 0.5
    x[0, :10] = 0.0
    x[0, 10:20] = 1.0
    return x


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_quantize_activation_gradient_equals_reference(bits):
    x = _act_input(bits)
    cot = _draw(x.shape, 100 + bits)
    got = _port_grad(lambda t: quant.quantize_activation(t, bits), x, cot)
    ref = _ref_grad(lambda z: jquant.quantize_activation(z, bits), x, cot)
    np.testing.assert_array_equal(got, ref)
    # the bounds take half the gradient, as jax.grad of jnp.clip gives
    np.testing.assert_array_equal(got[0, :20], 0.5 * cot[0, :20])


def test_clip01_bounds_take_half_the_gradient():
    x = np.array([-0.5, 0.0, 0.25, 1.0, 1.5], np.float32)
    cot = np.ones_like(x)
    got = _port_grad(quant.clip01, x, cot)
    ref = _ref_grad(lambda z: jnp.clip(z, 0.0, 1.0), x, cot)
    np.testing.assert_array_equal(got, [0.0, 0.5, 1.0, 0.5, 0.0])
    np.testing.assert_array_equal(got, ref)
    # torch.clamp alone gives the full gradient on the bounds
    t = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(torch.clamp(t, 0.0, 1.0).sum(), t)
    np.testing.assert_array_equal(g.numpy(), [0.0, 1.0, 1.0, 1.0, 0.0])


@pytest.mark.parametrize("bits", [1, 2])
def test_quantize_weight_gradient_equals_reference(bits):
    w = _draw((3, 3, 8, 16), 7 + bits, 0.3)
    w.reshape(-1)[5] = 0.0                  # sign and abs at zero
    cot = _draw(w.shape, 50 + bits)
    got = _port_grad(lambda t: quant.quantize_weight(t, bits), w, cot)
    ref = _ref_grad(lambda z: jquant.quantize_weight(z, bits), w, cot)
    _assert_grad_close(got, ref)
    if bits == 1:       # the straight-through identity, exactly
        np.testing.assert_array_equal(got, cot)


@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_act_signed_gradient_equals_reference(bits):
    a = _draw((4, 7, 32), 3 + bits)
    cot = _draw(a.shape, 9 + bits)
    got = _port_grad(lambda t: quant.fake_quant_act_signed(t, bits), a, cot)
    ref = _ref_grad(lambda z: jquant.fake_quant_act_signed(z, bits), a, cot)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, cot)


@pytest.mark.parametrize("which", ["ste", "quantize_k", "signed_scale"])
def test_without_the_gradient_cut_the_gradient_is_wrong(which):
    """What the repair fixed: the old forms' gradients (through
    ``torch.round``, through the signed absmax scale) are not the
    reference's."""
    x = _act_input(1)
    cot = _draw(x.shape, 2)
    if which == "signed_scale":
        def old(t):
            s = torch.max(torch.abs(t)) / 8.0 + 1e-12
            q = (torch.clamp(torch.round(t / s) + 8.0, 0, 15) - 8.0) * s
            return q
        ref = _ref_grad(lambda z: jquant.fake_quant_act_signed(z, 4), x, cot)
    else:
        def old(t):
            q = torch.round(torch.clamp(t, 0.0, 1.0) * 15) / 15
            return t + (q - t) if which == "ste" else q
        ref = _ref_grad(lambda z: jquant.quantize_activation(z, 4), x, cot)
    got = _port_grad(old, x, cot)
    assert not np.allclose(got, ref)
    if which != "signed_scale":
        assert not np.any(got)              # zeros through torch.round


def test_quantize_gradient_noise_free_backward_bit_identical():
    g = _draw((8, 5, 5, 16), 11, 1e-3)
    x = _draw(g.shape, 12)
    got = _port_grad(lambda t: quant.quantize_gradient(t, 8), x, g)
    f = jax.jit(lambda a, c: jax.vjp(
        lambda z: jquant.quantize_gradient(z, 8), a)[1](c)[0])
    ref = np.asarray(f(x, g))
    np.testing.assert_array_equal(got, ref)
    # identity forward
    t = torch.from_numpy(x)
    assert torch.equal(quant.quantize_gradient(t, 8), t)


@pytest.mark.parametrize("bits", [2, 4])
def test_quantize_gradient_noisy_on_levels_and_unbiased(bits):
    g = _draw((64, 64), 13, 0.01)
    gt = torch.from_numpy(g)
    mx = 2.0 * np.abs(g).max() + 1e-12
    n = (1 << bits) - 1
    outs = []
    for seed in range(200):
        gen = torch.Generator().manual_seed(seed)
        q = quant.quantize_gradient_values(gt, bits, gen).numpy()
        levels = (q / mx + 0.5) * n
        assert len(np.unique(np.round(levels, 3))) <= 1 << bits
        np.testing.assert_allclose(levels, np.round(levels), atol=1e-3)
        outs.append(q)
    # stochastic rounding is unbiased: the mean over seeds approaches g
    # (one level is mx / n; 200 draws bring the error to ~level / 28)
    err = np.abs(np.mean(outs, axis=0) - g).mean()
    assert err < 0.1 * mx / n
    # the noise-free form is biased by up to half a level, the mean of the
    # noisy one is not
    det = quant.quantize_gradient_values(gt, bits).numpy()
    assert err < 0.5 * np.abs(det - g).mean()


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_forward_values_unchanged(bits):
    x = _act_input(bits)
    n = (1 << bits) - 1
    t = torch.from_numpy(x)
    q = torch.round(torch.clamp(t, 0.0, 1.0) * n) / n
    assert torch.equal(quant.quantize_activation(t, bits), q)
    lv, _ = quant.activation_levels(t, bits)
    assert torch.equal(quant.quantize_activation(t, bits), lv.float() / n)
    w = torch.from_numpy(_draw((3, 3, 4, 8), bits, 0.3))
    qw = quant.quantize_weight(w, min(bits, 2))
    if bits == 1:
        alpha = torch.mean(torch.abs(w), dtype=torch.float64).float()
        q1 = torch.where(w >= 0, alpha, -alpha)
        assert torch.equal(qw, w + (q1 - w))
    # the train form under autograd computes the same values
    wg = w.clone().requires_grad_()
    assert torch.equal(quant.quantize_weight(wg, min(bits, 2)).detach(), qw)
    a = torch.from_numpy(_draw((4, 32), bits))
    ag = a.clone().requires_grad_()
    assert torch.equal(quant.fake_quant_act_signed(ag, 8).detach(),
                       quant.fake_quant_act_signed(a, 8))
    np.testing.assert_array_equal(
        quant.fake_quant_act_signed(a, 8).numpy(),
        np.asarray(jax.jit(lambda z: jquant.fake_quant_act_signed(z, 8))(
            a.numpy())))
