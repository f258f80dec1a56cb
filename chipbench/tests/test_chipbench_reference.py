"""The plain reference against the program's plain CPU path, and the
control against the limits, at sizes a test run holds."""
import numpy as np
import pytest
import torch

from chipbench import bench, check, control, inputs
from chipbench.reference import svhn_cnn
from chipbench.run import load_cell

SMALL = dict(channels=8, img_hw=16)
BULK, FAITHFUL = "svhn20-w1a4.bulk1024", "svhn20-w1a4-faithful.bulk1024"


def _cell(name=BULK, check_forwards=check.FORWARDS, check_rows=check.ROWS,
          **traffic):
    w, cfg, t, _ = load_cell(name)
    return bench.Cell(w["name"], dict(cfg, **SMALL), dict(t, **traffic),
                      w["chips"], [], check_forwards=check_forwards,
                      check_rows=check_rows)


def _program_states(cfg, params, x):
    """The program's hidden outputs and logits on the CPU (the kernels'
    plain versions), through the served executor."""
    from repro_torch.core.plan import plan_forward

    layers = svhn_cnn.network(cfg)
    plan = bench_compile(cfg, params, layers, x.shape[0])
    cap = check.Capture(np.random.default_rng(0), 1, x.shape[0],
                        cfg["a_bits"])
    cap.keep_all = True
    with check.observe_layers(cap):
        cap.begin(x)
        logits = plan_forward(plan, x)
        cap.end()
    return cap.kept[0], logits


def bench_compile(cfg, params, layers, batch):
    from repro_torch.core.plan import compile_model

    return compile_model(params, bench.program_spec(cfg, layers),
                         bench.quant_config(cfg), target="cuda",
                         batch_hints=(batch,), img_hw=cfg["img_hw"])


@pytest.mark.parametrize("name", [BULK, FAITHFUL])
@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_reference_matches_the_programs_cpu_path(name, seed):
    cfg = _cell(name).config
    gen = inputs.generator(seed, "cpu")
    params = inputs.draw_params(svhn_cnn.network(cfg), gen)
    x = inputs.draw_pool(6, cfg["img_hw"], 3, gen)
    kept, logits = _program_states(cfg, params, x)
    kept.update(pool_idx=torch.arange(6), served=logits)
    assert kept["rows"] == slice(0, 6) and kept["x"] is x
    got = check.compare(svhn_cnn, params, cfg, [kept], x)
    assert got["unmatched"] == 0 and len(got["flips_by_layer"]) == 7
    got["missing"] = 0
    assert check.verdict(got, cfg["limits"]), got
    with svhn_cnn.no_tf32():
        ref_logits = svhn_cnn.forward(params, x, cfg)
    assert (logits.argmax(1) == ref_logits.argmax(1)).float().mean() >= 0.8


def test_logits_depend_on_the_image():
    cfg = _cell().config
    gen = inputs.generator(5, "cpu")
    params = inputs.draw_params(svhn_cnn.network(cfg), gen)
    x = inputs.draw_pool(8, cfg["img_hw"], 3, gen)
    with svhn_cnn.no_tf32():
        logits = svhn_cnn.forward(params, x, cfg)
    scale = logits.abs().max()
    for i in range(1, 8):
        assert float((logits[i] - logits[0]).abs().max() / scale) > 1e-3


def test_the_full_size_logits_depend_on_the_image():
    """At the cell's width the last layers still see 10x10 maps."""
    cfg = load_cell(BULK)[1]
    gen = inputs.generator(7, "cpu")
    params = inputs.draw_params(svhn_cnn.network(cfg), gen)
    x = inputs.draw_pool(2, cfg["img_hw"], 3, gen)
    with svhn_cnn.no_tf32():
        hidden, logits = svhn_cnn.states(params, x, cfg)
    assert hidden[-1].shape[1:3] == (10, 10)
    assert float((logits[1] - logits[0]).abs().max()
                 / logits.abs().max()) > 1e-3


def test_tf32_round_keeps_ten_mantissa_bits_to_nearest_even():
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp / 2, 1.0 + 1.5 * ulp, 1.0 + 0.75 * ulp,
                      -(1.0 + 0.25 * ulp), 3.0], dtype=torch.float32)
    got = svhn_cnn.tf32_round(x)
    want = [1.0, 1.0 + 2 * ulp, 1.0 + ulp, -1.0, 3.0]
    assert got.tolist() == want
    assert svhn_cnn.tf32_round(one).tolist() == [1.0]


def test_weight_levels_of_one_and_two_bits():
    w = torch.tensor([[-0.5, 0.25], [0.0, 1.0]])
    lv, scale, zero = svhn_cnn.weight_levels(w, 1)
    assert lv.tolist() == [[0.0, 1.0], [1.0, 1.0]] and zero == 0.5
    assert scale == pytest.approx(2 * 0.4375)
    lv2, scale2, zero2 = svhn_cnn.weight_levels(w, 2)
    assert lv2.min() >= 0 and lv2.max() <= 3 and zero2 == 1.5
    assert scale2 == pytest.approx(2 / 3)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_the_limits_at_a_small_size(seed):
    """The TF32 control, in the program's place, reads above the level
    limit: the float first layer's levels flip."""
    cell = _cell(clients=64, max_batch=32, check_rows=16, check_forwards=2)
    got = control.control_numbers(cell, seed, torch.device("cpu"))
    limits = cell.config["limits"]
    assert got["level_flips"] > 3 * limits["level_flips"]
    assert not check.verdict(got, limits)
    assert got["flips_by_layer"][0] == got["level_flips"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", [BULK, FAITHFUL])
def test_control_fails_the_limits_at_the_cells_size(card, name):
    w, cfg, traffic, _ = load_cell(name)
    cell = bench.Cell(w["name"], cfg, traffic, w["chips"], [])
    for seed in (101, 102, 103):
        got = control.control_numbers(cell, seed, card)
        assert not check.verdict(got, cfg["limits"]), got
