"""A whole run on the CPU, past the harness's look for a card, at a small
size: sound it is correct; with the timed path broken underneath it is
not, once for each fault the cells can have."""
import pytest
import torch

from chipbench import bench
from chipbench.reference import svhn_cnn
from chipbench.run import load_cell

SMALL = dict(channels=8, img_hw=16)
BULK, FAITHFUL = "svhn20-w1a4.bulk1024", "svhn20-w1a4-faithful.bulk1024"


def _run(name, chips=1, seconds=0.5, trace=False):
    w, cfg, traffic, metrics = load_cell(name)
    traffic = dict(traffic, clients=16 * chips, max_batch=8 * chips)
    cell = bench.Cell(w["name"], dict(cfg, **SMALL), traffic, chips, metrics,
                      check_forwards=3, check_rows=4)
    return bench.run(cell, seed=2**31 + 3, seconds=seconds, trace=trace,
                     devices=["cpu"] * chips, t_process=0.0)


@pytest.mark.parametrize("name,chips", [(BULK, 1), (FAITHFUL, 1), (BULK, 4)])
def test_a_sound_run_is_correct(name, chips):
    res = _run(name, chips)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"images_per_s", "p95_ms", "setup_s"}
    assert list(res)[-1] == "check"


def test_a_traced_run_reports_the_host_spans():
    res = _run(BULK, 4, trace=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"engine.service_p50_ms", "executor.host_ms"}


def _alter_one_answer(monkeypatch):
    """An answer altered where it is produced: one logit of each forward's
    first row moved (every answer of a kept forward is compared)."""
    from repro_torch.launch import engine

    orig = engine.CNNRunner.forward

    def forward(self, x, key=None):
        out = orig(self, x, key).clone()
        out[0, 0] += 1.0
        return out

    monkeypatch.setattr(engine.CNNRunner, "forward", forward)


def _swap_rows(monkeypatch):
    """Answers handed to the wrong requests: each forward's rows reversed."""
    from repro_torch.launch import engine

    orig = engine.CNNRunner.forward
    monkeypatch.setattr(engine.CNNRunner, "forward",
                        lambda self, x, key=None: orig(self, x, key).flip(0))


def _tf32_first_layer(monkeypatch):
    """The float layers' operands in TF32 (what allowing TF32 does)."""
    from repro_torch.core import conv_lowering

    orig = conv_lowering.conv2d_float
    monkeypatch.setattr(
        conv_lowering, "conv2d_float",
        lambda x, w, **kw: orig(svhn_cnn.tf32_round(x),
                                svhn_cnn.tf32_round(w), **kw))


def _drop_exchange(monkeypatch):
    """The exchange between cards left out: every replica's rows answered
    from the first replica's output."""
    from repro_torch.distributed import sharding

    orig = sharding.data_parallel

    def data_parallel(fn, mesh):
        run = orig(fn, mesh)

        def first_only(replicas, batch, *args):
            out = run(replicas, batch, *args)
            n = out.shape[0] // len(mesh)
            return out[:n].repeat(len(mesh), 1)
        return first_only

    monkeypatch.setattr(sharding, "data_parallel", data_parallel)


def _half_the_batch(monkeypatch):
    """Half of each bucket left out of every quantized layer: its second
    half's rows take the first half's outputs."""
    from repro_torch.core import conv_lowering

    orig = conv_lowering.quant_conv2d_pre

    def half(h, *args, **kwargs):
        out = orig(h, *args, **kwargs).clone()
        n = out.shape[0] // 2
        out[n:2 * n] = out[:n]
        return out

    monkeypatch.setattr(conv_lowering, "quant_conv2d_pre", half)


def _lose_a_request(monkeypatch):
    """A request that never gets its answer."""
    from repro_torch.launch import engine

    orig = engine.ServeEngine.drain

    def drain(self):
        out = orig(self)
        return out[1:]

    monkeypatch.setattr(engine.ServeEngine, "drain", drain)


@pytest.mark.parametrize("fault", [_alter_one_answer, _swap_rows,
                                   _tf32_first_layer, _half_the_batch,
                                   _lose_a_request])
@pytest.mark.parametrize("name", [BULK, FAITHFUL])
def test_a_broken_path_is_not_correct(monkeypatch, fault, name):
    fault(monkeypatch)
    res = _run(name)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("name", [BULK, FAITHFUL])
def test_the_whole_chain_sees_rows_the_layer_check_does_not(monkeypatch,
                                                            name):
    """Half of each bucket wrong: the kept block of rows may lie in the
    sound half, but the chain from the images reads every row."""
    _half_the_batch(monkeypatch)
    res = _run(name)
    chain = res["check"]["chain_flips"]
    assert chain["value"] > chain["limit"], res["check"]


@pytest.mark.parametrize("fault", [_alter_one_answer, _swap_rows,
                                   _drop_exchange])
def test_a_broken_replica_path_is_not_correct(monkeypatch, fault):
    """The harness's data-parallel path (a cell of four cards), here four
    replicas on the CPU."""
    fault(monkeypatch)
    res = _run(BULK, 4)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**64 + 9])
def test_inputs_come_from_the_seed(seed):
    from chipbench import inputs

    layers = svhn_cnn.network(dict(load_cell(BULK)[1], **SMALL))

    def draw(s):
        gen = inputs.generator(s, "cpu")
        return inputs.draw_params(layers, gen), inputs.draw_pool(4, 16, 3, gen)

    (p1, x1), (p2, x2), (p3, x3) = draw(seed), draw(seed), draw(seed + 1)
    assert torch.equal(x1, x2) and not torch.equal(x1, x3)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(p1, p2) for k in a)
    assert 0.0 <= float(x1.min()) and float(x1.max()) <= 1.0
    assert [tuple(p["w"].shape) for p in p1] == [
        (l.k, l.k, l.cin, l.cout) for l in layers]
