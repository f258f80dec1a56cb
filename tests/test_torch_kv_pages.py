"""The port's paged KV allocator and continuous-batching engine
(``repro_torch.core.kv_pages``, ``repro_torch.launch.engine``) held to the
reference's contracts (``tests/test_kv_pages.py``).

Allocator: every reference ``PagePool`` test, run on the port's copy.
Engine: backpressure, pool exhaustion, page release, deadlines, the
three-program bound, continuous equal to alone bit for bit inside the
port, and greedy tokens equal to the reference engine's on the same
requests (smoke geometry with the full model's GQA group of 3, W1A8, f32).
The continuous paths here run the attention kernels' plain versions (CPU
tensors); ``tests/test_torch_gpu.py`` holds the kernels against them on
the card.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.quant import PAPER_CONFIGS as JPAPER  # noqa: E402
from repro.launch.engine import ContinuousLMEngine as JContinuous  # noqa: E402
from repro.models.layers import prequantize_params as jprequant  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.kv_pages import (PagePool, PoolExhausted,  # noqa: E402
                                       pages_needed)
from repro_torch.core.quant import PAPER_CONFIGS  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.launch.engine import (ContinuousLMEngine,  # noqa: E402
                                       QueueFull, run_offered_load,
                                       warm_engine)

GEOM = dict(n_layers=2, d_model=64, n_heads=3, n_kv_heads=1, d_ff=128,
            vocab=64, head_dim=32)


# ---------------------------------------------------------------------------
# pages_needed and PagePool (the reference's allocator tests, on the port)
# ---------------------------------------------------------------------------

def test_pages_needed_ragged():
    assert pages_needed(0, 16) == 0
    assert pages_needed(-3, 16) == 0
    assert pages_needed(1, 16) == 1
    assert pages_needed(16, 16) == 1
    assert pages_needed(17, 16) == 2
    assert pages_needed(33, 16) == 3


def test_pool_exhaustion_allocates_nothing():
    p = PagePool(4, 16)
    got = p.alloc(3)
    with pytest.raises(PoolExhausted):
        p.alloc(2)
    assert p.free_pages == 1
    assert p.stats()["allocs"] == 3
    p.free(got)
    assert p.free_pages == 4 and p.used_pages == 0


def test_pool_free_rejects_foreign_and_double():
    p = PagePool(4, 16)
    got = p.alloc(2)
    with pytest.raises(ValueError):
        p.free([got[0], 99])
    assert p.used_pages == 2
    p.free(got)
    with pytest.raises(ValueError):
        p.free([got[0]])
    with pytest.raises(ValueError):
        p.free([p.null_page])


def test_pool_fifo_reuse_order():
    p = PagePool(6, 8)
    a = p.alloc(3)
    b = p.alloc(3)
    p.free(b)
    p.free(a)
    assert p.alloc(6) == b + a


def test_pool_stats_and_capacity():
    p = PagePool(8, 4)
    assert p.capacity_tokens() == 32 and p.null_page == 8
    assert p.can_fit(32) and not p.can_fit(33)
    got = p.alloc(5)
    st = p.stats()
    assert st["used_pages"] == 5 and st["high_water"] == 5
    p.free(got[:2])
    p.alloc(1)
    assert p.stats()["high_water"] == 5


def test_pool_snapshot_restore_roundtrip_preserves_order():
    p = PagePool(6, 8)
    a = p.alloc(2)
    p.alloc(2)
    p.free(a)
    snap = p.snapshot()
    q = PagePool(6, 8)
    q.alloc(6)
    q.restore(snap)
    assert q.used_pages == p.used_pages == 2
    assert q.alloc(4) == p.alloc(4)
    with pytest.raises(ValueError):
        PagePool(6, 4).restore(snap)
    with pytest.raises(ValueError):
        PagePool(8, 8).restore(snap)


@pytest.mark.parametrize("num_pages,page_size", [(0, 4), (4, 0), (-1, 2)])
def test_pool_rejects_empty_geometry(num_pages, page_size):
    with pytest.raises(ValueError):
        PagePool(num_pages, page_size)


def test_pool_alloc_rejects_negative():
    with pytest.raises(ValueError):
        PagePool(4, 4).alloc(-1)


# ---------------------------------------------------------------------------
# ContinuousLMEngine
# ---------------------------------------------------------------------------

def _numpy_params(seed: int = 0) -> dict:
    """Random LM params in the reference's layout (init_lm's shapes and
    scales), drawn with numpy: drawing through jax.random costs seconds."""
    rs = np.random.RandomState(seed)
    L, d, hd = GEOM["n_layers"], GEOM["d_model"], GEOM["head_dim"]
    h, hk, ff = GEOM["n_heads"], GEOM["n_kv_heads"], GEOM["d_ff"]

    def w(*shape):
        return (rs.randn(*shape) / math.sqrt(shape[-2])).astype(np.float32)

    ones = lambda *s: np.ones(s, np.float32)  # noqa: E731
    return {"embed": (rs.randn(256, d) * 0.02).astype(np.float32),
            "final_norm": ones(d),
            "blocks": {"attn": {
                "attn": {"ln": ones(L, d), "wq": w(L, d, h * hd),
                         "wk": w(L, d, hk * hd), "wv": w(L, d, hk * hd),
                         "wo": w(L, h * hd, d)},
                "mlp": {"ln": ones(L, d), "w_in": w(L, d, ff),
                        "w_gate": w(L, d, ff), "w_out": w(L, ff, d)}}}}


@pytest.fixture(scope="module")
def lm():
    jcfg = dataclasses.replace(jget_config("smollm-360m").smoke(**GEOM),
                               quant=JPAPER["w1a8"])
    cfg = dataclasses.replace(get_config("smollm-360m").smoke(**GEOM),
                              quant=PAPER_CONFIGS["w1a8"])
    jp = jprequant(jax.tree.map(jnp.asarray, _numpy_params()), jcfg)
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                          device="cpu")
    return dict(cfg=cfg, params=params, jcfg=jcfg, jparams=jp)


def _engine(lm, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("num_pages", 16)
    kw.setdefault("max_seq", 16)
    return ContinuousLMEngine(lm["params"], lm["cfg"], **kw)


def _payloads(n, seed=0, lens=(3, 5, 8), gens=(2, 4, 6)):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, GEOM["vocab"], rng.choice(lens)).astype(np.int32),
             int(rng.choice(gens))) for _ in range(n)]


def test_submit_rejects_impossible_requests(lm):
    eng = _engine(lm)
    with pytest.raises(ValueError):
        eng.submit((np.arange(15, dtype=np.int32), 4))
    with pytest.raises(ValueError):
        eng.submit((np.asarray([1], np.int32), 0))
    with pytest.raises(ValueError):
        eng.submit((np.zeros(0, np.int32), 4))


def test_queue_full_at_max_pending(lm):
    eng = _engine(lm, max_pending=2)
    eng.submit((np.asarray([1, 2], np.int32), 2))
    eng.submit((np.asarray([3], np.int32), 2))
    with pytest.raises(QueueFull):
        eng.submit((np.asarray([4], np.int32), 2))
    assert len(eng.drain()) == 2


def test_pool_exhaustion_defers_admission_then_completes(lm):
    eng = _engine(lm, num_slots=2, num_pages=4, max_seq=16)
    res = eng.serve([(np.arange(1, 9, dtype=np.int32), 8),
                     (np.arange(1, 9, dtype=np.int32), 8)])
    assert len(res) == 2 and all(len(r.value) == 8 for r in res)
    assert eng.pool.used_pages == 0
    st = eng.pool.stats()
    assert st["allocs"] == st["frees"] == 8
    assert st["high_water"] == 4


def test_pages_released_on_retirement(lm):
    eng = _engine(lm)
    eng.serve(_payloads(6))
    assert eng.pool.used_pages == 0
    assert eng.pool.stats()["allocs"] == eng.pool.stats()["frees"] > 0
    assert (eng._table == eng.pool.null_page).all()


def test_pages_released_on_dead_letter(lm):
    t = [0.0]
    eng = _engine(lm, deadline_s=1.0, clock=lambda: t[0])
    eng.submit((np.asarray([1, 2, 3], np.int32), 12), t_submit=0.0)
    eng.pump()
    assert eng._slots[0] is not None
    t[0] = 2.0
    eng.pump()
    assert eng._slots[0] is None and eng.pool.used_pages == 0
    assert eng.dead_letters[0]["reason"] == "deadline"
    assert len(eng.dead_letters[0]["emitted"]) >= 1
    assert eng.stats["dead_lettered"] == 1


def test_continuous_bit_identical_to_alone(lm):
    """Join/leave between steps is invisible: each request's tokens equal
    running it alone through the same engine class, bit for bit."""
    payloads = _payloads(8, seed=3)
    batched = _engine(lm, num_slots=3, num_pages=16).serve(payloads)
    alone = _engine(lm, num_slots=3, num_pages=16)
    for p, r in zip(payloads, batched):
        [ref] = alone.serve([p])
        np.testing.assert_array_equal(r.value, ref.value)


def test_program_count_bounded_under_mixed_replay(lm):
    eng = _engine(lm, num_slots=2, num_pages=16)
    res = eng.serve(_payloads(24, seed=7))
    assert len(res) == 24
    assert eng.program_shapes == {
        ("reset",), ("run", 1, eng.chunk), ("run", eng.num_slots, 1)}


@pytest.mark.parametrize("seed", [5, 11])
def test_continuous_tokens_equal_reference_engine(lm, seed):
    """The port's continuous engine gives the reference engine's greedy
    tokens on the same requests (same params, levels carried across)."""
    payloads = _payloads(6, seed=seed)
    ref = JContinuous(lm["jparams"], lm["jcfg"], num_slots=2, page_size=4,
                      num_pages=16, max_seq=16).serve(payloads)
    got = _engine(lm).serve(payloads)
    assert [r.rid for r in got] == [r.rid for r in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.value, np.asarray(b.value))


def test_continuous_forces_row_scales_and_records_margins(lm):
    eng = _engine(lm, record_margins=True)
    assert eng.cfg.quant.act_scale_mode == "row"
    assert lm["cfg"].quant.act_scale_mode == "tensor"
    [r] = eng.serve([(np.asarray([3, 1, 4, 1, 5], np.int32), 4)])
    assert r.margins.shape == (4,) and (r.margins >= 0).all()


def test_reference_flag_is_the_same_path_on_cpu(lm):
    payloads = _payloads(4, seed=2)
    a = _engine(lm).serve(payloads)
    b = _engine(lm, reference=True).serve(payloads)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.value, y.value)


def test_cpu_engine_launches_no_kernel(lm):
    _lib.reset_launches()
    _engine(lm).serve(_payloads(3, seed=1))
    assert _lib.LAUNCHES["attn_paged"] == 0


@pytest.mark.parametrize("kw", [dict(checkpoint_dir="/nonexistent"),
                                dict(faults=object())])
def test_checkpoint_and_faults_not_yet_ported(lm, kw):
    with pytest.raises(NotImplementedError):
        _engine(lm, **kw)


def test_offered_load_harness_counts_every_request(lm):
    payloads = _payloads(5, seed=9)
    eng = warm_engine(_engine(lm), payloads)
    row = run_offered_load(eng, payloads, None)
    assert row["n_requests"] == 5 and row["offered_rps"] == "inf"
    assert row["achieved_rps"] > 0 and row["p99_ms"] >= row["p50_ms"]
