"""The port's dense, MoE and recurrent architectures (phi3-mini, yi, qwen3,
deepseek-moe, granite-moe, rwkv6, recurrentgemma) held against the
reference on the CPU, at the reference's smoke config of each, W1A8,
float32 compute.

Params are drawn with numpy in the reference's layout (each leaf's shape
from ``repro.models.transformer.init_lm``), prequantized by the reference
(which leaves RG-LRU's ``wx``/``wy``, every RWKV-6 projection and the MoE
experts float: its prequantization reaches one dict level) and carried
across with ``convert.lm_params_from_numpy``.  The reference runs
jitted: its float32 results are exact only under jit (ROADMAP Queue C).

Tolerances:
* config fields equal, field by field;
* logits within 1e-5 x max|logit| (``LOGIT_TOL``) with equal argmax, for
  prefill at S = 12 and 24 (recurrentgemma also at 72 and 80, past its
  smoke window of 64) and for 8 decode steps after a prefill;
* where an ulp between XLA and PyTorch flips one level of a
  per-tensor-quantized activation (the fake-quant products of RWKV-6 and
  RG-LRU, the signed serve levels after them), the case is in ``FLIPS``
  and pinned, not loosened: every ``qdense`` of the model is equal when
  fed the reference's own inputs (at each decode step too), the
  divergence exists (the test fails once it is closed) and stays under
  ``FLIP_BOUND`` x max|logit|, and the argmax is equal but at a pinned
  count of near-ties (``FLIPS``; 0 except recurrentgemma's prefill at
  80).  ROADMAP Queue C records each case with its numbers.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import paper_cnn as jpaper  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import api, configs, convert  # noqa: E402
from repro_torch.configs import paper_cnn  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.engine import (ContinuousLMEngine,  # noqa: E402
                                       LMRunner, ServeEngine)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.resilience import (EpochLMRunner, FaultPlan,  # noqa: E402
                                    ResilientServeEngine)

from test_torch_moe_rec import (assert_pinned_logits,  # noqa: E402
                                assert_qdense_equal_on_reference_inputs,
                                reference_qdense_calls)

ARCHS = ["phi3-mini-3.8b", "yi-34b", "qwen3-32b", "deepseek-moe-16b",
         "granite-moe-3b-a800m", "rwkv6-1.6b", "recurrentgemma-9b"]
LOGIT_TOL = 1e-5   # x max|logit|
# (arch, prefill length) where one activation level flips (Queue C), and
# the pinned number of positions whose argmax the flip moves (each a
# near-tie of the reference's top two)
FLIPS = {("rwkv6-1.6b", 24): 0, ("recurrentgemma-9b", 24): 0,
         ("recurrentgemma-9b", 80): 6}
# recurrentgemma prompts past its smoke window of 64: 72 stays within
# LOGIT_TOL through prefill and 8 decode steps (the rolling 'attn_local'
# cache held exactly), 80 flips a level and is pinned
RG_LONG = [("recurrentgemma-9b", 72), ("recurrentgemma-9b", 80)]
_FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
           "d_ff", "vocab", "head_dim", "qk_norm", "rope_theta", "causal",
           "window", "pattern", "n_experts", "top_k", "n_shared_experts",
           "expert_d_ff", "capacity_factor", "router_aux_coef", "act",
           "tie_embeddings", "lru_width", "conv_width", "rwkv_head_dim",
           "lora_rank", "banded_attn", "hd", "padded_vocab", "blocks_pattern")


def _t(a):
    return torch.from_numpy(np.array(a))


def numpy_params(jcfg, seed: int = 0) -> dict:
    """Float params in the reference's layout, drawn with numpy: projections
    N(0, 1/fan_in), norms near 1, the embedding and head x0.02, RG-LRU's Λ
    as the reference draws it, and RWKV-6's mixes, LoRA, bonus and decay
    away from their zero init so every term of the block is exercised."""
    shapes = jax.eval_shape(
        lambda k: JT.init_lm(k, jcfg, jconfigs.SINGLE)[0],
        jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)

    def leaf(path, sd):
        name, shp = path[-1].key, sd.shape
        keys = [getattr(k, "key", None) for k in path]
        if name in ("ln", "ln1", "ln2", "final_norm", "q_norm", "k_norm",
                    "ln_x"):
            a = 1.0 + 0.1 * rs.randn(*shp)
        elif name in ("embed", "lm_head"):
            a = rs.randn(*shp) * 0.02
        elif name == "conv_b":
            a = rs.randn(*shp) * 0.1
        elif name == "lam" and "rec" in keys:
            a = np.log(np.exp(-np.log(rs.uniform(0.9, 0.999, shp)) / 8.0)
                       - 1.0)
        elif name == "lam":
            a = -2.0 + 0.3 * rs.randn(*shp)
        elif name in ("mu_base", "mus", "cm_mu_k", "cm_mu_r"):
            a = rs.uniform(0, 1, shp)
        elif name == "u":
            a = rs.randn(*shp) * 0.3
        elif name in ("lora_A", "lora_B"):
            a = rs.randn(*shp) * 0.1
        else:
            a = rs.randn(*shp) / math.sqrt(shp[-2])
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


_MODELS: dict = {}


def model(arch: str, qname: str = "w1a8") -> dict:
    """The smoke model of ``arch`` on both sides (built once a module)."""
    if (arch, qname) not in _MODELS:
        jcfg = dataclasses.replace(jconfigs.get_config(arch).smoke(),
                                   quant=jquant.PAPER_CONFIGS[qname])
        cfg = dataclasses.replace(configs.get_config(arch).smoke(),
                                  quant=quant.PAPER_CONFIGS[qname])
        raw = numpy_params(jcfg)
        jp = JL.prequantize_params(jax.tree.map(jnp.asarray, raw), jcfg)
        params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                              cfg, device="cpu")
        _MODELS[arch, qname] = dict(cfg=cfg, jcfg=jcfg, jparams=jp,
                                    params=params, raw=raw)
    return _MODELS[arch, qname]


def _toks(m, s: int, seed: int = 1) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        0, m["cfg"].vocab, (2, s)).astype(np.int32)


def _ref_prefill(m, toks):
    return jax.jit(lambda p, t: JT.prefill(p, m["jcfg"], jconfigs.SINGLE,
                                           tokens=t, qmode="serve"))(
        m["jparams"], jnp.asarray(toks))


def _check_logits(m, got, ref, argmax_flips=None, monkeypatch=None,
                  run=None):
    """Within LOGIT_TOL with equal argmax, or, for a pinned flip
    (``argmax_flips`` not None), the flip's assertions (module docstring):
    ``run`` is the reference's eager counterpart, whose ``qdense`` calls
    are held on their own inputs."""
    vocab = m["cfg"].vocab
    ref = np.asarray(ref)[..., :vocab]
    got = got.numpy()[..., :vocab]
    if argmax_flips is None:
        diff, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
        assert diff <= LOGIT_TOL * scale, diff / scale
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        return
    assert_qdense_equal_on_reference_inputs(
        reference_qdense_calls(monkeypatch, run))
    assert_pinned_logits(got, ref, argmax_flips)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    ref, got = jconfigs.get_config(arch), configs.get_config(arch)
    for f in _FIELDS:
        assert getattr(got, f) == getattr(ref, f), f
    assert got.n_blocks_of("attn") == ref.n_blocks_of("attn")
    assert got.compute_dtype == torch.bfloat16
    assert got.param_dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_equals_reference_smoke(arch):
    ref, got = (jconfigs.get_config(arch).smoke(),
                configs.get_config(arch).smoke())
    for f in _FIELDS:
        assert getattr(got, f) == getattr(ref, f), f
    assert got.compute_dtype == torch.float32


def test_paper_cnn_config_equals_reference():
    assert paper_cnn.SVHN_CHANNELS == jpaper.SVHN_CHANNELS
    for got, ref in ((paper_cnn.SVHN_SPEC, jpaper.SVHN_SPEC),
                     (paper_cnn.ALEXNET_SPEC, jpaper.ALEXNET_SPEC)):
        # the port's ConvSpec adds ``groups`` (1 here) to the reference's
        assert [dataclasses.asdict(s) for s in got] == [
            dict(dataclasses.asdict(s), groups=1) for s in ref]
    assert (dataclasses.asdict(paper_cnn.DEFAULT_QUANT)
            == dataclasses.asdict(jpaper.DEFAULT_QUANT))
    assert {k: dataclasses.asdict(v) for k, v in paper_cnn.QUANTS.items()} \
        == {k: dataclasses.asdict(v) for k, v in jpaper.QUANTS.items()}


def test_every_family_arch_is_ported():
    assert set(ARCHS) | {"smollm-360m", "hubert-xlarge", "internvl2-26b"} \
        == set(configs.PORTED_ARCH_IDS) == set(jconfigs.ARCH_IDS)


# ---------------------------------------------------------------------------
# the model: prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,s", [(a, s) for a in ARCHS for s in (12, 24)]
                         + RG_LONG)
def test_prefill_logits_match_reference(arch, s, monkeypatch):
    m = model(arch)
    toks = _toks(m, s)
    ref, _ = _ref_prefill(m, toks)
    got, cache = T.prefill(m["params"], m["cfg"], configs.SINGLE,
                           tokens=_t(toks))
    assert got.shape == (2, s, m["cfg"].padded_vocab)
    jcfg = dataclasses.replace(m["jcfg"], scan_layers=False)
    _check_logits(m, got, ref, FLIPS.get((arch, s)), monkeypatch,
                  lambda: JT.prefill(m["jparams"], jcfg, jconfigs.SINGLE,
                                     tokens=jnp.asarray(toks), qmode="serve"))


@pytest.mark.parametrize("arch,s", [(a, 12) for a in ARCHS] + RG_LONG)
def test_decode_logits_match_reference(arch, s, monkeypatch):
    """8 decode steps after a prefill, each side on its own cache (grown to
    the horizon: the recurrent state — RG-LRU h and conv, RWKV-6 token
    shifts and wkv state — passes through, the 'attn_local' slots roll),
    both fed the reference's greedy tokens.  After the pinned prefill flip
    at S=80 the decode steps carry it: each step pinned too, its every
    ``qdense`` held on the reference's own inputs of that step, its argmax
    equal."""
    m = model(arch)
    cfg, steps = m["cfg"], 8
    toks = _toks(m, s)
    jl, jc = _ref_prefill(m, toks)
    jc = jserve.grow_cache(jc, s, s + steps)
    _, tc = T.prefill(m["params"], cfg, configs.SINGLE, tokens=_t(toks))
    tc = serve.grow_cache(tc, s, s + steps)
    tmpl = T.init_cache(cfg, configs.SINGLE, 2, s + steps)
    assert set(tc) == set(jc) == set(tmpl)
    for kind, entry in tc.items():
        for k, v in entry.items():
            assert v.dtype == tmpl[kind][k].dtype, (kind, k)
            assert tuple(v.shape) == tuple(jc[kind][k].shape), (kind, k)
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(
        p, c, t, pos, m["jcfg"], jconfigs.SINGLE, qmode="serve"))
    jcfg = dataclasses.replace(m["jcfg"], scan_layers=False)
    pinned = 0 if (arch, s) in FLIPS else None
    tok = np.asarray(jserve.greedy_token(jl, cfg.vocab))
    for i in range(steps):
        eager = (lambda c=jc, t=jnp.asarray(tok), pos=s + i: JT.decode_step(
            m["jparams"], c, t, pos, jcfg, jconfigs.SINGLE, qmode="serve"))
        jd, jc = step(m["jparams"], jc, jnp.asarray(tok), s + i)
        td, tc = T.decode_step(m["params"], tc, _t(tok), s + i, cfg,
                               configs.SINGLE)
        _check_logits(m, td, jd, pinned, monkeypatch, eager)
        tok = np.asarray(jserve.greedy_token(jd, cfg.vocab))
    for kind in tc:
        np.testing.assert_array_equal(tc[kind].get("pos", np.zeros(1)),
                                      np.asarray(jc[kind].get("pos",
                                                              np.zeros(1))))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_qdense_equals_reference_on_its_inputs(arch, monkeypatch):
    """Each projection of a whole prefill at S=12 — prequantized weights on
    the signed level GEMM, float weights on the fake-quant product, the
    head on a plain matmul — equals the reference's when fed the
    reference's own inputs."""
    m = model(arch)
    toks = jnp.asarray(_toks(m, 12))
    jcfg = dataclasses.replace(m["jcfg"], scan_layers=False)
    calls = reference_qdense_calls(monkeypatch, lambda: JT.prefill(
        m["jparams"], jcfg, jconfigs.SINGLE, tokens=toks, qmode="serve"))
    kinds = {isinstance(w, dict) for _, w, *_ in calls}
    fake = m["cfg"].family in ("rwkv", "rglru") or m["cfg"].n_shared_experts
    assert kinds == ({True, False} if fake or not m["cfg"].tie_embeddings
                     else {True}) or kinds == {False}
    assert_qdense_equal_on_reference_inputs(calls)


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "rwkv6-1.6b",
                                  "recurrentgemma-9b"])
def test_paged_cache_and_continuous_engine_refuse_the_pattern(arch):
    """As in the reference: the paged cache (and so the continuous engine)
    takes a pure-'attn' pattern only."""
    m = model(arch)
    with pytest.raises(ValueError, match="pure-'attn'"):
        T.init_paged_cache(m["cfg"], configs.SINGLE, 2, 8, 4, 4)
    with pytest.raises(ValueError, match="pure-'attn'"):
        JT.init_paged_cache(m["jcfg"], jconfigs.SINGLE, 2, 8, 4, 4)
    with pytest.raises(ValueError, match="pure-'attn'"):
        ContinuousLMEngine(m["params"], m["cfg"], num_slots=2, page_size=4,
                           num_pages=8)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "rwkv6-1.6b",
                                  "recurrentgemma-9b"])
def test_bucket_engine_tokens_equal_serve_once(arch):
    """``ServeEngine(LMRunner(...))`` serves a bucket's tokens as
    ``serve_once`` does on the same padded batch, and those equal the
    jitted reference's greedy decode."""
    m = model(arch)
    cfg, new = m["cfg"], 5
    prompts = _toks(m, 12)
    eng = ServeEngine(LMRunner(m["params"], cfg, new_tokens=new),
                      max_batch=2)
    got = np.stack([r.value for r in eng.serve(list(prompts))])
    once, _ = serve.serve_once(m["params"], cfg, configs.SINGLE, _t(prompts),
                               new, "serve")
    np.testing.assert_array_equal(got, once.numpy())
    jl, jc = _ref_prefill(m, prompts)
    jc = jserve.grow_cache(jc, 12, 12 + new)
    gen = jax.jit(jserve.make_generate(m["jparams"], m["jcfg"],
                                       jconfigs.SINGLE, "serve", 12, new))
    ref = np.asarray(gen(jc, jserve.greedy_token(jl, cfg.vocab)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("arch", ["qwen3-32b", "deepseek-moe-16b",
                                  "recurrentgemma-9b"])
def test_cli_serves_the_arch_on_cpu(arch, capsys):
    serve.main(["--device", "cpu", "--arch", arch, "--quant", "w1a8",
                "--batch", "2", "--prompt-len", "8", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke quant=w1a8 device=cpu engine=serve" in out
    assert "generated 2x3 tokens" in out


@pytest.mark.parametrize("flag", [["--plan-cache", "lm"], ["--autotune"]])
@pytest.mark.parametrize("quant", [[], ["--quant", "w32a32"]])
def test_cli_plan_flags_refuse_the_train_mode(flag, quant, tmp_path,
                                              capsys):
    """A plan compiles the quantized serve path: the CLI refuses its flags
    where no ``--quant`` or ``--quant w32a32`` selects the train-mode
    ``qdense``, instead of serving without the plan."""
    if flag[0] == "--plan-cache":
        flag = [flag[0], str(tmp_path / flag[1])]
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu", "--arch", "granite-moe-3b-a800m",
                    "--batch", "2", "--prompt-len", "8", "--new-tokens", "3"]
                   + quant + flag)
    assert e.value.code == 2
    assert "--plan-cache/--autotune" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b"])
def test_epoch_runner_resumes_recurrent_state_bit_for_bit(arch, tmp_path):
    """``EpochLMRunner`` killed by a power loss at its second decode epoch
    and resumed from the last checkpoint serves its fault-free run's
    tokens bit for bit: the checkpoint carries the recurrent state."""
    m = model(arch)
    prompts = list(_toks(m, 10, seed=3))

    def run(ckdir, faults):
        runner = EpochLMRunner(m["params"], m["cfg"], new_tokens=9,
                               epoch_steps=2)
        eng = ResilientServeEngine(runner, fault_plan=faults,
                                   checkpoint_dir=ckdir, max_batch=2,
                                   max_retries=10)
        return eng, [r.value for r in eng.serve(prompts)]

    _, clean = run(None, None)
    faults = FaultPlan.scripted([("decode", 2, "power_loss")])
    eng, got = run(str(tmp_path), faults)
    # resumed from the committed epoch, never prefilled again
    assert eng.stats["power_losses"] == 1
    assert eng.stats["resumes"] == 1 and eng.stats["prefills"] == 1
    for a, b in zip(got, clean):
        np.testing.assert_array_equal(a, b)
    # the resumed state held the recurrent entries of the cache
    kinds = {"recurrentgemma-9b": ("rec", "attn_local"),
             "rwkv6-1.6b": ("rwkv",)}[arch]
    tmpl = EpochLMRunner(m["params"], m["cfg"], new_tokens=9).\
        decode_state_template(("lm", 10, 9), 2, 1)
    assert set(tmpl["cache"]) == set(kinds)


def test_moe_plan_serves_the_plan_free_tokens(tmp_path):
    """``api.build(cfg, params).compile(...)`` on granite-moe: the plan
    covers the prequantized attention projections (the experts stay
    float), serves the plan-free run's tokens, and a saved plan reloads to
    the same tokens."""
    m = model("granite-moe-3b-a800m")
    cfg = m["cfg"]
    prompts = list(_toks(m, 12, seed=4))
    plain = ServeEngine(LMRunner(m["params"], cfg, new_tokens=4),
                        max_batch=2)
    want = [r.value for r in plain.serve(prompts)]
    compiled = api.build(cfg, params=m["params"]).compile(
        prompt_len=12, batch_hints=(2,), cache=str(tmp_path / "moe"))
    names = {lp.name for lp in compiled.plan.layers if lp.op == "dense"}
    assert names and all(n.startswith("moe.attn.") for n in names)
    for c in (compiled, api.load(str(tmp_path / "moe"), spec=cfg,
                                 device="cpu")):
        for a, b in zip(c.serve(new_tokens=4, max_batch=2).predict(prompts),
                        want):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# params: layout, conversion, plans
# ---------------------------------------------------------------------------

def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_layout_equals_reference(arch):
    """``init_lm`` draws every block kind in the reference's layout: one
    stacked tree per kind, the same paths and shapes, float32."""
    m = model(arch)
    got = dict(_leaves(T.init_lm(torch.Generator().manual_seed(0), m["cfg"],
                                 configs.SINGLE)))
    want = dict(_leaves(m["raw"]))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert got[path].dtype == torch.float32, path


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_numpy_keeps_the_reference_tree(arch):
    """The reference's prequantized tree carried across leaf for leaf: its
    levels int8, every float leaf (the experts, the nested shared MLP,
    RG-LRU's ``wx``/``wy``, all of RWKV-6) float32 and equal."""
    m = model(arch)
    want = dict(_leaves(jax.tree.map(np.asarray, m["jparams"])))
    got = dict(_leaves(m["params"]))
    assert set(got) == set(want)
    for path, leaf in want.items():
        t = got[path]
        if path[-1] == "q":
            assert t.dtype == torch.int8, path
        else:
            assert t.dtype == torch.float32, path
        np.testing.assert_array_equal(t.numpy(), leaf.astype(t.numpy().dtype))
    quantized = {p[:-1] for p in want if p[-1] == "q"}
    assert quantized == {p[:-1] for p in want
                         if len(p) == 5 and p[3] in JL.PREQUANT_KEYS
                         and p[-1] == "q"}
    fams = {"rwkv": 0, "rglru": 1, "moe": 1, "dense": 1}
    assert bool(quantized) == bool(fams[m["cfg"].family])


@pytest.mark.parametrize("arch", ARCHS)
def test_prequantize_params_equals_reference(arch):
    """The port's ``prequantize_params`` on the float tree, against the
    reference's: the same leaves quantized (one dict level deep, so the
    experts, the nested shared MLP, RG-LRU's ``wx``/``wy`` and all of
    RWKV-6 stay float), the same levels, every float leaf untouched."""
    from repro_torch.models import layers as L

    m = model(arch)
    raw = convert.lm_params_from_numpy(m["raw"], m["cfg"], device="cpu")
    got = dict(_leaves(L.prequantize_params(raw, m["cfg"])))
    want = dict(_leaves(m["params"]))
    assert set(got) == set(want)
    for path, ref in want.items():
        t = got[path]
        assert t.dtype == ref.dtype, path
        if path[-1] == "s" and path[:-1] + ("q",) in want:
            # 2*mean|w|: the port rounds a float64 mean once, XLA's
            # float32 mean lands a few ulps off (ROADMAP Queue C)
            np.testing.assert_allclose(t.numpy(), ref.numpy(),
                                       rtol=16 * 2 ** -23)
        else:
            assert torch.equal(t, ref), path


@pytest.mark.parametrize("arch", ARCHS)
def test_compile_lm_covers_every_prequantized_projection(arch):
    """An LM plan's dense table holds a verdict for every (K, N) of a
    prequantized projection and nothing else; the attention table a
    verdict for each attention kind's window."""
    from repro_torch.core.plan import compile_lm
    from repro_torch.kernels import ops

    m = model(arch)
    plan = compile_lm(m["params"], m["cfg"], prompt_len=12)
    want = {(int(v.shape[-2]), int(v.shape[-1]))
            for p, v in _leaves(m["params"]) if p[-1] == "q"}
    assert {k[1:3] for k in plan.dense_table} == want
    for K, N in want:
        assert ops.dense_plan_key(K, N, 8, 1, "cuda") in plan.dense_table
    kinds = {k for k in m["cfg"].blocks_pattern if k in T.ATTN_KINDS}
    assert len(plan.attn_table) == len(
        {m["cfg"].window if k == "attn_local" else None for k in kinds})
