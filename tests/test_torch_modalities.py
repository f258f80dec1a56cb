"""The port's encoder and VLM families (hubert-xlarge, internvl2-26b) held
against the reference on the CPU, at the reference's smoke configs, W1A8,
float32 compute, and ``attn_flash`` at hubert's head_dim 80, non-causal.

Params are drawn with numpy in the reference's layout
(``test_torch_families.numpy_params``: ``frame_proj`` and ``vision_proj``
N(0, 1/fan_in)), prequantized by the reference and carried across with
``convert.lm_params_from_numpy``; frame features, patch embeddings and
tokens come from a numpy seed.  The reference runs jitted.

Tolerances:
* config fields equal, field by field (the modality fields included);
* ``embed_inputs`` within 1e-6 x max|h| (a float32 matmul of the features
  or patches, summed in another order by XLA and PyTorch); the token
  rows of the VLM's sequence equal bit for bit;
* ``attn_flash_plain`` within 1e-5 x max|v| of ``attn_flash_xla`` and of
  ``attn_flash_pallas(interpret=True)`` (the same integer logits; exp and
  the sums in another order);
* logits within 1e-5 x max|logit| (``LOGIT_TOL``) with equal argmax, for
  prefill on the ``full`` and the ``flash`` engine (forced on both sides)
  and for 8 VLM decode steps after a prefill with patches;
* where an ulp between XLA and PyTorch flips one level of a
  per-tensor-quantized activation, the case is in ``FLIPS`` and pinned
  as ROADMAP Queue C says, not loosened: every ``qdense`` of the model
  equals the reference's on the reference's own inputs, the divergence
  exists and stays under ``FLIP_BOUND`` x max|logit|, and the argmax is
  equal but at the pinned count of near-ties.
"""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.api import targets as jtargets  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.kernels import attn_flash as JA  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.api import targets  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import _lib, ops  # noqa: E402
from repro_torch.kernels import attn_flash as A  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.engine import (ContinuousLMEngine,  # noqa: E402
                                       LMRunner, ServeEngine)
from repro_torch.models import transformer as T  # noqa: E402

from test_torch_families import _FIELDS, numpy_params  # noqa: E402
from test_torch_moe_rec import (assert_pinned_logits,  # noqa: E402
                                assert_qdense_equal_on_reference_inputs,
                                reference_qdense_calls)

ARCHS = ["hubert-xlarge", "internvl2-26b"]
MODALITY_FIELDS = ("n_patches", "vit_dim", "frame_input", "frame_dim")
LOGIT_TOL = 1e-5    # x max|logit|
EMBED_TOL = 1e-6    # x max|h|
ATTN_TOL = 1e-5     # x max|v|
# the smoke configs the model tests run: each family's smoke, and hubert's
# at its full head_dim of 80 (the flash kernel's new instance)
CASES = {"hubert-xlarge": {}, "hubert-xlarge-hd80": dict(head_dim=80),
         "internvl2-26b": {}}
TEXT = 12           # text tokens after internvl's 16 patches
# (case, engine) where one activation level flips (Queue C): hubert at
# head_dim 80, whose layer-0 attention output (5.8e-7 relative apart, on
# either engine) rounds one level of ``wo``'s per-tensor input the other
# way; the pinned number of positions whose argmax the flip moves
FLIPS = {("hubert-xlarge-hd80", "full"): 0, ("hubert-xlarge-hd80", "flash"): 0}


def _t(a):
    return torch.from_numpy(np.array(a))


_MODELS: dict = {}


def model(case: str) -> dict:
    """The smoke model of ``case`` on both sides (built once a module)."""
    if case not in _MODELS:
        arch = case.removesuffix("-hd80")
        kw = CASES[case]
        q8 = jquant.PAPER_CONFIGS["w1a8"]
        jcfg = dataclasses.replace(jconfigs.get_config(arch).smoke(**kw),
                                   quant=q8)
        cfg = dataclasses.replace(configs.get_config(arch).smoke(**kw),
                                  quant=quant.PAPER_CONFIGS["w1a8"])
        raw = numpy_params(jcfg)
        jp = JL.prequantize_params(jax.tree.map(jnp.asarray, raw), jcfg)
        params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                              cfg, device="cpu")
        _MODELS[case] = dict(cfg=cfg, jcfg=jcfg, jparams=jp, params=params,
                             raw=raw)
    return _MODELS[case]


def _inputs(cfg, seed: int = 1) -> dict:
    """The prefill inputs, numpy: (2, 24) frames of ``frame_dim`` for the
    encoder; 16 patches of ``vit_dim`` and TEXT tokens for the VLM."""
    rs = np.random.RandomState(seed)
    if cfg.frame_input:
        return dict(frame_feats=rs.randn(2, 24, cfg.frame_dim)
                    .astype(np.float32))
    return dict(tokens=rs.randint(0, cfg.vocab, (2, TEXT)).astype(np.int32),
                patch_embeds=rs.randn(2, cfg.n_patches, cfg.vit_dim)
                .astype(np.float32))


def _seq(cfg) -> int:
    return 24 if cfg.frame_input else cfg.n_patches + TEXT


def _ref_prefill(m, inp):
    return jax.jit(lambda p, kw: JT.prefill(p, m["jcfg"], jconfigs.SINGLE,
                                            qmode="serve", **kw))(
        m["jparams"], {k: jnp.asarray(v) for k, v in inp.items()})


def _force_flash(m, monkeypatch):
    cfg = m["cfg"]
    s = _seq(cfg)
    key = jops.attn_plan_key(jops.AttnShape(
        seq_q=s, seq_kv=s, heads=cfg.n_heads, head_dim=cfg.hd,
        causal=bool(cfg.causal), window=None, quantized=True), "cpu")
    jops.install_plan_table({key: "flash"})
    monkeypatch.setattr(targets, "ATTN_FLASH_SEQ_MIN", s)


def _check_logits(m, got, ref):
    vocab = m["cfg"].vocab
    ref = np.asarray(ref)[..., :vocab]
    got = got.numpy()[..., :vocab]
    diff, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert diff <= LOGIT_TOL * scale, diff / scale
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    ref, got = jconfigs.get_config(arch), configs.get_config(arch)
    for f in _FIELDS + MODALITY_FIELDS:
        assert getattr(got, f) == getattr(ref, f), f
    assert got.compute_dtype == torch.bfloat16
    assert got.family in T.PORTED_FAMILIES


@pytest.mark.parametrize("case", sorted(CASES))
def test_smoke_config_equals_reference_smoke(case):
    m = model(case)
    for f in _FIELDS + MODALITY_FIELDS:
        assert getattr(m["cfg"], f) == getattr(m["jcfg"], f), f
    assert m["cfg"].compute_dtype == torch.float32
    want = dict(n_patches=16, vit_dim=64, frame_dim=0) if \
        case.startswith("internvl") else dict(n_patches=0, vit_dim=0,
                                              frame_dim=64)
    assert {k: getattr(m["cfg"], k) for k in want} == want


def test_hubert_head_dim_is_a_kernel_instance():
    cfg = configs.get_config("hubert-xlarge")
    assert cfg.hd == 80 and not cfg.causal
    assert cfg.hd in A.KERNEL_HEAD_DIMS


# ---------------------------------------------------------------------------
# params: layout and conversion
# ---------------------------------------------------------------------------

def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_lm_layout_equals_reference(case):
    """``init_lm`` draws ``frame_proj`` instead of ``embed`` for the
    encoder and ``vision_proj`` beside ``embed`` for the VLM, in the
    reference's paths and shapes."""
    m = model(case)
    got = dict(_leaves(T.init_lm(torch.Generator().manual_seed(0), m["cfg"],
                                 configs.SINGLE)))
    want = dict(_leaves(m["raw"]))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert got[path].dtype == torch.float32, path
    top = {p[0] for p in want}
    assert ("embed" in top) == (not m["cfg"].frame_input)
    assert ("frame_proj" in top) == m["cfg"].frame_input
    assert ("vision_proj" in top) == bool(m["cfg"].n_patches)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_params_from_numpy_carries_the_modality_projections(case):
    m = model(case)
    want = dict(_leaves(jax.tree.map(np.asarray, m["jparams"])))
    got = dict(_leaves(m["params"]))
    assert set(got) == set(want)
    for path, leaf in want.items():
        t = got[path]
        assert t.dtype == (torch.int8 if path[-1] == "q" else torch.float32)
        np.testing.assert_array_equal(t.numpy(), leaf.astype(t.numpy().dtype))
    for name in ("frame_proj", "vision_proj"):
        if (name,) in want:
            assert got[(name,)].dtype == torch.float32


# ---------------------------------------------------------------------------
# embed_inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_embed_inputs_equals_reference(arch, dtype):
    """Frames projected in place of tokens (the encoder), patches
    projected and prepended to the token rows (the VLM), in the compute
    dtype: float32 within EMBED_TOL, bfloat16 within one rounding."""
    m = model(arch)
    jcfg = dataclasses.replace(m["jcfg"], compute_dtype=getattr(jnp, dtype))
    cfg = dataclasses.replace(m["cfg"], compute_dtype=getattr(torch, dtype))
    inp = _inputs(cfg)
    want = JT.embed_inputs(m["jparams"], jcfg,
                           **{k: jnp.asarray(v) for k, v in inp.items()})
    got = T.embed_inputs(m["params"], cfg, **{k: _t(v)
                                              for k, v in inp.items()})
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    assert tuple(got.shape) == want.shape == (2, _seq(cfg), cfg.d_model)
    got = got.float().numpy()
    tol = (EMBED_TOL if dtype == "float32" else 2 ** -7) * np.abs(want).max()
    assert float(np.abs(got - want).max()) <= tol
    if cfg.n_patches:   # the token rows are a gather: bit for bit
        np.testing.assert_array_equal(got[:, cfg.n_patches:],
                                      want[:, cfg.n_patches:])


def test_embed_inputs_without_patches_is_the_text_alone():
    """The VLM serves text alone as the reference does: no patches, no
    prepended rows."""
    m = model("internvl2-26b")
    toks = _inputs(m["cfg"])["tokens"]
    got = T.embed_inputs(m["params"], m["cfg"], _t(toks))
    want = JT.embed_inputs(m["jparams"], m["jcfg"], jnp.asarray(toks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_frame_input_refuses_tokens():
    m = model("hubert-xlarge")
    with pytest.raises(ValueError, match=r"prefill\(frame_feats="):
        T.prefill(m["params"], m["cfg"], configs.SINGLE,
                  tokens=torch.zeros((2, 8), dtype=torch.int32))


# ---------------------------------------------------------------------------
# attn_flash at head_dim 80, non-causal
# ---------------------------------------------------------------------------

def _qkv(seed, b, s, h, hd):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, s, h, hd).astype(np.float32) for _ in range(3))


def _close(got, ref, v, what):
    tol = ATTN_TOL * float(np.abs(v).max())
    d = float(np.abs(np.asarray(got, np.float32)
                     - np.asarray(ref, np.float32)).max())
    assert d <= tol, f"{what}: max abs diff {d} > {tol}"


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,block", [(2, 48, 2, 16), (1, 40, 3, 16)])
def test_flash_plain_hd80_matches_pallas_interpret_and_xla(b, s, h, block,
                                                          causal):
    """Three q blocks (two at S=40, the last ragged) of 16 rows, every kv
    block of a row's reach: the port's plain version against the Pallas
    kernel in interpret mode and against ``attn_flash_xla``."""
    q, k, v = _qkv(s + h, b, s, h, 80)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    kw = dict(causal=causal, block_q=block, block_kv=block)
    got = A.attn_flash_plain(_t(q), _t(k), _t(v), **kw).numpy()
    _close(got, JA.attn_flash_pallas(jq, jk, jv, interpret=True, **kw), v,
           "flash hd 80 vs pallas interpret")
    _close(got, JA.attn_flash_xla(jq, jk, jv, **kw), v, "flash hd 80 vs xla")


def test_flash_dispatch_hd80_on_cpu_is_the_plain_version():
    q, k, v = (_t(a) for a in _qkv(3, 1, 33, 2, 80))
    _lib.reset_launches()
    got = A.attn_flash(q, k, v, causal=False)
    assert _lib.LAUNCHES["attn_flash"] == 0
    assert torch.equal(got, A.attn_flash_plain(q, k, v, causal=False))


def test_hubert_prefill_routes_flash_non_causal_on_both_targets():
    """hubert's 2048-frame prefill: the port's cuda target and the
    reference's TPU target both pick ``flash``, keyed non-causal, and the
    attention cost counts every key (no causal halving)."""
    cfg = configs.get_config("hubert-xlarge")
    kw = dict(seq_q=2048, seq_kv=2048, heads=16, head_dim=80, causal=False,
              window=None, quantized=True, batch=2)
    got = targets.get_target("cuda").select_attn_engine(ops.AttnShape(**kw))
    want = jtargets.get_target("tpu").select_attn_engine(jops.AttnShape(**kw))
    assert got == want == "flash"
    assert ops.attn_engine_feasible("flash", ops.AttnShape(**kw)) == (True,
                                                                      "")
    key = ops.attn_plan_key(ops.AttnShape(**kw), "cuda")
    assert False in key and key != ops.attn_plan_key(
        ops.AttnShape(**dict(kw, causal=True)), "cuda")
    # every key counts: the cost of a window as long as the sequence, and
    # more than the causal half
    t = targets.get_target("cuda")
    full = t.attn_cost(ops.AttnShape(**kw))
    assert full == t.attn_cost(ops.AttnShape(**dict(kw, window=2048)))
    assert full.cycles > t.attn_cost(ops.AttnShape(**dict(
        kw, causal=True))).cycles
    from repro_torch.core.plan import compile_lm
    plan = compile_lm(model("hubert-xlarge")["params"], dataclasses.replace(
        cfg.smoke(), quant=quant.PAPER_CONFIGS["w1a8"]), prompt_len=4096)
    (akey, verdict), = plan.attn_table.items()
    assert verdict == "flash" and False in akey


# ---------------------------------------------------------------------------
# the model: prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["full", "flash"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_logits_match_reference(case, engine, monkeypatch):
    m = model(case)
    inp = _inputs(m["cfg"])
    flips = FLIPS.get((case, engine))
    if engine == "flash":
        _force_flash(m, monkeypatch)
    try:
        ref, jc = _ref_prefill(m, inp)
        if flips is not None:   # the reference's qdense inputs, eagerly
            jcfg = dataclasses.replace(m["jcfg"], scan_layers=False)
            calls = reference_qdense_calls(monkeypatch, lambda: JT.prefill(
                m["jparams"], jcfg, jconfigs.SINGLE, qmode="serve",
                **{k: jnp.asarray(v) for k, v in inp.items()}))
    finally:
        jops.clear_plan_state()
    got, cache = T.prefill(m["params"], m["cfg"], configs.SINGLE,
                           **{k: _t(v) for k, v in inp.items()})
    s = _seq(m["cfg"])
    assert got.shape == (2, s, m["cfg"].padded_vocab)
    assert tuple(cache["attn"]["k"].shape) == tuple(jc["attn"]["k"].shape)
    np.testing.assert_array_equal(cache["attn"]["pos"].numpy(),
                                  np.asarray(jc["attn"]["pos"]))
    if engine == "flash":   # the verdict took on both sides
        full, _ = _ref_prefill(m, inp)
        assert float(np.abs(np.asarray(ref) - np.asarray(full)).max()) > 1e-4
    if flips is None:
        _check_logits(m, got, ref)
        return
    assert_qdense_equal_on_reference_inputs(calls)
    vocab = m["cfg"].vocab
    assert_pinned_logits(got.numpy()[..., :vocab],
                         np.asarray(ref)[..., :vocab], flips)


@pytest.mark.parametrize("engine", ["full", "flash"])
def test_vlm_decode_logits_match_reference(engine, monkeypatch):
    """8 decode steps after a prefill of 16 patches + 12 text tokens, at
    positions n_patches + S + i on both sides, each side on its own grown
    cache, both fed the reference's greedy tokens."""
    m = model("internvl2-26b")
    cfg, steps = m["cfg"], 8
    inp = _inputs(cfg)
    s = _seq(cfg)
    if engine == "flash":
        _force_flash(m, monkeypatch)
    try:
        jl, jc = _ref_prefill(m, inp)
    finally:
        jops.clear_plan_state()
    jc = jserve.grow_cache(jc, s, s + steps)
    _, tc = T.prefill(m["params"], cfg, configs.SINGLE,
                      **{k: _t(v) for k, v in inp.items()})
    tc = serve.grow_cache(tc, s, s + steps)
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(
        p, c, t, pos, m["jcfg"], jconfigs.SINGLE, qmode="serve"))
    tok = np.asarray(jserve.greedy_token(jl, cfg.vocab))
    for i in range(steps):
        jd, jc = step(m["jparams"], jc, jnp.asarray(tok), s + i)
        td, tc = T.decode_step(m["params"], tc, _t(tok), s + i, cfg,
                               configs.SINGLE)
        _check_logits(m, td, jd)
        tok = np.asarray(jserve.greedy_token(jd, cfg.vocab))
    np.testing.assert_array_equal(tc["attn"]["pos"].numpy(),
                                  np.asarray(jc["attn"]["pos"]))


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------

def test_vlm_engines_serve_text_as_the_reference():
    """internvl's text through the bucket engine equals ``serve_once`` and
    the jitted reference's greedy decode; the continuous engine serves
    the same requests (its per-row scales give its own tokens)."""
    m = model("internvl2-26b")
    cfg, new = m["cfg"], 5
    prompts = _inputs(cfg)["tokens"]
    eng = ServeEngine(LMRunner(m["params"], cfg, new_tokens=new),
                      max_batch=2)
    got = np.stack([r.value for r in eng.serve(list(prompts))])
    once, _ = serve.serve_once(m["params"], cfg, configs.SINGLE, _t(prompts),
                               new, "serve")
    np.testing.assert_array_equal(got, once.numpy())
    jl, jc = jax.jit(lambda p, t: JT.prefill(
        p, m["jcfg"], jconfigs.SINGLE, tokens=t, qmode="serve"))(
        m["jparams"], jnp.asarray(prompts))
    jc = jserve.grow_cache(jc, TEXT, TEXT + new)
    gen = jax.jit(jserve.make_generate(m["jparams"], m["jcfg"],
                                       jconfigs.SINGLE, "serve", TEXT, new))
    np.testing.assert_array_equal(got, np.asarray(
        gen(jc, jserve.greedy_token(jl, cfg.vocab))))
    cont = ContinuousLMEngine(m["params"], cfg, num_slots=2, page_size=4,
                              num_pages=16, new_tokens=new)
    res = cont.serve([(p, new) for p in prompts])
    assert [len(r.value) for r in res] == [new, new]
    assert all(bool(np.all((r.value >= 0) & (r.value < cfg.vocab)))
               for r in res)


def test_encoder_bucket_engine_refuses_token_prompts():
    m = model("hubert-xlarge")
    eng = ServeEngine(LMRunner(m["params"], m["cfg"], new_tokens=2),
                      max_batch=2)
    with pytest.raises(ValueError, match=r"prefill\(frame_feats="):
        eng.serve([np.zeros(8, np.int32)])


def test_cli_serves_the_vlm_on_cpu(capsys):
    serve.main(["--device", "cpu", "--arch", "internvl2-26b", "--quant",
                "w1a8", "--batch", "2", "--prompt-len", "8",
                "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=internvl2-26b-smoke quant=w1a8 device=cpu engine=serve" \
        in out
    assert "generated 2x3 tokens" in out


FLAGS = ["--arch", "hubert-xlarge", "--quant", "w1a8", "--batch", "2",
         "--prompt-len", "8", "--new-tokens", "3"]


def test_cli_refuses_the_encoder_as_the_reference_fails(monkeypatch):
    """Both CLIs prefill tokens only, so hubert's ``embed_inputs`` gets no
    frames: the reference's fails on ``None @ frame_proj``, the port's
    raises a ``ValueError`` naming the entry point that takes frames."""
    with pytest.raises(ValueError, match=r"prefill\(frame_feats="):
        serve.main(["--device", "cpu"] + FLAGS)
    monkeypatch.setattr(sys, "argv", ["serve"] + FLAGS)
    with pytest.raises(TypeError, match="NoneType"):
        jserve.main()
