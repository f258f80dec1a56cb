"""CLI for the port's static verification subsystem.

  python -m repro_torch.analysis lint [paths...]          # RL001–RL005
  python -m repro_torch.analysis lint --list-rules
  python -m repro_torch.analysis check-plan <plan.json>...  # PV101–PV108
  python -m repro_torch.analysis check-plan --golden      # compile + verify
                                                          # the golden svhn/
                                                          # alexnet/LM plans
                                                          # in-process

Both subcommands exit nonzero on any violation.  Runs on the CPU: the
golden plans are compiled there (weights from a numpy seed) and saved
artifacts are reloaded there.
"""
from __future__ import annotations

import argparse
import sys
import tempfile


def _cmd_lint(args) -> int:
    from repro_torch.analysis.lint import RULES, lint_paths

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0
    paths = args.paths or ["src/repro_torch"]
    violations = lint_paths(paths)
    for v in violations:
        print(v)
    n = len(violations)
    print(f"repro-lint: {n} violation(s) in {', '.join(paths)}"
          if n else f"repro-lint: clean ({', '.join(paths)})")
    return 1 if n else 0


def golden_lm_config():
    """The smoke SmolLM the golden LM plan is compiled for (the reference
    CLI's: 2 layers, d_model 64, GQA 2:1, head_dim 32, W1A8)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import W1A8

    return dataclasses.replace(
        get_config("smollm-360m").smoke(
            n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
            vocab=64, head_dim=32),
        quant=dataclasses.replace(W1A8, engine="auto"))


def golden_lm_numpy(cfg, seed: int = 0) -> dict:
    """Float params of the golden (pure-attention, untied) smoke LM in the
    reference's layout, as numpy arrays drawn from
    ``np.random.RandomState(seed)``: N(0, 1/fan_in) projections, unit norm
    scales, the embedding x0.02 (``convert.lm_params_from_numpy`` makes
    them the port's)."""
    import numpy as np

    rs = np.random.RandomState(seed)
    n, d, hd = cfg.n_layers, cfg.d_model, cfg.hd
    h, hk, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def w(*shape):
        return (rs.randn(*shape) / np.sqrt(shape[-2])).astype(np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    return {"embed": (rs.randn(cfg.padded_vocab, d) * 0.02).astype(
                np.float32),
            "final_norm": ones(d),
            "blocks": {"attn": {
                "attn": {"ln": ones(n, d), "wq": w(n, d, h * hd),
                         "wk": w(n, d, hk * hd), "wv": w(n, d, hk * hd),
                         "wo": w(n, h * hd, d)},
                "mlp": {"ln": ones(n, d), "w_in": w(n, d, ff),
                        "w_gate": w(n, d, ff), "w_out": w(n, ff, d)}}}}


def _golden_plans(tmp: str):
    """Compile the golden plans (structure-only CNNs + the smoke LM) for
    ``cuda`` on the CPU, save each, and yield (name, artifact base path):
    the reference CLI's golden set, so what the tests pin is what the CLI
    proves.  The compiles skip the prover: check-plan states it."""
    from repro_torch.configs.paper_cnn import ALEXNET_SPEC, SVHN_SPEC
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.core.plan import compile_lm, compile_model, save_plan
    from repro_torch.core.quant import W1A4, W1A8

    for name, spec, img, quant in (("svhn", SVHN_SPEC, 40, W1A4),
                                   ("alexnet", ALEXNET_SPEC, 112, W1A8)):
        plan = compile_model(None, spec, quant, batch_hints=(1, 8),
                             img_hw=img, model=name, verify=False)
        yield name, save_plan(plan, f"{tmp}/{name}")
    cfg = golden_lm_config()
    params = lm_params_from_numpy(golden_lm_numpy(cfg), cfg, device="cpu")
    plan = compile_lm(params, cfg, batch_hints=(2,), prompt_len=8,
                      verify=False)
    yield "lm-smoke", save_plan(plan, f"{tmp}/lm_smoke")


def _cmd_check_plan(args) -> int:
    from repro_torch.analysis.prover import verify_plan_file

    targets: list[tuple[str, str]] = [(p, p) for p in args.plans]
    fails = 0
    with tempfile.TemporaryDirectory() as tmp:
        if args.golden:
            targets.extend(_golden_plans(tmp))
        if not targets:
            print("check-plan: no plans given (pass paths or --golden)",
                  file=sys.stderr)
            return 2
        for name, path in targets:
            violations = verify_plan_file(path, args.target)
            for v in violations:
                print(f"{name}: {v}")
            status = f"{len(violations)} violation(s)" if violations else "OK"
            print(f"check-plan {name}: {status}")
            fails += bool(violations)
    return 1 if fails else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    sub = ap.add_subparsers(dest="cmd", required=True)
    lint = sub.add_parser("lint", help="run the RL001–RL005 AST rules")
    lint.add_argument("paths", nargs="*",
                      help="files/dirs (default: src/repro_torch)")
    lint.add_argument("--list-rules", action="store_true")
    lint.set_defaults(fn=_cmd_lint)
    chk = sub.add_parser("check-plan",
                         help="verify serialized plan artifacts (PV101–108)")
    chk.add_argument("plans", nargs="*", help="plan .json paths")
    chk.add_argument("--golden", action="store_true",
                     help="compile + verify the golden svhn/alexnet/LM plans")
    chk.add_argument("--target", default=None,
                     help="override the backend the proofs are stated "
                          "against (default: each plan's own)")
    chk.set_defaults(fn=_cmd_check_plan)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
