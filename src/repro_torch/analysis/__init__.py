"""Static verification of the port: plan prover + repro-lint.

Two entry points, also exposed as ``python -m repro_torch.analysis``:

* :func:`verify_plan` / :func:`verify_plan_file` — interval/bit-range
  abstract interpretation over a compiled
  :class:`~repro_torch.core.plan.ModelPlan` (PV101–PV108, stated against
  the Hopper kernels' bounds), run by default inside ``compile_model`` /
  ``compile_lm`` / ``Model.compile``.
* :func:`lint_paths` — the RL001–RL005 AST rule engine (RL004 holds each
  ctypes launcher to its kernel's ``extern "C"`` signature).

The lint module itself imports the standard library only; the prover
names resolve lazily, on first use.
"""
from repro_torch.analysis.lint import (RULES, LintViolation, lint_file,  # noqa: F401
                                       lint_paths, lint_source)


def __getattr__(name):
    # prover symbols resolve lazily: `import repro_torch.analysis` (and
    # the lint CLI) never loads the plan IR and the kernels' modules
    if name in ("verify_plan", "verify_plan_file", "assert_plan_verified",
                "PlanVerificationError", "Violation"):
        from repro_torch.analysis import prover

        return getattr(prover, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["RULES", "LintViolation", "lint_file", "lint_paths",
           "lint_source", "verify_plan", "verify_plan_file",
           "assert_plan_verified", "PlanVerificationError", "Violation"]
