"""SmolLM-360M's first training loss at full width, port against the
reference, run by hand on the CPU (~4 GB, ~30 s; not collected by pytest):

    PYTHONPATH=src python tests/init_loss_full_width.py

Both sides take the same float params (the families tests' numpy draw)
and the first ``lm_batch`` the card's ``TRAIN`` phase trains on (8 x 64
over its first 512 tokens), at W1A8 and at W32A32, float32 compute; then
the port's own ``init_lm`` from seed 0 in bf16, as that phase draws it.
Prints each loss beside ln V + (0.02² d) / 2, the start a tied
N(0, 0.02²) embedding gives (logits of std 0.02·√d over V classes).
"""
import dataclasses
import math
import os
import sys

import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from repro import configs as jconfigs  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from test_torch_families import numpy_params  # noqa: E402


def main() -> None:
    torch.set_num_threads(4)
    batch = lm_batch(0, 0, batch=8, seq=64, vocab=512, seed=0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for name in ("w1a8", "w32a32"):
        jcfg = dataclasses.replace(
            jconfigs.get_config("smollm-360m"), remat=False,
            quant=jquant.PAPER_CONFIGS[name], compute_dtype=jnp.float32)
        cfg = dataclasses.replace(
            configs.get_config("smollm-360m"), remat=False,
            quant=quant.PAPER_CONFIGS[name], compute_dtype=torch.float32)
        raw = numpy_params(jcfg)
        ref, _ = jax.jit(lambda p, b: JT.lm_loss(
            p, b, jcfg, jconfigs.SINGLE))(
            jax.tree.map(jnp.asarray, raw),
            {k: jnp.asarray(v) for k, v in batch.items()})
        params = convert.lm_train_params_from_numpy(raw, device="cpu")
        with torch.no_grad():
            got, _ = T.lm_loss(params, tb, cfg, configs.SINGLE)
        print(f"{name}: reference {float(ref):.6f}, port {float(got):.6f}, "
              f"relative {abs(float(got) - float(ref)) / float(ref):.2e}")
    cfg = dataclasses.replace(configs.get_config("smollm-360m"),
                              quant=quant.W1A8, remat=False)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg,
                       configs.SINGLE, device="cpu")
    with torch.no_grad():
        own, _ = T.lm_loss(params, tb, cfg, configs.SINGLE)
    print(f"port init_lm seed 0, w1a8 bf16: {float(own):.6f}")
    print(f"ln V {math.log(cfg.vocab):.6f}, ln V + 0.02^2 d / 2 = "
          f"{math.log(cfg.vocab) + 0.02 ** 2 * cfg.d_model / 2:.6f}")


if __name__ == "__main__":
    main()
