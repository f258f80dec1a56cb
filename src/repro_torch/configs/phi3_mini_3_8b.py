"""phi3-mini-3.8b — dense RoPE+SwiGLU+GQA [arXiv:2404.14219]."""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064, rope_theta=10_000.0,
    pattern=("attn",), act="swiglu",
)
