"""yi-34b — llama-arch GQA dense [arXiv:2403.04652].

56 query heads are padded to 64 on TP=16 meshes (zero-masked, math-exact);
kv=8 heads replicate across the model axis (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128, rope_theta=5_000_000.0,
    pattern=("attn",), act="swiglu",
)
