"""qwen3-32b — qk_norm + GQA dense [hf:Qwen/Qwen3-*]."""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
    d_ff=25600, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1_000_000.0, pattern=("attn",), act="swiglu",
    skip_shapes=("long_500k",),
)
