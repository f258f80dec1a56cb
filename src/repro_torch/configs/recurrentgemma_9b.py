"""recurrentgemma-9b — RG-LRU + local attention, 1:2 pattern
[arXiv:2402.19427].
38 layers = 12 x (rec, rec, attn_local) + (rec, rec) remainder.
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="recurrentgemma-9b", family="rglru",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256, window=2048,
    lru_width=4096, conv_width=4,
    pattern=("rec", "rec", "attn_local"), act="gelu",
)
