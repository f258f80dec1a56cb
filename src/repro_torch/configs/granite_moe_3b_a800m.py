"""granite-moe-3b-a800m — 40 experts top-8
[hf:ibm-granite/granite-3.0-*]. 40 % 16 != 0 => experts replicate; each
expert d_ff=512 TP-shards (512/16=32) instead (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155, head_dim=64, tie_embeddings=True,
    n_experts=40, top_k=8, n_shared_experts=0, expert_d_ff=512,
    pattern=("moe",), act="swiglu",
    skip_shapes=("long_500k",),
)
