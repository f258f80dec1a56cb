"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066]. 64 % 16 == 0 => experts shard on the model axis (EP).
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, head_dim=128,
    n_experts=64, top_k=6, n_shared_experts=2, expert_d_ff=1408,
    pattern=("moe",), act="swiglu",
    skip_shapes=("long_500k",),
)
