"""smollm-360m — llama-arch small [hf:HuggingFaceTB/SmolLM].

15 query heads over 5 KV heads (GQA group 3), head_dim 64, tied
embeddings.
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, head_dim=64, tie_embeddings=True,
    pattern=("attn",), act="swiglu",
    skip_shapes=("long_500k",),
)
