"""internvl2-26b — InternViT + InternLM2 VLM [arXiv:2404.16821].

Vision frontend is a stub: the caller provides precomputed patch
embeddings (B, n_patches, vit_dim), projected into the LM sequence ahead
of the text (``prefill(patch_embeds=)``).
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553, head_dim=128,
    n_patches=256, vit_dim=1024,
    pattern=("attn",), act="swiglu",
)
