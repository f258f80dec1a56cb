"""hubert-xlarge — encoder-only audio backbone [arXiv:2106.07447].

Modality frontend is a stub: the caller provides precomputed frame
features (B, T, frame_dim) to ``prefill(frame_feats=)``.  Encoder-only:
no decode.
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504, causal=False, frame_input=True, frame_dim=512,
    pattern=("attn",), act="gelu", rope_theta=10_000.0,
)
