"""The paper's own models: SVHN bitwise CNN + binary AlexNet (port of
``repro/configs/paper_cnn.py``).

Not an LM ArchConfig — the CNN specs and bit widths the CNN serve path
and its benchmarks use; the channel width default is chosen so the SVHN
model costs ~80 MFLOPs per 40x40 image, matching the paper's §III-A
claim.
"""
from repro_torch.core.quant import PAPER_CONFIGS, W1A4
from repro_torch.models.cnn import alexnet_spec, svhn_cnn_spec

SVHN_CHANNELS = 20           # ~80 MFLOPs / 40x40 image
SVHN_SPEC = svhn_cnn_spec(SVHN_CHANNELS)
ALEXNET_SPEC = alexnet_spec()
DEFAULT_QUANT = W1A4
QUANTS = PAPER_CONFIGS
