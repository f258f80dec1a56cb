"""Core of the port: DoReFa quantization, the AND-Accumulation level GEMM
and its conv lowering (the entry points ``repro.core`` re-exports)."""
from .and_accum import bitgemm, quant_dense_forward, reference_float
from .conv_lowering import conv2d_float, im2col, quant_conv2d
from .quant import (FP32, PAPER_CONFIGS, W1A1, W1A4, W1A8, W2A2,
                    QuantConfig, activation_levels, quantize_activation,
                    quantize_gradient, quantize_weight, weight_levels)
from . import bitplane, compressor

__all__ = ["bitgemm", "quant_dense_forward", "reference_float",
           "conv2d_float", "im2col", "quant_conv2d", "FP32", "PAPER_CONFIGS",
           "W1A1", "W1A4", "W1A8", "W2A2", "QuantConfig",
           "activation_levels", "quantize_activation", "quantize_gradient",
           "quantize_weight", "weight_levels", "bitplane", "compressor"]
