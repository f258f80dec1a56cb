"""PyTorch / CUDA port of the PIM-CNN serve path for NVIDIA Hopper (H100).

A second package beside ``repro`` (the JAX reference, which it never
imports).  Module names mirror ``repro`` so each counterpart is easy to
find; public functions keep the reference's layouts (NHWC activations,
HWIO float weights, ``(kh, kw, cin)``-major K for weight levels) so the
parity tests compare like with like.

The quantized layers run on two hand-written CUDA kernels
(``csrc/fused_qgemm.cu``, ``csrc/conv_implicit.cu``), built with ``nvcc``
on first use and bound through ``ctypes``.  Every kernel wrapper takes its
plain PyTorch version for CPU tensors and launches the kernel (or raises)
for CUDA tensors — there is no fallback.
"""
import torch

# fp32 outside the kernels must stay fp32: the fp first/last layers and
# every float matmul are compared against the reference's full-precision
# (Precision.HIGHEST) math, and cuDNN convolutions default to TF32, which
# keeps only ~3 decimal digits.  Both switches are set explicitly.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
