"""DPQuant in PyTorch for NVIDIA Hopper.

A port of the JAX package ``repro`` that mirrors its module layout: each
module here has a counterpart of the same name there.  This package
imports ``torch`` and numpy only; the JAX package is the numerical
reference the tests hold it against.

Ported so far: the serving path (continuous batching over a quantized
slot-pool KV cache with the LUQ logits head), DP-SGD training of
ResNet-18 under the DPQuant scheduler and ghost-mode DP-SGD of the dense
LMs, with hand-written CUDA kernels in ``repro_torch.kernels`` for the KV
cache write, decode attention, the quantized matmul, the LUQ-FP4
quantizer, the per-example clip and the ghost norm.
"""
