"""DPQuant in PyTorch for NVIDIA Hopper.

A port of the JAX package ``repro`` that mirrors its module layout: each
module here has a counterpart of the same name there.  This package
imports ``torch`` and numpy only; the JAX package is the numerical
reference the tests hold it against.

Ported so far: the serving path (continuous batching over a quantized
slot-pool KV cache with the LUQ logits head), with hand-written CUDA
kernels for ``kv_quant``, ``decode_attn`` and the quantized matmul in
``repro_torch.kernels``.
"""
