"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``ops`` holds the wrappers (``luq_matmul``, ``kv_quant_write``,
``decode_attn_fused``, ``luq_quant``, ``clip_and_sum``,
``ghost_norm_sq``), ``ref`` the plain
versions, ``build`` the nvcc build of ``csrc/*.cu``.  Importing this
package builds nothing.
"""
