"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``ops`` holds the wrappers (``luq_matmul``, ``kv_quant_rows``,
``decode_attn_fused``), ``ref`` the plain versions, ``build`` the nvcc
build of ``csrc/*.cu``.  Importing this package builds nothing.
"""
