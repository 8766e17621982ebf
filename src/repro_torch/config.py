"""Config dataclasses and device resolution.

The counterpart of ``repro.config``, cut to what the serving path reads.
Dtypes are strings (as in the JAX package) mapped to ``torch.dtype`` by
:func:`torch_dtype`.
"""
from __future__ import annotations

import dataclasses

import torch

# KV-cache storage formats for serving (ServeConfig.kv_fmt / CLI --kv-fmt):
# deterministic round-to-nearest with one bfloat16 scale per written
# (token, kv-head) row (repro_torch.quant.kv_cache).
KV_CACHE_FORMATS = ("none", "int8", "luq_fp4")

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    """Map a config dtype string (``"bfloat16"``, ...) to a torch dtype."""
    return _DTYPES[name]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks.

    ``None`` means ``"cuda"``.  A CUDA request on a machine without a
    usable GPU raises; nothing drops quietly to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # name the device as tensors report it, so devices compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description (dense decoder-only LMs in this slice)."""

    name: str
    family: str
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    mlp_activation: str = "geglu"        # geglu | swiglu | gelu | relu
    tie_embeddings: bool = True
    rope_theta: float = 10_000.0
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    attn_chunk_q: int = 512
    ce_chunk: int = 512                  # chunked-loss sequence chunk (training)
    pad_heads_to: int = 1                # pad n_heads up to a multiple of this
    pad_vocab_to: int = 128

    @property
    def padded_heads(self) -> int:
        if self.n_heads == 0:
            return 0
        return _round_up(self.n_heads, self.pad_heads_to)

    @property
    def padded_vocab(self) -> int:
        if self.vocab_size == 0:
            return 0
        return _round_up(self.vocab_size, self.pad_vocab_to)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Low-precision config: ``fmt`` (serving: the logits head's format)
    and the quantizer ``backend``.

    ``backend``: ``"ref"`` = plain PyTorch formats; ``"cuda"`` = the
    hand-written kernels of ``repro_torch.kernels`` (their plain versions
    on CPU tensors).  Formats a backend lacks fall back to ``"ref"``
    explicitly; ``REPRO_QUANT_BACKEND`` overrides this field.
    """

    fmt: str = "luq_fp4"    # luq_fp4 | int4 | fp8_e4m3 | fp8_e5m2 | bf16 | none
    backend: str = "cuda"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Continuous-batching engine knobs.

    The engine allocates one ``max_slots x max_seq`` KV cache up front;
    requests are admitted into free slots and retire independently.
    """

    max_slots: int = 8               # decode batch width (slot pool size)
    max_seq: int = 256               # per-slot KV cache length
    max_new_tokens: int = 32         # default per-request generation budget
    temperature: float = 0.0         # 0 = greedy; >0 = per-slot sampling
    seed: int = 0                    # base of the sampling seed schedule
    kv_fmt: str = "none"             # KV_CACHE_FORMATS

    def __post_init__(self):
        if self.max_slots < 1:
            raise ValueError("ServeConfig.max_slots must be >= 1")
        if self.max_seq < 2:
            raise ValueError("ServeConfig.max_seq must be >= 2")
        if self.kv_fmt not in KV_CACHE_FORMATS:
            raise ValueError(
                f"ServeConfig.kv_fmt must be one of {KV_CACHE_FORMATS}, "
                f"got {self.kv_fmt!r}")
