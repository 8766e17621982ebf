"""Config dataclasses and device resolution.

The counterpart of ``repro.config``, cut to what the ported paths read
(serving, DP-SGD training of the ResNet, DenseNet, BERT, Mamba-2,
Griffin, VLM, encoder-decoder and MoE families, ghost-mode DP-SGD
training of the dense LMs and CNNs).  Dtypes are strings
(as in the JAX package) mapped to ``torch.dtype`` by :func:`torch_dtype`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

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


#: The device a shape-only trace names, innermost last (:func:`traced_device`).
_TRACED = []


@contextlib.contextmanager
def traced_device(device):
    """Name ``device`` for a trace on shape-only tensors
    (``repro_torch.launch.op_analysis``: ``"meta"``, or ``"cuda"`` under
    ``torch``'s ``FakeTensorMode``), where no device memory is touched:
    inside, :func:`resolve_device` accepts it with or without a GPU and
    :func:`generator` gives a CPU generator for it, since such a tensor's
    draws read no generator.  Nothing else takes this way past the GPU
    check."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"a trace names 'cuda' or 'meta', got {dev}")
    _TRACED.append(torch.device(dev.type, 0) if dev.type == "cuda" else dev)
    try:
        yield _TRACED[-1]
    finally:
        _TRACED.pop()


def generator(device) -> torch.Generator:
    """A random generator for draws on ``device``: the device's own, or
    a CPU one for the device a trace names (:func:`traced_device`)."""
    dev = torch.device(device)
    if _TRACED and dev.type == _TRACED[-1].type:
        return torch.Generator()
    return torch.Generator(device=dev)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks.

    ``None`` means ``"cuda"``.  A CUDA request on a machine without a
    usable GPU raises; nothing drops quietly to the CPU.  Inside
    :func:`traced_device` the traced device is returned as named.
    """
    dev = torch.device("cuda" if device is None else device)
    if _TRACED and dev.type == _TRACED[-1].type:
        return _TRACED[-1]
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
    """Architecture description (dense decoder-only LMs, ResNets,
    DenseNets, the BERT encoder, Mamba-2, the Griffin hybrid, the VLM
    backbone, the encoder-decoder and the mixture-of-experts LMs)."""

    name: str
    family: str
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    dense_ff_residual: int = 0          # arctic-style dense residual MLP width
    moe_impl: str = "dense"             # "dense" (small/smoke) | "capacity"
    moe_capacity_factor: float = 1.25
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_chunk: int = 256
    d_inner: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    conv_width: int = 4
    # --- hybrid (RG-LRU / griffin) ---
    lru_width: int = 0
    attn_window: int = 2048
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    # --- vlm ---
    n_vision_tokens: int = 0
    # --- encdec ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # --- cnn / bert ---
    num_classes: int = 0
    image_size: int = 32
    in_channels: int = 3
    resnet_blocks: Tuple[int, ...] = ()
    densenet_blocks: Tuple[int, ...] = ()
    growth_rate: int = 32
    max_position: int = 512
    mlp_activation: str = "geglu"        # geglu | swiglu | gelu | relu
    tie_embeddings: bool = True
    rope_theta: float = 10_000.0
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    attn_chunk_q: int = 512
    ce_chunk: int = 512                  # chunked-loss sequence chunk (training)
    # Dense LMs: recompute each block in the backward instead of keeping its
    # activations (torch.utils.checkpoint), the reference's jax.checkpoint
    # of every block, on by default as there.  Training only; serving and
    # the vmap engine's per-example grads run without it.
    remat: bool = True
    pad_heads_to: int = 1                # pad n_heads up to a multiple of this
    pad_vocab_to: int = 128
    # per-arch partitioner rule overrides: ((logical_name, ((axes...), ...)),
    # ...), merged over partitioner.DEFAULT_RULES by the train step
    sharding_overrides: Tuple = ()

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

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return self.family in ("dense_lm", "moe_lm", "ssm", "hybrid",
                               "encdec", "vlm")

    def policy_len(self) -> int:
        """Number of schedulable layers for DPQuant."""
        if self.family == "encdec":
            return self.n_enc_layers + self.n_dec_layers
        if self.family == "resnet":
            return sum(self.resnet_blocks) + 1
        if self.family == "densenet":
            return sum(self.densenet_blocks) + len(self.densenet_blocks)
        return self.n_layers


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Low-precision config: ``fmt`` (training: the fake-quantized GEMMs;
    serving: the logits head), which GEMMs of a quantized layer quantize
    their inputs, and the quantizer ``backend``.

    ``backend``: ``"ref"`` = plain PyTorch formats; ``"cuda"`` = the
    hand-written kernels of ``repro_torch.kernels`` (their plain versions
    on CPU tensors).  Formats a backend lacks fall back to ``"ref"``
    explicitly; ``REPRO_QUANT_BACKEND`` overrides this field.
    """

    fmt: str = "luq_fp4"    # luq_fp4 | int4 | fp8_e4m3 | fp8_e5m2 | bf16 | none
    quantize_fwd: bool = True
    quantize_dgrad: bool = True   # paper A.12: quantize inputs of dgrad GEMM
    quantize_wgrad: bool = True   # ... and of wgrad GEMM
    backend: str = "cuda"


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """DP-SGD and DPQuant-analysis knobs, the JAX package's (without its
    ``compress_cross_pod``, which no step there reads either)."""

    enabled: bool = True
    clip_norm: float = 1.0
    noise_multiplier: float = 1.0
    delta: float = 1e-5
    microbatch_size: int = 1
    # "data_parallel": each microbatch holds microbatch_size examples per
    # data shard (mb = microbatch_size * dp_degree, launch/steps.py);
    # "single": mb = 1.
    microbatch_mode: str = "data_parallel"
    grad_accum_dtype: str = "float32"    # dtype of the clipped-grad sum
    # "ref": per-leaf norms and a scaled sum in PyTorch; "fused": flatten
    # each microbatch's per-example grads to (B, D) and run the
    # per_sample_clip kernel (repro_torch.kernels).
    clip_backend: str = "ref"
    # "vmap" materializes per-example grads with torch.func (dp/clip.py);
    # "ghost" = two-pass ghost-norm clipping (dp/ghost.py): per-example
    # norms from layer activation / cotangent Grams, then ONE reweighted
    # batched backward.  Needs a family with ghost hooks (dense_lm) and
    # clip_backend="ref"; microbatch_size is ignored.
    grad_mode: str = "vmap"
    # Ghost pass-1 chunk size (0 = the whole batch in one pass): pass-1
    # live state is one chunk of activations; numerically identical
    # (per-example quantization is chunk-invariant).
    ghost_microbatch: int = 0
    # Data-parallel ghost driver (dp/ghost.sharded_ghost_clipped_grad_sum):
    # "auto" = each rank runs both passes on its block of the batch when
    # the mesh's data axes have degree > 1, its model axis degree 1 and
    # the batch divides; "on" / "off" force the choice.
    ghost_sharded: str = "auto"
    # DPQuant analysis (paper Table 3 defaults)
    analysis_interval: int = 2       # epochs between COMPUTELOSSIMPACT runs
    analysis_reps: int = 2           # R
    analysis_batch_size: int = 32    # n_sample
    analysis_clip: float = 0.01      # C_measure
    analysis_noise: float = 0.5      # sigma_measure
    ema_alpha: float = 0.3           # EMA decay for policy scores
    beta: float = 10.0               # softmax temperature
    quant_fraction: float = 0.9      # fraction of layers quantized
    # vmap engine on a mesh: each rank keeps its own clipped sum over the
    # microbatches and the ranks reduce once a step, instead of once a
    # microbatch
    partial_accum: bool = False


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    name: str = "sgd"                # sgd | momentum | adam | adamw
    lr: float = 0.5
    momentum: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    warmup_steps: int = 0
    schedule: str = "constant"       # constant | cosine | linear


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the assigned input-shape cells."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    quant: QuantConfig = QuantConfig()
    dp: DPConfig = DPConfig()
    optim: OptimConfig = OptimConfig()
    seed: int = 0
    global_batch: int = 1024
    seq_len: int = 1024
    steps: int = 100
    steps_per_epoch: int = 10
    # "scan": the steps run as replays of one CUDA graph of the train step,
    # captured once for every quantization policy (the policy is a device
    # tensor the graph reads), and the DPQuant probes as replays of a
    # second one (train_loop.Trainer._train_steps_scan; one host sync per
    # chunk).  "loop": one eager step, host sync and accountant charge per
    # step, and eager probe steps.
    epoch_executor: str = "scan"
    # 0 = the whole epoch at once; k > 0 = chunks of k steps (bounds the
    # device memory held by the staged batches).
    epoch_chunk: int = 0
    # Steps per loop iteration of the reference's lax.scan; 1 only.
    epoch_unroll: int = 1
    # The degree of the host mesh's ``model`` axis (tensor and expert
    # parallelism: launch.mesh.make_host_mesh, the train CLI's
    # --model-parallel); 1 = every rank holds whole params.
    model_parallel: int = 1


EPOCH_EXECUTORS = ("scan", "loop")


def validate_executor(run: RunConfig) -> None:
    """Raise on an epoch executor the port does not have."""
    if run.epoch_executor not in EPOCH_EXECUTORS:
        raise ValueError(f"epoch_executor must be 'scan' or 'loop', "
                         f"got {run.epoch_executor!r}")
    if run.epoch_chunk < 0:
        raise ValueError(f"epoch_chunk must be >= 0, got {run.epoch_chunk}")
    if run.epoch_unroll != 1:
        raise NotImplementedError(
            f"epoch_unroll={run.epoch_unroll}: a CUDA graph has no unroll "
            "factor yet (ROADMAP.md section 1, item 1: epoch_unroll > 1)")


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
    # ---- admission control and fault tolerance ----
    # Per-request deadline in seconds from arrival (None = no deadline).
    # An expired queued request is retired without admission ("rejected"
    # bucket); an expired in-flight request retires with its partial
    # tokens and status "timed_out".  Overridable per request at submit().
    deadline_s: Optional[float] = None
    # Queue bound: submissions beyond this many waiting requests are shed
    # at once (status "shed").  0 = unbounded.
    max_queue: int = 0
    # Retry policy for injected or detected faults (prefill or decode
    # dispatch failure, detected slot-cache poison): a victim is re-queued
    # up to max_retries times and replayed (its prompt prefilled, its
    # generated prefix decoded again), token-identical because the
    # computation of every position is the fault-free run's.  Exhausted
    # retries finalize the request with status "failed" and its partial
    # tokens.
    max_retries: int = 2
    # Linear backoff: re-admission of attempt k is gated to
    # ``now + k * retry_backoff_s``.  0 = immediate re-queue.
    retry_backoff_s: float = 0.0

    def __post_init__(self):
        if self.max_slots < 1:
            raise ValueError("ServeConfig.max_slots must be >= 1")
        if self.max_seq < 2:
            raise ValueError("ServeConfig.max_seq must be >= 2")
        if self.kv_fmt not in KV_CACHE_FORMATS:
            raise ValueError(
                f"ServeConfig.kv_fmt must be one of {KV_CACHE_FORMATS}, "
                f"got {self.kv_fmt!r}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("ServeConfig.deadline_s must be > 0 (or None)")
        if self.max_queue < 0:
            raise ValueError("ServeConfig.max_queue must be >= 0")
        if self.max_retries < 0:
            raise ValueError("ServeConfig.max_retries must be >= 0")
        if self.retry_backoff_s < 0:
            raise ValueError("ServeConfig.retry_backoff_s must be >= 0")
