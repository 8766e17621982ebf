"""Roofline terms on one NVIDIA H100 SXM, and the least time of each
hand-written kernel.

The counterpart of ``repro.launch.roofline``.  Per traced step (one
``repro_torch.launch.op_analysis`` result):

    compute term    = each class of work at its own peak, summed: bf16 on
                      the tensor cores, float32 outside them (or TF32 on
                      them where the step allowed TF32), and the Philox
                      draws' int32 operations
    memory term     = bytes moved / HBM rate
    collective term = collective wire bytes / NVLink rate

and ``bound_s``, the largest of the three.  Eager PyTorch runs one kernel
at a time on one stream, so the classes of different kernels add up.

The card's constants are the data sheet's for the H100 SXM at its 700 W
limit (dense, no sparsity): 3.35 TB/s of HBM3; 989 TFLOP/s bf16 on the
tensor cores, 495 TF32, 67 float32 outside them; 450 GB/s of NVLink each
way.  A card set below 700 W runs slower under load, so a share taken
against these is an upper bound on the card's own.

:func:`kernel_cost` owns the least work of the six kernels of
``repro_torch.kernels`` (inputs read once, outputs written once, the
operations at their peaks), for ``chip_smoke.py``'s kernel rows and for
the analysis's per-call costs alike: a kernel's bound counts the same
work whatever implements it.

``count_params``, ``active_params``, ``_attention_flops`` and
``model_flops`` are the reference's arithmetic on the port's flat param
dicts (an expert leaf: a name whose last component starts with ``e_``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

HBM_BW = 3.35e12                     # bytes / s
#: float operations / s by class: bf16 (and fp16) on the tensor cores,
#: float32 on them as TF32, float32 outside them
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
LINK_BW = 450e9                      # NVLink, bytes / s each way
#: the card's device memory, against which a trace's peak ``fits``
DEVICE_BYTES = 80e9

# The int32 lanes: 64 an SM a clock on Hopper, 132 SMs, at the card's
# maximum SM clock (nvidia-smi's clocks.max.sm).
SM_COUNT = 132
INT32_LANES = SM_COUNT * 64
MAX_SM_CLOCK_MHZ = 1980.0

# float32 operations of one LUQ rounding (abs, two divisions, log2,
# floor, two exp2, clamps, compares, selects, sign, two products)
LUQ_OPS = 24
# 32-bit integer operations of one Philox4x32-10 call, at the least: 10
# rounds of two 32 x 32 -> 64 multiplies (one IMAD.WIDE.U32 each gives
# both words) and two three-input XORs (one LOP3 each), and one shift a
# word for the uniforms: 10 * 4 + 4 = 44.  The key bumps are the same for
# every call of a key and the float conversions are not int32 work; not
# counted.
PHILOX_INT_OPS = 44

# ring costs: an all-reduce moves ~2x its buffer over the slowest link,
# the others ~1x (the reference's factors)
WIRE_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

#: The kernel wrappers of ``repro_torch.kernels.ops``.
KERNELS = ("luq_matmul", "kv_quant_write", "decode_attn_fused", "luq_quant",
           "clip_and_sum", "ghost_norm_sq")


class KernelCost(NamedTuple):
    """The least work of one kernel call: bytes moved, float32 operations
    outside the tensor cores, bf16 tensor-core operations, int32
    operations."""
    bytes: float
    flops: float
    tc_flops: float = 0.0
    int_ops: float = 0.0


def _luq_matmul(rows, k, n, keys, variant):
    # a, Q(a)'s scratch, b, the scales, the keys and the output; the keys
    # and scales are one a row (the decode tick) or one (a shared key)
    nbytes = 4 * (2 * rows * k + k * n + keys + 1 + 2 * keys + rows * n)
    flops = 2 * rows * k * n + LUQ_OPS * (k * n + rows * k)
    if variant == "uniforms_from_memory":
        # the first design's convention: its uniforms read from memory
        return KernelCost(nbytes + 4 * (rows * k + keys * k * n), flops)
    if variant is not None:
        raise ValueError(f"luq_matmul has no variant {variant!r}")
    # Philox calls: a's elements one a call; b's four a call, each key
    calls = rows * k + keys * k * n // 4
    return KernelCost(nbytes, flops, 0.0, PHILOX_INT_OPS * calls)


def _kv_quant_write(rows, head_dim, code_dim, elem, slots, variant):
    # the K and V rows read, codes and bf16 scales written, each slot's
    # position read (0 slots: a prefill's rows from row 0)
    if variant is not None:
        raise ValueError(f"kv_quant_write has no variant {variant!r}")
    return KernelCost(elem * rows * head_dim + rows * (code_dim + 2)
                      + 8 * slots, 8.0 * rows * head_dim)


def _decode_attn(batch, kv_heads, group, head_dim, code_dim, live_rows,
                 variant):
    # float32 queries read and outputs written, the positions, and each
    # attended (slot, row)'s K and V codes and scales for every KV head
    if variant is not None:
        raise ValueError(f"decode_attn_fused has no variant {variant!r}")
    nbytes = (batch * kv_heads * group * head_dim * 4 * 2 + batch * 4
              + live_rows * kv_heads * (2 * code_dim + 2 * 2))
    return KernelCost(nbytes, live_rows * kv_heads * group * (4 * head_dim
                                                               + 8))


def _luq_quant(rows, n, elem, variant):
    # each element read once and written once in its own dtype, the key's
    # draws once (ceil(n / 4) Philox calls, shared by the rows) and LUQ's
    # rounding of every element
    numel = rows * n
    ops = dict(flops=LUQ_OPS * numel,
               int_ops=PHILOX_INT_OPS * ((n + 3) // 4))
    if variant is None:
        return KernelCost(2 * elem * numel, **ops)
    if variant == "three_passes":
        # the kernel's own passes: x read twice (row max, rounding)
        return KernelCost(3 * elem * numel, **ops)
    if variant == "float32_uniforms":
        # the first design's convention: float32 x and uniforms read, the
        # float32 result written
        return KernelCost(4 * (2 * numel + n + rows), LUQ_OPS * numel)
    if variant == "pass":
        # the layer's flag at 0: x copied through
        return KernelCost(2 * elem * numel, 0.0)
    raise ValueError(f"luq_quant has no variant {variant!r}")


def _clip_and_sum(rows, n, variant):
    # the (B, D) float32 rows read once, the sum and the norms written
    nbytes = 4 * (rows * n + n + rows)
    if variant == "two_reads":
        # the floor of any kernel taking the matrix from device memory:
        # each clip factor needs its row's norm before a column is summed
        nbytes += 4 * rows * n
    elif variant is not None:
        raise ValueError(f"clip_and_sum has no variant {variant!r}")
    return KernelCost(nbytes, 4.0 * rows * n)


def _ghost_norm_sq(batch, t, dx, dg, elem_x, elem_g, variant):
    # the operands read once, the (B,) norms written; LUQ's rounding of
    # both in float32, each symmetric Gram's upper triangle with its
    # diagonal (T (T + 1) / 2 dot products of D) on the bf16 tensor cores
    # (the codes are exact in bf16), then XX o GG and its sum in float32
    nbytes = elem_x * batch * t * dx + elem_g * batch * t * dg + 4 * batch
    luq = LUQ_OPS * batch * t * (dx + dg)
    grams = batch * t * (t + 1) * (dx + dg)
    tail = batch * t * (t + 1)
    if variant is None:
        return KernelCost(nbytes, luq + tail, grams)
    if variant == "pass":
        # the layer's flag at 0: the Grams of the operands themselves
        return KernelCost(nbytes, tail, grams)
    if variant == "f32_full_grams":
        # the first design's convention: both whole Grams in float32
        return KernelCost(nbytes, 2 * batch * t * t * (dx + dg)
                          + 2 * batch * t * t + luq)
    raise ValueError(f"ghost_norm_sq has no variant {variant!r}")


_COSTS = {"luq_matmul": _luq_matmul, "kv_quant_write": _kv_quant_write,
          "decode_attn_fused": _decode_attn, "luq_quant": _luq_quant,
          "clip_and_sum": _clip_and_sum, "ghost_norm_sq": _ghost_norm_sq}


def kernel_cost(name: str, variant: Optional[str] = None,
                **shape) -> KernelCost:
    """The least work of one call of kernel ``name`` (:data:`KERNELS`) at
    ``shape``:

    * ``luq_matmul``: ``rows``, ``k``, ``n`` of (rows, k) x (k, n) and its
      ``keys`` (one a row, or one shared by the rows);
    * ``kv_quant_write``: ``rows`` (K's and V's rows together),
      ``head_dim``, ``code_dim`` (bytes of a row's codes), ``elem`` (bytes
      of an input element), ``slots`` (0 for a prefill from row 0);
    * ``decode_attn_fused``: ``batch``, ``kv_heads``, ``group`` (query
      heads a KV head), ``head_dim``, ``code_dim``, ``live_rows`` (the
      (slot, row) pairs attended, what the positions give);
    * ``luq_quant``: ``rows``, ``n``, ``elem``;
    * ``clip_and_sum``: ``rows``, ``n`` of the (B, D) float32 matrix;
    * ``ghost_norm_sq``: ``batch``, ``t``, ``dx``, ``dg``, ``elem_x``,
      ``elem_g``.

    ``variant`` names another convention of a row's side bounds (e.g.
    ``"two_reads"`` of the clip, ``"pass"`` of a flag at 0)."""
    if name not in _COSTS:
        raise ValueError(f"unknown kernel {name!r} (expected one of "
                         f"{KERNELS})")
    return _COSTS[name](variant=variant, **shape)


def int32_rate(sm_clock_mhz: float = MAX_SM_CLOCK_MHZ) -> float:
    """int32 operations / s at ``sm_clock_mhz``."""
    return INT32_LANES * sm_clock_mhz * 1e6


def bound(cost: KernelCost, sm_clock_mhz: float = MAX_SM_CLOCK_MHZ):
    """``(bound_ms, bound_by)``: the larger of the bytes' time at the
    memory rate and the operations' time, ``flops`` at the float32 rate,
    ``tc_flops`` at the bf16 tensor cores' and ``int_ops`` at the int32
    rate, whichever of those is longest."""
    t_bytes = cost.bytes / HBM_BW * 1e3
    t_ops = max(cost.flops / PEAK_FLOPS["f32"],
                cost.tc_flops / PEAK_FLOPS["bf16"],
                cost.int_ops / int32_rate(sm_clock_mhz)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def memory_ms(nbytes: float) -> float:
    """The least time of moving ``nbytes`` through device memory."""
    return nbytes / HBM_BW * 1e3


# --------------------------------------------------------------------------- #
# a traced step's terms
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class RooflineTerms:
    flops: float                     # float operations, every class
    flops_by_class: Dict[str, float]
    int_ops: float
    bytes_accessed: float
    collective_bytes: float          # buffer bytes, per device
    collective_wire_bytes: float     # ring-cost wire bytes
    compute_s: float
    memory_s: float
    collective_s: float
    bound_s: float
    dominant: str
    model_flops_per_device: Optional[float] = None
    useful_ratio: Optional[float] = None

    def as_dict(self):
        return dataclasses.asdict(self)


def derive(analysis: dict, model_flops_per_device: Optional[float] = None,
           sm_clock_mhz: float = MAX_SM_CLOCK_MHZ) -> RooflineTerms:
    """The terms of one ``op_analysis`` result: its ``flops_by_class``
    (the kernels' own operations included) each at its class's peak and
    its ``int_ops`` at the int32 rate, summed; its ``bytes`` at the
    memory rate; its ``collective_wire_bytes`` at NVLink's."""
    by_class = {k: float(v) for k, v in analysis["flops_by_class"].items()}
    int_ops = float(analysis.get("int_ops", 0.0))
    flops = sum(by_class.values())
    compute_s = (sum(v / PEAK_FLOPS[k] for k, v in by_class.items())
                 + int_ops / int32_rate(sm_clock_mhz))
    memory_s = float(analysis["bytes"]) / HBM_BW
    wire = float(analysis["collective_wire_bytes"])
    coll_s = wire / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    ratio = (model_flops_per_device / flops
             if model_flops_per_device and flops else None)
    return RooflineTerms(
        flops=flops, flops_by_class=by_class, int_ops=int_ops,
        bytes_accessed=float(analysis["bytes"]),
        collective_bytes=float(sum(analysis["collectives"].values())),
        collective_wire_bytes=wire, compute_s=compute_s, memory_s=memory_s,
        collective_s=coll_s, bound_s=terms[dominant], dominant=dominant,
        model_flops_per_device=model_flops_per_device, useful_ratio=ratio)


# --------------------------------------------------------------------------- #
# MODEL_FLOPS estimation
# --------------------------------------------------------------------------- #
def _numel(leaf) -> int:
    shape = leaf.shape if hasattr(leaf, "shape") else leaf[0]
    n = 1
    for d in shape:
        n *= int(d)
    return n


def count_params(params: dict) -> int:
    """Parameters of a flat param dict (tensors, or (shape, dtype)
    specs)."""
    return int(sum(_numel(x) for x in params.values()))


def active_params(cfg, params: dict) -> int:
    """N_active: for MoE, experts count at top_k / n_experts utilization."""
    total = 0.0
    for name, leaf in params.items():
        frac = 1.0
        if cfg.family == "moe_lm" and name.split(".")[-1].startswith("e_"):
            frac = cfg.top_k / max(cfg.n_experts, 1)
        total += _numel(leaf) * frac
    return int(total)


def _attention_flops(cfg, kind: str, B: int, S: int) -> float:
    """Quadratic attention term missing from 6*N*D (PaLM-appendix style).

    fwd = 4 * B * S^2 * (H*hd) / 2 (causal); train multiplies by 4
    (fwd + 2x bwd + remat re-fwd); decode reads S keys for 1 query."""
    H = getattr(cfg, "padded_heads", 0) or 0
    hd = cfg.head_dim or 0
    if H == 0 or hd == 0:
        return 0.0
    if cfg.family == "hybrid":
        # only 1-in-3 layers attend, over a bounded window
        L_attn = cfg.n_layers // 3
        span = min(cfg.attn_window, S)
        per_layer_fwd = 4.0 * B * S * span * H * hd / 2.0
    elif cfg.family == "encdec":
        L_attn = cfg.n_enc_layers + 2 * cfg.n_dec_layers
        per_layer_fwd = 4.0 * B * S * S * H * hd / 2.0
    elif cfg.family in ("ssm",):
        return 0.0
    else:
        L_attn = cfg.n_layers
        per_layer_fwd = 4.0 * B * S * S * H * hd / 2.0
    if kind == "train":
        return 4.0 * L_attn * per_layer_fwd
    if kind == "prefill":
        return L_attn * per_layer_fwd
    # decode: one query over the full cache
    return L_attn * 4.0 * B * S * H * hd


def model_flops(cfg, params: dict, kind: str, global_batch: int,
                seq_len: int, n_devices: int = 1) -> float:
    """6 N D (train), 2 N D (prefill), 2 N B (decode), N the active
    parameters, D the tokens, plus the attention term."""
    n_act = active_params(cfg, params)
    if kind == "train":
        total = 6.0 * n_act * global_batch * seq_len
    elif kind == "prefill":
        total = 2.0 * n_act * global_batch * seq_len
    else:  # decode: one token per sequence
        total = 2.0 * n_act * global_batch
    total += _attention_flops(cfg, kind, global_batch, seq_len)
    return total / n_devices
