"""Wrappers of the CUDA kernels: checks, outputs, launch, launch counts.

Each wrapper takes tensors and:

* on CPU tensors, returns its kernel's plain version (``kernels.ref``);
* on CUDA tensors, checks device, dtype, shape and contiguity, allocates
  the outputs with ``torch.empty``, launches the kernel on the current
  stream, raises if the launch returned an error, and adds one to its
  entry of :data:`LAUNCHES`.  There is no fallback: a CUDA tensor either
  goes through the kernel or the call raises.

The kernels (``csrc/*.cu``) are built at first use by ``kernels.build``.

A third kind of tensor, one with a shape and no memory (a ``meta``
tensor, or a fake one of ``torch``'s ``FakeTensorMode`` on a device other
than the CPU), is what ``repro_torch.launch.op_analysis`` traces a step
with: such a call launches nothing, tells the analysis
(:func:`traced_launches`) which kernel it would launch, how many times
and at what shape, and returns empty outputs of the kernel's shapes and
dtypes.  Such a tensor outside an analysis raises (a ``meta`` one as
a tensor of any device but the CPU and CUDA does).
"""
from __future__ import annotations

import contextlib
import ctypes
import math

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import ref
from repro_torch.kernels.build import load_library
from repro_torch.quant import kv_cache as kvc
from repro_torch.quant import philox

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
#: Only launches of a kernel count; CPU calls of the plain versions do not.
LAUNCHES = {"luq_matmul": 0, "kv_quant_write": 0, "decode_attn_fused": 0,
            "luq_quant": 0, "clip_and_sum": 0, "ghost_norm_sq": 0}
#: The ``luq_matmul`` launches of :data:`LAUNCHES` by the serving step
#: that made them: a ``prefill``'s logits head (inside
#: :func:`prefill_launches`) or a ``decode`` step's (anywhere else).
LUQ_MATMUL_LAUNCHES = {"prefill": 0, "decode": 0}
_LUQ_MATMUL_STEP = ["decode"]
#: The ``luq_quant`` calls of :data:`LAUNCHES` by operand: a tensor
#: quantized as one row (``whole``: a weight, or anything outside vmap)
#: or one row per example (``per_example``: activations and cotangents
#: under the DP engine's vmap, the ghost hooks' batched operands; the
#: calls inside :func:`per_example_launches`, at any number of examples);
#: and the device ``kernels`` those calls launched (the row maxima and
#: the rounding: two a call).
LUQ_QUANT_LAUNCHES = {"whole": 0, "per_example": 0, "kernels": 0}
_LUQ_QUANT_OPERAND = ["whole"]
#: The ``ghost_norm_sq`` launches of :data:`LAUNCHES` by shape class, the
#: operands' widths ``"{min(Dx, Dg)}/{max(Dx, Dg)}"`` (keys appear at the
#: first launch of a class).
GHOST_NORM_LAUNCHES: dict = {}

#: The ``kv_quant_write`` launches of :data:`LAUNCHES` by caller: rows
#: written at each slot's position (``decode``) or from row 0 (``prefill``).
KV_WRITE_LAUNCHES = {"decode": 0, "prefill": 0}

_KV_FMT_CODE = {"int8": 0, "luq_fp4": 1}

#: The calls of the kernels on a shard of an operand split over the
#: model group (the model axis), each already counted in :data:`LAUNCHES`
#: where it quantizes, clips or serves: training's ``luq_round`` (a
#: ``luq_quant`` call given its rows' scales and an index map) and
#: ``luq_row_max`` before it, ``clip_sumsq`` and ``clip_apply`` (the two
#: passes of a ``clip_and_sum`` call), and ``ghost_norm_sq`` given an
#: operand's scales (``ghost_norm_mapped``); serving's ``luq_matmul`` on
#: a vocab shard (``luq_matmul_cols``), ``kv_quant_write`` into a
#: sequence shard (``kv_quant_rows``), and the two passes of a
#: ``decode_attn_fused`` call over a sequence shard, run apart
#: (``decode_attn_split``, ``decode_attn_merge``).
SPLIT_LAUNCHES = {"luq_row_max": 0, "luq_round": 0, "clip_sumsq": 0,
                  "clip_apply": 0, "ghost_norm_mapped": 0,
                  "luq_matmul_cols": 0, "kv_quant_rows": 0,
                  "decode_attn_split": 0, "decode_attn_merge": 0}


_COUNTS = {"launches": LAUNCHES, "luq_matmul": LUQ_MATMUL_LAUNCHES,
           "luq_quant": LUQ_QUANT_LAUNCHES, "ghost_norm": GHOST_NORM_LAUNCHES,
           "kv_write": KV_WRITE_LAUNCHES, "split": SPLIT_LAUNCHES}


def reset_launch_counts() -> None:
    GHOST_NORM_LAUNCHES.clear()
    for counts in (LAUNCHES, LUQ_MATMUL_LAUNCHES, LUQ_QUANT_LAUNCHES,
                   KV_WRITE_LAUNCHES, SPLIT_LAUNCHES):
        for name in counts:
            counts[name] = 0


@contextlib.contextmanager
def prefill_launches():
    """Count the ``luq_matmul`` launches inside as a prefill's
    (:data:`LUQ_MATMUL_LAUNCHES`)."""
    _LUQ_MATMUL_STEP.append("prefill")
    try:
        yield
    finally:
        _LUQ_MATMUL_STEP.pop()


@contextlib.contextmanager
def per_example_launches():
    """Count the ``luq_quant`` launches inside as quantizing one row per
    example (:data:`LUQ_QUANT_LAUNCHES`)."""
    _LUQ_QUANT_OPERAND.append("per_example")
    try:
        yield
    finally:
        _LUQ_QUANT_OPERAND.pop()


def launch_counts() -> dict:
    """A copy of every launch count, ``{table: {name: count}}``."""
    return {table: dict(counts) for table, counts in _COUNTS.items()}


def launch_counts_since(before: dict) -> dict:
    """The counts added since :func:`launch_counts` returned ``before``."""
    return {table: {name: n - before[table].get(name, 0)
                    for name, n in counts.items()}
            for table, counts in _COUNTS.items()}


def add_launch_counts(delta: dict, times: int) -> None:
    """Add ``times`` x ``delta`` (a :func:`launch_counts_since` result) to
    the counts: the kernels a CUDA graph replays, which run without their
    wrappers being called (``repro_torch.graph``)."""
    for table, counts in delta.items():
        target = _COUNTS[table]
        for name, n in counts.items():
            if n:
                target[name] = target.get(name, 0) + times * n


#: The analyses a traced call reports to, innermost last: each a callable
#: ``sink(kernel, launches, **shape)``, ``shape`` the keywords of
#: ``repro_torch.launch.roofline.kernel_cost``.
_TRACE_SINKS = []

#: Rows of ``a`` a ``luq_matmul`` launch takes (``kMaxRows`` of
#: ``csrc/luq_matmul.cu``; every launch checks the library's).
LUQ_MATMUL_MAX_ROWS = 8


@contextlib.contextmanager
def traced_launches(sink):
    """Report the kernel calls on shape-only tensors inside to ``sink``."""
    _TRACE_SINKS.append(sink)
    try:
        yield
    finally:
        _TRACE_SINKS.pop()


def _traced(*tensors) -> bool:
    """True inside an analysis when a tensor is a ``meta`` one, or a fake
    one on a device other than the CPU: the call is traced, not run.
    Outside an analysis a fake tensor raises here, and a ``meta`` one in
    :func:`_on_cpu`."""
    if not any(t.device.type == "meta" or (isinstance(t, FakeTensor)
                                           and t.device.type != "cpu")
               for t in tensors):
        return False
    if _TRACE_SINKS:
        return True
    if any(isinstance(t, FakeTensor) for t in tensors):
        raise RuntimeError(
            "a kernel wrapper was given fake device tensors outside an "
            "analysis (repro_torch.launch.op_analysis)")
    return False


def _trace(kernel: str, launches: int, **shape) -> None:
    _TRACE_SINKS[-1](kernel, launches, **shape)


def _on_cpu(*tensors) -> bool:
    """True when every tensor is on the CPU; raises on mixed or other
    devices so a CUDA tensor can never reach a plain version."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    if types != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"kernel inputs must all be CPU tensors or all on one CUDA "
            f"device, got {sorted(str(t.device) for t in tensors)}")
    return False


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on_error(lib, err: int, kernel: str) -> None:
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} (cudaError {err})")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _flag_ptr(flag, device):
    """The device address of a DPQuant policy flag for a kernel that reads
    it (None: no flag, always quantize): a one-element float32 tensor on
    ``device``, e.g. a 0-dim view into the trainer's flags tensor."""
    if flag is None:
        return None
    if (flag.dtype != torch.float32 or flag.numel() != 1
            or flag.device != device):
        raise ValueError(f"flag: expected one float32 on {device}, got "
                         f"{flag.dtype} {tuple(flag.shape)} on "
                         f"{flag.device}")
    return _ptr(flag)


def _one_key(key):
    """The ``(k0, k1)`` words of one Philox key."""
    keys, per_row = philox.split_keys(key, 0)
    if per_row:
        raise ValueError(f"expected one Philox key (k0, k1), got {key!r}")
    return keys[0]


# --------------------------------------------------------------------------- #
# luq_matmul  (csrc/luq_matmul.cu, replaces the TPU kernel quant_matmul)
# --------------------------------------------------------------------------- #
def luq_matmul(a, b, keys, alpha_a, alpha_b, cols=None) -> torch.Tensor:
    """LUQ-FP4 quantize-both-operands matmul: (R, K) x (K, N) -> float32,
    the uniforms drawn inside the kernel with Philox4x32-10.

    ``keys``: one ``(k0, k1)`` pair of 32-bit ints, the draw shared by all
    rows (prefill: ``a`` quantized as one matrix), or one key a row (the
    decode tick's per-slot logits head): R pairs, or an (R, 2) int32 or
    int64 tensor on ``a``'s device, which the kernel reads from device
    memory (so a CUDA graph replays it with the keys of each tick); the
    stream's layout is ``repro_torch.quant.philox``'s.  ``alpha_a``: () or
    (R,) scales of ``a`` (per row: each row quantized on its own);
    ``alpha_b``: () scale of ``b``.  ``a``, ``b`` and the scales float32.
    The kernel sums in a fixed order: the same inputs and keys give the
    same bits every run.

    ``cols`` ``(col0, n_whole)``: ``b`` is a vocab shard, the columns
    ``col0 .. col0 + N - 1`` of a head ``n_whole`` wide, and ``alpha_b``
    the whole head's scale (the model group's max): each element draws at
    its index in the whole head and the K splits are the whole head's, so
    the result is the whole head's columns bit for bit (``None``: ``b``
    is whole).
    """
    R, K = a.shape
    N = b.shape[1]
    col0, n_whole = (0, N) if cols is None else (int(cols[0]), int(cols[1]))
    if not 0 <= col0 <= n_whole - N:
        raise ValueError(f"columns {col0} .. {col0 + N} of a head of "
                         f"{n_whole}")
    key_list, per_row = philox.split_keys(keys, R)
    key_t = (keys,) if isinstance(keys, torch.Tensor) else ()
    if _traced(a, b, *key_t):
        _trace("luq_matmul", math.ceil(R / LUQ_MATMUL_MAX_ROWS), rows=R,
               k=K, n=N, keys=R if per_row else 1)
        return a.new_empty((R, N), dtype=torch.float32)
    if _on_cpu(a, b, *key_t):
        return ref.luq_matmul_keys_ref(a, b, keys, alpha_a, alpha_b,
                                       cols=cols)
    alpha_a = alpha_a.reshape(-1).expand(R).contiguous()
    alpha_b = alpha_b.reshape(())
    _check("a", a, torch.float32, (R, K))
    _check("b", b, torch.float32, (K, N))
    _check("alpha_a", alpha_a, torch.float32, (R,))
    _check("alpha_b", alpha_b, torch.float32, ())
    _on_cpu(a, alpha_a, alpha_b)
    k0 = k1 = 0
    row_keys = None
    if per_row:
        row_keys = philox.key_tensor(keys, a.device)
        _check("keys", row_keys, torch.int32, (R, 2))
        _on_cpu(a, row_keys)
    else:
        k0, k1 = key_list[0]
    lib = load_library()
    out = torch.empty((R, N), dtype=torch.float32, device=a.device)
    step = lib.repro_luq_matmul_max_rows()
    if step != LUQ_MATMUL_MAX_ROWS:
        raise RuntimeError(f"luq_matmul takes {step} rows a launch, the "
                           f"wrapper says {LUQ_MATMUL_MAX_ROWS}")
    splits = lib.repro_luq_matmul_splits(K, n_whole)
    # scratch: Q(a), and the K splits' partial sums
    aq = torch.empty((R, K), dtype=torch.float32, device=a.device)
    partial = torch.empty((splits * min(R, step) * N if splits > 1 else 1,),
                          dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = _stream(a.device)
        for r0 in range(0, R, step):
            r1 = min(R, r0 + step)
            err = lib.repro_luq_matmul(
                _ptr(a[r0:r1]), _ptr(b), _ptr(alpha_a[r0:r1]), _ptr(alpha_b),
                k0, k1, None if row_keys is None else _ptr(row_keys[r0:r1]),
                r0, _ptr(aq[r0:r1]), _ptr(partial), _ptr(out[r0:r1]), r1 - r0,
                K, N, n_whole, col0, stream)
            _raise_on_error(lib, err, "luq_matmul")
            LAUNCHES["luq_matmul"] += 1
            LUQ_MATMUL_LAUNCHES[_LUQ_MATMUL_STEP[-1]] += 1
            if cols is not None:
                SPLIT_LAUNCHES["luq_matmul_cols"] += 1
    return out


# --------------------------------------------------------------------------- #
# kv_quant_write  (csrc/kv_quant.cu, replaces the TPU kernel kv_rowquant_2d)
# --------------------------------------------------------------------------- #
def _strides3(t: torch.Tensor):
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def kv_quant_write(k, v, k_codes, v_codes, k_scales, v_scales, fmt: str,
                   wpos=None, row0: int = 0, seq_len=None) -> None:
    """Quantize the K and V rows of one call into the cache, in place, in
    one launch: what ``kv_cache.kv_write`` computes.

    ``k``, ``v``: (N0, N1, T, hd) float32 or bf16, any strides with the
    last dim contiguous (the decode step's (slots, kv, 1, hd) views, or
    prefill's (layers x batch, kv, S, hd) stack); ``k_codes`` /
    ``v_codes``: (N0, N1, S, code_dim) int8 or packed uint8; ``k_scales``
    / ``v_scales``: (N0, N1, S) bf16; ``wpos``: (N0,) int64 on the device
    (each slot's clamped position) or None (from row 0).  Row t of (i, j)
    lands at cache row ``wpos[i] + t``; no other row is touched.

    A sequence shard: the codes and scales hold the rows ``row0 ..
    row0 + S - 1`` of a cache of ``seq_len`` rows (default: the whole
    cache, ``row0`` 0); row t of (i, j) goes to the whole cache's row
    ``wpos[i] + t`` (clamped into ``[0, seq_len - T]``, from row 0
    without ``wpos``), written only when the shard holds it.
    """
    if fmt not in _KV_FMT_CODE:
        raise ValueError(f"kv_quant_write has no kernel for fmt {fmt!r}")
    tensors = (k, v, k_codes, v_codes, k_scales, v_scales)
    wpos_t = () if wpos is None else (wpos,)
    N0, N1, T, hd = k.shape
    S = k_codes.shape[2]
    whole = S if seq_len is None else int(seq_len)
    sharded = row0 != 0 or whole != S
    if not (0 <= row0 <= whole - S):
        raise ValueError(f"rows {row0} .. {row0 + S} of a cache of {whole}")
    code_dtype, code_dim = kvc.code_spec(fmt, hd)
    if _traced(*tensors, *wpos_t):
        # the rows the shard writes: a tick's one row a slot that lands
        # on some rank (counted in full: the most it can hold), or the
        # prompt's rows inside the shard
        held = T if wpos is not None else max(0, min(S, T - row0))
        _trace("kv_quant_write", 1, rows=2 * N0 * N1 * held, head_dim=hd,
               code_dim=code_dim, elem=k.element_size(),
               slots=0 if wpos is None else N0)
        return None
    if _on_cpu(*tensors, *wpos_t):
        return ref.kv_quant_write_ref(*tensors, fmt, wpos, row0, seq_len)
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise TypeError(f"kv_quant_write reads float32 or bf16 rows, got "
                        f"{k.dtype} / {v.dtype}")
    if v.shape != k.shape or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("k and v must have one shape and a contiguous "
                         "last dim")
    for name, t in (("k_codes", k_codes), ("v_codes", v_codes)):
        _check(name, t, code_dtype, (N0, N1, S, code_dim))
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        _check(name, t, kvc.SCALE_DTYPE, (N0, N1, S))
    if wpos is not None:
        _check("wpos", wpos, torch.int64, (N0,))
    if not 1 <= T <= whole:
        raise ValueError(f"{T} rows do not fit a cache of {whole}")
    lib = load_library()
    with torch.cuda.device(k.device):
        err = lib.repro_kv_quant_write(
            _ptr(k), _ptr(v), int(k.dtype == torch.bfloat16), _strides3(k),
            _strides3(v), _ptr(k_codes), _ptr(v_codes), _ptr(k_scales),
            _ptr(v_scales), None if wpos is None else _ptr(wpos), N0, N1, T,
            S, hd, _KV_FMT_CODE[fmt], row0, whole, _stream(k.device))
    _raise_on_error(lib, err, "kv_quant_write")
    LAUNCHES["kv_quant_write"] += 1
    KV_WRITE_LAUNCHES["prefill" if wpos is None else "decode"] += 1
    if sharded:
        SPLIT_LAUNCHES["kv_quant_rows"] += 1


# --------------------------------------------------------------------------- #
# decode_attn_fused  (csrc/decode_attn.cu, replaces decode_attn_call)
# --------------------------------------------------------------------------- #
def decode_attn_fused(q, k_codes, v_codes, k_scale, v_scale, pos, *,
                      fmt: str, n_kv: int, scale: float) -> torch.Tensor:
    """Fused decode attention over a quantized slot-pool cache.

    Same signature and result as ``kv_cache.ref_decode_attn`` for the
    quantized formats: ``q`` (B, H, hd); codes (B, KV, S, code_dim); bf16
    scales (B, KV, S); ``pos`` (B,) int tensor of per-slot positions (on
    the device of ``q``), row ``s`` attended when ``s <= pos``.  Returns
    (B, H, hd) float32.

    The kernel splits each slot's rows into fixed ranges of 64 and merges
    the splits in order (no atomics): the same inputs give the same bits
    on every run, and a slot's output does not depend on the other slots.
    """
    if fmt not in _KV_FMT_CODE:
        raise ValueError(f"decode_attn_fused has no kernel for fmt {fmt!r}")
    B, hp, hd = q.shape
    g = hp // n_kv
    if hp != g * n_kv:
        raise ValueError(f"{hp} query heads do not split over {n_kv} kv heads")
    S = k_codes.shape[2]
    code_dtype, code_dim = kvc.code_spec(fmt, hd)
    if _traced(q, k_codes, v_codes, k_scale, v_scale):
        # a trace sees no positions: every row of every slot attended,
        # the most a call can need
        _trace("decode_attn_fused", 1, batch=B, kv_heads=n_kv, group=g,
               head_dim=hd, code_dim=code_dim, live_rows=B * S)
        return q.new_empty((B, hp, hd), dtype=torch.float32)
    if _on_cpu(q, k_codes, v_codes, k_scale, v_scale):
        return ref.decode_attn_ref(q, k_codes, v_codes, k_scale, v_scale, pos,
                                   fmt=fmt, n_kv=n_kv, scale=scale)
    lib = load_library()
    _decode_attn_checks(lib, q, n_kv)
    qf = q.float().contiguous()
    pos_b = torch.as_tensor(pos, device=q.device).to(torch.int32).expand(B)
    pos_b = pos_b.contiguous()
    _check("k_codes", k_codes, code_dtype, (B, n_kv, S, code_dim))
    _check("v_codes", v_codes, code_dtype, (B, n_kv, S, code_dim))
    _check("k_scale", k_scale, kvc.SCALE_DTYPE, (B, n_kv, S))
    _check("v_scale", v_scale, kvc.SCALE_DTYPE, (B, n_kv, S))
    _on_cpu(qf, pos_b, k_codes)
    out = torch.empty((B, n_kv, g, hd), dtype=torch.float32, device=q.device)
    # scratch: each split's partial output and its softmax (max, sum)
    scratch = torch.empty((lib.repro_decode_attn_scratch(B, n_kv, g, S, hd),),
                          dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.repro_decode_attn(
            _ptr(qf), _ptr(k_codes), _ptr(v_codes), _ptr(k_scale),
            _ptr(v_scale), _ptr(pos_b), _ptr(out), _ptr(scratch), B, n_kv, g,
            S, hd, float(scale), _KV_FMT_CODE[fmt], _stream(q.device))
    _raise_on_error(lib, err, "decode_attn_fused")
    LAUNCHES["decode_attn_fused"] += 1
    return out.reshape(B, hp, hd)


#: Cache rows a split of ``decode_attn.cu`` owns (its ``kSplit``).
DECODE_ATTN_SPLIT = 64
_DECODE_ATTN_MAX_G = 8


def decode_attn_scratch(B: int, n_kv: int, g: int, S: int, hd: int) -> int:
    """Float32 elements of one shard's pass-1 scratch
    (``repro_decode_attn_scratch``): each split's partial output and its
    (max, sum) for 8 query rows."""
    return (B * n_kv * (-(-S // DECODE_ATTN_SPLIT))
            * (g * hd + 2 * _DECODE_ATTN_MAX_G))


def _decode_attn_checks(lib, q, n_kv):
    B, hp, hd = q.shape
    g = hp // n_kv
    max_g, max_hd = ctypes.c_int(), ctypes.c_int()
    lib.repro_decode_attn_limits(ctypes.byref(max_g), ctypes.byref(max_hd))
    if g > max_g.value or hd > max_hd.value or hd % 4:
        raise ValueError(
            f"decode_attn_fused takes g <= {max_g.value} and head_dim a "
            f"multiple of 4 up to {max_hd.value}; got g={g}, head_dim={hd}")
    return B, hp, hd, g


def decode_attn_split(q, k_codes, v_codes, k_scale, v_scale, pos, *,
                      fmt: str, n_kv: int, scale: float, row0: int,
                      seq_len: int) -> torch.Tensor:
    """Pass 1 of :func:`decode_attn_fused` alone, over a sequence shard:
    the codes and scales (B, KV, S, ...) hold the rows ``row0 .. row0 +
    S - 1`` of a cache of ``seq_len`` rows, ``q`` (B, H, hd) every query
    head.  Returns this rank's partials, one float32 tensor (on CUDA the
    kernel's scratch, :func:`decode_attn_scratch` elements; on the CPU
    ``kv_cache.attn_partial``'s (B, KV, g, hd + 2)).  Gather the ranks'
    in rank order and hand them to :func:`decode_attn_merge`.  One
    launch."""
    if fmt not in _KV_FMT_CODE:
        raise ValueError(f"decode_attn_split has no kernel for fmt {fmt!r}")
    B, hp, hd = q.shape
    g = hp // n_kv
    S = k_codes.shape[2]
    if hp != g * n_kv:
        raise ValueError(f"{hp} query heads do not split over {n_kv} kv heads")
    if not 0 <= row0 <= seq_len - S:
        raise ValueError(f"rows {row0} .. {row0 + S} of a cache of "
                         f"{seq_len}")
    code_dtype, code_dim = kvc.code_spec(fmt, hd)
    if _traced(q, k_codes, v_codes, k_scale, v_scale):
        _trace("decode_attn_fused", 1, batch=B, kv_heads=n_kv, group=g,
               head_dim=hd, code_dim=code_dim, live_rows=B * S)
        return q.new_empty((decode_attn_scratch(B, n_kv, g, S, hd),),
                           dtype=torch.float32)
    if _on_cpu(q, k_codes, v_codes, k_scale, v_scale):
        return ref.decode_attn_partial_ref(q, k_codes, v_codes, k_scale,
                                           v_scale, pos, fmt=fmt, n_kv=n_kv,
                                           scale=scale, row0=row0)
    lib = load_library()
    _decode_attn_checks(lib, q, n_kv)
    qf = q.float().contiguous()
    pos_b = torch.as_tensor(pos, device=q.device).to(torch.int32).expand(B)
    pos_b = pos_b.contiguous()
    _check("k_codes", k_codes, code_dtype, (B, n_kv, S, code_dim))
    _check("v_codes", v_codes, code_dtype, (B, n_kv, S, code_dim))
    _check("k_scale", k_scale, kvc.SCALE_DTYPE, (B, n_kv, S))
    _check("v_scale", v_scale, kvc.SCALE_DTYPE, (B, n_kv, S))
    _on_cpu(qf, pos_b, k_codes)
    n = lib.repro_decode_attn_scratch(B, n_kv, g, S, hd)
    if n != decode_attn_scratch(B, n_kv, g, S, hd):
        raise RuntimeError("decode_attn's scratch size disagrees with the "
                           "library's")
    scratch = torch.empty((n,), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.repro_decode_attn_split(
            _ptr(qf), _ptr(k_codes), _ptr(v_codes), _ptr(k_scale),
            _ptr(v_scale), _ptr(pos_b), _ptr(scratch), B, n_kv, g, S, row0,
            seq_len, hd, float(scale), _KV_FMT_CODE[fmt], _stream(q.device))
    _raise_on_error(lib, err, "decode_attn_split")
    LAUNCHES["decode_attn_fused"] += 1
    SPLIT_LAUNCHES["decode_attn_split"] += 1
    return scratch


def decode_attn_merge(parts, pos, *, batch: int, n_kv: int, group: int,
                      head_dim: int, rows: int, seq_len: int) -> torch.Tensor:
    """Pass 2 of :func:`decode_attn_fused` over the ranks' pass 1
    (:func:`decode_attn_split`), ``parts`` (R, ...) stacked in rank order,
    each over ``rows`` rows of a cache of ``seq_len``: the attention of
    the whole cache, (B, H, hd) float32.  Where ``rows`` is a multiple of
    64 the splits are the whole cache's, and the result is
    :func:`decode_attn_fused`'s on the whole cache, bit for bit.  One
    launch."""
    B, hd, g = batch, head_dim, group
    R = parts.shape[0]
    if _traced(parts):
        return parts.new_empty((B, n_kv * g, hd), dtype=torch.float32)
    if _on_cpu(parts):
        return ref.decode_attn_merge_ref(parts)
    if seq_len > R * rows:
        raise ValueError(f"{R} shards of {rows} rows hold no cache of "
                         f"{seq_len}")
    lib = load_library()
    n = decode_attn_scratch(B, n_kv, g, rows, hd)
    _check("parts", parts, torch.float32, (R, n))
    pos_b = torch.as_tensor(pos, device=parts.device).to(
        torch.int32).expand(B).contiguous()
    _on_cpu(parts, pos_b)
    out = torch.empty((B, n_kv, g, hd), dtype=torch.float32,
                      device=parts.device)
    with torch.cuda.device(parts.device):
        err = lib.repro_decode_attn_merge(
            _ptr(parts), _ptr(pos_b), _ptr(out), B, n_kv, g, rows, seq_len,
            hd, R, _stream(parts.device))
    _raise_on_error(lib, err, "decode_attn_merge")
    SPLIT_LAUNCHES["decode_attn_merge"] += 1
    return out.reshape(B, n_kv * g, hd)


# --------------------------------------------------------------------------- #
# luq_quant  (csrc/luq_quant.cu, replaces the TPU kernel luq_quant_2d)
# --------------------------------------------------------------------------- #
_LUQ_DTYPES = (torch.float32, torch.bfloat16)


def luq_quant(x: torch.Tensor, key, codes: bool = False,
              flag=None) -> torch.Tensor:
    """LUQ-FP4 stochastic quantization of the rows of ``x`` (R, N), the
    whole quantize op in two launches.

    Each row is scaled by its own ``max|x[r]|``, which the kernel takes
    itself, and every row rounds against the one draw of the Philox
    ``key`` ``(k0, k1)``, which the kernel draws itself (element n takes
    uniform n of ``quant.philox.row_uniforms``).  ``x``: float32 or bf16,
    contiguous at any address.  Returns (R, N) in ``x``'s dtype, or with
    ``codes`` the bf16 codes ``Q(x) / alpha = sign * 2^-k`` (exact in
    bf16).  Same bits on every run.

    ``flag``: the layer's DPQuant policy flag, one float32 on ``x``'s
    device that both launches read (so a CUDA graph replays it with the
    policy of each replay): at 0 ``x`` passes through bit for bit (codes:
    ``x`` in bf16), as the reference's ``lax.cond(flag > 0.5, q, id)``.
    """
    flag_t = () if flag is None else (flag,)
    if _traced(x, *flag_t):
        if x.numel():
            _trace("luq_quant", 1, rows=x.shape[0], n=x.shape[1],
                   elem=x.element_size())
        return torch.empty_like(x, dtype=torch.bfloat16 if codes
                                else x.dtype)
    if _on_cpu(x, *flag_t):
        return ref.luq_quant_ref(x, key, codes, flag)
    if x.dim() != 2 or x.dtype not in _LUQ_DTYPES or not x.is_contiguous():
        raise ValueError(f"luq_quant takes a contiguous (R, N) float32 or "
                         f"bf16 matrix, got {x.dtype} {tuple(x.shape)}")
    R, N = x.shape
    k0, k1 = _one_key(key)
    flag_p = _flag_ptr(flag, x.device)
    out = torch.empty_like(x, dtype=torch.bfloat16 if codes else x.dtype)
    if x.numel() == 0:
        return out
    lib = load_library()
    scratch = torch.empty((lib.repro_luq_quant_scratch(R, N),),
                          dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.repro_luq_quant(_ptr(x), int(x.dtype == torch.bfloat16),
                                  _ptr(out), int(codes), R, N, k0, k1,
                                  _ptr(scratch), None, flag_p,
                                  _stream(x.device))
    _raise_on_error(lib, err, "luq_quant")
    LAUNCHES["luq_quant"] += 1
    LUQ_QUANT_LAUNCHES[_LUQ_QUANT_OPERAND[-1]] += 1
    LUQ_QUANT_LAUNCHES["kernels"] += 2
    return out


def _index_map_args(index_map):
    """``(blk, gblk, off)`` of an index map (``quant.philox.global_index``),
    (0, 0, 0) for none (every element at its own index)."""
    if index_map is None:
        return 0, 0, 0
    blk, gblk, off = (int(v) for v in index_map)
    if not (0 < blk <= gblk and 0 <= off <= gblk - blk):
        raise ValueError(f"bad index map {index_map!r}")
    return blk, gblk, off


def luq_row_max(x: torch.Tensor) -> torch.Tensor:
    """The first pass of :func:`luq_quant` alone: (R,) float32 ``max|x[r]|``
    of the rows of ``x`` (R, N), float32 or bf16, in two launches (the
    partial maxima, then each row's).  For an operand split over ranks:
    the caller takes the max over the ranks and hands it to
    :func:`luq_round`."""
    if _traced(x):
        return x.new_empty((x.shape[0],), dtype=torch.float32)
    if _on_cpu(x):
        return ref.luq_row_max_ref(x)
    if x.dim() != 2 or x.dtype not in _LUQ_DTYPES or not x.is_contiguous():
        raise ValueError(f"luq_row_max takes a contiguous (R, N) float32 or "
                         f"bf16 matrix, got {x.dtype} {tuple(x.shape)}")
    R, N = x.shape
    out = torch.empty((R,), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out.zero_()
    lib = load_library()
    scratch = torch.empty((lib.repro_luq_quant_scratch(R, N),),
                          dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.repro_luq_row_max(_ptr(x), int(x.dtype == torch.bfloat16),
                                    R, N, _ptr(scratch), _ptr(out),
                                    _stream(x.device))
    _raise_on_error(lib, err, "luq_row_max")
    LUQ_QUANT_LAUNCHES["kernels"] += 2
    SPLIT_LAUNCHES["luq_row_max"] += 1
    return out


def luq_round(x: torch.Tensor, key, alpha: torch.Tensor, index_map=None,
              codes: bool = False, flag=None) -> torch.Tensor:
    """The second pass of :func:`luq_quant` alone, one launch: the rows of
    ``x`` (R, N) rounded against the given scales ``alpha`` (R,) float32
    and the draw of ``key``, element n taking the uniform of its index in
    the whole row under ``index_map`` ``(blk, gblk, off)``
    (``quant.philox.global_index``; None: index n).  With the max of
    every rank's :func:`luq_row_max` as ``alpha``, a shard of an operand
    quantizes to the slice of the whole operand's quantization, bit for
    bit.  Where the map keeps groups of 4 elements whole (``blk``,
    ``gblk`` and ``off`` multiples of 4) the kernel draws one Philox call
    a group, else one an element.  ``codes`` and ``flag``: as
    :func:`luq_quant`."""
    flag_t = () if flag is None else (flag,)
    if _traced(x, alpha, *flag_t):
        if x.numel():
            _trace("luq_quant", 1, rows=x.shape[0], n=x.shape[1],
                   elem=x.element_size())
        return torch.empty_like(x, dtype=torch.bfloat16 if codes
                                else x.dtype)
    blk, gblk, off = _index_map_args(index_map)
    if _on_cpu(x, alpha, *flag_t):
        return ref.luq_round_ref(x, key, alpha, index_map, codes, flag)
    if x.dim() != 2 or x.dtype not in _LUQ_DTYPES or not x.is_contiguous():
        raise ValueError(f"luq_round takes a contiguous (R, N) float32 or "
                         f"bf16 matrix, got {x.dtype} {tuple(x.shape)}")
    R, N = x.shape
    alpha = alpha.reshape(-1).contiguous()
    _check("alpha", alpha, torch.float32, (R,))
    k0, k1 = _one_key(key)
    flag_p = _flag_ptr(flag, x.device)
    out = torch.empty_like(x, dtype=torch.bfloat16 if codes else x.dtype)
    if x.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.repro_luq_round(_ptr(x), int(x.dtype == torch.bfloat16),
                                  _ptr(out), int(codes), R, N, k0, k1,
                                  _ptr(alpha), None, blk, gblk, off, flag_p,
                                  _stream(x.device))
    _raise_on_error(lib, err, "luq_round")
    LAUNCHES["luq_quant"] += 1
    LUQ_QUANT_LAUNCHES[_LUQ_QUANT_OPERAND[-1]] += 1
    LUQ_QUANT_LAUNCHES["kernels"] += 1
    SPLIT_LAUNCHES["luq_round"] += 1
    return out


# --------------------------------------------------------------------------- #
# clip_and_sum  (csrc/per_sample_clip.cu, replaces per_sample_clip)
# --------------------------------------------------------------------------- #
def clip_and_sum(grads: torch.Tensor, clip_norm: float):
    """Fused DP per-example clip and batch sum of (B, D) float32 rows.

    Returns ``(clipped_sum (D,), norms (B,))``, both float32:
    ``clipped_sum = sum_b min(1, C / max(||g_b||, 1e-12)) * g_b``.  The
    kernel sums in a fixed order (no atomics): the same input gives the
    same bits on every run.
    """
    B, D = grads.shape
    if _traced(grads):
        _trace("clip_and_sum", 1, rows=B, n=D)
        return grads.new_empty((D,)), grads.new_empty((B,))
    if _on_cpu(grads):
        return ref.per_sample_clip_ref(grads, clip_norm)
    _check("grads", grads, torch.float32, (B, D))
    lib = load_library()
    P = lib.repro_per_sample_clip_chunks(B, D)
    out = torch.empty((D,), dtype=torch.float32, device=grads.device)
    norms = torch.empty((B,), dtype=torch.float32, device=grads.device)
    partial = torch.empty((B * P,), dtype=torch.float32, device=grads.device)
    with torch.cuda.device(grads.device):
        err = lib.repro_per_sample_clip(
            _ptr(grads), _ptr(out), _ptr(norms), _ptr(partial), B, D,
            float(clip_norm), _stream(grads.device))
    _raise_on_error(lib, err, "clip_and_sum")
    LAUNCHES["clip_and_sum"] += 1
    return out, norms


def clip_sumsq(grads: torch.Tensor, cols=None) -> torch.Tensor:
    """The first pass of :func:`clip_and_sum` alone: (B,) float32 squared
    norms of the rows of ``grads`` (B, D) over their first ``cols``
    columns (all by default), two launches (the kernel's column-chunk
    partials, then each row's sum in chunk order: the bits
    :func:`clip_and_sum` takes its norms from).  For rows split over
    ranks the caller sums the ranks' results and hands them to
    :func:`clip_apply`."""
    B, D = grads.shape
    cols = D if cols is None else int(cols)
    if not 0 <= cols <= D:
        raise ValueError(f"clip_sumsq: {cols} columns of rows of {D}")
    if _traced(grads):
        return grads.new_empty((B,))
    if _on_cpu(grads):
        return ref.clip_sumsq_ref(grads, cols)
    _check("grads", grads, torch.float32, (B, D))
    out = torch.zeros((B,), dtype=torch.float32, device=grads.device)
    if cols == 0:
        return out
    lib = load_library()
    P = lib.repro_per_sample_clip_chunks(B, cols)
    partial = torch.empty((B * P,), dtype=torch.float32, device=grads.device)
    with torch.cuda.device(grads.device):
        err = lib.repro_per_sample_clip_sumsq(
            _ptr(grads), _ptr(out), _ptr(partial), B, cols, D,
            _stream(grads.device))
    _raise_on_error(lib, err, "clip_sumsq")
    SPLIT_LAUNCHES["clip_sumsq"] += 1
    return out


def clip_apply(grads: torch.Tensor, sumsq: torch.Tensor, clip_norm: float):
    """The second pass of :func:`clip_and_sum` alone, one launch: the
    clipped sum of the rows of ``grads`` (B, D) whose squared norms
    ``sumsq`` (B,) are given, and the norms.  On a sum of one rank's
    :func:`clip_sumsq` it gives :func:`clip_and_sum`'s bits."""
    B, D = grads.shape
    if _traced(grads, sumsq):
        _trace("clip_and_sum", 1, rows=B, n=D)
        return grads.new_empty((D,)), grads.new_empty((B,))
    if _on_cpu(grads, sumsq):
        return ref.clip_apply_ref(grads, sumsq, clip_norm)
    _check("grads", grads, torch.float32, (B, D))
    _check("sumsq", sumsq, torch.float32, (B,))
    lib = load_library()
    out = torch.empty((D,), dtype=torch.float32, device=grads.device)
    norms = torch.empty((B,), dtype=torch.float32, device=grads.device)
    with torch.cuda.device(grads.device):
        err = lib.repro_per_sample_clip_apply(
            _ptr(grads), _ptr(sumsq), _ptr(out), _ptr(norms), B, D,
            float(clip_norm), _stream(grads.device))
    _raise_on_error(lib, err, "clip_apply")
    LAUNCHES["clip_and_sum"] += 1
    SPLIT_LAUNCHES["clip_apply"] += 1
    return out, norms


# --------------------------------------------------------------------------- #
# ghost_norm_sq  (csrc/ghost_norm.cu, replaces the TPU kernel ghost_norm_gram)
# --------------------------------------------------------------------------- #
def ghost_norm_sq(x, g, key_x, key_g, flag=None, alpha_x=None,
                  alpha_g=None, map_x=None, map_g=None) -> torch.Tensor:
    """LUQ-FP4 quantize + Grams + reduce in one call, per example:
    ``out[b] = ||Q(x_b)^T Q(g_b)||_F^2 = <Q(x_b)Q(x_b)^T, Q(g_b)Q(g_b)^T>``.

    ``x``: (B, T, Dx) wgrad-GEMM input rows of B examples; ``g``: (B, T,
    Dg) their cotangent rows; float32 or bf16, contiguous.  ``key_x``,
    ``key_g``: the Philox keys of the draws shared by the examples (the
    streams of fake-quant's folds 4 and 5, so fused and unfused routes
    agree); each example is scaled by its own ``max|x_b|``, ``max|g_b|``,
    which the kernel takes itself.  Returns (B,) float32.

    The kernel quantizes both operands once into bf16 codes (``Q(v) /
    alpha``, exact; ``luq_quant``'s two passes each), runs the upper
    triangles of the (T, T) Grams of the codes on the tensor cores in
    tiles, and scales each example by ``(alpha_x alpha_g)^2`` at the end,
    so any T is taken: the JAX wrapper's ``T <= 512`` cap
    (``GHOST_NORM_MAX_T``) sized its two whole Grams for a TPU core's
    VMEM, and above it that wrapper computes the same value unfused.
    Partials are summed in a fixed order (no atomics): the same input
    gives the same bits on every run.

    ``flag``: the layer's DPQuant policy flag (as in :func:`luq_quant`),
    read by the two quantize passes; at 0 they write the operands
    themselves, in bf16, with alpha 1, and the result is
    ``||x_b^T g_b||_F^2`` of the unquantized operands (exact products for
    bf16 operands, summed in float32).

    An operand that is a shard of the examples' rows (split over the
    model group) is given its rows' scales, ``alpha_x`` or ``alpha_g``
    ((B,) float32, the max over the ranks), and its index map, ``map_x``
    or ``map_g`` (:func:`luq_round`'s); its quantize pass is then
    :func:`luq_round`'s alone, and the result is this rank's part of the
    whole operands' norm (the Gram identity adds over a split dim).
    """
    flag_t = () if flag is None else (flag,)
    mapped = alpha_x is not None or alpha_g is not None
    B, T, Dx = x.shape
    Dg = g.shape[2]
    if _traced(x, g, *flag_t):
        if B and T and Dx and Dg:
            _trace("ghost_norm_sq", 1, batch=B, t=T, dx=Dx, dg=Dg,
                   elem_x=x.element_size(), elem_g=g.element_size())
        return x.new_empty((B,), dtype=torch.float32)
    alphas = tuple(a for a in (alpha_x, alpha_g) if a is not None)
    if _on_cpu(x, g, *flag_t, *alphas):
        return ref.ghost_norm_ref(x, g, key_x, key_g, flag, alpha_x,
                                  alpha_g, map_x, map_g)
    for name, t, d in (("x", x, Dx), ("g", g, Dg)):
        if t.dtype not in _LUQ_DTYPES:
            raise TypeError(f"{name}: expected float32 or bf16, got {t.dtype}")
        _check(name, t, t.dtype, (B, T, d))
    kx0, kx1 = _one_key(key_x)
    kg0, kg1 = _one_key(key_g)
    flag_p = _flag_ptr(flag, x.device)
    out = torch.empty((B,), dtype=torch.float32, device=x.device)
    if out.numel() == 0 or T == 0 or Dx == 0 or Dg == 0:
        return out.zero_()
    lib = load_library()
    # scratch: the codes of both operands, the alphas, the tile partials
    scratch = torch.empty((lib.repro_ghost_norm_scratch(B, T, Dx, Dg),),
                          dtype=torch.uint8, device=x.device)
    if mapped:
        given = []
        for name, a in (("alpha_x", alpha_x), ("alpha_g", alpha_g)):
            if a is not None:
                a = a.reshape(-1).contiguous()
                _check(name, a, torch.float32, (B,))
            given.append(a)
        alpha_x, alpha_g = given
        bx, gx, ox = _index_map_args(map_x)
        bg, gg, og = _index_map_args(map_g)
    with torch.cuda.device(x.device):
        if mapped:
            err = lib.repro_ghost_norm_mapped(
                _ptr(x), int(x.dtype == torch.bfloat16), _ptr(g),
                int(g.dtype == torch.bfloat16), kx0, kx1, kg0, kg1,
                _ptr(scratch), _ptr(out), B, T, Dx, Dg, flag_p,
                None if alpha_x is None else _ptr(alpha_x), bx, gx, ox,
                None if alpha_g is None else _ptr(alpha_g), bg, gg, og,
                _stream(x.device))
        else:
            err = lib.repro_ghost_norm(
                _ptr(x), int(x.dtype == torch.bfloat16), _ptr(g),
                int(g.dtype == torch.bfloat16), kx0, kx1, kg0, kg1,
                _ptr(scratch), _ptr(out), B, T, Dx, Dg, flag_p,
                _stream(x.device))
    _raise_on_error(lib, err, "ghost_norm_sq")
    LAUNCHES["ghost_norm_sq"] += 1
    if mapped:
        SPLIT_LAUNCHES["ghost_norm_mapped"] += 1
    shape_class = f"{min(Dx, Dg)}/{max(Dx, Dg)}"
    GHOST_NORM_LAUNCHES[shape_class] = GHOST_NORM_LAUNCHES.get(shape_class,
                                                               0) + 1
    return out
