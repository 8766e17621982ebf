"""Build and load the CUDA kernels of ``repro_torch.kernels.csrc``.

Each ``*.cu`` source has a plain C interface (``*.cuh`` headers beside
them are included, not compiled on their own).  The first call of
:func:`load_library` compiles every source with ``nvcc`` for ``sm_90a``,
one ``nvcc`` per source, all started together, links the objects into one
shared library and loads it with ``ctypes``.  The library is cached under
``build/repro_torch_kernels/<digest>/`` beside the checkout (``build/`` is
git-ignored), keyed by a digest of the sources and flags, so a later
process reuses it.

Never add ``--use_fast_math``: it swaps ``log2f``, ``exp2f`` and IEEE
division for approximations, and the kernels rely on those being the
ones PyTorch's CUDA operators use, for bitwise agreement with the plain
versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("luq_matmul.cu", "kv_quant.cu", "decode_attn.cu", "luq_quant.cu",
           "per_sample_clip.cu", "ghost_norm.cu")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "repro_luq_matmul": (_I, [_P, _P, _P, _P, ctypes.POINTER(ctypes.c_uint32),
                              _I, _I, _P, _P, _P, _I, _I, _I, _P]),
    "repro_luq_matmul_max_rows": (_I, []),
    "repro_luq_matmul_splits": (_I, [_I, _I]),
    "repro_kv_quant_rows": (_I, [_P, _P, _P, ctypes.c_long, _I, _I, _P]),
    "repro_decode_attn": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, ctypes.c_float, _I, _P]),
    "repro_decode_attn_scratch": (_L, [_I, _I, _I, _I, _I]),
    "repro_decode_attn_limits": (_I, [ctypes.POINTER(_I), ctypes.POINTER(_I)]),
    "repro_luq_quant": (_I, [_P, _P, _P, _P, _I, _L, _I, _I, _I, _P]),
    "repro_per_sample_clip_chunks": (_I, [_L]),
    "repro_per_sample_clip": (_I, [_P, _P, _P, _P, _I, _L, ctypes.c_float,
                                   _P]),
    "repro_ghost_norm_partials": (_I, [_I]),
    "repro_ghost_norm": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _P]),
    "repro_cuda_error_string": (ctypes.c_char_p, [_I]),
}

_LIB = None
#: What the last build did: seconds spent and nvcc's ``-Xptxas -v`` output
#: (registers, shared memory and spills of each kernel); empty when the
#: library came from the cache.
BUILD_INFO: dict = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out_dir: Path) -> str:
    """Compile every source in parallel and link; returns nvcc's output."""
    procs = []
    for src in SOURCES:
        obj = out_dir / (Path(src).stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(CSRC / src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = out_dir / (LIB_NAME + f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, out_dir / LIB_NAME)
    return "\n".join(log)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    out_dir = BUILD_ROOT / _digest()
    so = out_dir / LIB_NAME
    if not so.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log = _compile(find_nvcc(), out_dir)
        BUILD_INFO.update(seconds=time.perf_counter() - t0, log=log)
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _LIB = lib
    return lib
