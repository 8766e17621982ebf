"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, and its entry points run on CUDA unless asked for the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import QuantConfig, ServeConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve import ContinuousEngine  # noqa: E402

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any import of jax now fails
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(n for n, mod in sys.modules.items() if mod is not None
                and (n in ("repro", "jax") or n.startswith(("repro.", "jax."))))
missing = sorted({"repro_torch.parallel.collectives",
                  "repro_torch.parallel.partitioner",
                  "repro_torch.launch.mesh",
                  "repro_torch.models.moe"} - set(names))
print(len(names), leaked, missing)
"""


def test_every_module_imports_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, leaked, missing = out.stdout.strip().split(" ", 2)
    assert int(n) >= 20
    assert leaked == "[]"
    assert missing == "[]"          # the data-parallel and MoE modules


def test_quantizer_and_kernel_layers_import_nothing_of_the_dp_engine():
    """Layering: the quantizers (``quant/``) and the kernels (``kernels/``)
    sit below the DP engines; the ghost engine hands the model its hooks
    explicitly.  Every import statement is checked, the ones inside
    functions too."""
    import ast
    found = []
    for sub in ("quant", "kernels"):
        for path in sorted((SRC / "repro_torch" / sub).rglob("*.py")):
            for node in ast.walk(ast.parse(path.read_text())):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module] + [f"{node.module}.{a.name}"
                                             for a in node.names]
                else:
                    continue
                found += [f"{path.name}:{node.lineno} {n}" for n in names
                          if n.startswith("repro_torch.dp")]
    assert found == []


def test_entry_points_raise_without_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("yi-6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, QuantConfig(fmt="none"))
    model = build_model(cfg, QuantConfig(fmt="none"), device="cpu")
    params = model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousEngine(model, params, ServeConfig(max_slots=1, max_seq=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", "yi-6b", "--smoke"])


def test_serve_cli_runs_on_cpu_at_smoke_size(capsys, monkeypatch):
    monkeypatch.delenv("REPRO_QUANT_BACKEND", raising=False)
    serve_cli.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                    "--quant-fmt", "luq_fp4", "--kv-fmt", "int8",
                    "--slots", "2", "--requests", "3", "--prompt-len", "6",
                    "--gen", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 new tokens" in out
    assert out.count("request ") == 3


def test_kernel_wrappers_never_send_device_tensors_to_plain_versions():
    """Only CPU tensors take the plain versions: any other device, or a
    mix of devices, raises before anything runs (meta tensors stand in
    for device tensors here)."""
    meta = dict(device="meta")
    rows = torch.empty(2, 1, 1, 8, **meta)
    cache = torch.empty(2, 1, 5, 8, dtype=torch.int8)
    scales = torch.empty(2, 1, 5, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CPU tensors or all on one CUDA"):
        ops.kv_quant_write(rows, rows, cache, cache, scales, scales, "int8")
    with pytest.raises(ValueError, match="CPU tensors or all on one CUDA"):
        ops.luq_matmul(torch.empty(2, 8), torch.empty(8, 4, **meta),
                       (1, 17), torch.tensor(1.0), torch.tensor(1.0))
    codes = torch.empty(1, 1, 5, 8, dtype=torch.int8, **meta)
    scales = torch.empty(1, 1, 5, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="CPU tensors or all on one CUDA"):
        ops.decode_attn_fused(torch.empty(1, 2, 8, **meta), codes, codes,
                              scales, scales, 0, fmt="int8", n_kv=1,
                              scale=1.0)
    with pytest.raises(ValueError, match="CPU tensors or all on one CUDA"):
        ops.luq_quant(torch.empty(2, 8, **meta), (3, 5))
    with pytest.raises(ValueError, match="CPU tensors or all on one CUDA"):
        ops.clip_and_sum(torch.empty(2, 8, **meta), 1.0)
    with pytest.raises(ValueError, match="CPU tensors or all on one CUDA"):
        ops.ghost_norm_sq(torch.empty(2, 4, 8, **meta), torch.empty(2, 4, 6),
                          (3, 5), (3, 6))
    assert ops.LAUNCHES == {"luq_matmul": 0, "kv_quant_write": 0,
                            "decode_attn_fused": 0, "luq_quant": 0,
                            "clip_and_sum": 0, "ghost_norm_sq": 0}
    assert ops.LUQ_MATMUL_LAUNCHES == {"prefill": 0, "decode": 0}
    assert ops.LUQ_QUANT_LAUNCHES == {"whole": 0, "per_example": 0,
                                      "kernels": 0}
    assert ops.GHOST_NORM_LAUNCHES == {}


def test_luq_quant_launches_are_counted_by_operand(monkeypatch):
    """The cuda quantizer hands ``ops.luq_quant`` a tensor quantized whole
    (a weight, or an operand outside vmap) outside
    ``ops.per_example_launches`` and per-example rows inside it, at any
    number of examples, one included."""
    from repro_torch.quant import fake_quant as fq
    seen = []

    def record(x, key, codes=False, flag=None):
        seen.append((ops._LUQ_QUANT_OPERAND[-1], tuple(x.shape)))
        return x.clone()
    monkeypatch.setattr(ops, "luq_quant", record)
    w = torch.randn(4, 8)
    for n in (1, 3):
        x = torch.randn(n, 5, 4)
        torch.func.vmap(lambda xe: fq.fake_quant(xe, "luq_fp4", "cuda", 7, 0)
                        + fq.fake_quant(w, "luq_fp4", "cuda", 7, 1).sum())(x)
        fq._quantize_per_example(x, "luq_fp4", "cuda", 7, 2)
    assert seen == [("per_example", (1, 20)), ("whole", (1, 32)),
                    ("per_example", (1, 20)),
                    ("per_example", (3, 20)), ("whole", (1, 32)),
                    ("per_example", (3, 20))]
    assert ops._LUQ_QUANT_OPERAND == ["whole"]
