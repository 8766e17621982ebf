"""Dry-run: trace every (architecture x input shape) of the assigned
cells on shape-only tensors and record each cell's op-level costs, roofline
terms and peak device memory against one H100.

The counterpart of ``repro.launch.dryrun``.  Nothing runs on a device:
each cell's step runs once on ``meta`` tensors, shapes without memory
(``launch.op_analysis``), so
every arch traces at full size, kimi-k2-1t-a32b too, which no card
holds, on the card's host or on a machine without a GPU alike:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k

``--mesh card`` (the default) is one H100.  ``single`` and ``multi`` are
the reference's production meshes, (16, 16) and (2, 16, 16) over
``(data, model)`` and ``(pod, data, model)``: a cell there traces one
rank's shard program (rank 0's) in a world of 256 or 512 ranks made of
``torch``'s fake process group (``op_analysis.fake_world``), its
collectives counted and returning at once: its shard of the params over
the ``model`` axis, its block of the batch over the data axes (the vmap
engine's examples of each microbatch; serving's sequences), its shard of
the KV cache (by heads, or by sequence rows where the KV heads do not
divide the axis), the vocab-split logits.  ``fits`` compares the rank's
own peak with the card's 80 GB.  The families without ``param_axes`` in
the port (the encoder-decoder, Mamba-2, the Griffin hybrid, the VLM, the
CNNs, BERT) are written ``skipped`` there.  Outputs one JSON per cell under
``--out`` (default ``results/dryrun_torch/``): the reference's fields
(``status``, ``collectives``, ``warnings``, ``roofline``, ``n_params``,
``n_active_params``, ``n_devices``), the kernels' calls and costs,
``peak_bytes`` and ``fits`` (against the card's 80 GB) and ``trace_s``.

The train cells run the reference's DP-SGD settings: one example a
microbatch (the MoE archs ``microbatch_mode="single"`` with a bf16
clipped sum), SGD at lr 0.5, the vmap engine; float32 without TF32, as
the train CLI sets it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

#: The production meshes: (axis sizes, axis names), and their devices.
PRODUCTION_MESHES = {"single": ((16, 16), ("data", "model")),
                     "multi": ((2, 16, 16), ("pod", "data", "model"))}
MESH_TAGS = {"card": "1xH100", "single": "16x16", "multi": "2x16x16"}


def cell_skip_reason(cfg, shape) -> str:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("SKIP(full-attention): 500k dense-KV decode is assigned only "
                "to sub-quadratic (ssm/hybrid) archs")
    return ""


def mesh_skip_reason(cfg, mesh: str) -> str:
    """Why a production-mesh cell does not trace: the family has no
    ``param_axes`` in the port, so its params cannot be laid out over
    the ``model`` axis."""
    from repro_torch.config import QuantConfig
    from repro_torch.launch.op_analysis import fake_device
    from repro_torch.models.registry import build_model

    if mesh == "card":
        return ""
    with fake_device() as dev:
        model = build_model(cfg, QuantConfig(), device=dev)
    if model.param_axes is not None:
        return ""
    sizes, names = PRODUCTION_MESHES[mesh]
    return (f"SKIP(param_axes): the {cfg.family!r} family has no "
            f"param_axes in the port (ROADMAP.md section 1), so its "
            f"params are not laid out over the 'model' axis of the "
            f"{'x'.join(map(str, sizes))} mesh {names}")


def _run_config(cfg, quant, shape, dp_overrides):
    from repro_torch.config import DPConfig, OptimConfig, RunConfig

    dp_kwargs = dict(enabled=True, microbatch_size=1,
                     microbatch_mode=("single" if cfg.family == "moe_lm"
                                      else "data_parallel"),
                     grad_accum_dtype=("bfloat16" if cfg.family == "moe_lm"
                                       else "float32"))
    dp_kwargs.update(dp_overrides or {})
    return RunConfig(model=cfg, quant=quant, dp=DPConfig(**dp_kwargs),
                     optim=OptimConfig(name="sgd", lr=0.5),
                     global_batch=shape.global_batch, seq_len=shape.seq_len)


def run_cell(arch: str, shape_name: str, mesh: str = "card",
             fmt: str = "luq_fp4", extra_tag: str = "",
             overrides: dict = None, dp_overrides: dict = None) -> dict:
    from repro_torch.config import SHAPES, QuantConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import op_analysis, roofline

    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    rec = {"arch": arch, "shape": shape_name, "mesh": MESH_TAGS[mesh],
           "kind": shape.kind, "tag": extra_tag}
    reason = cell_skip_reason(cfg, shape) or mesh_skip_reason(cfg, mesh)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    quant = QuantConfig(fmt=fmt)
    t0 = time.perf_counter()
    world = (contextlib.nullcontext() if mesh == "card"
             else op_analysis.fake_world(*PRODUCTION_MESHES[mesh]))
    with world as ranks:
        if shape.kind == "train":
            analysis = op_analysis.analyze_train(
                _run_config(cfg, quant, shape, dp_overrides), mesh=ranks)
        else:
            analysis = op_analysis.analyze_serve(cfg, quant, shape.kind,
                                                 shape.global_batch,
                                                 shape.seq_len, mesh=ranks)
        n_devices = 1 if ranks is None else int(ranks.devices.size)
    rec["trace_s"] = time.perf_counter() - t0
    terms = roofline.derive(analysis,
                            model_flops_per_device=analysis["model_flops"])
    rec.update({
        "status": "ok",
        "collectives": analysis["collectives"],
        "warnings": analysis["warnings"],
        "roofline": terms.as_dict(),
        "kernels": analysis["kernels"],
        "ops": analysis["ops"],
        "trips": analysis.get("trips", 1),
        "n_params": analysis["n_params"],
        "n_active_params": analysis["n_active_params"],
        "n_devices": n_devices,
        "peak_bytes": analysis["peak_bytes"],
        "fits": op_analysis.fits(analysis),
    })
    return rec


def main(argv=None) -> int:
    import torch

    from repro_torch.config import SHAPES
    from repro_torch.configs import ASSIGNED_ARCHS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (the 10 assigned)")
    ap.add_argument("--shape", default="all",
                    help="train_4k|prefill_32k|decode_32k|long_500k|all")
    ap.add_argument("--mesh", default="card",
                    choices=["card", "single", "multi", "both"],
                    help="card: one H100; single / multi: the production "
                         "meshes (one rank's shard program); both: the "
                         "two production meshes")
    ap.add_argument("--fmt", default="luq_fp4")
    ap.add_argument("--tag", default="", help="variant tag for perf runs")
    ap.add_argument("--out", default="results/dryrun_torch")
    # perf-variant overrides
    ap.add_argument("--microbatch-size", type=int, default=None)
    ap.add_argument("--partial-accum", action="store_true")
    ap.add_argument("--ssm-chunk", type=int, default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--attn-chunk-q", type=int, default=None)
    args = ap.parse_args(argv)

    overrides = {}
    if args.ssm_chunk is not None:
        overrides["ssm_chunk"] = args.ssm_chunk
    if args.capacity_factor is not None:
        overrides["moe_capacity_factor"] = args.capacity_factor
    if args.attn_chunk_q is not None:
        overrides["attn_chunk_q"] = args.attn_chunk_q
    dp_overrides = {}
    if args.microbatch_size is not None:
        dp_overrides["microbatch_size"] = args.microbatch_size
    if args.partial_accum:
        dp_overrides["partial_accum"] = True

    # float32 without TF32, as the train CLI runs it
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    archs = ASSIGNED_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                name = f"{arch}__{shape}__{mesh}"
                if args.tag:
                    name += f"__{args.tag}"
                try:
                    rec = run_cell(arch, shape, mesh, fmt=args.fmt,
                                   extra_tag=args.tag, overrides=overrides,
                                   dp_overrides=dp_overrides)
                except Exception as e:  # noqa: BLE001
                    rec = {"arch": arch, "shape": shape,
                           "mesh": MESH_TAGS[mesh], "status": "error",
                           "error": str(e),
                           "traceback": traceback.format_exc()}
                    failures += 1
                    print(f"[{name}] ERROR: {e}", flush=True)
                (outdir / f"{name}.json").write_text(
                    json.dumps(rec, indent=2, default=str))
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(f"[{name}] OK compute={r['compute_s']:.3e}s "
                          f"memory={r['memory_s']:.3e}s "
                          f"collective={r['collective_s']:.3e}s "
                          f"dominant={r['dominant']} "
                          f"peak={rec['peak_bytes'] / 1e9:.2f}GB "
                          f"fits={rec['fits']} "
                          f"trace={rec['trace_s']:.1f}s", flush=True)
                elif rec["status"] == "skipped":
                    print(f"[{name}] {rec['reason']}", flush=True)
    print("dry-run complete; failures:", failures)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
