"""Dry-run of every (architecture x input shape) combination on a
production mesh (port of ``repro.launch.dryrun``): build each step, run it
once on the meta device over a shape-only mesh, prove that its sharding
holds together, and emit its memory and roofline terms as JSONL records
with the JAX dry-run's keys.

The JAX dry-run compiles each step for 512 placeholder CPU devices and
reads XLA's analyses.  Here the mesh is a fake process group of 256 (512)
ranks (``launch.mesh.make_production_mesh``), this process its rank 0; the
arguments are DTensors of meta tensors with rank 0's local shapes, and
``StepBundle.account`` runs the eager step once under
``launch.hlo_analysis.Accounting``: per-device FLOPs, bytes, collectives,
kernel launches (the kernels' meta route) and the high-water mark of
storage.  Nothing is computed or allocated, so no card is needed, and
there is no card path to fall back from.

Counts are per device, and the eager step's ops are counted as they run
(unfused).  By default (``accounting``) :func:`accounting_costs` runs two
reduced depths and extrapolates linearly, as the JAX dry-run does for its
own reasons (XLA counts a loop body once); here it shortens the recurrent
families' step loops, which a meta step runs op by op.  FLOPs,
collectives and kernel launches are exactly linear in depth, so their
extrapolation is exact.  Bytes are not: the backward of indexing one
layer out of a stacked parameter fills a zero gradient of the whole stack,
L times a step, a term in L squared that two depths do not see; nor is the
storage high-water mark, whose peak moves as depth grows.  ``--full-depth``
(``accounting=False``) counts one step at full depth instead, every field
exact.  The memory fields are the port's: ``arg_bytes_per_device`` is
rank 0's local shards of the arguments, ``out_bytes_per_device`` the
outputs' new storage, ``temp_bytes_per_device`` the high-water mark of
storage the step made and ``peak_bytes_per_device`` their sum with the
arguments'.

``models.flags.scan_unroll`` changes nothing here: the port's models loop
over their layers in Python and have no scans to unroll, so every layer
is counted as it runs.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \
      [--full-depth] [--limit 600] --out results/dryrun_torch.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \
      --shape prefill_32k --mesh 1x1 --batch 4 --seq 512 \
      --compute-dtype float32 --out counts.jsonl     # a one-card step
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time
import traceback

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, RunConfig,
                                      get_arch_config)
from repro_torch.launch.hlo_analysis import roofline_from_counts
from repro_torch.launch.mesh import (PRODUCTION_SHAPES, make_production_mesh,
                                     make_shape_mesh)
from repro_torch.launch.steps import (arch_for_run, build_step,
                                     resolve_decode_layout)
from repro_torch.sharding.spec import axis_sizes

#: the per-device counts extrapolated in depth, and the memory fields
_LINEAR = ("flops", "product_flops", "bytes", "arg_bytes", "out_bytes",
           "temp_bytes", "peak_bytes")


def model_flops_for(cfg, shape) -> float:
    """Analytic useful FLOPs (6ND train / 2ND inference) for a shape."""
    from repro_torch.models.model import count_params_analytic

    n = count_params_analytic(cfg, active_only=True)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _accounting_depths(cfg):
    if cfg.family == "hybrid":
        p = cfg.attn_layer_period
        return p, 2 * p
    return 2, 4


def _reduced_depth(cfg, depth: int):
    kw = {"num_layers": depth}
    if cfg.family == "encdec":
        kw["encoder_layers"] = depth
    return dataclasses.replace(cfg, **kw)


def _extrap(v1: int, v2: int, d1: int, d2: int, depth: int) -> int:
    """v at ``depth`` on the line through (d1, v1) and (d2, v2), in
    integers (the counts are exactly linear in depth)."""
    return max(v1 + (v2 - v1) * (depth - d1) // (d2 - d1), 0)


def _extrap_dict(a: dict, b: dict, d1, d2, depth) -> dict:
    return {k: _extrap(a.get(k, 0), b.get(k, 0), d1, d2, depth)
            for k in sorted(set(a) | set(b))}


def warm(cfg, run, shape, mesh) -> None:
    """One step at the shallowest accounting depth, not counted.  DTensor
    runs an op it has no sharding rule for as its decomposition on the
    first call alone (and caches the rule it finds), so a first step runs
    ops that later ones do not (Jamba's full-width step at depth 8: 3x the
    bytes and 1.7x the storage of the next); a count is of a later
    step."""
    build_step(_reduced_depth(cfg, _accounting_depths(cfg)[0]), run, shape,
               mesh).account()


def accounting_costs(cfg, run, shape, mesh) -> dict:
    """One rank's counts (``StepBundle.account``) of ``cfg``'s step at its
    full depth, from the steps of two reduced depths
    (:func:`_accounting_depths`) extrapolated linearly (exact for FLOPs,
    collectives and launches; see the module docstring for bytes and
    memory)."""
    d1, d2 = _accounting_depths(cfg)
    samples = []
    for d in (d1, d2):
        bundle = build_step(_reduced_depth(cfg, d), run, shape, mesh)
        samples.append(bundle.account())
        del bundle
        gc.collect()
    return extrapolate(samples, (d1, d2), cfg.num_layers)


def extrapolate(samples, depths, depth: int) -> dict:
    """The counts of two runs at ``depths`` extrapolated to ``depth``."""
    (a, b), (d1, d2) = samples, depths
    out = {k: _extrap(a[k], b[k], d1, d2, depth) for k in _LINEAR}
    out["sequential_all_reduces"] = _extrap(
        a["sequential_all_reduces"], b["sequential_all_reduces"], d1, d2,
        depth)
    for k in ("collectives", "collective_counts", "launches",
              "flops_by_op"):
        out[k] = _extrap_dict(a[k], b[k], d1, d2, depth)
    out["accounting_depths"] = [d1, d2]
    return out


def make_run(cfg, shape, mesh, *, strategy=None, multi_pod=False,
             compute_dtype=None) -> RunConfig:
    """The dry-run's run of ``cfg`` at ``shape`` on ``mesh``, as the JAX
    dry-run's: ``split_concurrent`` for training and ``fsdp_tp`` else, f32
    parameters for training and bf16 else, the decode layout resolved
    against the full-size config; ``compute_dtype`` (bf16 by default)."""
    strategy = strategy or ("split_concurrent" if shape.kind == "train"
                            else "fsdp_tp")
    layout = (resolve_decode_layout(cfg, mesh, "auto")
              if shape.kind == "decode" else "batch_sharded")
    return RunConfig(arch=cfg.name, shape=shape.name, strategy=strategy,
                     param_dtype="float32" if shape.kind == "train"
                     else "bfloat16", decode_layout=layout,
                     multi_pod=multi_pod,
                     **({"compute_dtype": compute_dtype}
                        if compute_dtype else {}))


def _mesh_of(mesh_shape, multi_pod: bool):
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod)
    names = PRODUCTION_SHAPES[len(mesh_shape) == 3][1]
    return make_shape_mesh(mesh_shape, names)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            strategy: str | None = None, verbose: bool = True,
            accounting: bool = True, mesh_shape=None, batch=None, seq=None,
            compute_dtype: str | None = None) -> dict:
    """Run one (arch, shape) combo's step on the meta device on the
    production mesh (or a shape-only mesh of ``mesh_shape``) and return its
    memory/roofline record.  ``accounting``: the counts from two reduced
    depths (:func:`accounting_costs`); else from one step at full depth
    (every field exact).
    ``batch``/``seq`` replace the shape's global batch and sequence,
    ``compute_dtype`` the run's (bf16 by default)."""
    shape = INPUT_SHAPES[shape_name]
    shape = dataclasses.replace(
        shape, global_batch=batch or shape.global_batch,
        seq_len=seq or shape.seq_len)
    cfg = get_arch_config(arch)
    mesh = _mesh_of(mesh_shape, multi_pod)
    run = make_run(cfg, shape, mesh, strategy=strategy, multi_pod=multi_pod,
                   compute_dtype=compute_dtype)
    strategy = run.strategy
    sizes = axis_sizes(mesh)
    chips = 1
    for s in sizes.values():
        chips *= s
    t0 = time.time()
    warm(cfg, run, shape, mesh)
    if accounting:
        counts = accounting_costs(cfg, run, shape, mesh)
    else:
        counts = build_step(cfg, run, shape, mesh).account()
    t1 = time.time()
    roof = roofline_from_counts(
        counts, chips,
        model_flops=model_flops_for(arch_for_run(cfg, shape, strategy),
                                    shape),
        compute_dtype=run.compute_dtype)
    rec = {
        "arch": arch, "shape": shape_name, "strategy": strategy,
        "mesh": "x".join(str(s) for s in sizes.values()),
        "chips": chips,
        "compile_s": round(t1 - t0, 1),
        "arg_bytes_per_device": counts["arg_bytes"],
        "out_bytes_per_device": counts["out_bytes"],
        "temp_bytes_per_device": counts["temp_bytes"],
        "peak_bytes_per_device": counts["peak_bytes"],
        "collectives": {k: int(v) for k, v in counts["collectives"].items()},
        "collective_counts": dict(counts["collective_counts"]),
        "sequential_all_reduces": counts["sequential_all_reduces"],
        **roof.as_dict(),
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "compute_dtype": run.compute_dtype,
        "product_flops_per_device": counts["product_flops"],
        "flops_by_op": counts["flops_by_op"],
        "launches": counts["launches"],
        "accounting_depths": counts.get("accounting_depths"),
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} ({rec['mesh']}, {strategy}): "
              f"OK run={rec['compile_s']}s "
              f"args/dev={rec['arg_bytes_per_device']/2**30:.2f}GiB "
              f"temp/dev={rec['temp_bytes_per_device']/2**30:.2f}GiB "
              f"dominant={rec['dominant']} "
              f"t=({roof.t_compute:.4f},{roof.t_memory:.4f},"
              f"{roof.t_collective:.4f})s", flush=True)
    gc.collect()
    return rec


def _run_limited(arch: str, shape: str, argv, limit: float) -> dict:
    """One combo through this CLI in a child process (the other flags as
    given), killed at ``limit`` seconds; its record."""
    import os
    import subprocess
    import sys
    import tempfile

    argv = list(sys.argv[1:] if argv is None else argv)
    skip = {"--all": 0, "--limit": 1, "--out": 1, "--arch": 1,
            "--shape": 1}
    rest, i = [], 0
    while i < len(argv):
        if argv[i] in skip:
            i += 1 + skip[argv[i]]
            continue
        rest.append(argv[i])
        i += 1
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rec.jsonl")
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--out", out, *rest],
                capture_output=True, text=True, timeout=limit)
        except subprocess.TimeoutExpired:
            raise TimeoutError(f"cut at the {limit:g} s limit") from None
        print("".join(ln for ln in proc.stdout.splitlines(True)
                      if " OK, " not in ln), end="", flush=True)
        if proc.returncode:
            raise RuntimeError(proc.stderr.strip().splitlines()[-1]
                               if proc.stderr.strip() else "failed")
        with open(out) as f:
            return json.loads(f.readline())


def main(argv=None) -> None:
    """CLI: ``--arch/--shape`` for one combo or ``--all`` for the sweep."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--strategy", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="write JSONL records here")
    ap.add_argument("--mesh", default=None,
                    help="a shape-only mesh DxM (or PxDxM) in place of the "
                         "production mesh")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--compute-dtype", default=None)
    ap.add_argument("--full-depth", action="store_true",
                    help="count one step at full depth, not two reduced "
                         "depths extrapolated")
    ap.add_argument("--limit", type=float, default=None,
                    help="run each combo in a process of its own, killed "
                         "(and counted failed) after this many seconds")
    args = ap.parse_args(argv)

    if args.all:     # every combo, or every one of --arch's / --shape's
        combos = [(a, s) for a in ([args.arch] if args.arch else ARCH_IDS)
                  for s in ([args.shape] if args.shape else INPUT_SHAPES)]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")
    mesh_shape = (tuple(int(x) for x in args.mesh.split("x"))
                  if args.mesh else None)

    records, failures = [], []
    for arch, shape in combos:
        try:
            records.append(
                _run_limited(arch, shape, argv, args.limit) if args.limit
                else run_one(arch, shape, multi_pod=args.multi_pod,
                             strategy=args.strategy,
                             accounting=not args.full_depth,
                             mesh_shape=mesh_shape, batch=args.batch,
                             seq=args.seq, compute_dtype=args.compute_dtype))
        except Exception as e:  # a failure here is a sharding bug
            failures.append((arch, shape, repr(e)))
            print(f"[dryrun] {arch} x {shape} FAILED: {e}", flush=True)
            traceback.print_exc()
        if args.out:
            with open(args.out, "w") as f:
                for r in records:
                    f.write(json.dumps(r) + "\n")
    print(f"[dryrun] {len(records)} OK, {len(failures)} failed")
    if failures:
        raise SystemExit(1)


__all__ = ["accounting_costs", "extrapolate", "main",
           "make_run", "model_flops_for", "run_one", "warm"]

if __name__ == "__main__":
    main()
