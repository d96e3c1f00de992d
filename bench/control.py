"""The readings a cell's limits are set from, on the card at the cell's
own size, several seeds in one process:

    python bench/control.py --workload <cell> --seeds 11 12 13 \
        [--what program control half_batch] [--witness-above 0.1]

- ``control``: the reference put in the program's place, its products in
  TF32 (the precision below the configuration's f32), against the f32
  reference;
- training cells: ``program``, the set-up's steps of the timed path
  (``TrainLoop``), and ``half_batch``, the reference with the second
  half of each batch's rows masked out (the mean over the rest), against
  the f32 reference; a state left unchanged, or a stale head never
  refreshed, reads 1 by construction.  With ``--witness-above x``, a
  seed whose program reads a worst leaf's change gap of ``x`` or more is
  also read against a float64 reference, the program's steps and the
  f32 reference's alike (``f64``);
- serving cells: ``program``, the program's served tokens over a short
  window at the cell's load, and ``token_altered``, one of them changed,
  against the f32 reference.

The benchmark's own runs never run this.  Prints one JSON line a seed.
Give a training cell one seed a process: the program's freed graph pools
stay with the allocator, and a second seed's set-up or float64 reference
does not fit beside them.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _f64_steps(cell, dims, layout, seed, batches, device) -> dict:
    """The reference's steps from the seed's weights in float64."""
    from bench.core import weights
    from bench.reference import common

    params = common.unflat([(p, v.double()) for p, v in
                            common.flat(weights.make(layout, seed, device))])
    mix = cell.mix
    with common.precision("f32", device):
        return common.split_concurrent(
            cell.reference.Model(dims), params, batches, lr=mix["lr"],
            beta=mix["adagrad_beta"],
            head_sync_period=mix["head_sync_period"])


def train_readings(cell, seed, device, what, witness_above=None) -> dict:
    from bench.core import traffic
    from bench.core.train import (TrainLoop, gaps, model_dims,
                                  reference_steps)

    dims = model_dims(cell.config)
    layout = cell.reference.layout(dims)
    mix = cell.mix
    batches = traffic.train_batches(dict(mix, pool=mix["compare_steps"]),
                                    dims["vocab_size"], seed, device)
    prog = None
    if "program" in what:
        loop = TrainLoop(cell, seed, device)
        loop.setup()
        loop.release()
        prog = {"losses": loop.losses, "grads": loop.grads,
                "change": loop.change, "stale": loop.stale}
        del loop
    ref = reference_steps(cell, dims, layout, seed, batches, device, "f32")
    out = {}
    if prog is not None:
        out["program"] = gaps(prog, ref)
    for name, prec, kw in (("control", "tf32", {}),
                           ("half_batch", "f32", {"half_batch": True})):
        if name in what:
            got = reference_steps(cell, dims, layout, seed, batches, device,
                                  prec, **kw)
            out[name] = gaps(got, ref)
    if (prog is not None and witness_above is not None
            and out["program"]["change_gap"] >= witness_above):
        f64 = _f64_steps(cell, dims, layout, seed, batches, device)
        out["f64"] = {"program": gaps(prog, f64),
                      "f32_reference": gaps(ref, f64)}
    return out


def serve_readings(cell, seed, device, what, witness_above=None) -> dict:
    import torch

    from bench.core.serve import ServeLoop, logit_gap, reference_logits

    loop = ServeLoop(cell, seed, device)
    loop.setup()
    calls = -(-cell.mix["sample_requests"] // cell.mix["batch"])
    for _ in range(calls):
        loop.step()
    loop.release()
    seqs, served = loop.sample()
    args = (cell, loop.dims, loop.layout, seed, seqs, cell.mix, device)
    f32 = reference_logits(*args, "f32")
    tf32 = reference_logits(*args, "tf32")
    altered = served.clone()
    altered[0, served.shape[1] // 2] = (altered[0, served.shape[1] // 2]
                                        + 1) % f32.shape[-1]
    return {"program": logit_gap(f32, served),
            "control": logit_gap(f32, tf32.argmax(-1)),
            "token_altered": logit_gap(f32, altered),
            "positions": int(served.numel()),
            "control_flips": int((tf32.argmax(-1) != f32.argmax(-1)).sum()),
            "program_flips": int((served != f32.argmax(-1)).sum()),
            "device": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--what", nargs="+",
                    default=["program", "control", "half_batch"])
    ap.add_argument("--witness-above", type=float, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.core import manifest

    if not torch.cuda.is_available():
        print("control readings need a CUDA device", file=sys.stderr)
        return 2
    cell = manifest.load_cell(args.workload, ROOT)
    fn = train_readings if cell.mix["kind"] == "train" else serve_readings
    for seed in args.seeds:
        t = time.perf_counter()
        out = fn(cell, seed, torch.device("cuda:0"), set(args.what),
                 args.witness_above)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
