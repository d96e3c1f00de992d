"""mfu.serve: a whole ``generate`` call's share of the chip's peak, in %.

The products a call needs (``bench/work/counts.py::serve_call_flops``:
the prefill, every decode step against its cache, the head at each
served position), times the window's calls, over the window's seconds,
over 495 TFLOP/s (TF32)."""

from bench.work import counts as c


def read(run):
    mix, w = run.cell.mix, run.window
    flops = c.serve_call_flops(run.dims, mix["batch"], mix["prompt"],
                               mix["gen"])
    return 100.0 * flops * w["done"] / w["seconds"] / c.PEAK_TF32
