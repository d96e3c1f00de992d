"""mfu.train: the whole training step's share of the chip's peak, in %.

The benchmark's count of the products a split_concurrent step needs at
the cell's shapes (``bench/work/counts.py::train_step_flops``: forward
and backward, recomputation not counted), times the window's steps, over
the window's seconds, over 495 TFLOP/s (TF32, the peak no product held
to f32 results runs above on this chip)."""

from bench.work import counts as c


def read(run):
    mix, w = run.cell.mix, run.window
    flops = c.train_step_flops(run.dims, mix["batch"], mix["seq"])
    return 100.0 * flops * w["done"] / w["seconds"] / c.PEAK_TF32
