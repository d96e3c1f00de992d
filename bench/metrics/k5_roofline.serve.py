"""k5_roofline.serve: the WKV recurrence's share of its roofline, in %.

The bytes the WKV must move in a call (``bench/work/counts.py::
wkv_bytes``: every layer over the prompt, then over one token at each
decode step) over 3.35 TB/s, over the device time of K5's kernels in the
traced calls.  Absent when no kernel of these names ran."""

from bench.work import counts as c

KERNELS = ("wkv_kernel",)


def read(run):
    t = run.trace
    if t is None:
        return None
    seconds, launches = t.seconds_of(KERNELS)
    if not launches or seconds <= 0:
        return None
    mix, d = run.cell.mix, run.dims
    hd = d["rwkv"]["head_size"]
    h, b = d["d_model"] // hd, mix["batch"]
    per_call = d["num_layers"] * (c.wkv_bytes(b, mix["prompt"], h, hd)
                                  + mix["gen"] * c.wkv_bytes(b, 1, h, hd))
    return 100.0 * per_call / c.HBM_BYTES_PER_S * t.n / seconds
