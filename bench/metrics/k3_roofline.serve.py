"""k3_roofline.serve: the prefill attention's share of its roofline, in %.

The causal attention every layer's prefill needs over the prompts
(``bench/work/counts.py::attention_work``), the larger of its operations
over 495 TFLOP/s (TF32) and its bytes over 3.35 TB/s, over the device
time of K3's kernels in the traced calls.  Absent when no kernel of these
names ran."""

from bench.work import counts as c

KERNELS = ("flash_kernel",)


def read(run):
    t = run.trace
    if t is None:
        return None
    seconds, launches = t.seconds_of(KERNELS)
    if not launches or seconds <= 0:
        return None
    mix, d = run.cell.mix, run.dims
    flops, nbytes = c.attention_work(mix["batch"], mix["prompt"],
                                     mix["prompt"], d["num_heads"],
                                     d["num_kv_heads"], d["head_dim"], True)
    bound = d["num_layers"] * c.bound_s(flops, nbytes)
    return 100.0 * bound * t.n / seconds
