"""k2_roofline.train: the optimizer's share of its roofline, in %.

The bytes the modified-AdaGrad update of every parameter must move
(``bench/work/counts.py::adagrad_bytes``: 20 bytes a parameter) over
3.35 TB/s, a step, over the device time of K2's kernels in the traced
steps.  Absent when no kernel of these names ran."""

from bench.work import counts as c

KERNELS = ("adagrad_kernel",)


def read(run):
    t = run.trace
    if t is None:
        return None
    seconds, launches = t.seconds_of(KERNELS)
    if not launches or seconds <= 0:
        return None
    bound = c.adagrad_bytes(c.n_params(run.layout)) / c.HBM_BYTES_PER_S
    return 100.0 * bound * t.n / seconds
