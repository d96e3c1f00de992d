"""kernels_per_step.train: the device kernels one training step launches
(copies and fills not counted), from the profiler's trace of replayed
steps."""


def read(run):
    t = run.trace
    if t is None or not t.device_ops:
        return None
    return len(t.kernels()) / t.n
