"""prefill_ms.serve: the median over the window's calls of the prefill's
time, CUDA events around the api's ``prefill`` in the api the benchmark
hands to ``generate``."""

import statistics


def read(run):
    ms = run.window.get("prefill_ms")
    return statistics.median(ms) if ms else None
