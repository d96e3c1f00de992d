"""decode_ms.serve: the median over the window's calls of a call's time
(CUDA events around ``generate``) less its prefill, over its new tokens:
a decode step with the call's share of its graph capture."""

import statistics


def read(run):
    w, gen = run.window, run.cell.mix["gen"]
    if not w.get("call_ms"):
        return None
    return statistics.median((c - p) / gen for c, p in
                             zip(w["call_ms"], w["prefill_ms"]))
