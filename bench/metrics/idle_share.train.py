"""idle_share: the share of the traced stretch (whole steps or calls, the
device synchronised at both ends) in which no operation ran on the
device, in %, from the profiler's trace."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
