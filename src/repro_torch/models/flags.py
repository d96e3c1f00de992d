"""Global model-lowering flags.

``scan_unroll``: when True, layer-stack scans lower as straight-line code
(and chunked attention runs unchunked).  Used ONLY by the dry-run's
cost-accounting compiles: XLA's HLO cost analysis counts a while-loop body
once regardless of trip count, so the roofline FLOP/byte terms are derived
from reduced-depth *unrolled* compiles and extrapolated linearly in depth
(see launch/dryrun.py).  Real execution always uses the scanned form.
"""
from __future__ import annotations

import contextlib

scan_unroll: bool = False


@contextlib.contextmanager
def unrolled_for_accounting():
    global scan_unroll
    prev = scan_unroll
    scan_unroll = True
    try:
        yield
    finally:
        scan_unroll = prev


def scan_kwargs() -> dict:
    return {"unroll": True} if scan_unroll else {}
