"""Device profiles for browser-scale populations (paper §4 heterogeneity).

The paper's fleet is whatever browsers happen to open the page: a GPU
workstation (the Sukiyaki WebCL path, ~30x its own CPU fallback), office
desktops, laptops on Wi-Fi, phones on mobile networks — and every one of
them can close the tab mid-lease.  The browser-DL measurement study
(*Moving Deep Learning into Web Browser*, PAPERS.md) puts hard numbers
on this: device capability spreads exceed 30x and network latencies are
heavy-tailed, so a realistic churn simulation cannot draw clients from a
uniform distribution.

This module is the single source of those draws.  A :class:`DeviceTier`
describes one device class (relative speed, latency scale, per-round
tab-close hazard, population weight); :func:`draw_fleet` samples a
population of :class:`DeviceDraw`\\ s from the tier mix with a seeded
RNG, so a 10k-client chaos run is exactly reproducible from its seed.
Draws convert to the scheduler's :class:`~repro.core.distributor
.ClientProfile` via :meth:`DeviceDraw.client_profile` — the virtual-clock
sim (``benchmarks/churn_scale.py``) and the socket-level chaos harness
(``tests/chaos.py``) both consume the same distributions.

Latency is **Pareto** (heavy-tailed: most draws near the scale, rare
draws many multiples out — the study's long-tail mobile links), speed is
log-uniform within a tier's spread, and tab-close is a per-round hazard
(memoryless: a tab is as likely to close in round 40 as round 1).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.core.distributor import ClientProfile

__all__ = ["DeviceTier", "DeviceDraw", "DEFAULT_TIERS", "draw_fleet",
           "fleet_summary", "scale_hazard"]


@dataclass(frozen=True)
class DeviceTier:
    """One device class in the population mix.

    ``speed`` is the tier's median throughput in work-units/s on the
    fabric's normalized scale (the GPU tier sits ~30x the CPU tiers —
    the paper's Sukiyaki gap); a draw lands log-uniformly in
    ``[speed / spread, speed * spread]``.  ``latency_s`` is the Pareto
    scale of the per-lease network latency; ``latency_alpha`` its tail
    index (smaller = heavier tail).  ``tab_close_hazard`` is the
    probability the tab closes during any one round.  ``weight`` is the
    tier's share of the population."""

    name: str
    speed: float
    spread: float = 2.0
    latency_s: float = 0.02
    latency_alpha: float = 2.5
    tab_close_hazard: float = 0.1
    weight: float = 1.0


#: The default population mix.  Speeds put the GPU tier 30x the desktop
#: CPU tier; hazards average out near the ROADMAP's 20%/round churn when
#: mixed by weight (mobile tabs close far more often than workstations).
DEFAULT_TIERS: Dict[str, DeviceTier] = {
    "gpu_desktop": DeviceTier("gpu_desktop", speed=300.0, spread=1.5,
                              latency_s=0.01, latency_alpha=3.0,
                              tab_close_hazard=0.05, weight=0.1),
    "cpu_desktop": DeviceTier("cpu_desktop", speed=10.0, spread=2.0,
                              latency_s=0.02, latency_alpha=2.5,
                              tab_close_hazard=0.1, weight=0.4),
    "laptop": DeviceTier("laptop", speed=6.0, spread=2.5,
                         latency_s=0.04, latency_alpha=2.0,
                         tab_close_hazard=0.25, weight=0.3),
    "mobile": DeviceTier("mobile", speed=2.0, spread=3.0,
                         latency_s=0.08, latency_alpha=1.6,
                         tab_close_hazard=0.45, weight=0.2),
}


@dataclass(frozen=True)
class DeviceDraw:
    """One sampled device: a concrete (speed, latency, hazard) triple
    plus the tier it came from."""

    name: str
    tier: str
    speed: float
    latency: float
    tab_close_hazard: float

    def client_profile(self, **overrides) -> ClientProfile:
        """The scheduler-facing view of this device (``die_after`` /
        ``fail_prob`` and friends may be layered on by the caller)."""
        kw = dict(name=self.name, speed=self.speed, latency=self.latency)
        kw.update(overrides)
        return ClientProfile(**kw)


def _pareto(rng: random.Random, scale: float, alpha: float) -> float:
    """One Pareto(Lomax-shifted) draw: ``scale`` at the head, tail index
    ``alpha``.  Mean exists only for alpha > 1; the mobile tier's 1.6
    keeps rare multi-second stalls in the population on purpose."""
    u = 1.0 - rng.random()                 # (0, 1]
    return scale * u ** (-1.0 / alpha)


def draw_fleet(n: int, *, seed: int = 0,
               tiers: Optional[Sequence[DeviceTier]] = None
               ) -> List[DeviceDraw]:
    """Sample a reproducible ``n``-device population from the tier mix.

    Deterministic in ``(n, seed, tiers)``: the chaos harness and the
    virtual-clock benchmark re-create identical fleets from one seed, so
    a churn failure replays exactly."""
    if tiers is None:
        tiers = list(DEFAULT_TIERS.values())
    if not tiers:
        raise ValueError("tier mix is empty")
    rng = random.Random(seed)
    weights = [max(t.weight, 0.0) for t in tiers]
    out: List[DeviceDraw] = []
    for i in range(n):
        tier = rng.choices(tiers, weights=weights)[0]
        # log-uniform speed inside the tier's spread
        lo, hi = tier.speed / tier.spread, tier.speed * tier.spread
        speed = lo * (hi / lo) ** rng.random()
        latency = _pareto(rng, tier.latency_s, tier.latency_alpha)
        out.append(DeviceDraw(name=f"{tier.name}-{i}", tier=tier.name,
                              speed=speed, latency=latency,
                              tab_close_hazard=tier.tab_close_hazard))
    return out


def scale_hazard(fleet: Sequence[DeviceDraw], target: float
                 ) -> List[DeviceDraw]:
    """Rescale every device's tab-close hazard so the population mean
    hits ``target`` (e.g. the ROADMAP's 20%/round churn), preserving the
    relative tier shape (mobile still churns more than workstations).
    Hazards are clamped to [0, 1]."""
    if not fleet:
        return []
    mean = sum(d.tab_close_hazard for d in fleet) / len(fleet)
    if mean <= 0.0:
        factor = 0.0
    else:
        factor = target / mean
    return [DeviceDraw(name=d.name, tier=d.tier, speed=d.speed,
                       latency=d.latency,
                       tab_close_hazard=min(1.0, max(
                           0.0, d.tab_close_hazard * factor)))
            for d in fleet]


def fleet_summary(fleet: Sequence[DeviceDraw]) -> dict:
    """JSON-safe population description for ``BENCH_churn.json``: tier
    counts, the realised speed spread, latency tail, and mean hazard."""
    if not fleet:
        return {"devices": 0, "tiers": {}}
    by_tier: Dict[str, int] = {}
    for d in fleet:
        by_tier[d.tier] = by_tier.get(d.tier, 0) + 1
    speeds = sorted(d.speed for d in fleet)
    lats = sorted(d.latency for d in fleet)

    def pct(xs, q):
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    return {
        "devices": len(fleet),
        "tiers": by_tier,
        "speed_spread": speeds[-1] / max(speeds[0], 1e-9),
        "speed_p50": pct(speeds, 0.5),
        "latency_p50_s": pct(lats, 0.5),
        "latency_p99_s": pct(lats, 0.99),
        "mean_tab_close_hazard": (sum(d.tab_close_hazard for d in fleet)
                                  / len(fleet)),
    }
