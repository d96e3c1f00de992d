"""Causal ticket tracing for the Sashimi fabric.

A :class:`Tracer` records spans and instant events for the full ticket
lifecycle (enqueue -> shard-route -> lease -> wire-transfer ->
client-execute -> submit -> barrier-fold) and exports them as Chrome
trace-event JSON, loadable directly in Perfetto (ui.perfetto.dev).

Design constraints, in order:

  * **Zero-cost when disabled.**  Nothing in the fabric holds a tracer by
    default; every instrumentation site is guarded by a single
    ``if tracer is not None`` attribute check.  There is no global
    registry and no no-op call overhead on the hot path.
  * **Deterministic on the virtual clock.**  The tracer never reads wall
    time on its own when a caller supplies ``ts``; when it must, it uses
    its injectable ``clock`` (set it to the queue's clock).  Two
    same-seed virtual-clock runs therefore produce byte-identical
    traces (``benchmarks/run.py --only obs`` asserts this).
  * **Balanced by construction.**  ``begin`` returns an opaque span id;
    every code path that retires the underlying fabric object (submit,
    release, cancel, fold) ends the span exactly once because the span
    id lives *in* the bookkeeping dict whose pop already happens exactly
    once.  ``balanced()`` is the invariant the property tests check.

Span encoding: lifecycle spans that overlap arbitrarily on one lane
(ticket lifetimes, lease windows) are emitted as Chrome *async* events
(``ph: "b"/"e"`` pairs keyed by span id); per-lane sequential spans
(client execute, wire transfer, round barriers) are emitted as complete
``ph: "X"`` slices so Perfetto nests them on their track.

Two long-running-fleet modes sit on top of the default
record-everything behaviour, both off unless asked for:

  * **Ring buffer** (``max_events=N``): finished events live in a
    bounded deque; the oldest are discarded (counted in
    ``events_dropped``) so a tracer can stay attached to a server for
    days.  :meth:`drain` pops the buffered events for shipping — the
    client-side telemetry flush uses it.
  * **Flight recorder** (:meth:`dump_on`): named instants (the PR 9
    failure signals — ``round.stall``, ``transport.evict``,
    ``transport.busy``) arm a trigger that writes the current buffer to
    a Perfetto file the moment the instant fires, so the evidence
    window around a failure is captured without anyone watching.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Tracer", "render_chrome_trace"]

_US = 1e6      # Chrome trace-event timestamps are microseconds


def render_chrome_trace(events: List[dict],
                        process_name: str = "sashimi-fabric") -> dict:
    """Render decoded events (the :meth:`Tracer.events` schema) to the
    Chrome trace-event JSON object format.  Tracks become threads of a
    single process: tid assignment is by sorted track name, with
    ``thread_name`` / ``thread_sort_index`` metadata so Perfetto shows
    one labelled lane per track.  Shared by :meth:`Tracer.chrome_trace`
    and the fleet aggregator's merged export."""
    tracks = sorted({e["track"] for e in events})
    tid = {t: i + 1 for i, t in enumerate(tracks)}
    out: List[dict] = []
    for t in tracks:
        out.append({"ph": "M", "name": "thread_name", "pid": 1,
                    "tid": tid[t], "args": {"name": t}})
        out.append({"ph": "M", "name": "thread_sort_index", "pid": 1,
                    "tid": tid[t], "args": {"sort_index": tid[t]}})
    out.append({"ph": "M", "name": "process_name", "pid": 1,
                "args": {"name": process_name}})
    for e in events:
        ev = {"name": e["name"], "cat": e["cat"], "ph": e["ph"],
              "ts": round(e["ts"] * _US, 3), "pid": 1,
              "tid": tid[e["track"]]}
        if e["ph"] == "X":
            ev["dur"] = round(e["dur"] * _US, 3)
        elif e["ph"] in ("b", "e"):
            ev["id"] = e["id"]
        elif e["ph"] == "i":
            ev["s"] = "t"
        if e.get("args"):
            ev["args"] = e["args"]
        out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


class Tracer:
    """Collects lifecycle spans and exports Chrome trace-event JSON.

    ``clock`` is the fallback timestamp source for calls that do not
    pass ``ts`` explicitly; wire it to the same injectable clock the
    ticket queue uses so simulated time and trace time agree.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic, *,
                 max_events: Optional[int] = None):
        self.clock = clock
        self._lock = threading.Lock()
        # finished events, in completion order (deterministic under the
        # single-threaded virtual-clock sims).  Stored as compact tuples
        # (ph, name, cat, track, ts0, ts1, sid, args) — ph "X" lane
        # slice, "a" async begin/end pair, "i" instant — and decoded to
        # the dict schema lazily in events()/chrome_trace(), keeping the
        # record path (the only part on the fabric's hot path) cheap.
        # With max_events set the store is a bounded ring: the oldest
        # finished events fall off (counted), so a long-lived fleet
        # tracer holds a sliding evidence window instead of growing
        # without bound.
        self.max_events = max_events
        self._events = ([] if max_events is None
                        else deque(maxlen=int(max_events)))
        # hot-path dispatch: the default (unbounded) tracer appends via
        # the list's own bound method — zero added cost over the pre-ring
        # implementation; only ring mode pays for drop accounting.  Both
        # drain() and clear() keep container identity, so the binding
        # stays valid for the tracer's lifetime.
        self._append = (self._events.append if max_events is None
                        else self._ring_append)
        self.events_dropped = 0
        # sid -> (name, cat, track, lane, ts0, args)
        self._open: Dict[int, Tuple[str, str, str, bool, float,
                                    Optional[dict]]] = {}
        self._next_sid = 0
        self.spans_opened = 0
        self.spans_closed = 0
        # ends on unknown / already-closed ids; must stay 0 (see
        # balanced()) — counted rather than raised so a bug in one
        # instrumentation site cannot take down the fabric itself
        self.end_errors = 0
        # flight-recorder triggers: instant name -> mutable state dict
        # {path, after, seen, limit, fired} (see dump_on)
        self._triggers: Dict[str, dict] = {}
        self.dumps_written: List[str] = []

    def _ring_append(self, event: tuple) -> None:
        """Ring-mode append under the lock, counting evictions."""
        ev = self._events
        if len(ev) == ev.maxlen:
            self.events_dropped += 1
        ev.append(event)

    # -- recording ---------------------------------------------------------

    def begin(self, name: str, *, track: str = "fabric", cat: str = "fabric",
              ts: Optional[float] = None, lane: bool = False,
              args: Optional[dict] = None) -> int:
        """Open a span; returns an id to pass to :meth:`end` exactly once.

        ``lane=True`` emits a complete-slice event (for sequential,
        properly-nested spans on one track); the default emits an async
        begin/end pair (safe for spans that overlap arbitrarily).
        """
        if ts is None:
            ts = self.clock()
        with self._lock:
            sid = self._next_sid = self._next_sid + 1
            self._open[sid] = (name, cat, track, lane, ts, args)
            self.spans_opened += 1
        return sid

    def begin_many(self, name: str, args_list, *, track: str = "fabric",
                   cat: str = "fabric",
                   ts: Optional[float] = None) -> List[int]:
        """Open one async span per element of ``args_list`` (each element
        the span's args dict) under a single lock acquisition — the bulk
        path for per-ticket spans in ``add_many``."""
        if ts is None:
            ts = self.clock()
        with self._lock:
            sid = self._next_sid
            sids = []
            for a in args_list:
                sid += 1
                self._open[sid] = (name, cat, track, False, ts, a)
                sids.append(sid)
            self._next_sid = sid
            self.spans_opened += len(sids)
        return sids

    def end(self, sid: Optional[int], *, ts: Optional[float] = None,
            args: Optional[dict] = None) -> None:
        """Close a span opened by :meth:`begin`.  ``sid=None`` is a no-op
        so call sites can pass ``spans.pop(key, None)`` unconditionally."""
        if sid is None:
            return
        if ts is None:
            ts = self.clock()
        with self._lock:
            rec = self._open.pop(sid, None)
            if rec is None:
                self.end_errors += 1
                return
            self.spans_closed += 1
            # begin-args and end-args ride as-is; merged lazily at decode
            self._append(("X" if rec[3] else "a", rec[0], rec[1],
                          rec[2], rec[4], ts, sid, rec[5], args))

    def instant(self, name: str, *, track: str = "fabric",
                cat: str = "fabric", ts: Optional[float] = None,
                args: Optional[dict] = None) -> None:
        """Record a zero-duration event (enqueue, route, policy firing)."""
        if ts is None:
            ts = self.clock()
        dump_path = None
        with self._lock:
            self._append(("i", name, cat, track, ts, ts, 0, args, None))
            if self._triggers:           # falsy-check: free when unused
                trig = self._triggers.get(name)
                if trig is not None and trig["fired"] < trig["limit"]:
                    trig["seen"] += 1
                    if trig["seen"] >= trig["after"]:
                        trig["fired"] += 1
                        trig["seen"] = 0
                        dump_path = trig["path"]
        if dump_path is not None:
            # outside the lock: write() re-enters via events()
            self.write(dump_path)
            self.dumps_written.append(dump_path)

    # -- flight recorder ---------------------------------------------------

    def dump_on(self, trigger: str, path: str, *, after: int = 1,
                limit: int = 1) -> None:
        """Arm the flight recorder: when the instant named ``trigger``
        has fired ``after`` times, write the current (ring-bounded)
        trace to ``path``.  At most ``limit`` dumps per trigger; the
        occurrence count resets after each dump so ``after=N`` means
        "every N-th occurrence" (busy *storms*, not single refusals).
        Written paths are recorded in ``dumps_written``."""
        if after < 1 or limit < 1:
            raise ValueError("dump_on requires after >= 1 and limit >= 1")
        with self._lock:
            self._triggers[trigger] = {"path": path, "after": int(after),
                                       "seen": 0, "limit": int(limit),
                                       "fired": 0}

    def drain(self) -> List[dict]:
        """Pop and return every buffered finished event in the decoded
        schema (see :meth:`events`).  Open spans stay open; counters
        (``spans_opened``/``closed``, ``events_dropped``) are untouched.
        The client-side telemetry flush ships these over the wire."""
        with self._lock:
            raw = list(self._events)
            self._events.clear()
        return self._decode(raw)

    # -- invariants --------------------------------------------------------

    def balanced(self) -> bool:
        """True iff every opened span was closed exactly once."""
        with self._lock:
            return not self._open and self.end_errors == 0 \
                and self.spans_opened == self.spans_closed

    def open_spans(self) -> List[dict]:
        """Snapshot of still-open spans (for stall diagnostics)."""
        with self._lock:
            return [{"name": n, "track": tr, "since": ts0,
                     "args": a or {}}
                    for (n, c, tr, lane, ts0, a) in self._open.values()]

    def event_count(self) -> int:
        """Finished events in the decoded schema (async spans count as
        their begin/end pair — two events)."""
        return len(self.events())

    def events(self) -> List[dict]:
        """Finished events decoded to the internal dict schema (seconds
        timestamps): lane spans as ``ph "X"`` with ``dur``, async spans
        as ``ph "b"/"e"`` pairs sharing an ``id``, instants as ``ph
        "i"``."""
        with self._lock:
            raw = list(self._events)
        return self._decode(raw)

    @staticmethod
    def _decode(raw: List[tuple]) -> List[dict]:
        out: List[dict] = []
        for ph, name, cat, track, ts0, ts1, sid, args, args_end in raw:
            if args_end:
                args = {**args, **args_end} if args else args_end
            base = {"name": name, "cat": cat, "track": track}
            if ph == "X":
                out.append({**base, "ph": "X", "ts": ts0,
                            "dur": max(0.0, ts1 - ts0), "args": args or {}})
            elif ph == "a":
                out.append({**base, "ph": "b", "id": sid, "ts": ts0,
                            "args": args or {}})
                out.append({**base, "ph": "e", "id": sid, "ts": ts1})
            else:
                out.append({**base, "ph": "i", "ts": ts0,
                            "args": args or {}})
        return out

    # -- export ------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """Render to the Chrome trace-event JSON object format.

        Tracks become threads of a single process: tid assignment is by
        sorted track name, with ``thread_name`` / ``thread_sort_index``
        metadata so Perfetto shows one labelled lane per track
        (per-client lanes, per-member lanes, the queue, the trainer).
        """
        return render_chrome_trace(self.events())

    def to_json(self) -> str:
        """Deterministic serialization (same-seed runs compare equal)."""
        return json.dumps(self.chrome_trace(), sort_keys=True,
                          separators=(",", ":"))

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json())
