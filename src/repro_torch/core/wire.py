"""Wire-level codecs shared by the transport and the registry (protocol v2).

This module is a *leaf*: it imports nothing from :mod:`repro`, so both
:mod:`repro.core.transport` (the framing layer) and
:mod:`repro.core.distributor` (the versioned registry) can use it without
creating an import cycle.  It provides the three building blocks of wire
protocol v2 (see ``docs/PROTOCOL.md``):

* :class:`ProtocolError` — the one exception type every decoder raises.
  Historically defined in ``transport.py``; it lives here now and is
  re-exported there for compatibility.
* The **binary payload codec** (:func:`encode_binary` /
  :func:`decode_binary`): splits an arbitrary pytree into (a) a compact
  JSON-safe *manifest* describing each array leaf (dtype, shape, nbytes)
  plus a pickled skeleton for the non-array residue, and (b) one
  contiguous byte buffer holding the raw array data.  Array payloads
  cross the wire with zero pickle framing and zero base64 expansion.
* The **delta helpers** (:func:`flatten_tree`, :func:`leaf_equal`,
  :func:`apply_delta`): path-addressed leaf flattening used by the
  registry to stamp per-leaf versions and by clients to splice a
  changed-leaves delta into their cached full payload.

Decoding is adversarial-input territory (anonymous browsers connect to
the distributor), so every validation failure raises
:class:`ProtocolError` with a documented code and decoding never
allocates based on unchecked size fields: array extents are checked
against the actual buffer length before any array is materialized.
"""
from __future__ import annotations

import base64
import dataclasses
import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

try:  # registers the "bfloat16" (etc.) dtype names with numpy
    import ml_dtypes  # noqa: F401
except ImportError:  # pragma: no cover - present wherever jax is
    ml_dtypes = None

__all__ = [
    "ProtocolError", "DeltaApplyError",
    "encode_binary", "decode_binary",
    "flatten_tree", "leaf_equal", "apply_delta",
    "TRACE_CONTEXT_FIELDS", "make_trace_context", "parse_trace_context",
    "MAX_RETRY_AFTER_S", "parse_retry_after",
    "MAX_TELEMETRY_SPANS", "MAX_TELEMETRY_SERIES",
    "make_telemetry", "parse_telemetry",
    "make_clock_echo", "parse_clock_echo",
]

#: The optional ``trace`` object carried by ``lease_grant`` and ``submit``
#: frames (protocol v2, emitted only when the sender has a tracer; spec in
#: docs/PROTOCOL.md §Trace context).  Field -> accepted wire types.  v1
#: peers never see the field; tolerant parsers on both sides ignore it.
TRACE_CONTEXT_FIELDS: Dict[str, tuple] = {
    "lease": (int,),          # lease id the context rides on
    "client": (str,),         # client name (echoed on submit)
    "round": (int, str),      # training-round tag, when a trainer set one
    "exec_s": (int, float),   # client-measured execute time (submit echo)
}


def make_trace_context(**fields) -> Dict[str, Any]:
    """Build a wire ``trace`` object from the known fields (None values
    are dropped).  Unknown field names are a programming error and raise —
    the *parser* is the tolerant side, not the builder."""
    out: Dict[str, Any] = {}
    for k, v in fields.items():
        if k not in TRACE_CONTEXT_FIELDS:
            raise ValueError(f"unknown trace-context field {k!r}")
        if v is None:
            continue
        out[k] = v
    return out


def parse_trace_context(obj: Any) -> Optional[Dict[str, Any]]:
    """Tolerantly parse a peer's ``trace`` object: returns the recognised,
    correctly-typed fields, or None when ``obj`` is absent or not an
    object.  Never raises — trace context is observability metadata from
    an untrusted peer and must not be able to poison a connection (the
    fuzz tests drive junk through here)."""
    if not isinstance(obj, dict):
        return None
    out: Dict[str, Any] = {}
    for k, types in TRACE_CONTEXT_FIELDS.items():
        v = obj.get(k)
        if isinstance(v, types) and not isinstance(v, bool):
            out[k] = v
    return out


#: Ceiling on the ``retry_after`` hint a peer may impose via a ``busy``
#: refusal — an adversarial (or buggy) server must not be able to park a
#: client for an hour with one frame.
MAX_RETRY_AFTER_S = 60.0


def parse_retry_after(value: Any, default: float,
                      *, cap: float = MAX_RETRY_AFTER_S) -> float:
    """Tolerantly parse a ``busy`` refusal's ``retry_after`` hint (seconds).

    Same adversarial-input posture as :func:`parse_trace_context`: the
    hint comes from an untrusted peer, so anything that is not a finite
    non-negative real — missing, a bool, a string, NaN, negative —
    falls back to ``default``, and a sane value is clamped to ``cap``.
    Never raises."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return default
    v = float(value)
    if v != v or v < 0.0:                  # NaN or negative
        return default
    return min(v, cap)


# -- telemetry batches (protocol v2, docs/PROTOCOL.md §telemetry) ----------

#: ceilings on what a single ``telemetry`` frame may carry — an
#: adversarial client must not be able to make the server buffer an
#: unbounded span list or metric registry.  Excess entries are dropped
#: (and counted), never an error.
MAX_TELEMETRY_SPANS = 512
MAX_TELEMETRY_SERIES = 256

_SPAN_PHASES = ("X", "b", "e", "i")
_METRIC_KINDS = ("counter", "gauge", "histogram")


def _finite_num(v: Any) -> bool:
    return (isinstance(v, (int, float)) and not isinstance(v, bool)
            and v == v and v not in (float("inf"), float("-inf")))


def make_telemetry(metrics: Optional[dict], spans: Optional[List[dict]],
                   *, dropped: int = 0) -> Dict[str, Any]:
    """Build the ``telemetry`` payload object: a client's local
    ``MetricsRegistry.snapshot()`` plus a batch of drained tracer events
    (the decoded dict schema of ``Tracer.events()``), and the client's
    own cumulative drop count (ring-buffer evictions + flush drops).
    Builder side is strict by convention but has nothing to validate
    beyond shape — the *parser* is the tolerant side."""
    out: Dict[str, Any] = {"dropped": int(dropped)}
    if metrics:
        out["metrics"] = metrics
    if spans:
        out["spans"] = list(spans)
    return out


def parse_telemetry(obj: Any, *, max_spans: int = MAX_TELEMETRY_SPANS,
                    max_series: int = MAX_TELEMETRY_SERIES
                    ) -> Optional[Dict[str, Any]]:
    """Tolerantly parse a peer's ``telemetry`` payload.

    Returns ``{"metrics", "spans", "dropped", "local_drops"}`` where
    ``metrics`` holds only well-formed series (str name -> dict body
    with a known ``kind`` and a list of ``values``), ``spans`` only
    well-formed trace events (str name/track/cat, known ``ph``, finite
    ``ts``; ``dur``/``id``/``args`` sanitized), ``dropped`` is the
    peer's self-reported drop count, and ``local_drops`` counts every
    entry *this* parser discarded (malformed or over the caps).
    Returns None when ``obj`` is not an object at all.  Never raises —
    telemetry is observability metadata from an untrusted peer and a
    garbage batch must cost the sender its data, not the server its
    connection (the fuzz tests drive junk through here)."""
    if not isinstance(obj, dict):
        return None
    local_drops = 0

    metrics: Dict[str, Any] = {}
    raw_metrics = obj.get("metrics")
    if isinstance(raw_metrics, dict):
        for name in sorted(raw_metrics, key=str):
            body = raw_metrics[name]
            if (not isinstance(name, str) or not isinstance(body, dict)
                    or body.get("kind") not in _METRIC_KINDS
                    or not isinstance(body.get("values"), list)):
                local_drops += 1
                continue
            if len(metrics) >= max_series:
                local_drops += 1
                continue
            metrics[name] = {"kind": body["kind"],
                             "help": body.get("help", "")
                             if isinstance(body.get("help"), str) else "",
                             "values": body["values"]}
    elif raw_metrics is not None:
        local_drops += 1

    spans: List[Dict[str, Any]] = []
    raw_spans = obj.get("spans")
    if isinstance(raw_spans, list):
        for ev in raw_spans:
            if (not isinstance(ev, dict)
                    or not isinstance(ev.get("name"), str)
                    or not isinstance(ev.get("track"), str)
                    or ev.get("ph") not in _SPAN_PHASES
                    or not _finite_num(ev.get("ts"))):
                local_drops += 1
                continue
            if len(spans) >= max_spans:
                local_drops += 1
                continue
            clean: Dict[str, Any] = {
                "name": ev["name"], "ph": ev["ph"],
                "track": ev["track"],
                "cat": ev["cat"] if isinstance(ev.get("cat"), str)
                else "client",
                "ts": float(ev["ts"]),
            }
            if ev["ph"] == "X":
                dur = ev.get("dur")
                clean["dur"] = (float(dur)
                                if _finite_num(dur) and dur >= 0 else 0.0)
            elif ev["ph"] in ("b", "e"):
                sid = ev.get("id")
                if isinstance(sid, bool) or not isinstance(sid, int):
                    local_drops += 1
                    continue
                clean["id"] = sid
            if isinstance(ev.get("args"), dict):
                clean["args"] = ev["args"]
            spans.append(clean)
    elif raw_spans is not None:
        local_drops += 1

    dropped = obj.get("dropped")
    if not (isinstance(dropped, int) and not isinstance(dropped, bool)
            and dropped >= 0):
        dropped = 0
    return {"metrics": metrics, "spans": spans, "dropped": dropped,
            "local_drops": local_drops}


def make_clock_echo(t0: float, server_ts: float,
                    t1: float) -> Dict[str, float]:
    """Build the heartbeat ``echo`` object a client sends back after a
    ``heartbeat_ok`` carrying ``server_ts``: its own send time ``t0``,
    the server's stamp, and its receive time ``t1`` (all in the
    sender's respective clocks).  The server turns one echo into a
    clock-skew sample: ``offset = server_ts - (t0 + t1) / 2`` with
    uncertainty ``rtt = t1 - t0`` (NTP's symmetric-delay estimate)."""
    return {"t0": float(t0), "server_ts": float(server_ts),
            "t1": float(t1)}


def parse_clock_echo(obj: Any) -> Optional[Tuple[float, float, float]]:
    """Tolerantly parse a heartbeat ``echo`` object into
    ``(t0, server_ts, t1)``.  Returns None — never raises — unless all
    three fields are finite numbers with ``t1 >= t0`` (a negative RTT
    is necessarily garbage)."""
    if not isinstance(obj, dict):
        return None
    t0, sts, t1 = obj.get("t0"), obj.get("server_ts"), obj.get("t1")
    if not (_finite_num(t0) and _finite_num(sts) and _finite_num(t1)):
        return None
    if t1 < t0:
        return None
    return (float(t0), float(sts), float(t1))


#: hard ceiling on manifest array count (a manifest is decoded before its
#: buffer, so the count must be bounded independently of the data).
MAX_MANIFEST_ARRAYS = 1 << 16
#: hard ceiling on array rank accepted from the wire.
MAX_MANIFEST_NDIM = 32


class ProtocolError(Exception):
    """A wire-protocol violation.  ``code`` is a short machine-readable
    string from the table in docs/PROTOCOL.md; ``message`` is free text."""

    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message


class DeltaApplyError(Exception):
    """A delta payload does not fit the base tree it claims to patch.

    Raised by :func:`apply_delta`; clients treat it as a cache miss and
    refetch the full payload rather than failing the fetch."""


# --------------------------------------------------------------------------
# binary payload codec
# --------------------------------------------------------------------------


class _ArrayRef:
    """Placeholder left in the pickled skeleton where an array leaf was
    extracted; ``index`` points into the manifest's array table."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __reduce__(self):
        return (_ArrayRef, (self.index,))


def _is_array_leaf(x: Any) -> bool:
    """True for numpy/jax array objects (not scalars, not lists)."""
    if isinstance(x, np.ndarray):
        return True
    if isinstance(x, np.generic):  # 0-d numpy scalar: pickle round-trips type
        return False
    return (hasattr(x, "__array__") and hasattr(x, "dtype")
            and hasattr(x, "shape") and hasattr(x, "ndim"))


def encode_binary(obj: Any) -> Tuple[Dict[str, Any], bytes]:
    """Split ``obj`` into a JSON-safe manifest and a raw byte buffer.

    Array leaves (numpy or jax, any dtype including bfloat16) are pulled
    out into ``buffer`` back-to-back in C order; everything else is
    pickled with :class:`_ArrayRef` placeholders and carried base64 in
    ``manifest["rest"]``.  ``decode_binary(manifest, buffer)`` inverts
    this bit-exactly."""
    arrays: List[np.ndarray] = []

    def extract(x):
        if _is_array_leaf(x):
            a = np.asarray(x)
            # ascontiguousarray alone would promote 0-d to (1,)
            arrays.append(np.ascontiguousarray(a).reshape(a.shape))
            return _ArrayRef(len(arrays) - 1)
        if isinstance(x, dict):
            return {k: extract(v) for k, v in x.items()}
        if isinstance(x, list):
            return [extract(v) for v in x]
        if isinstance(x, tuple):
            return tuple(extract(v) for v in x)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            try:
                fields = {f.name: extract(getattr(x, f.name))
                          for f in dataclasses.fields(x) if f.init}
                return dataclasses.replace(x, **fields)
            except TypeError:
                return x  # exotic dataclass: fall back to whole-object pickle
        return x

    skeleton = extract(obj)
    manifest = {
        "arrays": [{"dtype": a.dtype.name, "shape": list(a.shape),
                    "nbytes": int(a.nbytes)} for a in arrays],
        "rest": base64.b64encode(
            pickle.dumps(skeleton, protocol=pickle.HIGHEST_PROTOCOL)
        ).decode("ascii"),
    }
    return manifest, b"".join(a.tobytes() for a in arrays)


def _resolve_dtype(name: Any) -> np.dtype:
    if not isinstance(name, str):
        raise ProtocolError("bad-manifest", f"dtype must be a string, "
                            f"got {type(name).__name__}")
    try:
        dt = np.dtype(name)
    except TypeError:
        dt = None
    if dt is None and ml_dtypes is not None:
        scalar = getattr(ml_dtypes, name, None)
        if scalar is not None:
            try:
                dt = np.dtype(scalar)
            except TypeError:
                dt = None
    if dt is None:
        raise ProtocolError("bad-manifest", f"unknown dtype {name!r}")
    if dt.hasobject:
        raise ProtocolError("bad-manifest",
                            f"object dtype {name!r} not allowed on the wire")
    return dt


def decode_binary(manifest: Any, buffer: bytes) -> Any:
    """Inverse of :func:`encode_binary`; validates everything.

    Every malformed-manifest condition (wrong types, unknown or object
    dtype, shape/nbytes mismatch, extents past the end of ``buffer``,
    dangling array references, un-unpicklable skeleton) raises
    ``ProtocolError("bad-manifest")``.  No array is allocated before its
    extent has been checked against ``len(buffer)``."""
    if not isinstance(manifest, dict):
        raise ProtocolError("bad-manifest", "manifest must be an object")
    entries = manifest.get("arrays")
    rest = manifest.get("rest")
    if not isinstance(entries, list) or not isinstance(rest, str):
        raise ProtocolError("bad-manifest",
                            "manifest needs 'arrays' list and 'rest' string")
    if len(entries) > MAX_MANIFEST_ARRAYS:
        raise ProtocolError("bad-manifest",
                            f"{len(entries)} arrays exceeds cap "
                            f"{MAX_MANIFEST_ARRAYS}")
    arrays: List[np.ndarray] = []
    offset = 0
    for i, entry in enumerate(entries):
        if not isinstance(entry, dict):
            raise ProtocolError("bad-manifest", f"array {i}: not an object")
        dt = _resolve_dtype(entry.get("dtype"))
        shape = entry.get("shape")
        nbytes = entry.get("nbytes")
        if (not isinstance(shape, list) or len(shape) > MAX_MANIFEST_NDIM
                or not all(isinstance(s, int) and not isinstance(s, bool)
                           and s >= 0 for s in shape)):
            raise ProtocolError("bad-manifest", f"array {i}: bad shape "
                                f"{shape!r}")
        count = 1
        for s in shape:
            count *= s
        if (not isinstance(nbytes, int) or isinstance(nbytes, bool)
                or nbytes != count * dt.itemsize):
            raise ProtocolError("bad-manifest",
                                f"array {i}: nbytes {nbytes!r} != "
                                f"prod(shape)*itemsize "
                                f"({count * dt.itemsize})")
        if offset + nbytes > len(buffer):
            raise ProtocolError("bad-manifest",
                                f"array {i}: extent [{offset}, "
                                f"{offset + nbytes}) past end of "
                                f"{len(buffer)}-byte buffer")
        arr = np.frombuffer(buffer, dtype=dt, count=count,
                            offset=offset).reshape(tuple(shape)).copy()
        arrays.append(arr)
        offset += nbytes
    if offset != len(buffer):
        raise ProtocolError("bad-manifest",
                            f"{len(buffer) - offset} trailing bytes after "
                            f"last declared array")
    try:
        skeleton = pickle.loads(base64.b64decode(rest, validate=True))
    except Exception as exc:
        raise ProtocolError("bad-manifest",
                            f"skeleton does not unpickle: {exc}") from None

    def restore(x):
        if isinstance(x, _ArrayRef):
            if not (0 <= x.index < len(arrays)):
                raise ProtocolError("bad-manifest",
                                    f"dangling array ref {x.index}")
            return arrays[x.index]
        if isinstance(x, dict):
            return {k: restore(v) for k, v in x.items()}
        if isinstance(x, list):
            return [restore(v) for v in x]
        if isinstance(x, tuple):
            return tuple(restore(v) for v in x)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            try:
                fields = {f.name: restore(getattr(x, f.name))
                          for f in dataclasses.fields(x) if f.init}
                return dataclasses.replace(x, **fields)
            except TypeError:
                return x
        return x

    return restore(skeleton)


# --------------------------------------------------------------------------
# delta helpers: path-addressed leaf flattening
# --------------------------------------------------------------------------
#
# Paths are tuples of (tag, key) steps so they survive pickling inside a
# delta payload and never collide the way "/"-joined strings can:
#   (0, key)   dict entry
#   (1, i)     list element
#   (2, i)     tuple element
#   (3, name)  dataclass field

_DICT, _LIST, _TUPLE, _FIELD = 0, 1, 2, 3


def flatten_tree(tree: Any) -> Dict[tuple, Any]:
    """Map each leaf of ``tree`` to its path.  Containers (dict, list,
    tuple, dataclass) are traversed; everything else — arrays included —
    is a leaf.  Leaves are the *same objects* as in ``tree`` (no copy)."""
    out: Dict[tuple, Any] = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, path + ((_DICT, k),))
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, path + ((_LIST, i),))
        elif isinstance(x, tuple):
            for i, v in enumerate(x):
                walk(v, path + ((_TUPLE, i),))
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), path + ((_FIELD, f.name),))
        else:
            out[path] = x

    walk(tree, ())
    return out


def leaf_equal(a: Any, b: Any) -> bool:
    """Bit-exact leaf equality: arrays compare dtype + shape + raw bytes,
    scalars compare type *and* value (so ``1`` != ``1.0`` — a delta that
    skips a leaf must leave the client holding the identical object)."""
    a_is_arr = _is_array_leaf(a)
    if a_is_arr != _is_array_leaf(b):
        return False
    if a_is_arr:
        aa, bb = np.asarray(a), np.asarray(b)
        if aa.dtype != bb.dtype or aa.shape != bb.shape:
            return False
        try:  # byte view: bit-exact (NaN == NaN) without a tobytes() copy
            return bool(np.array_equal(aa.view(np.uint8),
                                       bb.view(np.uint8)))
        except (ValueError, TypeError):  # non-contiguous / 0-d views
            return aa.tobytes() == bb.tobytes()
    if type(a) is not type(b):
        return False
    try:
        return bool(a == b)
    except Exception:
        return False


def apply_delta(base: Any, changed: Dict[tuple, Any]) -> Any:
    """Return a copy of ``base`` with each ``path -> leaf`` spliced in.

    Copy-on-write: only containers on a changed path are rebuilt;
    untouched subtrees are shared with ``base``.  Raises
    :class:`DeltaApplyError` if a path does not exist in ``base`` with
    the expected container types (the registry never serves a delta
    across a structure change, so this only fires on corrupt input)."""
    for path, leaf in changed.items():
        base = _set_path(base, path, leaf)
    return base


def _set_path(node: Any, path: tuple, leaf: Any) -> Any:
    if not path:
        return leaf
    (tag, key), rest = path[0], path[1:]
    if tag == _DICT and isinstance(node, dict):
        if key not in node:
            raise DeltaApplyError(f"missing dict key {key!r}")
        out = dict(node)
        out[key] = _set_path(node[key], rest, leaf)
        return out
    if tag == _LIST and isinstance(node, list):
        if not (isinstance(key, int) and 0 <= key < len(node)):
            raise DeltaApplyError(f"list index {key!r} out of range")
        out = list(node)
        out[key] = _set_path(node[key], rest, leaf)
        return out
    if tag == _TUPLE and isinstance(node, tuple):
        if not (isinstance(key, int) and 0 <= key < len(node)):
            raise DeltaApplyError(f"tuple index {key!r} out of range")
        items = list(node)
        items[key] = _set_path(node[key], rest, leaf)
        return tuple(items)
    if tag == _FIELD and dataclasses.is_dataclass(node) \
            and not isinstance(node, type):
        names = {f.name for f in dataclasses.fields(node) if f.init}
        if key not in names:
            raise DeltaApplyError(f"missing dataclass field {key!r}")
        try:
            return dataclasses.replace(
                node, **{key: _set_path(getattr(node, key), rest, leaf)})
        except TypeError as exc:
            raise DeltaApplyError(f"cannot replace field {key!r}: {exc}")
    raise DeltaApplyError(
        f"path step ({tag}, {key!r}) does not match node "
        f"{type(node).__name__}")
