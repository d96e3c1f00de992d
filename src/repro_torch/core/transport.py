"""Cross-host transport: the federation's wire protocol over asyncio streams.

The paper's premise is that nodes join "only by accessing a website" —
distribution happens over HTTP/WebSocket, never over in-process method
calls.  Until this module, our federation (``core/federation.py``) still
communicated by direct object references inside one event loop.  Here the
client ⇄ distributor surface becomes a real **message protocol**:

  * **Framing** — length-prefixed JSON: a 4-byte big-endian length header
    followed by one UTF-8 JSON object.  Opaque payloads (task code, static
    assets, ticket args, results) travel as base64 fields inside the JSON
    envelope — this reproduction pickles them, where the paper ships
    JavaScript source; the envelope is identical either way.
  * **Protocol v2** (negotiated in ``hello`` via ``max_proto``; v1 peers
    keep the JSON-only wire unchanged) adds **binary chunk frames**: a
    header frame may announce ``chunks``/``blob_bytes``, followed by that
    many raw-byte frames (length prefix with the top bit set).  Static
    payloads then ride the :mod:`repro.core.wire` binary codec — raw
    array buffers with a compact dtype/shape manifest, zero pickle and
    zero base64 for array data, streamed in bounded chunks so a large
    weight blob never materializes as one frame.  Conditional static
    fetches may ask for a **delta** (``"delta": true``): the registry's
    per-leaf version stamps let it ship only the leaves that changed
    since the client's cached version (full payload past the
    ``DELTA_HISTORY`` staleness horizon), and the client splices them in
    via the same ``merge_versioned_fetch`` helper the in-process path
    uses.
  * **Messages** — ``hello`` answered by ``hello_ok`` or a ``busy``
    refusal (admission control), ``lease_request``/``lease_grant``,
    ``submit``/``submit_ok``, ``release``/``release_ok``,
    ``fetch_task``/``fetch_static`` answered by ``task_data``/
    ``static_data``/``not_modified``, ``heartbeat``/``heartbeat_ok``
    (liveness while holding a lease), ``error_report``/
    ``error_report_ok``, server-pushed ``invalidate``, and ``error``.
    The full spec with frame layout, JSON examples, and the reconnect
    state machine is **docs/PROTOCOL.md** — keep the two in sync.
  * **Browser-scale churn machinery** (see docs/PROTOCOL.md §Admission
    control and §Heartbeat and eviction): the server may cap accepted
    connections per endpoint (``max_conns_per_member``) and refuse the
    overflow at ``hello`` with ``busy`` + a ``retry_after`` hint; a
    connection holding leases that goes silent past
    ``heartbeat_timeout`` is **evicted** — its leases are force-released
    immediately instead of waiting out the watchdog's ``grace x ETA``
    deadline, so 10^4-client fleets with tab-close churn redistribute
    stranded work in one heartbeat interval.
  * :class:`TransportServer` — wraps an ``AsyncDistributor`` or
    ``FederatedDistributor`` behind a loopback (or any TCP) socket.  Each
    connection is bound at ``hello`` time to one endpoint
    (``transport_endpoints()``: the distributor itself, or the
    least-connected alive federation member), so remote clients get the
    same home-shard/steal lease path and edge-cached asset serving as
    in-process clients.  Registry invalidations are pushed to every
    connection as ``invalidate`` frames.
  * :class:`RemoteBrowserClient` — a browser node that speaks ONLY the
    wire protocol: it holds no reference to any distributor object, just a
    host/port.  It keeps the version-aware LRU cache and conditional-fetch
    (ETag analogue) behaviour of the in-process clients, so PR 3's cache
    coherence survives the serialization boundary, and it
    **reconnects with resume**: a dropped connection re-dials, re-submits
    any finished-but-unsubmitted results (duplicates are dropped
    server-side, first result wins), and re-leases — tickets stranded in
    its dead lease come back through the existing watchdog path.

``benchmarks/transport_overhead.py`` measures serialized vs in-process
round throughput and re-runs the PR 3 re-register storm over the wire;
``examples/sashimi_browser_sim.py --transport`` is the runnable demo.
"""
from __future__ import annotations

import asyncio
import base64
import collections
import itertools
import json
import pickle
import random
import struct
import time
import traceback
from typing import Any, Callable, Optional

from repro_torch.core.distributor import (BrowserNodeBase, ClientProfile, Fetched,
                                    TaskDef, merge_unconditional_fetch,
                                    merge_versioned_fetch)
from repro_torch.core.tickets import LeaseBatch
# ProtocolError lives in the leaf module repro.core.wire (the registry's
# codecs raise it too); re-exported here where it historically lived.
from repro_torch.core.wire import (ProtocolError, decode_binary, encode_binary,
                             make_clock_echo, make_telemetry,
                             make_trace_context, parse_clock_echo,
                             parse_retry_after, parse_telemetry,
                             parse_trace_context)

#: Highest protocol version this build speaks.  ``hello`` negotiates: the
#: client sends ``proto`` (its floor, 1 for compatibility) and
#: ``max_proto``; the server answers with the highest version both sides
#: support.  A ``proto`` outside the server's supported range is refused
#: with an ``error`` frame (code ``proto-mismatch``).
PROTOCOL_VERSION = 2

#: Lowest protocol version still served (v1 = JSON-only wire).
MIN_PROTOCOL_VERSION = 1

#: Default ceiling on one frame's body (JSON or binary chunk).  A header
#: announcing more is rejected (code ``frame-too-large``) without
#: allocating the buffer.
MAX_FRAME_BYTES = 64 * 1024 * 1024

#: Top bit of the length prefix marks a **binary chunk frame** (raw
#: bytes, no JSON).  Frame bodies are capped far below 2^31, so the bit
#: is unambiguous.
CHUNK_FLAG = 0x80000000

#: Default ceiling on one chunked message's total binary payload
#: (checked against the header's ``blob_bytes`` BEFORE any chunk is
#: read, code ``blob-too-large``).
MAX_BLOB_BYTES = 1 << 30

#: Ceiling on the chunk count one header may announce.
MAX_BLOB_CHUNKS = 1 << 16

#: Default size a sender slices binary payloads into — large statics
#: stream in bounded frames instead of materializing as one.
DEFAULT_CHUNK_BYTES = 1 << 20

_HEADER = struct.Struct(">I")


# ---------------------------------------------------------------------------
# Framing + payload codec
# ---------------------------------------------------------------------------


def encode_frame(msg: dict) -> bytes:
    """Serialise one message: 4-byte big-endian body length + UTF-8 JSON."""
    body = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME_BYTES:
        raise ProtocolError("frame-too-large",
                            f"frame body is {len(body)} bytes "
                            f"(max {MAX_FRAME_BYTES})")
    return _HEADER.pack(len(body)) + body


def encode_chunk(part: bytes) -> bytes:
    """Serialise one binary chunk frame: length prefix with the top bit
    set, then the raw bytes (protocol v2)."""
    if len(part) > MAX_FRAME_BYTES:
        raise ProtocolError("frame-too-large",
                            f"chunk is {len(part)} bytes "
                            f"(max {MAX_FRAME_BYTES})")
    return _HEADER.pack(CHUNK_FLAG | len(part)) + part


def build_blob_frames(msg: dict, buffer: bytes, *,
                      chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                      max_frame_bytes: int = MAX_FRAME_BYTES) -> list[bytes]:
    """Frames for one logical message with a binary payload: the JSON
    header (annotated with ``chunks``/``blob_bytes``) followed by the
    payload sliced into chunk frames of ``chunk_bytes``.  An empty buffer
    yields just the plain header frame.  The sender must write the list
    contiguously (no interleaved pushes) — both sides here do so under
    their write lock / sequential request loop."""
    if not buffer:
        return [encode_frame(msg)]
    size = max(1, min(chunk_bytes, max_frame_bytes))
    n_chunks = -(-len(buffer) // size)
    if n_chunks > MAX_BLOB_CHUNKS:             # huge blob: fewer, larger
        size = -(-len(buffer) // MAX_BLOB_CHUNKS)
        n_chunks = -(-len(buffer) // size)
    frames = [encode_frame({**msg, "chunks": n_chunks,
                            "blob_bytes": len(buffer)})]
    for i in range(0, len(buffer), size):
        frames.append(encode_chunk(buffer[i:i + size]))
    return frames


async def read_frame_ex(reader: asyncio.StreamReader, *,
                        max_bytes: int = MAX_FRAME_BYTES,
                        allow_chunk: bool = False
                        ) -> tuple[Any, int]:
    """Read one frame; returns ``(message, wire_bytes)``.

    ``(None, 0)`` means clean EOF at a frame boundary (peer closed).  A
    JSON frame decodes to a dict; a binary chunk frame (v2, top length
    bit set) returns raw ``bytes`` — but only where the caller expects
    one (``allow_chunk=True``, i.e. inside a chunked message), otherwise
    it is a protocol error (code ``unexpected-chunk``).  Raises
    :class:`ProtocolError` for a truncated frame (EOF mid-frame), an
    oversized length header, a non-JSON body, or a body that is not an
    object with a string ``type`` — the reader never hangs on garbage,
    and never allocates more than ``max_bytes``."""
    try:
        header = await reader.readexactly(_HEADER.size)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None, 0
        raise ProtocolError("truncated-frame", "EOF inside frame header")
    (raw,) = _HEADER.unpack(header)
    is_chunk = bool(raw & CHUNK_FLAG)
    length = raw & (CHUNK_FLAG - 1)
    if length > max_bytes:
        raise ProtocolError("frame-too-large",
                            f"frame announces {length} bytes "
                            f"(max {max_bytes})")
    try:
        body = await reader.readexactly(length)
    except asyncio.IncompleteReadError:
        raise ProtocolError("truncated-frame", "EOF inside frame body")
    if is_chunk:
        if not allow_chunk:
            raise ProtocolError("unexpected-chunk",
                                "binary chunk frame outside a chunked "
                                "message")
        return bytes(body), _HEADER.size + length
    try:
        msg = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        raise ProtocolError("bad-json", "frame body is not valid JSON")
    if not isinstance(msg, dict) or not isinstance(msg.get("type"), str):
        raise ProtocolError(
            "bad-message", "frame must be an object with a string 'type'")
    return msg, _HEADER.size + length


async def read_frame(reader: asyncio.StreamReader, *,
                     max_bytes: int = MAX_FRAME_BYTES) -> Optional[dict]:
    """:func:`read_frame_ex` without the byte count (JSON frames only)."""
    msg, _ = await read_frame_ex(reader, max_bytes=max_bytes)
    return msg


async def read_message(reader: asyncio.StreamReader, *,
                       max_bytes: int = MAX_FRAME_BYTES,
                       max_blob_bytes: int = MAX_BLOB_BYTES,
                       allow_chunks: bool = True
                       ) -> tuple[Optional[dict], int]:
    """Read one **logical** message: a JSON frame, plus — when its header
    announces ``chunks``/``blob_bytes`` (protocol v2) — exactly that many
    binary chunk frames, reassembled into ``msg["_blob"]``.

    The chunk state machine is strict (docs/PROTOCOL.md §Chunked
    messages): the declared total is validated against ``max_blob_bytes``
    *before* the first chunk is read (code ``blob-too-large``), chunk
    count and sizes must match the declaration exactly (code
    ``bad-blob``), a JSON frame where a chunk is due is
    ``chunk-mismatch``, and EOF mid-blob is ``truncated-frame``.  Memory
    is bounded by ``max_blob_bytes`` + one frame."""
    msg, n = await read_frame_ex(reader, max_bytes=max_bytes)
    if msg is None or ("chunks" not in msg and "blob_bytes" not in msg):
        return msg, n
    if not allow_chunks:
        raise ProtocolError("bad-blob",
                            "chunked message on a v1 connection")
    n_chunks = msg.get("chunks")
    total = msg.get("blob_bytes")
    if (not isinstance(n_chunks, int) or isinstance(n_chunks, bool)
            or not isinstance(total, int) or isinstance(total, bool)
            or n_chunks < 1 or n_chunks > MAX_BLOB_CHUNKS or total < 0):
        raise ProtocolError("bad-blob",
                            f"bad chunk declaration: chunks={n_chunks!r} "
                            f"blob_bytes={total!r}")
    if total > max_blob_bytes:
        raise ProtocolError("blob-too-large",
                            f"blob announces {total} bytes "
                            f"(max {max_blob_bytes})")
    parts: list[bytes] = []
    received = 0
    for _ in range(n_chunks):
        chunk, cn = await read_frame_ex(reader, max_bytes=max_bytes,
                                        allow_chunk=True)
        if chunk is None:
            raise ProtocolError("truncated-frame",
                                "EOF inside a chunked message")
        if not isinstance(chunk, bytes):
            raise ProtocolError("chunk-mismatch",
                                "JSON frame arrived where a binary chunk "
                                "was expected")
        received += len(chunk)
        n += cn
        if received > total:
            raise ProtocolError("bad-blob",
                                f"chunks carry more than the declared "
                                f"{total} bytes")
        parts.append(chunk)
    if received != total:
        raise ProtocolError("bad-blob",
                            f"chunks carry {received} bytes, header "
                            f"declared {total}")
    out = dict(msg)
    out["_blob"] = b"".join(parts)
    return out, n


def encode_payload(obj: Any) -> str:
    """Opaque payload codec: pickle + base64.  This reproduction's stand-in
    for the paper's JavaScript-source payloads — the JSON envelope treats
    it as an uninterpreted string either way."""
    return base64.b64encode(pickle.dumps(obj)).decode("ascii")


def decode_payload(s: str) -> Any:
    """Inverse of :func:`encode_payload`."""
    return pickle.loads(base64.b64decode(s.encode("ascii")))


def _fetch_reply(kind: str, seq, got: Fetched) -> dict:
    """Wire reply for a versioned fetch: ``not_modified`` is metadata only,
    otherwise the payload rides in a ``task_data``/``static_data`` frame
    (v1 JSON form: pickled-base64 ``payload``)."""
    if got.not_modified:
        return {"type": "not_modified", "seq": seq, "version": got.version}
    return {"type": kind, "seq": seq, **got.to_wire(encode_payload)}


def _fetch_reply_bin(kind: str, seq, got: Fetched) -> tuple[dict, bytes]:
    """Protocol v2 wire reply for a versioned fetch with a payload: the
    JSON header plus the binary buffer (``encoding: "bin"``); array data
    travels raw, described by the ``manifest``.  A delta reply (changed
    leaves only) additionally carries ``delta_base``."""
    manifest, buffer = encode_binary(got.value)
    header = {"type": kind, "seq": seq, "version": got.version,
              "not_modified": False, "current": got.current,
              "encoding": "bin", "manifest": manifest}
    if got.delta_base is not None:
        header["delta_base"] = got.delta_base
    return header, buffer


def _decode_fetch(reply: dict) -> Fetched:
    """Client-side inverse of :func:`_fetch_reply` /
    :func:`_fetch_reply_bin` (the binary buffer rides in
    ``reply["_blob"]``, attached by :func:`read_message`)."""
    if reply["type"] == "not_modified":
        return Fetched(None, reply["version"], not_modified=True)
    if reply.get("encoding") == "bin":
        value = decode_binary(reply.get("manifest"),
                              reply.get("_blob", b""))
        return Fetched(value, reply["version"],
                       current=reply.get("current", True),
                       delta_base=reply.get("delta_base"))
    return Fetched.from_wire(reply, decode_payload)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class _Connection:
    """Server-side per-connection state: the endpoint the client is bound
    to, its open leases, and a write lock so request replies and pushed
    ``invalidate`` frames never interleave mid-frame."""

    def __init__(self, server: "TransportServer",
                 reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.server = server
        self.reader = reader
        self.writer = writer
        self.endpoint = None               # bound at hello time
        self.client = "?"
        self.leases: dict[int, LeaseBatch] = {}
        self.ready = False                 # hello completed
        self.proto = MIN_PROTOCOL_VERSION  # negotiated at hello time
        # liveness mark on the server's (injectable) wall clock: stamped
        # at hello and refreshed by EVERY inbound frame — a heartbeat is
        # just the cheapest frame a busy client can send
        self.last_seen = server._clock()
        self.evicted = False               # eviction happened exactly once
        self._wlock = asyncio.Lock()

    async def send(self, msg: dict):
        """Write one frame under the connection's write lock."""
        frame = encode_frame(msg)
        async with self._wlock:
            self.writer.write(frame)
            await self.writer.drain()
        self.server.frames_out += 1
        self.server.bytes_out += len(frame)
        self.server._count_out(msg.get("type", "?"), 1, len(frame))

    async def send_blob(self, msg: dict, buffer: bytes):
        """Write one chunked message (header + binary chunk frames) under
        the write lock, so a pushed ``invalidate`` can never interleave
        mid-blob."""
        frames = build_blob_frames(msg, buffer,
                                   chunk_bytes=self.server.chunk_bytes,
                                   max_frame_bytes=self.server
                                   .max_frame_bytes)
        async with self._wlock:
            for frame in frames:
                self.writer.write(frame)
            await self.writer.drain()
        self.server.frames_out += len(frames)
        self.server.chunks_out += len(frames) - 1
        self.server.bytes_out += sum(len(f) for f in frames)
        self.server._count_out(msg.get("type", "?"), len(frames),
                               sum(len(f) for f in frames))

    async def send_error(self, seq, err: ProtocolError):
        """Best-effort ``error`` frame (swallowed if the peer is gone)."""
        try:
            await self.send({"type": "error", "seq": seq,
                             "code": err.code, "message": err.message})
        except (ConnectionError, RuntimeError):
            pass                           # peer already gone

    def close(self):
        """Drop the underlying transport (idempotent)."""
        try:
            self.writer.close()
        except RuntimeError:
            pass


class TransportServer:
    """Serve a distributor's client surface over length-prefixed JSON.

    Wraps an ``AsyncDistributor`` **or** a ``FederatedDistributor``: each
    incoming connection is bound to one of ``transport_endpoints()`` (the
    least-connected alive member in a federation) for its lifetime, and
    every request on it — leases, submits, releases, versioned fetches —
    goes through that endpoint exactly as an in-process client's calls
    would.  Registry invalidations are fanned out to every live connection
    as ``invalidate`` pushes.

    Lifecycle: ``await start()`` binds the socket (default loopback,
    ephemeral port — ``address`` holds the result) and arms the
    endpoints' watchdogs; ``await stop()`` closes every connection.

    **Admission control** (``max_conns_per_member``): with the cap set,
    a ``hello`` that would push every endpoint past its cap is refused
    with a ``busy`` frame carrying a ``retry_after`` hint, and the
    connection is closed — backpressure happens at the door, before the
    connection consumes a handler task or a lease.  Unset (the default),
    admission is unlimited, as before.

    **Heartbeat/eviction** (``heartbeat_timeout``): with the timeout
    set, a sweeper evicts any connection that holds open leases but has
    been silent (no frame of any kind) longer than the timeout — its
    leases are force-released (``client_failed=True``) *immediately*,
    instead of waiting out the watchdog's ``grace x ETA`` deadline, and
    the socket is closed.  Clients signal liveness mid-execution with
    ``heartbeat`` frames.  Idle connections (no open leases — e.g.
    parked in ``lease_request``) are never evicted: they hold no work,
    and a parked request cannot frame heartbeats anyway.  Unset (the
    default), dead connections fall back to the watchdog path alone,
    exactly the pre-eviction behaviour.
    """

    def __init__(self, distributor, *, host: str = "127.0.0.1",
                 port: int = 0, max_frame_bytes: int = MAX_FRAME_BYTES,
                 max_proto: int = PROTOCOL_VERSION,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 max_blob_bytes: int = MAX_BLOB_BYTES,
                 max_conns_per_member: Optional[int] = None,
                 retry_after: float = 0.5,
                 heartbeat_timeout: Optional[float] = None,
                 eviction_interval: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 tracer=None, fleet=None):
        self.distributor = distributor
        # default to the distributor's tracer, so wiring one tracer into
        # the fabric lights up the transport lanes with no extra plumbing
        self.tracer = (tracer if tracer is not None
                       else getattr(distributor, "tracer", None))
        #: optional repro.obs.FleetAggregator — the sink for clients'
        #: ``telemetry`` frames and heartbeat clock echoes.  Unset, the
        #: server drops telemetry (counted) and its heartbeat replies
        #: stay byte-identical to pre-fleet builds.
        self.fleet = fleet
        self._wire_spans: dict[int, int] = {}     # lease_id -> span id
        self.host = host
        self.port = port
        self.max_frame_bytes = max_frame_bytes
        #: highest protocol version this server negotiates; set to 1 to
        #: behave exactly like a pre-v2 (JSON-only) server
        self.max_proto = max_proto
        self.chunk_bytes = chunk_bytes
        self.max_blob_bytes = max_blob_bytes
        #: accepted-connection cap per endpoint (None = unlimited)
        self.max_conns_per_member = max_conns_per_member
        #: seconds hinted in a ``busy`` refusal's ``retry_after``
        self.retry_after = retry_after
        #: silence (on ``clock``) after which a lease-holding connection
        #: is evicted; None disables eviction entirely
        self.heartbeat_timeout = heartbeat_timeout
        # sweep cadence: a fraction of the timeout, so detection latency
        # is at most ~1.25x the timeout itself
        self.eviction_interval = (
            eviction_interval if eviction_interval is not None
            else (heartbeat_timeout / 4.0
                  if heartbeat_timeout is not None else 1.0))
        self._clock = clock                # liveness clock (injectable)
        self.address: Optional[tuple[str, int]] = None
        self.frames_in = 0
        self.frames_out = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.chunks_in = 0
        self.chunks_out = 0
        self.protocol_errors = 0
        self.busy_refusals = 0             # hellos refused at the door
        self.heartbeats = 0                # heartbeat frames answered
        self.evictions = 0                 # connections evicted
        self.evicted_leases = 0            # leases force-released by those
        self.telemetry_accepted = 0        # telemetry batches into fleet
        self.telemetry_dropped = 0         # telemetry batches discarded
        # per-message-type wire accounting (frames include chunk frames;
        # feeds the obs MetricsRegistry via repro.obs.collect)
        self.msg_frames_in: collections.Counter = collections.Counter()
        self.msg_frames_out: collections.Counter = collections.Counter()
        self.msg_bytes_in: collections.Counter = collections.Counter()
        self.msg_bytes_out: collections.Counter = collections.Counter()
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._conns: set[_Connection] = set()
        self._handler_tasks: set[asyncio.Task] = set()
        self._eviction_task: Optional[asyncio.Task] = None
        self._subscribed = False

    # -- lifecycle ------------------------------------------------------------

    async def start(self) -> tuple[str, int]:
        """Bind the listening socket; returns ``(host, port)``.  Arms the
        endpoint watchdogs and subscribes to the registry's invalidation
        feed (pushed to clients as ``invalidate`` frames)."""
        self._loop = asyncio.get_running_loop()
        for ep in self.distributor.transport_endpoints():
            ep.ensure_watchdog()
        if not self._subscribed and hasattr(self.distributor,
                                            "subscribe_invalidation"):
            self.distributor.subscribe_invalidation(self._on_invalidate)
            self._subscribed = True
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.address = self._server.sockets[0].getsockname()[:2]
        if (self.heartbeat_timeout is not None
                and self._eviction_task is None):
            self._eviction_task = self._loop.create_task(
                self._eviction_loop())
        return self.address

    async def stop(self):
        """Close the listener and every live connection, and wait for the
        per-connection handler tasks to unwind."""
        if self._eviction_task is not None:
            self._eviction_task.cancel()
            try:
                await self._eviction_task
            except asyncio.CancelledError:
                pass
            self._eviction_task = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for conn in list(self._conns):
            conn.close()
        tasks = list(self._handler_tasks)
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        self._conns.clear()
        self._handler_tasks.clear()
        if self.tracer is not None:
            # leases granted but never submitted back (client died, lease
            # watchdog-released): close their wire spans so a stopped
            # server always leaves a balanced trace
            for lid in list(self._wire_spans):
                self.tracer.end(self._wire_spans.pop(lid, None),
                                args={"status": "orphaned"})

    def drop_connections(self) -> int:
        """Hard-close every live connection WITHOUT stopping the listener —
        fault injection for reconnect tests (the wire analogue of
        ``kill_member``).  Open leases stay with the watchdog."""
        n = 0
        for conn in list(self._conns):
            conn.close()
            n += 1
        return n

    def drop_member_connections(self, index: int) -> int:
        """Hard-close every connection bound to federation member
        ``index`` — the transport half of ``kill_member``.  A remote
        client whose member dies would otherwise keep talking to a
        scheduler with no watchdog; dropping the connection makes it
        reconnect-with-resume, and ``_pick_endpoint`` (alive members only)
        lands it on a survivor.  Returns how many connections dropped."""
        n = 0
        for conn in list(self._conns):
            if getattr(conn.endpoint, "index", None) == index:
                conn.close()
                n += 1
        return n

    # -- heartbeat / eviction -------------------------------------------------

    async def _eviction_loop(self):
        """Sweep for lease-holding connections silent past the heartbeat
        timeout, forcing their leases back into circulation immediately.
        Runs only when ``heartbeat_timeout`` is set (armed by start())."""
        while True:
            await asyncio.sleep(self.eviction_interval)
            now = self._clock()
            for conn in list(self._conns):
                if (conn.ready and conn.leases and not conn.evicted
                        and now - conn.last_seen > self.heartbeat_timeout):
                    await self._evict(conn, reason="silent")

    async def _evict(self, conn: _Connection, *, reason: str) -> int:
        """Evict one connection: drain its lease bookkeeping FIRST (so a
        submit frame racing this eviction takes the late-submit path,
        where the queue's first-result-wins rule drops duplicates — a
        ticket can never double-complete), force-release every drained
        lease, close its wire spans, then close the socket.  Returns the
        number of leases force-released.  Idempotent per connection."""
        if conn.evicted:
            return 0
        conn.evicted = True
        self.evictions += 1
        batches = list(conn.leases.values())
        conn.leases.clear()
        released = 0
        for batch in batches:
            if self.tracer is not None:
                self.tracer.end(
                    self._wire_spans.pop(batch.lease_id, None),
                    ts=conn.endpoint.queue.clock(),
                    args={"status": "evicted", "reason": reason})
            released += await conn.endpoint.release_lease(
                batch, client_failed=True)
        self.evicted_leases += len(batches)
        if self.tracer is not None:
            self.tracer.instant(
                "transport.evict", track="wire", cat="wire",
                ts=conn.endpoint.queue.clock(),
                args={"client": conn.client, "reason": reason,
                      "leases": len(batches), "released": released})
        conn.close()
        return released

    async def evict_client(self, client: str, *,
                           reason: str = "forced") -> int:
        """Evict every ready connection announcing ``client`` in its
        hello — the server-side tab-close lever (chaos harness, admin
        tooling).  Unlike the silent-sweep path this also evicts
        connections holding no leases (they are just closed).  Returns
        the total leases force-released."""
        released = 0
        for conn in list(self._conns):
            if conn.ready and conn.client == client:
                released += await self._evict(conn, reason=reason)
        return released

    def _count_out(self, kind: str, frames: int, nbytes: int):
        self.msg_frames_out[kind] += frames
        self.msg_bytes_out[kind] += nbytes

    def _count_in(self, kind: str, frames: int, nbytes: int):
        self.msg_frames_in[kind] += frames
        self.msg_bytes_in[kind] += nbytes

    def stats(self) -> dict:
        """Console counters: live connections, wire traffic totals, and
        the per-message-type frame/byte breakdown."""
        return {"connections": len(self._conns),
                "frames_in": self.frames_in, "frames_out": self.frames_out,
                "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
                "chunks_in": self.chunks_in, "chunks_out": self.chunks_out,
                "protocol_errors": self.protocol_errors,
                "busy_refusals": self.busy_refusals,
                "heartbeats": self.heartbeats,
                "evictions": self.evictions,
                "evicted_leases": self.evicted_leases,
                "telemetry_accepted": self.telemetry_accepted,
                "telemetry_dropped": self.telemetry_dropped,
                "by_type": {
                    "frames_in": dict(self.msg_frames_in),
                    "frames_out": dict(self.msg_frames_out),
                    "bytes_in": dict(self.msg_bytes_in),
                    "bytes_out": dict(self.msg_bytes_out)}}

    # -- invalidation push ----------------------------------------------------

    def _on_invalidate(self, key: str, version: int):
        # sync registry callback (may fire from a non-loop thread); hop to
        # the server loop, where per-connection write locks serialise the
        # push against in-flight replies
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        loop.call_soon_threadsafe(self._broadcast_invalidate, key, version)

    def _broadcast_invalidate(self, key: str, version: int):
        msg = {"type": "invalidate", "key": key, "version": version}
        for conn in list(self._conns):
            if conn.ready:
                task = asyncio.ensure_future(conn.send(msg))
                task.add_done_callback(lambda t: t.exception())

    # -- connection handling --------------------------------------------------

    def _pick_endpoint(self, conns: set[_Connection]):
        """Least-connected alive endpoint (ties break toward the lowest
        member index), so remote clients spread across a federation the
        way ``spawn_clients`` spreads in-process ones."""
        endpoints = self.distributor.transport_endpoints()
        if not endpoints:
            raise ProtocolError("no-endpoint", "no alive endpoint to serve")
        load = collections.Counter(
            id(c.endpoint) for c in conns if c.endpoint is not None)
        return min(endpoints,
                   key=lambda e: (load.get(id(e), 0),
                                  getattr(e, "index", 0)))

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        conn = _Connection(self, reader, writer)
        self._conns.add(conn)
        self._handler_tasks.add(asyncio.current_task())
        try:
            await self._serve(conn)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass                           # peer vanished mid-exchange
        finally:
            self._conns.discard(conn)
            self._handler_tasks.discard(asyncio.current_task())
            conn.close()
            if (self.heartbeat_timeout is not None and conn.leases
                    and not conn.evicted):
                # eviction mode: a DETECTED death (EOF/reset) is treated
                # like heartbeat silence — the leases come back now, not
                # at the watchdog's grace x ETA.  Without eviction mode
                # the watchdog stays the single recovery path (legacy).
                await self._evict(conn, reason="disconnect")

    async def _serve(self, conn: _Connection):
        # -- handshake: first frame must be a protocol-compatible hello --
        try:
            msg, n = await read_frame_ex(conn.reader,
                                         max_bytes=self.max_frame_bytes)
        except ProtocolError as e:
            self.protocol_errors += 1
            await conn.send_error(None, e)
            return
        if msg is None:
            return
        self.frames_in += 1
        self.bytes_in += n
        self._count_in(msg.get("type", "?"), 1, n)
        seq = msg.get("seq")
        if msg["type"] != "hello":
            self.protocol_errors += 1
            await conn.send_error(seq, ProtocolError(
                "bad-handshake", "first frame must be 'hello'"))
            return
        # negotiation: ``proto`` is the client's floor (1 for old
        # clients), ``max_proto`` its ceiling (defaults to the floor, so
        # a plain v1 hello negotiates v1); the connection speaks the
        # highest version inside both sides' ranges
        proto = msg.get("proto")
        if (not isinstance(proto, int) or isinstance(proto, bool)
                or not (MIN_PROTOCOL_VERSION <= proto <= self.max_proto)):
            self.protocol_errors += 1
            await conn.send_error(seq, ProtocolError(
                "proto-mismatch",
                f"server speaks protos {MIN_PROTOCOL_VERSION}.."
                f"{self.max_proto}, client sent {proto!r}"))
            return
        client_max = msg.get("max_proto", proto)
        if not isinstance(client_max, int) or isinstance(client_max, bool):
            client_max = proto
        conn.proto = min(self.max_proto, max(proto, client_max))
        conn.client = str(msg.get("client", "remote"))
        try:
            conn.endpoint = self._pick_endpoint(self._conns)
        except ProtocolError as e:
            # e.g. every federation member is dead: refuse the hello with
            # an error frame instead of a silent close
            self.protocol_errors += 1
            await conn.send_error(seq, e)
            return
        if self.max_conns_per_member is not None:
            # admission control: _pick_endpoint chose the least-loaded
            # endpoint, so if even that one is at its cap the fabric is
            # full — refuse with ``busy`` (retryable backpressure, not an
            # error) and close.  Only ready connections count: a flood of
            # half-open hellos must not starve out accepted clients.
            load = sum(1 for c in self._conns
                       if c is not conn and c.ready
                       and c.endpoint is conn.endpoint)
            if load >= self.max_conns_per_member:
                self.busy_refusals += 1
                if self.tracer is not None:
                    self.tracer.instant(
                        "transport.busy", track="wire", cat="wire",
                        ts=conn.endpoint.queue.clock(),
                        args={"client": str(msg.get("client", "remote")),
                              "retry_after": self.retry_after})
                conn.endpoint = None
                await conn.send({"type": "busy", "seq": seq,
                                 "retry_after": self.retry_after})
                return
        conn.endpoint.ensure_watchdog()    # re-arm after a drained round
        conn.ready = True
        conn.last_seen = self._clock()
        await conn.send({"type": "hello_ok", "seq": seq,
                         "proto": conn.proto,
                         "project": conn.endpoint.project_name,
                         "member": getattr(conn.endpoint, "index", None)})
        # -- request loop: sequential request/response per connection ----
        while True:
            try:
                msg, n = await read_message(
                    conn.reader, max_bytes=self.max_frame_bytes,
                    max_blob_bytes=self.max_blob_bytes,
                    allow_chunks=conn.proto >= 2)
            except ProtocolError as e:
                # reject loudly, then close: after a framing error the
                # stream position is unrecoverable
                self.protocol_errors += 1
                await conn.send_error(None, e)
                return
            if msg is None:
                return                     # clean close
            conn.last_seen = self._clock() # any frame proves liveness
            self.frames_in += 1 + msg.get("chunks", 0)
            self.chunks_in += msg.get("chunks", 0)
            self.bytes_in += n
            self._count_in(msg.get("type", "?"), 1 + msg.get("chunks", 0), n)
            await self._dispatch(conn, msg)

    async def _dispatch(self, conn: _Connection, msg: dict):
        seq = msg.get("seq")
        kind = msg["type"]
        try:
            if kind == "lease_request":
                await self._handle_lease(conn, seq)
            elif kind == "submit":
                if msg.get("encoding") == "bin":
                    # v2: one binary blob for the whole result dict —
                    # gradient arrays go up raw, no pickle+base64
                    decoded = decode_binary(msg.get("manifest"),
                                            msg.get("_blob", b""))
                    if not isinstance(decoded, dict):
                        raise ProtocolError(
                            "bad-manifest",
                            "binary submit must decode to a dict")
                    results = {int(tid): r for tid, r in decoded.items()}
                else:
                    results = {int(tid): decode_payload(payload)
                               for tid, payload in msg["results"].items()}
                batch = conn.leases.pop(msg["lease_id"], None)
                if batch is not None:
                    accepted = await conn.endpoint.submit_batch(batch,
                                                                results)
                else:
                    # resume after reconnect: the lease lives on another
                    # (dead) connection or was watchdog-released; the
                    # queue accepts late results and drops duplicates
                    accepted = conn.endpoint.queue.submit_batch(
                        msg["lease_id"], results, conn.client)
                    conn.endpoint._notify_waiters()
                if self.tracer is not None:
                    # the span covers grant -> submit; the client's echoed
                    # trace context (its measured execute time) lands in
                    # the span args so the wire/compute split is visible
                    echo = parse_trace_context(msg.get("trace")) or {}
                    self.tracer.end(
                        self._wire_spans.pop(msg["lease_id"], None),
                        ts=conn.endpoint.queue.clock(),
                        args={"status": "submitted", "accepted": accepted,
                              **echo})
                await conn.send({"type": "submit_ok", "seq": seq,
                                 "accepted": accepted})
            elif kind == "release":
                await self._handle_release(conn, seq, msg)
            elif kind == "fetch_task":
                got = conn.endpoint.fetch_task_versioned(
                    msg["name"], if_version=msg.get("if_version"))
                await conn.send(_fetch_reply("task_data", seq, got))
            elif kind == "fetch_static":
                want_delta = bool(msg.get("delta")) and conn.proto >= 2
                got = conn.endpoint.serve_static_versioned(
                    msg["key"], if_version=msg.get("if_version"),
                    delta=want_delta)
                if conn.proto >= 2 and not got.not_modified:
                    # v2: full payloads AND deltas go binary + chunked
                    header, buffer = _fetch_reply_bin("static_data", seq,
                                                      got)
                    await conn.send_blob(header, buffer)
                else:
                    await conn.send(_fetch_reply("static_data", seq, got))
            elif kind == "heartbeat":
                # liveness already refreshed by the read loop (any frame
                # counts); the reply just completes the round-trip.  The
                # optional lease_id is advisory — a replayed heartbeat
                # naming a lease this connection no longer holds (post-
                # eviction reconnect) is harmless and stays tolerated,
                # mirroring parse_trace_context's posture on peer junk.
                self.heartbeats += 1
                reply: dict[str, Any] = {"type": "heartbeat_ok",
                                         "seq": seq}
                if self.fleet is not None and conn.proto >= 2:
                    # fleet plane armed: stamp the reply so the client
                    # can echo (t0, server_ts, t1) next heartbeat, and
                    # turn any echo riding THIS heartbeat into a clock-
                    # skew sample.  Without a fleet the reply stays
                    # byte-identical to pre-fleet servers.
                    reply["server_ts"] = conn.endpoint.queue.clock()
                    echo = parse_clock_echo(msg.get("echo"))
                    if echo is not None:
                        t0, sts, t1 = echo
                        self.fleet.clock_sample(
                            conn.client,
                            offset=sts - (t0 + t1) / 2.0, rtt=t1 - t0)
                await conn.send(reply)
            elif kind == "telemetry":
                # observability payload from an untrusted peer: parse
                # tolerantly, ingest when the fleet plane is armed, and
                # otherwise drop silently-but-counted.  Garbage costs
                # the sender its batch, never the server its connection.
                accepted = False
                if conn.proto >= 2 and self.fleet is not None:
                    parsed = parse_telemetry(msg.get("telemetry"))
                    accepted = self.fleet.ingest(
                        conn.client, parsed,
                        recv_ts=conn.endpoint.queue.clock())
                if accepted:
                    self.telemetry_accepted += 1
                else:
                    self.telemetry_dropped += 1
                await conn.send({"type": "telemetry_ok", "seq": seq,
                                 "accepted": accepted})
            elif kind == "error_report":
                conn.endpoint.queue.report_error(
                    int(msg["ticket_id"]), str(msg.get("error", "")),
                    conn.client)
                await conn.send({"type": "error_report_ok", "seq": seq})
            else:
                self.protocol_errors += 1
                await conn.send_error(seq, ProtocolError(
                    "bad-type", f"unknown message type {kind!r}"))
        except ProtocolError as e:
            self.protocol_errors += 1
            await conn.send_error(seq, e)
        except (ConnectionError, asyncio.IncompleteReadError):
            raise
        except KeyError as e:
            await conn.send_error(seq, ProtocolError(
                "unknown-key", f"no such task/static/field: {e}"))
        except Exception as e:             # never kill the connection on
            await conn.send_error(seq, ProtocolError(  # a handler bug
                "internal", repr(e)))

    async def _handle_lease(self, conn: _Connection, seq):
        # may park until tickets are eligible (or the round is terminal);
        # the client is sequential, so nothing else arrives meanwhile
        batch = await conn.endpoint.lease(conn.client)
        if batch is None:
            await conn.send({"type": "lease_grant", "seq": seq,
                             "done": True})
            return
        conn.leases[batch.lease_id] = batch
        grant = {"type": "lease_grant", "seq": seq, "done": False,
                 **batch.to_wire(encode_payload)}
        if self.tracer is not None and conn.proto >= 2:
            # trace context rides the v2 wire only when a tracer is
            # installed, so untraced traffic stays byte-identical; v1
            # peers never see the field (see docs/PROTOCOL.md)
            grant["trace"] = make_trace_context(lease=batch.lease_id,
                                                client=conn.client)
            self._wire_spans[batch.lease_id] = self.tracer.begin(
                "wire.lease", lane=True, cat="wire",
                track=f"client:{conn.client}",
                ts=conn.endpoint.queue.clock(),
                args={"lease": batch.lease_id, "client": conn.client,
                      "tickets": len(batch.tickets)})
        try:
            await conn.send(grant)
        except (ConnectionError, RuntimeError):
            # granted but undeliverable: hand the tickets straight back
            conn.leases.pop(batch.lease_id, None)
            if self.tracer is not None:
                self.tracer.end(self._wire_spans.pop(batch.lease_id, None),
                                ts=conn.endpoint.queue.clock(),
                                args={"status": "undeliverable"})
            await conn.endpoint.release_lease(batch, client_failed=True)
            raise

    async def _handle_release(self, conn: _Connection, seq, msg: dict):
        client_failed = bool(msg.get("client_failed", False))
        reset_vct = bool(msg.get("reset_vct", True))
        batch = conn.leases.pop(msg["lease_id"], None)
        if batch is not None:
            released = await conn.endpoint.release_lease(
                batch, client_failed=client_failed, reset_vct=reset_vct)
        else:
            released = conn.endpoint.queue.release(
                msg["lease_id"], client_failed=client_failed,
                reset_vct=reset_vct)
            conn.endpoint._notify_waiters()
        if self.tracer is not None:
            self.tracer.end(self._wire_spans.pop(msg["lease_id"], None),
                            ts=conn.endpoint.queue.clock(),
                            args={"status": "released",
                                  "released": released})
        await conn.send({"type": "release_ok", "seq": seq,
                         "released": released})


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class ServerBusy(ConnectionError):
    """The server refused our ``hello`` with a ``busy`` frame (admission
    control).  A ConnectionError subclass so the reconnect loop treats it
    as retryable, never fatal; ``retry_after`` carries the server's
    (already-sanitised) backoff hint in seconds."""

    def __init__(self, retry_after: float):
        super().__init__(f"server busy, retry after ~{retry_after:.3g}s")
        self.retry_after = retry_after


def reconnect_backoff(attempt: int, *, base: float, cap: float,
                      rand: Callable[[], float]) -> float:
    """Delay before reconnect ``attempt`` (1-based): capped exponential
    backoff with jitter.

    The undecorated span doubles per attempt from ``base`` up to ``cap``;
    the returned delay is drawn uniformly from the span's upper half
    (``[span/2, span]``), so simultaneous victims of one server drop
    decorrelate (no thundering herd at 10^4 clients) while a positive
    floor still prevents a tight dial loop.  Pure — ``rand`` is injected
    (callers pass a seeded generator; tests pass constants)."""
    span = min(cap, base * (2.0 ** max(0, attempt - 1)))
    return span * (0.5 + 0.5 * rand())


class RemoteBrowserClient(BrowserNodeBase):
    """A simulated browser node that speaks ONLY the wire protocol.

    Holds no reference to any distributor object — just ``(host, port)``
    (``BrowserNodeBase`` state is initialised with ``dist=None``).  Runs
    the same basic-program loop as ``AsyncBrowserClient`` (lease →
    download code/data through a version-aware LRU cache → execute →
    submit), but every step is a framed round-trip; conditional fetches
    and ticket version pins share the in-process merge rule
    (``merge_versioned_fetch``), so PR 3's zero-staleness guarantee holds
    across the serialization boundary by construction.

    **Reconnect with resume** (see docs/PROTOCOL.md §Reconnect): on a
    connection error the client re-dials with capped **exponential
    backoff with jitter** (:func:`reconnect_backoff` — at browser scale,
    a member death drops thousands of connections at once and a linear
    retry schedule re-dials them in lockstep), re-submits any
    finished-but-unsubmitted results under the old lease id (the queue
    accepts late results; duplicates are dropped), and goes back to
    leasing.  Tickets stranded in the dead connection's lease return to
    the queue through heartbeat eviction (when the server runs it) or
    the watchdog — so a dropped connection delays work but never loses
    it.  A ``busy`` refusal (admission control) is retryable the same
    way, honouring the server's jittered ``retry_after`` hint.

    **Heartbeats**: executes longer than ``heartbeat_interval`` are
    chunked, with a ``heartbeat`` round-trip between chunks, so a
    slow-but-alive device holding a lease is never mistaken for a closed
    tab (``None`` disables; the mid-lease fetch round-trips also count
    as liveness server-side).
    """

    def __init__(self, host: str, port: int, profile: ClientProfile, *,
                 max_reconnects: int = 8, reconnect_delay: float = 0.05,
                 backoff_cap: float = 2.0,
                 heartbeat_interval: Optional[float] = 1.0,
                 max_frame_bytes: int = MAX_FRAME_BYTES,
                 max_proto: int = PROTOCOL_VERSION,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 max_blob_bytes: int = MAX_BLOB_BYTES,
                 tracer=None, metrics=None, telemetry: bool = False,
                 clock: Callable[[], float] = time.monotonic):
        # cache/counters/failure-RNG come from the shared browser base;
        # there is no distributor object on this side of the wire
        self._init_browser(None, profile)
        # optional client-side tracer (in-process tests may share the
        # server's): records client.execute lanes; independent of the
        # trace-context echo, which only needs the server to be tracing
        self.tracer = tracer
        # optional client-LOCAL MetricsRegistry: busy refusals, backoff
        # sleeps, and reconnects land here (the client-side half of the
        # events the server only sees from its side of the wire).  With
        # ``telemetry=True`` on a v2 connection, snapshots of this
        # registry plus the tracer's drained span buffer flush to the
        # server's FleetAggregator, piggybacked on submits/heartbeats.
        # ``clock`` stamps heartbeat echoes for the server's clock-skew
        # estimate — wire the tracer's clock to the SAME callable so
        # shipped span timestamps live in the clock the skew remaps.
        self.metrics = metrics
        self.telemetry = telemetry
        self._clock = clock
        self._last_echo: Optional[dict] = None   # (t0, server_ts, t1)
        self.telemetry_sent = 0            # batches the server accepted
        self.telemetry_refused = 0         # batches it answered accepted=False
        self._m_busy = self._m_reconnects = self._m_backoff = None
        self._m_executed = self._m_heartbeats = None
        if metrics is not None:
            # no labels here: the FleetAggregator injects client= when
            # it merges per-client registries into the fleet snapshot
            self._m_busy = metrics.counter(
                "client.busy_refusals_total",
                "Hellos this client had refused with busy")
            self._m_reconnects = metrics.counter(
                "client.reconnects_total",
                "Reconnect attempts after transport failures")
            self._m_backoff = metrics.histogram(
                "client.backoff_sleep_seconds",
                "Jittered backoff sleeps before re-dialling")
            self._m_executed = metrics.counter(
                "client.executed_total", "Tickets executed")
            self._m_heartbeats = metrics.counter(
                "client.heartbeats_total", "Heartbeat round-trips sent")
        self.host = host
        self.port = port
        self.max_reconnects = max_reconnects
        self.reconnect_delay = reconnect_delay
        self.backoff_cap = backoff_cap
        self.heartbeat_interval = heartbeat_interval
        # backoff jitter draws come from a dedicated per-client RNG (NOT
        # the failure-simulation LCG, whose draw sequence tests pin) and
        # the sleep is injectable, so a backoff schedule is unit-testable
        # against a fake clock
        self._backoff_rand = random.Random(profile.name)
        self._sleep = asyncio.sleep
        self.max_frame_bytes = max_frame_bytes
        #: highest protocol version this client offers in ``hello``; set
        #: to 1 to behave exactly like a pre-v2 (JSON-only) client
        self.max_proto = max_proto
        self.chunk_bytes = chunk_bytes
        self.max_blob_bytes = max_blob_bytes
        self.proto = MIN_PROTOCOL_VERSION  # negotiated at hello time
        self.push_invalidations = 0        # server pushes that hit our cache
        self.reconnects = 0
        self.busy_refusals = 0             # hellos refused with ``busy``
        self.heartbeats_sent = 0
        self.leases_taken = 0
        self.deltas_applied = 0            # v2 delta fetches spliced in
        self.trace_contexts = 0            # grants that carried trace ctx
        # lease_id -> trace echo to attach to the submit (survives a
        # reconnect so a resumed submit still closes the server's span)
        self._trace_echo: dict[int, dict] = {}
        self.bytes_in = 0
        self.bytes_out = 0
        self.member: Optional[int] = None  # endpoint index from hello_ok
        self.done = False
        self._seq = itertools.count(1)
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._stopping = False
        # finished-but-unsubmitted results, parked for reconnect-resume:
        # (lease_id, {str(ticket_id): raw result}) or None — encoded per
        # the negotiated protocol only at submit time
        self._pending: Optional[tuple[int, dict]] = None

    # -- wire plumbing --------------------------------------------------------

    async def _connect(self):
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        # floor 1 so a v1 server accepts the hello as-is; ``max_proto``
        # advertises how high we can negotiate
        reply = await self._request({"type": "hello",
                                     "client": self.profile.name,
                                     "proto": MIN_PROTOCOL_VERSION,
                                     "max_proto": self.max_proto})
        if reply["type"] == "busy":
            # admission refusal: retryable backpressure, not an error —
            # close our half and surface the (sanitised) retry hint to
            # the reconnect loop
            self.busy_refusals += 1
            retry_after = parse_retry_after(
                reply.get("retry_after"), self.reconnect_delay)
            if self._m_busy is not None:
                self._m_busy.inc()
            if self.tracer is not None:
                self.tracer.instant(
                    "client.busy", cat="client",
                    track=f"client:{self.profile.name}",
                    args={"retry_after": retry_after})
            self._disconnect()
            raise ServerBusy(retry_after)
        proto = reply.get("proto", MIN_PROTOCOL_VERSION)
        if (not isinstance(proto, int) or isinstance(proto, bool)
                or not (MIN_PROTOCOL_VERSION <= proto <= self.max_proto)):
            raise ProtocolError(
                "proto-mismatch",
                f"server negotiated unsupported proto {proto!r}")
        self.proto = proto
        self.member = reply.get("member")

    def _disconnect(self):
        if self._writer is not None:
            try:
                self._writer.close()
            except RuntimeError:
                pass
        self._reader = self._writer = None

    async def _request(self, msg: dict, blob: Optional[bytes] = None
                       ) -> dict:
        """One framed round-trip: send ``msg`` (stamped with a fresh seq),
        return the reply bearing that seq.  A ``blob`` (v2 binary
        payload) is sent as header + chunk frames.  Pushed ``invalidate``
        frames arriving in between are applied inline; an ``error`` reply
        raises :class:`ProtocolError`; a closed stream raises
        ConnectionError (the run loop's reconnect trigger).  Chunked
        replies are reassembled by :func:`read_message` into
        ``reply["_blob"]``."""
        if self._writer is None:
            raise ConnectionResetError("not connected")
        seq = next(self._seq)
        frames = build_blob_frames({**msg, "seq": seq}, blob or b"",
                                   chunk_bytes=self.chunk_bytes,
                                   max_frame_bytes=self.max_frame_bytes)
        for frame in frames:
            self._writer.write(frame)
        await self._writer.drain()
        self.bytes_out += sum(len(f) for f in frames)
        while True:
            reply, n = await read_message(self._reader,
                                          max_bytes=self.max_frame_bytes,
                                          max_blob_bytes=self
                                          .max_blob_bytes)
            if reply is None:
                raise ConnectionResetError("server closed the connection")
            self.bytes_in += n
            if reply["type"] == "invalidate":
                self._apply_invalidate(reply)
                continue
            if reply["type"] == "error":
                # check BEFORE the seq filter: framing errors are sent
                # with seq=null and are fatal either way — skipping them
                # would turn "peer rejected our bytes" into a reconnect
                # loop that re-sends the identical doomed frame
                raise ProtocolError(reply.get("code", "error"),
                                    reply.get("message", ""))
            if reply.get("seq") != seq:
                continue                   # stale pre-reconnect reply
            return reply

    def _apply_invalidate(self, msg: dict):
        """Server push: a registry key was re-published.  Correctness
        never depends on this (ticket pins force revalidation); the push
        just stops us re-validating a copy the origin already knows is
        stale.

        v1 drops the copy outright.  v2 keeps the stale payload but
        voids its validation mark (``validated = -1`` fails every pin,
        including 0), so the next use revalidates conditionally — and the
        kept copy is exactly the **delta base** that lets the server ship
        only the changed leaves instead of a full payload."""
        key = str(msg.get("key"))
        entry = self.cache.pop(key)
        if entry is None:
            return
        self.push_invalidations += 1
        if self.proto >= 2:
            entry.validated = -1
            self.cache.put(key, entry)

    # -- version-aware cache (async mirror of BrowserNodeBase) ---------------

    async def _aget_versioned(self, cache_key: str, fetch,
                              min_version: int):
        """Async twin of ``BrowserNodeBase._get_versioned``: identical
        control flow, with the transport round-trip at the awaits, and
        the subtle merge decision delegated to the SAME pure helpers
        (``merge_versioned_fetch``/``merge_unconditional_fetch``) the
        in-process path uses — a coherence fix lands on both sides of
        the wire at once.  ``fetch(if_version)`` is a coroutine factory;
        ``min_version`` is the ticket's pin."""
        entry = self.cache.get(cache_key)
        if entry is not None and entry.validated >= min_version:
            return entry.value
        got = await fetch(entry.version if entry is not None else None)
        new, revalidated, refetch = merge_versioned_fetch(entry, got,
                                                          min_version)
        if refetch:
            new = merge_unconditional_fetch(await fetch(None), min_version)
        elif got.delta_base is not None:
            self.deltas_applied += 1       # changed leaves spliced in
        if revalidated:
            self.revalidations += 1
        self.cache.put(cache_key, new)
        return new.value

    async def _get_task(self, name: str, min_version: int = 0) -> TaskDef:
        """Task code through the cache; a pin newer than the cached entry
        forces a conditional ``fetch_task`` round-trip."""
        async def fetch(v):
            return _decode_fetch(await self._request(
                {"type": "fetch_task", "name": name, "if_version": v}))
        return await self._aget_versioned(f"task:{name}", fetch, min_version)

    async def _get_static(self, task: TaskDef, min_version: int) -> dict:
        """The task's statics through the cache, same revalidation rule.
        On a v2 connection a conditional fetch also asks for a **delta**
        (changed leaves relative to our cached version); the shared merge
        helper splices it in, or falls back to a full refetch when the
        base no longer matches."""
        out = {}
        for key in task.static_files:
            async def fetch(v, k=key):
                req = {"type": "fetch_static", "key": k, "if_version": v}
                if v is not None and self.proto >= 2:
                    req["delta"] = True
                return _decode_fetch(await self._request(req))
            out[key] = await self._aget_versioned(f"static:{key}", fetch,
                                                  min_version)
        return out

    # -- the basic-program loop ----------------------------------------------

    async def run(self):
        """Connect → lease → download → execute → submit, reconnecting on
        transport failure, until the server reports the work done (or the
        profile says the tab closes)."""
        failures = 0
        try:
            while not self._stopping:
                try:
                    if self._writer is None:
                        await self._connect()
                        failures = 0
                    if self._pending is not None:
                        # resume: re-submit results finished before the
                        # drop under their old lease id (dupes are fine)
                        lease_id, results = self._pending
                        await self._submit_results(lease_id, results)
                        self._pending = None
                    if not await self._one_lease():
                        break
                except ProtocolError:
                    raise                  # a peer speaking garbage is fatal
                except (ConnectionError, asyncio.IncompleteReadError,
                        OSError) as e:
                    self._disconnect()
                    if self._stopping:
                        break
                    failures += 1
                    if failures > self.max_reconnects:
                        raise ConnectionError(
                            f"{self.profile.name}: gave up after "
                            f"{self.max_reconnects} reconnects") from e
                    self.reconnects += 1
                    if self._m_reconnects is not None:
                        self._m_reconnects.inc()
                    if self.tracer is not None:
                        self.tracer.instant(
                            "client.reconnect", cat="client",
                            track=f"client:{self.profile.name}",
                            args={"attempt": failures,
                                  "busy": isinstance(e, ServerBusy)})
                    delay = reconnect_backoff(
                        failures, base=self.reconnect_delay,
                        cap=self.backoff_cap,
                        rand=self._backoff_rand.random)
                    if isinstance(e, ServerBusy):
                        # a busy server set the floor: honour its hint,
                        # jittered so refused clients don't re-dial as
                        # one synchronized wave
                        delay = max(delay, e.retry_after
                                    * (0.5 + 0.5
                                       * self._backoff_rand.random()))
                    if self._m_backoff is not None:
                        self._m_backoff.observe(delay)
                    if self.tracer is not None:
                        self.tracer.instant(
                            "client.backoff", cat="client",
                            track=f"client:{self.profile.name}",
                            args={"delay_s": delay})
                    await self._sleep(delay)
        finally:
            self.done = True
            self._disconnect()

    async def _submit_results(self, lease_id: int, results: dict) -> dict:
        """Submit a lease's results: v2 sends the whole dict as one
        binary blob (raw array buffers, no pickle+base64); v1 sends the
        per-ticket pickled-base64 form.  ``results`` maps str(ticket_id)
        to the RAW result object either way, so a reconnect that
        renegotiates the protocol re-encodes correctly on resume."""
        # echo trace context only when the grant carried it (server is
        # tracing, v2): untraced and v1 submits stay byte-identical.
        # Kept until the submit actually lands, so a resumed re-submit
        # after a reconnect still closes the server's wire span.
        extra = {}
        echo = self._trace_echo.get(lease_id)
        if echo is not None:
            extra["trace"] = echo
        if self.proto >= 2:
            manifest, buffer = encode_binary(results)
            reply = await self._request(
                {"type": "submit", "lease_id": lease_id,
                 "encoding": "bin", "manifest": manifest, **extra},
                blob=buffer)
        else:
            reply = await self._request(
                {"type": "submit", "lease_id": lease_id,
                 "results": {tid: encode_payload(r)
                             for tid, r in results.items()}, **extra})
        self._trace_echo.pop(lease_id, None)
        return reply

    async def _heartbeat(self, lease_id: Optional[int] = None):
        """One liveness round-trip; any frame refreshes the server's
        silence clock.  On a v2 connection to a fleet-plane server each
        exchange also advances the clock-skew protocol: the previous
        exchange's ``(t0, server_ts, t1)`` echo rides out, and this
        reply's ``server_ts`` (when present) seeds the next one.  A
        heartbeat is also a telemetry flush trigger."""
        msg: dict[str, Any] = {"type": "heartbeat"}
        if lease_id is not None:
            msg["lease_id"] = lease_id     # advisory, for log correlation
        if self.proto >= 2 and self._last_echo is not None:
            msg["echo"] = self._last_echo
            self._last_echo = None
        t0 = self._clock()
        reply = await self._request(msg)
        self.heartbeats_sent += 1
        if self._m_heartbeats is not None:
            self._m_heartbeats.inc()
        sts = reply.get("server_ts")
        if (self.proto >= 2 and isinstance(sts, (int, float))
                and not isinstance(sts, bool)):
            self._last_echo = make_clock_echo(t0, sts, self._clock())
        await self._flush_telemetry()

    async def _flush_telemetry(self):
        """Ship buffered observability to the server's FleetAggregator:
        the local registry snapshot plus the tracer's drained span
        buffer, as one ``telemetry`` frame.  No-op unless this client
        was built with ``telemetry=True`` and negotiated v2, or when
        there is nothing to send.  The server may still refuse
        (``accepted: false`` — no fleet aggregator armed); that costs
        this batch its spans (already drained) and is counted."""
        if not self.telemetry or self.proto < 2:
            return
        spans = self.tracer.drain() if self.tracer is not None else []
        metrics = None
        if self.metrics is not None:
            if self._m_executed is not None:
                self._m_executed.set_total(self.executed)
            metrics = self.metrics.snapshot()
        if not spans and not metrics:
            return
        dropped = (self.tracer.events_dropped
                   if self.tracer is not None else 0)
        reply = await self._request(
            {"type": "telemetry",
             "telemetry": make_telemetry(metrics, spans,
                                         dropped=dropped)})
        if reply.get("accepted"):
            self.telemetry_sent += 1
        else:
            self.telemetry_refused += 1

    async def _paced_sleep(self, seconds: float,
                           lease_id: Optional[int] = None):
        """Sleep (simulated compute / network latency) while holding a
        lease: stretches longer than ``heartbeat_interval`` are chunked
        with a heartbeat between chunks, so the eviction sweeper can tell
        *slow* from *gone*."""
        hb = self.heartbeat_interval
        while hb is not None and seconds > hb:
            await asyncio.sleep(hb)
            seconds -= hb
            await self._heartbeat(lease_id)
        if seconds > 0:
            await asyncio.sleep(seconds)

    async def _one_lease(self) -> bool:
        """One lease round; returns False when the server says the work is
        done (client exits).  Finished-but-unsubmitted results are parked
        in ``_pending`` so a reconnect can resume them."""
        self._pending = None
        reply = await self._request({"type": "lease_request"})
        if reply["type"] != "lease_grant":
            raise ProtocolError("bad-reply",
                                f"expected lease_grant, got {reply['type']}")
        if reply.get("done"):
            return False
        batch = LeaseBatch.from_wire(reply, decode_payload)
        ctx = parse_trace_context(reply.get("trace"))
        if ctx is not None:
            self.trace_contexts += 1
        self.leases_taken += 1
        if self.profile.latency:
            await self._paced_sleep(self.profile.latency, batch.lease_id)
        if (self.profile.die_after is not None
                and self.leases_taken > self.profile.die_after):
            # tab closed mid-lease: hand the tickets straight back
            await self._request({"type": "release",
                                 "lease_id": batch.lease_id,
                                 "client_failed": True})
            self._stopping = True
            return False
        results: dict[str, Any] = {}       # str(tid) -> raw result object
        failed = False
        tr = self.tracer
        exec_span = None
        t0 = time.monotonic() if (ctx is not None or tr is not None) else 0.0
        if tr is not None:
            exec_span = tr.begin("client.execute", lane=True, cat="client",
                                 track=f"client:{self.profile.name}",
                                 args={"lease": batch.lease_id,
                                       "tickets": len(batch.tickets)})
        try:
            for ticket in batch.tickets:
                try:
                    task = await self._get_task(ticket.task_name,
                                                ticket.task_version)
                    static = await self._get_static(task,
                                                    ticket.task_version)
                    if (self.profile.fail_prob
                            and self._rand() < self.profile.fail_prob):
                        raise RuntimeError("simulated browser crash in "
                                           f"{ticket.task_name}")
                    if self.profile.speed > 0:
                        await self._paced_sleep(
                            ticket.work / self.profile.speed,
                            batch.lease_id)
                    results[str(ticket.ticket_id)] = task.run(ticket.args,
                                                              static)
                    self.executed += 1
                except (ConnectionError, asyncio.IncompleteReadError,
                        OSError, ProtocolError):
                    # transport failure mid-lease: park what we finished
                    # so the reconnect path can resume-submit it
                    self._pending = (batch.lease_id, results)
                    raise
                except Exception:
                    self.errors += 1
                    # park BEFORE the report round-trip: if the connection
                    # drops during it, the finished results must still
                    # ride the reconnect-resume path
                    self._pending = (batch.lease_id, results)
                    await self._request({"type": "error_report",
                                         "ticket_id": ticket.ticket_id,
                                         "error": traceback.format_exc()})
                    self._pending = None
                    self._reload()         # paper: reload browser
                    failed = True
        finally:
            if tr is not None:
                tr.end(exec_span, args={"executed": len(results),
                                        "failed": failed})
        if ctx is not None:
            self._trace_echo[batch.lease_id] = make_trace_context(
                lease=batch.lease_id, client=self.profile.name,
                exec_s=time.monotonic() - t0)
        self._pending = (batch.lease_id, results)
        await self._submit_results(batch.lease_id, results)
        self._pending = None
        await self._flush_telemetry()      # submit is a flush trigger too
        if failed:
            # drop the lease bookkeeping for the errored tickets but keep
            # their cool-down (paper behaviour; mirrors AsyncBrowserClient)
            await self._request({"type": "release",
                                 "lease_id": batch.lease_id,
                                 "reset_vct": False})
        return True

    async def stop(self):
        """Ask the client to exit; drops the connection so a parked
        lease_request unblocks immediately."""
        self._stopping = True
        self._disconnect()


def spawn_remote_clients(address: tuple[str, int], profiles, **kw
                         ) -> tuple[list[RemoteBrowserClient],
                                    list[asyncio.Task]]:
    """Create and start one :class:`RemoteBrowserClient` task per profile
    (must be called with an event loop running).  Returns
    ``(clients, tasks)`` — await the tasks to join the clients."""
    loop = asyncio.get_running_loop()
    clients = [RemoteBrowserClient(address[0], address[1], p, **kw)
               for p in profiles]
    tasks = [loop.create_task(c.run()) for c in clients]
    return clients, tasks
