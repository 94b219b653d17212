"""Binary framed wire protocol for the serving tier (counterpart of
``deeplearning4j_tpu/serving/wire.py``; frames are byte for byte the JAX
package's for the same arrays and fields, so either package's client,
router and worker talk to the other's).

The JSON serving path marshals every row through ``tolist()`` /
``json.dumps`` / ``json.loads`` and opens a fresh TCP connection per
router->worker hop. This module is the binary answer: a magic + version +
CRC-framed frame carrying dtype/shape-tagged ndarray payloads, so a corrupt
frame is an explicit :class:`WireProtocolError` — never a silently wrong
tensor. Decoded tensors stay read-only numpy views over the frame: the one
copy on the serving path is the batcher's into its pad buffers.

Frame layout (little-endian)::

    magic    4s   b"DWF1"
    version  B    1
    kind     B    1=request  2=response
    flags    H    bit0: payload rides a shared-memory segment
    meta_len I    length of the JSON meta block
    payload_len Q length of the tensor payload (inline OR in shm)
    crc32    I    zlib.crc32 over meta + payload
    meta     ...  compact JSON: tensors [{name,dtype,shape,offset,nbytes}],
                  fields (control headers), model/version, timeout_ms,
                  shm {name,size,pid} when flags bit0 is set
    payload  ...  concatenated C-contiguous tensor bytes (absent for shm)

Every control header the router forwards has a registered frame-field
mapping in :data:`HEADER_FIELDS`, so hedging, deadlines, shed windows,
sessions, and shadow mirroring are protocol-invariant. Negotiation is
per-connection content-type: a worker that cannot (or is configured not
to) speak binary answers 415 and the sender transcodes to JSON and
downgrades that endpoint.

Also here: :class:`ConnectionPool`, the bounded keep-alive pool the router
and its clients share — so the JSON path stops paying per-request TCP
setup too.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import socket
import time
import zlib
from collections import deque
from http.client import HTTPConnection
from http.server import ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..runtime import chaos

MAGIC = b"DWF1"
VERSION = 1
KIND_REQUEST = 1
KIND_RESPONSE = 2
FLAG_SHM = 0x0001

#: content type that negotiates the binary protocol on an HTTP hop
CONTENT_TYPE = "application/x-dl4j-wire"

#: payloads below this many bytes are not worth a shared-memory segment
SHM_MIN_BYTES = 32768

_HEADER = struct.Struct("<4sBBHIQI")

# Every control header forwarded on the HTTP path, mapped 1:1 into a
# frame field so the binary protocol carries identical semantics.
HEADER_FIELDS: Dict[str, str] = {
    "X-Request-Id": "request_id",
    "X-Deadline-Ms": "deadline_ms",
    "X-Trace-Id": "trace_id",
    "X-Parent-Span-Id": "parent_span_id",
    "X-Trace-Flags": "trace_flags",
    "X-Worker-Id": "worker_id",
    "X-Model-Version": "model_version",
    "X-Session-Step": "session_step",
    "X-Shadow": "shadow",
    "Retry-After": "retry_after",
    "Retry-After-Ms": "retry_after_ms",
}

_FIELD_HEADERS = {v: k for k, v in HEADER_FIELDS.items()}
_LOWER_HEADERS = {k.lower(): k for k in HEADER_FIELDS}


class WireProtocolError(RuntimeError):
    """A frame failed validation (bad magic/version/CRC/bounds/dtype).

    Always an explicit, counted error — the decode path never hands a
    partially-valid tensor to the model.
    """


def headers_to_fields(headers) -> Dict[str, str]:
    """Project the registered control headers out of an HTTP header map
    into their frame-field names (unregistered headers are dropped)."""
    fields = {}
    for key, value in dict(headers or {}).items():
        canon = _LOWER_HEADERS.get(str(key).lower())
        if canon is not None:
            fields[HEADER_FIELDS[canon]] = str(value)
    return fields


def fields_to_headers(fields) -> Dict[str, str]:
    """Inverse of :func:`headers_to_fields`; unknown fields are dropped
    (forward compatibility: a newer sender's extra fields are ignored,
    never misinterpreted)."""
    headers = {}
    for field, value in dict(fields or {}).items():
        header = _FIELD_HEADERS.get(field)
        if header is not None:
            headers[header] = str(value)
    return headers


# ------------------------------------------------------------------ counters
class _Counters:
    """Process-wide wire counters, rendered into /v1/metricsz."""

    def __init__(self):
        self._lock = threading.Lock()  # guards: all counter attributes
        self.reset()

    def reset(self):
        with self._lock:
            self.frames_encoded_total = 0
            self.frames_decoded_total = 0
            self.protocol_errors_total = 0
            self.shm_frames_total = 0
            self.bytes_encoded_total = 0

    def inc(self, name, n=1):
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "frames_encoded_total": self.frames_encoded_total,
                "frames_decoded_total": self.frames_decoded_total,
                "protocol_errors_total": self.protocol_errors_total,
                "shm_frames_total": self.shm_frames_total,
                "bytes_encoded_total": self.bytes_encoded_total,
            }


_counters = _Counters()


def counters() -> Dict[str, int]:
    """Snapshot of the process-wide wire counters."""
    return _counters.snapshot()


def reset_counters():
    """Zero the process-wide wire counters (test isolation)."""
    _counters.reset()


def render_prometheus() -> List[str]:
    """``serving_wire_*`` rows for a worker's /v1/metricsz."""
    snap = _counters.snapshot()
    return [f"serving_wire_{name} {value}" for name, value in snap.items()]


# --------------------------------------------------------------- frame codec
def _check_dtype(dt: np.dtype) -> np.dtype:
    if dt.kind not in "biuf" or dt.hasobject:
        raise WireProtocolError(f"dtype {dt} not wire-encodable")
    return dt


def _pack_tensors(arrays) -> Tuple[List[dict], List[Any], int]:
    metas, parts, offset = [], [], 0
    for name, arr in arrays:
        arr = np.ascontiguousarray(arr)
        _check_dtype(arr.dtype)
        parts.append(arr.data.cast("B") if arr.nbytes else b"")
        metas.append({"name": name, "dtype": arr.dtype.str,
                      "shape": list(arr.shape), "offset": offset,
                      "nbytes": arr.nbytes})
        offset += arr.nbytes
    return metas, parts, offset


def encode_frame(kind: int, meta: dict, payload_parts=(), flags: int = 0,
                 inline_payload: bool = True) -> bytes:
    """Assemble a frame; fires the ``serving.wire.frame`` chaos point
    (call + byte point) so drills can corrupt/truncate/flip the encoded
    bytes and prove damage is always a counted protocol error.

    ``inline_payload=False`` builds a shm frame: the CRC and
    ``payload_len`` still cover the parts, but the bytes themselves ride
    the shared-memory segment instead of the socket.
    """
    meta_b = json.dumps(meta, separators=(",", ":")).encode()
    crc = zlib.crc32(meta_b)
    payload_len = 0
    for part in payload_parts:
        crc = zlib.crc32(part, crc)
        payload_len += len(part)
    header = _HEADER.pack(MAGIC, VERSION, kind, flags, len(meta_b),
                          payload_len, crc & 0xFFFFFFFF)
    parts = [header, meta_b]
    if inline_payload:
        parts.extend(payload_parts)  # join accepts buffers: single copy
    frame = b"".join(parts)
    chaos.inject("serving.wire.frame")
    frame = chaos.transform_bytes("serving.wire.frame", frame)
    _counters.inc("frames_encoded_total")
    _counters.inc("bytes_encoded_total", len(frame))
    return frame


class DecodedFrame:
    """A validated frame: ``meta`` dict plus a zero-copy ``payload``
    view (over the inline bytes, or an attached shm segment).  Call
    :meth:`close` when the tensors are no longer needed."""

    def __init__(self, kind, flags, meta, payload, shm=None):
        self.kind = kind
        self.flags = flags
        self.meta = meta
        self.payload = payload
        self._shm = shm

    def tensors(self):
        """Decode the tagged tensors as READ-ONLY zero-copy views into
        the payload — the single copy on the serving path is the
        batcher's pad-buffer gather."""
        out = []
        for t in self.meta.get("tensors", []):
            try:
                dt = _check_dtype(np.dtype(t["dtype"]))
                ofs, nbytes = int(t["offset"]), int(t["nbytes"])
                shape = tuple(int(d) for d in t["shape"])
            except WireProtocolError:
                raise
            except Exception as e:
                raise WireProtocolError(f"bad tensor meta: {e}") from e
            if ofs < 0 or nbytes < 0 or ofs + nbytes > len(self.payload):
                raise WireProtocolError("tensor bounds exceed payload")
            arr = np.frombuffer(self.payload[ofs:ofs + nbytes], dtype=dt)
            try:
                arr = arr.reshape(shape)
            except ValueError as e:
                raise WireProtocolError(f"tensor shape mismatch: {e}") from e
            arr.flags.writeable = False
            out.append((t.get("name"), arr))
        return out

    def close(self):
        if self._shm is None:
            return
        try:
            self._shm.close()
        except BufferError:
            # a numpy view still exports the buffer: keep the handle so
            # a later close() (after the caller drops its tensors) can
            # finish the job; the creator owns the unlink either way
            return
        self._shm = None


def decode_frame(buf, expect_kind: Optional[int] = None) -> DecodedFrame:
    """Validate and open a frame.  Any damage — wrong magic, truncated
    body, flipped bits (CRC), nonsense tensor tags — raises
    :class:`WireProtocolError` after counting it."""
    try:
        return _decode_frame(buf, expect_kind)
    except WireProtocolError:
        _counters.inc("protocol_errors_total")
        raise


def _decode_frame(buf, expect_kind):
    view = memoryview(buf)
    if len(view) < _HEADER.size:
        raise WireProtocolError(f"frame truncated: {len(view)} bytes")
    magic, version, kind, flags, meta_len, payload_len, crc = \
        _HEADER.unpack_from(view)
    if magic != MAGIC:
        raise WireProtocolError(f"bad magic {bytes(magic)!r}")
    if version != VERSION:
        raise WireProtocolError(f"unsupported wire version {version}")
    if expect_kind is not None and kind != expect_kind:
        raise WireProtocolError(f"unexpected frame kind {kind}")
    meta_end = _HEADER.size + meta_len
    shm = None
    if flags & FLAG_SHM:
        if len(view) != meta_end:
            raise WireProtocolError("shm frame carries inline payload")
    elif len(view) != meta_end + payload_len:
        raise WireProtocolError(
            f"frame length {len(view)} != header + {meta_len} + "
            f"{payload_len}")
    meta_b = view[_HEADER.size:meta_end]
    try:
        meta = json.loads(bytes(meta_b))
    except Exception as e:
        raise WireProtocolError(f"bad meta block: {e}") from e
    if not isinstance(meta, dict):
        raise WireProtocolError("meta block is not an object")
    if flags & FLAG_SHM:
        shm, payload = _attach_shm(meta, payload_len)
    else:
        payload = view[meta_end:]
    actual = zlib.crc32(payload, zlib.crc32(meta_b)) & 0xFFFFFFFF
    if actual != crc:
        if shm is not None:
            shm.close()
        raise WireProtocolError(
            f"CRC mismatch: frame says {crc:#010x}, payload is "
            f"{actual:#010x}")
    _counters.inc("frames_decoded_total")
    return DecodedFrame(kind, flags, meta, payload, shm=shm)


# ------------------------------------------------------------ predict frames
def _as_arrays(inputs, dtype=None):
    if isinstance(inputs, dict):
        return True, [(str(k), np.asarray(v, dtype=dtype))
                      for k, v in inputs.items()]
    return False, [(None, np.asarray(inputs, dtype=dtype))]


def encode_predict_request(inputs, timeout_ms=None, headers=None,
                           fields=None, dtype=None) -> bytes:
    """Frame a predict request: ``inputs`` is an ndarray (or dict of
    named ndarrays, mirroring the JSON multi-input form)."""
    multi, arrays = _as_arrays(inputs, dtype=dtype)
    metas, parts, _total = _pack_tensors(arrays)
    meta: Dict[str, Any] = {"tensors": metas,
                            "fields": dict(fields or
                                           headers_to_fields(headers))}
    if multi:
        meta["multi"] = True
    if timeout_ms is not None:
        meta["timeout_ms"] = float(timeout_ms)
    return encode_frame(KIND_REQUEST, meta, parts)


def decode_predict_request(raw):
    """Returns ``(inputs, timeout_ms, fields, frame)`` — inputs are
    read-only zero-copy views; close ``frame`` once served."""
    fr = decode_frame(raw, expect_kind=KIND_REQUEST)
    try:
        tensors = fr.tensors()
        if not tensors:
            raise WireProtocolError("request frame has no tensors")
        if fr.meta.get("multi"):
            x = {name: arr for name, arr in tensors}
        else:
            x = tensors[0][1]
    except WireProtocolError:
        fr.close()
        _counters.inc("protocol_errors_total")
        raise
    return x, fr.meta.get("timeout_ms"), fr.meta.get("fields") or {}, fr


def encode_predict_response(model, version, outputs, fields=None) -> bytes:
    """Frame a predict response; ``outputs`` is an ndarray or a
    list/tuple of ndarrays (multi-output heads)."""
    multi = isinstance(outputs, (list, tuple))
    arrays = [(None, np.asarray(o)) for o in
              (outputs if multi else [outputs])]
    metas, parts, _total = _pack_tensors(arrays)
    meta: Dict[str, Any] = {"model": model, "version": version,
                            "tensors": metas, "fields": dict(fields or {})}
    if multi:
        meta["multi"] = True
    return encode_frame(KIND_RESPONSE, meta, parts)


def decode_predict_response(raw):
    """Returns ``(model, version, outputs, frame)``; outputs mirror the
    encoder's single-vs-list shape.  Close ``frame`` after use."""
    fr = decode_frame(raw, expect_kind=KIND_RESPONSE)
    try:
        tensors = fr.tensors()
    except WireProtocolError:
        fr.close()
        _counters.inc("protocol_errors_total")
        raise
    outs = [arr for _name, arr in tensors]
    outputs = outs if fr.meta.get("multi") else (outs[0] if outs else None)
    return fr.meta.get("model"), fr.meta.get("version"), outputs, fr


def frame_to_json_body(raw) -> Tuple[bytes, Optional[float]]:
    """Transcode a binary predict request into the equivalent JSON body
    (the mid-stream downgrade path for JSON-only workers).  The dtype is
    pinned in the body so the downgraded request produces bit-identical
    outputs to the binary path."""
    x, timeout_ms, _fields, fr = decode_predict_request(raw)
    try:
        if isinstance(x, dict):
            body: Dict[str, Any] = {
                "inputs": {k: np.asarray(v).tolist() for k, v in x.items()}}
            dtypes = {np.asarray(v).dtype.name for v in x.values()}
            if len(dtypes) == 1:
                body["dtype"] = dtypes.pop()
        else:
            body = {"inputs": np.asarray(x).tolist(),
                    "dtype": np.asarray(x).dtype.name}
        if timeout_ms is not None:
            body["timeout_ms"] = timeout_ms
    finally:
        fr.close()
    return json.dumps(body).encode(), timeout_ms


def response_to_jsonable(raw) -> dict:
    """Decode a binary predict response into the JSON response shape
    (used by shadow-mirror comparison so gated delivery sees identical
    structures whichever protocol carried the traffic)."""
    model, version, outputs, fr = decode_predict_response(raw)
    try:
        if isinstance(outputs, list):
            out = [np.asarray(o).tolist() for o in outputs]
        else:
            out = np.asarray(outputs).tolist()
    finally:
        fr.close()
    return {"model": model, "version": version, "outputs": out}


# ------------------------------------------------------- shared-memory hop
def _attach_shm(meta, payload_len):
    info = meta.get("shm")
    if not isinstance(info, dict) or "name" not in info:
        raise WireProtocolError("shm frame missing segment name")
    try:
        from multiprocessing import resource_tracker, shared_memory
        seg = shared_memory.SharedMemory(name=str(info["name"]))
        if int(info.get("pid", -1)) != os.getpid():
            # attaching registered the segment with OUR resource
            # tracker; the creator owns unlink, so unregister here or
            # the tracker reaps (and warns about) a foreign segment
            resource_tracker.unregister(seg._name, "shared_memory")
    except WireProtocolError:
        raise
    except Exception as e:
        raise WireProtocolError(f"cannot attach shm segment: {e}") from e
    if payload_len > seg.size:
        seg.close()
        raise WireProtocolError("shm segment smaller than payload_len")
    return seg, memoryview(seg.buf)[:payload_len]


def frame_to_shm(raw, min_bytes: int = SHM_MIN_BYTES):
    """Re-frame an inline frame so its payload rides a shared-memory
    segment (the colocated router->worker fast path).  Returns
    ``(frame_bytes, shm)`` — the caller owns ``shm`` and must
    ``close()`` + ``unlink()`` it once the hop completes — or
    ``(raw, None)`` when the payload is too small to bother.  Any
    failure here is the caller's cue to fall back to the socket path."""
    fr = decode_frame(raw)
    if len(fr.payload) < min_bytes:
        return raw, None
    from multiprocessing import shared_memory
    seg = shared_memory.SharedMemory(create=True, size=len(fr.payload))
    try:
        seg.buf[:len(fr.payload)] = fr.payload
        meta = dict(fr.meta)
        meta["shm"] = {"name": seg.name.lstrip("/"),
                       "size": len(fr.payload), "pid": os.getpid()}
        frame = encode_frame(fr.kind, meta, [fr.payload],
                             flags=fr.flags | FLAG_SHM,
                             inline_payload=False)
    except Exception:
        seg.close()
        seg.unlink()
        raise
    _counters.inc("shm_frames_total")
    return frame, seg


def release_shm(seg):
    """Creator-side teardown of a fast-path segment (close + unlink);
    tolerant of the receiver having raced us to the unlink."""
    if seg is None:
        return
    try:
        seg.close()
    except BufferError:
        pass
    try:
        seg.unlink()
    except FileNotFoundError:
        pass


# ---------------------------------------------------------- connection pool
class KeepAliveHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` that force-closes every accepted socket on
    ``server_close()``.  With HTTP/1.1 pooled clients, a daemon handler
    thread parked in a keep-alive read would otherwise keep serving a
    "stopped" server through the already-open socket — stop must look
    like process death to connected peers, or failover paths that fire
    on connection faults (router death, worker kill) never trigger."""

    daemon_threads = True
    # without this, server_close() would join the handler threads — i.e.
    # block stop() on every idle keep-alive connection's read timeout
    block_on_close = False

    def __init__(self, *args, **kwargs):
        # guards: _conns
        self._conn_lock = threading.Lock()
        self._conns: set = set()
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address):
        with self._conn_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conn_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def server_close(self):
        super().server_close()
        with self._conn_lock:
            conns, self._conns = list(self._conns), set()
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


class _NoDelayConnection(HTTPConnection):
    """HTTPConnection with TCP_NODELAY: http.client writes headers and
    body in separate sends, and Nagle + delayed ACK turns that into a
    ~40ms stall per request on loopback."""

    def connect(self):
        super().connect()
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # non-TCP transports (tests may stub the socket)


class ConnectionPool:
    """Bounded per-endpoint keep-alive HTTP connection pool.

    Health-aware recycling keeps breaker/failover semantics unchanged: a
    request on a REUSED connection that fails at the socket layer is
    retried exactly once on a fresh connection (the idle keep-alive may
    simply have expired); a fresh-connection failure propagates — that
    is the same signal the old one-connection-per-request path produced,
    so ``_classify`` and the breakers see identical evidence.
    """

    def __init__(self, max_idle_per_endpoint: int = 8,
                 max_idle_s: float = 30.0):
        self.max_idle_per_endpoint = max_idle_per_endpoint
        self.max_idle_s = max_idle_s
        # guards: _idle, _closed, created_total, reused_total, discarded_total, invalidated_total
        self._lock = threading.Lock()
        self._idle: Dict[str, deque] = {}
        self._closed = False
        self.created_total = 0
        self.reused_total = 0
        self.discarded_total = 0
        self.invalidated_total = 0

    def _checkout(self, address, timeout):
        now = time.monotonic()
        with self._lock:
            dq = self._idle.get(address)
            while dq:
                conn, parked_at = dq.pop()  # LIFO: warmest first
                if now - parked_at <= self.max_idle_s:
                    self.reused_total += 1
                    break
                self.discarded_total += 1
                _close_quiet(conn)
            else:
                conn = None
        if conn is not None:
            conn.timeout = timeout
            if conn.sock is not None:
                try:
                    conn.sock.settimeout(timeout)
                except OSError:
                    pass
            return conn, True
        host, _, port = address.partition(":")
        conn = _NoDelayConnection(host, int(port or 80), timeout=timeout)
        with self._lock:
            self.created_total += 1
        return conn, False

    def _checkin(self, address, conn):
        with self._lock:
            if not self._closed:
                dq = self._idle.setdefault(address, deque())
                if len(dq) < self.max_idle_per_endpoint:
                    dq.append((conn, time.monotonic()))
                    return
        _close_quiet(conn)

    def request(self, address, method, path, body=None, headers=None,
                timeout=None):
        """Issue one HTTP request over a pooled connection.  Returns
        ``(status, headers_dict, body_bytes)``; socket-layer failures
        raise exactly as the unpooled path did."""
        for _attempt in (0, 1):
            conn, reused = self._checkout(address, timeout)
            try:
                conn.request(method, path, body=body,
                             headers=dict(headers or {}))
                resp = conn.getresponse()
                data = resp.read()
            except Exception:
                _close_quiet(conn)
                with self._lock:
                    self.discarded_total += 1
                if reused:
                    continue  # stale keep-alive: one retry on a fresh conn
                raise
            hdrs = dict(resp.getheaders())
            if resp.will_close:
                _close_quiet(conn)
            else:
                self._checkin(address, conn)
            return resp.status, hdrs, data
        raise AssertionError("unreachable")  # pragma: no cover

    def invalidate(self, address):
        """Drop every idle connection to an endpoint (breaker opened,
        worker restarted, address changed)."""
        with self._lock:
            dq = self._idle.pop(address, None) or ()
            self.invalidated_total += len(dq)
        for conn, _t in dq:
            _close_quiet(conn)

    def idle_count(self, address=None) -> int:
        with self._lock:
            if address is not None:
                return len(self._idle.get(address, ()))
            return sum(len(dq) for dq in self._idle.values())

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "idle_connections": sum(len(dq)
                                        for dq in self._idle.values()),
                "created_total": self.created_total,
                "reused_total": self.reused_total,
                "discarded_total": self.discarded_total,
                "invalidated_total": self.invalidated_total,
            }

    def close(self):
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, {}
        for dq in idle.values():
            for conn, _t in dq:
                _close_quiet(conn)


def _close_quiet(conn):
    try:
        conn.close()
    except Exception:
        pass
