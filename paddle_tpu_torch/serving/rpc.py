"""Socket RPC control plane for the multi-process serving cluster.

The port's counterpart of ``paddle_tpu/serving/rpc.py``, frame for
frame: a length-prefixed, CRC-framed request/reply protocol over TCP,
the write-ahead log's ``MAGIC | payload_len | crc32 | payload`` frame
discipline (:mod:`.wal`) with its own magic. One frame is one message:

- payload = ``u32 header_len | JSON header | blob bytes...``. The
  header carries ``id`` / ``kind`` (call, reply, error) / ``method`` /
  ``data`` (JSON-able args or result) / ``blobs`` (name, dtype, shape
  per binary attachment, in payload order) / optional ``trace`` (the
  controller's trace id, which stitches request spans across the
  process boundary).
- Binary attachments (KV-page exports, fabric entries) ride as raw
  bytes after the header. They are numpy arrays; a bf16 page travels
  as the host tier's ``uint8`` encoding plus its ``meta``
  (:meth:`.host_tier.HostPageStore.encode`), never as a tensor. The
  frame CRC covers header and blobs together.

The bytes on the wire are the JAX package's, so a port client talks to
a JAX server and the other way round. Large attachments are not copied
into a frame: a frame is sent as its parts (the header, then each
blob's own buffer) and its CRC is folded over the parts (:func:`_crc32`
on worker threads for a large blob, combined as zlib's
``crc32_combine``); a received frame lands in one buffer, from which
the blobs are sliced without another copy. A transport's ``alloc``
chooses that buffer (a replica on the card receives a large frame
straight into pinned host memory, from which its pages go up without
being staged again). A multi-page KV handoff thus costs one copy on
each side (the socket's), not three.

Failure discipline:

- a torn frame (EOF mid-frame), a bit-flipped frame (CRC mismatch) or
  a bad magic NEVER installs anything: the receiver counts the event
  and drops the connection; the peer reconnects.
- :class:`RpcClient` retries transport-level failures with bounded
  exponential backoff (``min(cap, base * 2**(attempt-1))``, injectable
  sleep), reconnecting between attempts. Retries are safe because
  :class:`RpcServer` keeps a bounded per-client dedupe cache of
  serialized replies: a retried call whose first attempt did execute
  replays the cached reply instead of executing twice (exactly once
  for submit, adopt and finish).
- retry exhaustion raises a structured :class:`ReplicaUnreachable`,
  never a hang or a silent drop; the cluster maps it to the
  ``replica_unreachable`` finish reason (``engine_dead`` means the
  remote supervisor's circuit breaker opened).
- remote application exceptions travel as typed error envelopes and
  are raised client-side as the port's classes (``PoolExhausted``,
  ``CorruptionDetected``, ``StepStalled``, ``EngineDead``, ...), so the
  cluster's handoff and failover except-clauses work unchanged across
  the process boundary. Unmapped types raise :class:`RpcRemoteError`.

Fault sites (fire BEFORE any commit): ``rpc_send`` before a frame hits
the socket, ``rpc_recv`` before a received reply is decoded. An
injected fault at either is handled as a transport failure (drop the
connection, bounded retry).

The transport is injectable (anything with ``send_frame`` /
``recv_frame`` / ``settimeout`` / ``close``) so the retry, dedupe and
error machinery is testable without sockets; ``socket.socketpair``
drives the torn / corrupt / half-closed checks.

Host-side only: no torch, no device work.
"""
from __future__ import annotations

import itertools
import json
import os
import socket
import struct
import threading
import time
import zlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..observability import hooks as _obs
from .paged_cache import PoolExhausted
from .resilience import (_CRC_CHUNK, CorruptionDetected, EngineDead,
                         InjectedFault, StepStalled, _crc32, _multmodp,
                         _x8nmodp, fault_point)

#: the RPC frame magic: the WAL's ``magic|len|crc32`` header struct with
#: a distinct magic, so a WAL segment fed to a socket (or the other way
#: round) is rejected as corrupt instead of parsed
MAGIC = b"PTRC"
_HDR = struct.Struct("<4sII")
_U32 = struct.Struct("<I")

#: hard ceiling on one frame's payload: a corrupt length field must not
#: make the receiver try to allocate gigabytes
MAX_FRAME_BYTES = 1 << 30


class RpcError(RuntimeError):
    """Base transport-level failure (retryable: the client drops the
    connection, reconnects and retries under its bounded budget)."""


class RpcClosed(RpcError):
    """The peer closed the stream cleanly between frames."""


class RpcTornFrame(RpcError):
    """EOF mid-frame: the sender died (or half-closed the socket) partway
    through a write; the partial bytes are discarded."""


class RpcCorruptFrame(RpcError):
    """Frame failed validation (bad magic, oversized length or CRC
    mismatch), detected before anything is decoded or installed."""


class RpcTimeout(RpcError):
    """One attempt exceeded its deadline waiting on the socket."""


class ReplicaUnreachable(RuntimeError):
    """The client's bounded retry budget is exhausted: the replica
    process is gone (or the network to it is). Carries the replica
    ``label`` and the last transport error, so the router can fail over
    and finish orphaned sessions with the ``replica_unreachable``
    reason instead of ``engine_dead``."""

    def __init__(self, label: str, detail: str = ""):
        self.label = label
        super().__init__(
            f"replica {label!r} unreachable after bounded retries"
            + (f": {detail}" if detail else ""))


class RpcRemoteError(RuntimeError):
    """A remote exception type the envelope mapping does not know,
    raised with the remote type name and message preserved."""

    def __init__(self, etype: str, detail: str = ""):
        self.etype = etype
        super().__init__(f"remote {etype}: {detail}")


# ---------------------------------------------------------------------------
# message codec


def _json_default(o):
    """JSON fallback for the numpy scalars that ride inside otherwise
    plain dicts (load_stats snapshots, export metadata)."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON-able on the RPC wire: {type(o)!r}")


def _crc_parts(parts) -> int:
    """``zlib.crc32`` of the parts' concatenation without joining them:
    small parts fold in one by one, a large one is checksummed on worker
    threads (:func:`_crc32`) and combined (zlib's ``crc32_combine``)."""
    crc = 0
    for p in parts:
        n = len(p)
        if n > 2 * _CRC_CHUNK:
            crc = _multmodp(_x8nmodp(n), crc) ^ _crc32(
                np.frombuffer(p, np.uint8))
        else:
            crc = zlib.crc32(p, crc)
    return crc & 0xFFFFFFFF


def encode_frame(header: Dict,
                 blobs: Optional[Dict[str, np.ndarray]] = None
                 ) -> List[memoryview]:
    """One message -> its frame as a list of buffers: the frame header
    with the JSON header first, then each blob's own bytes (no copy).
    ``blobs`` ride as raw bytes after the JSON header; their (name,
    dtype, shape) manifest is folded into the header so the receiver
    can slice them back out."""
    arrs = {k: np.ascontiguousarray(v) for k, v in (blobs or {}).items()}
    header = dict(header)
    header["blobs"] = [{"name": k, "dtype": str(a.dtype),
                        "shape": list(a.shape)}
                       for k, a in arrs.items()]
    hb = json.dumps(header, separators=(",", ":"),
                    default=_json_default).encode("utf-8")
    body = [_U32.pack(len(hb)) + hb] + [
        memoryview(a.reshape(-1).view(np.uint8)) for a in arrs.values()]
    n = sum(len(p) for p in body)
    head = _HDR.pack(MAGIC, n, _crc_parts(body)) + body[0]
    return [memoryview(head)] + body[1:]


def frame_bytes(frame) -> int:
    """Length of a frame given as bytes or as :func:`encode_frame`
    parts."""
    if isinstance(frame, (bytes, bytearray, memoryview)):
        return len(frame)
    return sum(len(p) for p in frame)


def encode_message(header: Dict,
                   blobs: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    """One message -> one CRC-framed byte string (the parts of
    :func:`encode_frame` joined: the JAX package's bytes)."""
    return b"".join(encode_frame(header, blobs))


def decode_message(payload) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Inverse of :func:`encode_message` (the frame CRC has already been
    verified by the transport). Blobs of a received buffer are slices of
    it, which the caller owns; blobs of immutable ``bytes`` are copied
    out so that callers own writable storage either way."""
    (hlen,) = _U32.unpack_from(payload, 0)
    header = json.loads(bytes(payload[_U32.size:_U32.size + hlen])
                        .decode("utf-8"))
    off = _U32.size + hlen
    owned = not isinstance(payload, bytes)
    blobs: Dict[str, np.ndarray] = {}
    for m in header.pop("blobs", []):
        dt = np.dtype(m["dtype"])
        count = int(np.prod(m["shape"], dtype=np.int64)) if m["shape"] \
            else 1
        arr = np.frombuffer(payload, dtype=dt, count=count,
                            offset=off).reshape(m["shape"])
        blobs[m["name"]] = arr if owned else arr.copy()
        off += count * dt.itemsize
    return header, blobs


# ---------------------------------------------------------------------------
# transports


class SocketTransport:
    """Blocking framed byte stream over a connected TCP socket.
    ``alloc(n)``, when given, returns the writable buffer a received
    payload of ``n`` bytes lands in (default a ``bytearray``)."""

    def __init__(self, sock: socket.socket, alloc=None):
        self.sock = sock
        self._alloc = alloc or bytearray

    @classmethod
    def connect(cls, host: str, port: int,
                timeout: Optional[float] = 10.0,
                alloc=None) -> "SocketTransport":
        sock = socket.create_connection((host, int(port)),
                                        timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return cls(sock, alloc)

    def settimeout(self, seconds: Optional[float]) -> None:
        self.sock.settimeout(seconds)

    def send_frame(self, frame) -> None:
        """Send one frame: bytes, or the parts of :func:`encode_frame`
        (each part's buffer goes to the socket as it is)."""
        if isinstance(frame, (bytes, bytearray, memoryview)):
            self.sock.sendall(frame)
            return
        for part in frame:
            self.sock.sendall(part)

    def recv_frame(self):
        """One frame's payload, CRC-checked, in a buffer of its own."""
        hdr = self._recv_exact(_HDR.size, frame_start=True)
        magic, length, crc = _HDR.unpack(hdr)
        if magic != MAGIC:
            raise RpcCorruptFrame(f"bad magic {magic!r}")
        if length > MAX_FRAME_BYTES:
            raise RpcCorruptFrame(f"frame length {length} exceeds "
                                  f"{MAX_FRAME_BYTES}")
        payload = self._recv_exact(length, frame_start=False,
                                   alloc=self._alloc)
        if _crc_parts([payload]) != crc:
            raise RpcCorruptFrame("payload crc mismatch")
        return payload

    def _recv_exact(self, n: int, frame_start: bool, alloc=bytearray):
        buf = alloc(n)
        view = memoryview(buf).cast("B")
        got = 0
        while got < n:
            try:
                k = self.sock.recv_into(view[got:], min(1 << 24, n - got))
            except socket.timeout as e:
                raise RpcTimeout(f"socket recv timed out "
                                 f"({got}/{n} bytes)") from e
            if not k:
                if frame_start and not got:
                    raise RpcClosed("peer closed the stream")
                raise RpcTornFrame(f"EOF mid-frame after {got}/{n} bytes")
            got += k
        return buf

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


_CLIENT_SEQ = itertools.count(1)
#: this process's part of every client token: the pid alone would let a
#: later process that reuses it (or a second RPC package in this one)
#: collide with an earlier client's cached replies on a long-lived
#: server
_CLIENT_NONCE = f"{os.getpid()}.{os.urandom(4).hex()}"


class RpcClient:
    """One logical connection to one RPC server, with bounded idempotent
    retry. ``connect`` is any zero-arg callable returning a transport
    (injectable for tests); :meth:`dial` wires the TCP default. Calls
    are serialized per client (the cluster's control plane is
    synchronous by design)."""

    def __init__(self, connect: Callable[[], object], *,
                 label: str = "replica", retries: int = 3,
                 timeout_s: Optional[float] = 60.0,
                 backoff_s: float = 0.005, max_backoff_s: float = 0.2,
                 sleep: Callable[[float], None] = time.sleep):
        self._connect = connect
        self.label = label
        self.retries = int(retries)
        self.timeout_s = timeout_s
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self._sleep = sleep
        self._t = None
        self._lock = threading.Lock()
        # globally unique call ids: the server's dedupe cache is keyed
        # by (client token, call id) so two clients never collide
        self._token = f"{_CLIENT_NONCE}.{next(_CLIENT_SEQ)}"
        self._id = 0
        self.retries_total = 0
        self.timeouts_total = 0

    def call(self, method: str, data: Optional[Dict] = None,
             blobs: Optional[Dict[str, np.ndarray]] = None, *,
             trace: Optional[int] = None,
             timeout_s: Optional[float] = None,
             retries: Optional[int] = None) -> Tuple[Dict, Dict]:
        """One request/reply exchange. Returns ``(data, blobs)`` from the
        reply; raises the re-mapped remote exception on an error
        envelope, :class:`ReplicaUnreachable` on retry exhaustion."""
        with self._lock:
            return self._call(method, data, blobs, trace,
                              self.timeout_s if timeout_s is None
                              else timeout_s,
                              self.retries if retries is None
                              else int(retries))

    def _call(self, method, data, blobs, trace, timeout, retries):
        self._id += 1
        header = {"id": self._id, "client": self._token,
                  "kind": "call", "method": method,
                  "data": data if data is not None else {}}
        if trace is not None:
            header["trace"] = int(trace)
        frame = encode_frame(header, blobs)
        last: Optional[BaseException] = None
        for attempt in range(retries + 1):
            if attempt:
                self.retries_total += 1
                _obs.serving_rpc_retry(method)
                self._sleep(min(self.max_backoff_s,
                                self.backoff_s * 2 ** (attempt - 1)))
            t0 = _obs.generate_begin()
            try:
                t = self._transport(timeout)
                fault_point("rpc_send")
                t.send_frame(frame)
                payload = t.recv_frame()
                fault_point("rpc_recv")
                reply, rblobs = decode_message(payload)
                if reply.get("id") != self._id:
                    raise RpcCorruptFrame(
                        f"reply id {reply.get('id')} != {self._id}")
                _obs.serving_rpc_call(method, t0, frame_bytes(frame),
                                      len(payload))
            except RpcTimeout as e:
                self.timeouts_total += 1
                _obs.serving_rpc_timeout(method)
                self._drop()
                last = e
            except (RpcError, InjectedFault, OSError) as e:
                if isinstance(e, RpcCorruptFrame):
                    _obs.serving_rpc_corrupt("crc")
                elif isinstance(e, RpcTornFrame):
                    _obs.serving_rpc_corrupt("torn")
                self._drop()
                last = e
            else:
                # raised OUTSIDE the try: a remote application exception
                # (CorruptionDetected, PoolExhausted, ...) must reach the
                # caller's except-clauses, not the transport-retry catch
                # above (CorruptionDetected IS an InjectedFault)
                if reply.get("kind") == "error":
                    raise remote_exception(reply)
                return reply.get("data"), rblobs
        raise ReplicaUnreachable(self.label, f"{method}: {last!r}")

    @classmethod
    def dial(cls, host: str, port: int, alloc=None, **kw) -> "RpcClient":
        """A client over TCP; ``alloc`` as :class:`SocketTransport`'s."""
        return cls(lambda: SocketTransport.connect(host, port, alloc=alloc),
                   **kw)

    def _transport(self, timeout):
        if self._t is None:
            self._t = self._connect()
        if timeout is not None and hasattr(self._t, "settimeout"):
            self._t.settimeout(timeout)
        return self._t

    def _drop(self) -> None:
        if self._t is not None:
            try:
                self._t.close()
            except Exception:  # noqa: BLE001 - close is best-effort
                pass
            self._t = None

    def close(self) -> None:
        with self._lock:
            self._drop()


# ---------------------------------------------------------------------------
# remote-exception envelopes


def encode_exception(e: BaseException) -> Dict:
    """Exception -> JSON-able error-envelope fields."""
    out = {"kind": "error", "etype": type(e).__name__,
           "detail": str(e)}
    if isinstance(e, CorruptionDetected):
        out["eargs"] = [e.site]
    elif isinstance(e, InjectedFault):
        out["eargs"] = [e.site, e.mode]
    return out


#: remote type name -> rebuild(args, detail). The mapped classes are the
#: ones the cluster's handoff and failover paths tell apart; anything
#: else becomes an RpcRemoteError
_EXC_TYPES = {
    "PoolExhausted": lambda a, d: PoolExhausted(d),
    "CorruptionDetected":
        lambda a, d: CorruptionDetected(a[0] if a else "rpc"),
    "InjectedFault":
        lambda a, d: InjectedFault(a[0] if a else "rpc",
                                   a[1] if len(a) > 1 else "raise"),
    "StepStalled": lambda a, d: StepStalled(0.0),
    "EngineDead": lambda a, d: EngineDead(d),
    "ValueError": lambda a, d: ValueError(d),
    "KeyError": lambda a, d: KeyError(d),
    "RuntimeError": lambda a, d: RuntimeError(d),
}


def remote_exception(reply: Dict) -> BaseException:
    """Error envelope -> the exception to raise client-side."""
    build = _EXC_TYPES.get(reply.get("etype", ""))
    if build is None:
        return RpcRemoteError(reply.get("etype", "?"),
                              reply.get("detail", ""))
    return build(reply.get("eargs", []), reply.get("detail", ""))


# ---------------------------------------------------------------------------
# server


class RpcServer:
    """Threaded TCP server dispatching framed calls to ``handler``'s
    ``rpc_<method>(data, blobs)`` methods (returning ``data`` or
    ``(data, blobs)``). Dispatch is serialized under one lock: a replica
    node is single-engine, so concurrency lives between processes, not
    within one. Corrupt or torn inbound frames are counted and drop the
    connection (the client reconnects and retries); replies to call ids
    already executed replay from a bounded dedupe cache, so a retried
    call never executes twice. The cache keeps each client's LAST reply
    only: a client's calls are serialized, so it never retries an older
    one, and a reply's blobs (a handoff's pages, in pinned memory on
    the card) are released as soon as its client moves on."""

    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0,
                 dedupe: int = 64, alloc=None):
        self.handler = handler
        self._alloc = alloc
        self._dedupe = int(dedupe)
        self._lock = threading.Lock()
        # client token -> (call id, the reply frame's parts)
        self._replies: "OrderedDict[str, Tuple[int, List]]" = \
            OrderedDict()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()[:2]
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.frames_served = 0
        self.corrupt_frames = 0
        self.deduped_replies = 0
        #: host nanoseconds of dispatch (handler + reply encode), by
        #: method: a client's wall time less this is the wire's share
        self.served_ns: Dict[str, int] = {}

    def start(self) -> "RpcServer":
        """Accept loop in a daemon thread (in-process servers: the
        fabric in tests, loopback nodes)."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True, name="rpc-accept")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Accept loop inline (a worker process's main loop). Returns
        when :meth:`shutdown` closes the listener."""
        while not self._done.is_set():
            try:
                sock, _ = self._sock.accept()
            except OSError:
                break
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(sock,),
                             daemon=True, name="rpc-conn").start()

    def _serve_conn(self, sock: socket.socket) -> None:
        t = SocketTransport(sock, self._alloc)
        while not self._done.is_set():
            try:
                payload = t.recv_frame()
            except RpcClosed:
                break
            except (RpcTornFrame, RpcCorruptFrame) as e:
                self.corrupt_frames += 1
                _obs.serving_rpc_corrupt(
                    "torn" if isinstance(e, RpcTornFrame) else "crc")
                break
            except (RpcTimeout, OSError):
                break
            try:
                header, blobs = decode_message(payload)
            except Exception:  # noqa: BLE001 - undecodable after CRC
                self.corrupt_frames += 1
                _obs.serving_rpc_corrupt("crc")
                break
            try:
                t.send_frame(self._dispatch(header, blobs))
            except OSError:
                break
        t.close()

    def _dispatch(self, header: Dict, blobs: Dict) -> List:
        key = (str(header.get("client", "")), int(header.get("id", 0)))
        method = str(header.get("method", ""))
        with self._lock:
            cached = self._replies.get(key[0])
            if cached is not None and cached[0] == key[1]:
                self.deduped_replies += 1
                return cached[1]
            t0 = _obs.generate_begin()
            t_ns = time.perf_counter_ns()
            reply = {"id": key[1], "kind": "reply"}
            oblobs = None
            try:
                fn = getattr(self.handler, "rpc_" + method, None)
                if fn is None:
                    raise ValueError(f"no such RPC method {method!r}")
                out = fn(header.get("data") or {}, blobs)
                data, oblobs = out if isinstance(out, tuple) \
                    else (out, None)
                reply["data"] = data
            except BaseException as e:  # noqa: BLE001 - envelope relay
                reply.update(encode_exception(e))
                oblobs = None
            frame = encode_frame(reply, oblobs)
            self.served_ns[method] = (self.served_ns.get(method, 0)
                                      + time.perf_counter_ns() - t_ns)
            self.frames_served += 1
            _obs.serving_rpc_served(method, t0)
            self._replies.pop(key[0], None)
            self._replies[key[0]] = (key[1], frame)
            while len(self._replies) > self._dedupe:
                self._replies.popitem(last=False)
            return frame

    def shutdown(self) -> None:
        self._done.set()
        try:
            # wakes an accept() blocked in another thread, which a close
            # alone does not on Linux
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
