"""Framed socket transport for the distributed serve fleet (counterpart
of ``singa_tpu/serve/dist/transport.py``; the bytes on the wire are the
JAX transport's).

One wire format for everything the fleet says to a worker peer:
length-prefixed, versioned, crc-checked frames over a plain TCP
socket.  Three message kinds ride it —

* ``CALL``/``REPLY`` — the synchronous control RPC the fleet drives a
  replica with (submit/step/build/export/...).  Every call carries a
  sequence number, a typed timeout, and an optional bounded
  retry-with-backoff for idempotent operations;
* ``ONEWAY`` — fire-and-forget messages that must not stall the
  sender: streamed KV ship frames (dist/fleet.py relays them to the
  destination while the source is still prefilling) and best-effort
  aborts/shutdowns;
* ``HELLO`` — the connect-time handshake: a worker proves it belongs
  to THIS fleet (shared token, compared constant-time, plus a single-
  use session nonce) and says which replica index it is;
* ``RESUME`` — the reconnect handshake: a worker whose socket dropped
  redials and offers to CONTINUE its session (fencing epoch +
  last-executed seq, HMAC-authenticated) instead of being respawned —
  the controller replays the one unacked CALL and routing resumes
  with the worker's captured decode steps intact.

Frame layout (all integers network byte order)::

    | magic 'STPU' | u8 proto | u8 kind | u32 crc32(payload) |
    | u64 length   | payload (pickle)                        |

Every payload is decoded by a restricted unpickler
(:class:`_WireUnpickler`): it rebuilds numpy arrays, dtypes and scalars
and the port's own wire types (``ModelSpec``, its factories, the model
configuration) and nothing else, so a peer's bytes call no other code.
A frame that names any other global, or fails the magic, version, crc
or length checks, raises :class:`TransportError` — the stream is unusable after that (framing
lost), so callers escalate to peer loss.  Socket-level failures map to
the PEER-LOSS family: :class:`PeerGoneError` subclasses
``RestartBudgetExceededError`` ON PURPOSE — to the fleet, a worker
that dropped off the network and a supervisor that spent its restart
budget are the same event ("this replica cannot serve; fail over"),
so every existing fleet path (admission, step, ship driving) handles a
partition with zero new code.  :class:`PeerTimeoutError` narrows it
for calls that exceeded their deadline after retries.

Heartbeats are PIGGYBACKED: every received frame refreshes the
connection's ``last_rx`` clock, so a busy peer never pays a separate
ping, and ``Conn.age()`` tells the fleet's watchdog how stale a quiet
peer is (it pings only those — serve/dist/fleet.py
``_check_watchdog``).

The ``serve.dist.rpc`` fault site is checked on the CALLER side of
every RPC (when armed): a fired fault is a modeled network partition —
the peer process is still alive, but this side treats it as gone,
which is exactly what a partition looks like from one end.
"""

from __future__ import annotations

import hashlib
import hmac
import io
import os
import pickle
import random
import socket
import struct
import time
import zlib

from ...resilience import faults as _faults
from ...utils.logging import get_channel
from ..request import RestartBudgetExceededError

__all__ = ["PROTO_VERSION", "TransportError", "PeerGoneError",
           "PeerTimeoutError", "StaleEpochError",
           "NonIdempotentReplayError", "IDEMPOTENT_OPS", "Conn",
           "Listener", "MSG_CALL", "MSG_REPLY", "MSG_ONEWAY",
           "MSG_HELLO", "MSG_RESUME", "resume_auth"]

#: bump when the frame layout or the RPC envelope changes; a peer on a
#: different proto version fails the handshake typed instead of
#: misparsing frames
PROTO_VERSION = 1

MSG_CALL = 1
MSG_REPLY = 2
MSG_ONEWAY = 3
MSG_HELLO = 4
MSG_RESUME = 5

#: ops a reconnecting controller may safely RE-ISSUE under a fresh seq
#: when replay state has diverged (the worker may have executed the
#: lost call once already).  Everything else — submit, step, the ship/
#: build protocol — mutates worker state in a way a blind second
#: delivery would corrupt (double-admit, double-step), so divergence
#: on those aborts typed via :class:`NonIdempotentReplayError` and the
#: fleet's normal failover reconciles instead.
IDEMPOTENT_OPS = frozenset({
    "ping", "clock", "snapshot", "telemetry", "prefix_lookup",
    "validate", "cache_release", "session_release", "build_abandon",
    "abandon", "reconcile", "describe", "shutdown", "die",
})

_MAGIC = b"STPU"
_HEAD = struct.Struct("!4sBBIQ")
#: refuse absurd frame lengths before allocating: the largest honest
#: payload is a KV image of a test/bench pool (MBs); 1 GiB means a
#: corrupted length field, not a message
_MAX_FRAME = 1 << 30


#: the globals a frame may name: numpy's array, dtype and scalar
#: reconstructors (``numpy.core`` before numpy 2, ``numpy._core`` after),
#: the compute dtypes an engine takes, and the port's wire types (the
#: worker's model recipe and the engine's configuration objects)
_PKG = __name__.split(".")[0]
_WIRE_GLOBALS = frozenset(
    [(f"numpy.{core}.{mod}", name)
     for core in ("core", "_core")
     for mod, name in (("multiarray", "_reconstruct"),
                       ("multiarray", "scalar"),
                       ("numeric", "_frombuffer"))]
    + [("numpy", "ndarray"), ("numpy", "dtype")]
    + [("torch", name) for name in ("float32", "bfloat16", "float16")]
    + [(f"{_PKG}.{mod}", name) for mod, name in (
        ("serve.dist.worker", "ModelSpec"),
        ("serve.dist.worker", "gpt2_factory"),
        ("models.gpt2", "GPT2Config"),
        ("serve.paged", "PagedConfig"),
        ("serve.prefix", "PrefixCacheConfig"),
        ("observe.health", "SLO"))])


class _WireUnpickler(pickle.Unpickler):
    """Decodes a frame's payload, refusing every global outside
    :data:`_WIRE_GLOBALS`: plain containers, numpy payloads and the
    port's wire types come back, and nothing else is called."""

    def find_class(self, module, name):
        if (module, name) not in _WIRE_GLOBALS:
            raise pickle.UnpicklingError(
                f"frame names the global {module}.{name}, which is not a "
                f"wire type")
        return super().find_class(module, name)


def _loads(payload, label):
    try:
        return _WireUnpickler(io.BytesIO(payload)).load()
    except Exception as e:
        raise TransportError(
            f"frame from peer {label or '?'} undecodable: {e}") from e


class TransportError(RuntimeError):
    """The byte stream itself is broken: bad magic, proto-version
    skew, a crc mismatch, or a length-lying frame.  Framing is lost
    after this — the connection cannot be trusted for another
    message, so callers escalate to peer loss."""


class PeerGoneError(RestartBudgetExceededError):
    """The worker peer is unreachable (connection reset, EOF,
    injected partition, or timeouts past the retry budget).

    Subclasses :class:`RestartBudgetExceededError` deliberately: the
    fleet's existing failure handling — mark the replica down, reject
    its outstanding work typed, requeue the never-started part onto
    healthy siblings — is EXACTLY the right response to a partitioned
    host, and inheriting the type means every ``except
    RestartBudgetExceededError`` site in serve/fleet.py handles
    partitions with no dist-specific code."""


class PeerTimeoutError(PeerGoneError):
    """A call exceeded its deadline (after any retries).  Still peer
    loss — a peer that cannot answer within the budget is
    indistinguishable from a dead one, and waiting longer would stall
    the whole fleet's step loop."""


class StaleEpochError(RuntimeError):
    """The frame carried a fencing epoch older than the receiver's:
    the sender is a DEPOSED controller (someone adopted this worker
    under a higher epoch).  Refused typed on every op so split-brain
    dual routing is impossible by construction — a stale controller
    cannot step, submit to, or ship through a fenced worker.  Crosses
    the wire (registered in the worker's error table)."""


class NonIdempotentReplayError(PeerGoneError):
    """A reconnect found an unacked in-flight CALL whose replay state
    diverged AND whose op is not in :data:`IDEMPOTENT_OPS`: the worker
    may have executed it exactly once already, and re-issuing could
    double-admit or double-step.  Controller-side only — subclasses
    :class:`PeerGoneError` so the fleet's existing failover path
    (reject started work typed, requeue never-started) reconciles."""


def _full_jitter(rng, base, attempt, cap):
    """Full-jitter backoff: uniform in ``[0, min(base·2^attempt, cap))``
    — N workers redialing a restarted controller decorrelate instead
    of thundering in lockstep (the ``RetryPolicy.seed=None`` idiom)."""
    return rng.random() * min(base * (2.0 ** attempt), cap)


def resume_auth(token, nonce, idx, epoch, last_seq) -> str:
    """HMAC proving a RESUME frame was minted by a holder of the fleet
    token for THIS (nonce, replica, epoch, seq) tuple — a captured
    frame replays as garbage under any other session nonce."""
    key = token if isinstance(token, (bytes, bytearray)) else \
        str(token).encode()
    msg = f"{nonce}:{int(idx)}:{int(epoch)}:{int(last_seq)}".encode()
    return hmac.new(bytes(key), msg, hashlib.sha256).hexdigest()


def _recv_exact(sock, n):
    """Read exactly ``n`` bytes or raise on EOF mid-read (the
    mid-stream-EOF case: a peer that died between frames raises
    PeerGone at the next read; one that died MID-frame raises here)."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise PeerGoneError(
                f"peer closed the stream mid-frame ({len(buf)} of {n} "
                f"bytes read)", started=None)
        buf.extend(chunk)
    return bytes(buf)


class Conn:
    """One framed connection to a peer.  Single-threaded by design —
    the fleet drives every replica from its own loop, and the worker
    loop is strictly serial — so there is no locking, only framing.

    ``label`` is used in error messages and logs ("r2", "listener").
    """

    def __init__(self, sock, label=""):
        self.sock = sock
        self.label = label
        self.last_rx = time.monotonic()
        self._seq = 0
        #: fencing epoch stamped into every CALL/ONEWAY envelope when
        #: set — workers refuse stale epochs typed (StaleEpochError)
        self.epoch = None
        #: the one unacked in-flight CALL ``(seq, op, payload)`` —
        #: what a reconnect must replay (the protocol is strictly
        #: serial, so there is never more than one)
        self._pending = None
        #: OS-entropy rng for full-jitter backoff — deliberately NOT
        #: seeded so concurrent redialers decorrelate
        self._rng = random.Random()
        self._log = get_channel("serve")
        # transport self-observability (attach_metrics): None until a
        # registry attaches — the unobserved cost is one truthiness
        # check per frame
        self._m_frames = None
        self._m_bytes = None
        self._m_retries = None
        self._m_rtt = None
        # TCP_NODELAY: RPCs are small request/response frames; Nagle
        # would add 40ms floors to every fleet step
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass

    def attach_metrics(self, reg, peer, **labels) -> list:
        """Register this connection's per-peer transport metrics:
        ``serve.dist.{frames,bytes,retries}{peer=}`` counters (frames/
        bytes cover BOTH directions — everything that crossed this
        socket) and a ``serve.dist.rtt_s{peer=}`` histogram observed
        per successful ``call`` round trip (the bucket ladder starts
        at 10µs — loopback RPCs live far below the default 1ms
        floor).  Returns the metric objects so the owner can
        ``registry.remove(*them)`` on retire — the
        retire-unregisters contract."""
        lbl = dict(labels, peer=str(peer))
        self._m_frames = reg.counter(
            "serve.dist.frames",
            help="framed messages crossing this peer connection "
                 "(both directions)", **lbl)
        self._m_bytes = reg.counter(
            "serve.dist.bytes",
            help="wire bytes crossing this peer connection (headers "
                 "included, both directions)", **lbl)
        self._m_retries = reg.counter(
            "serve.dist.retries",
            help="RPC timeout retries re-sent on this connection",
            **lbl)
        self._m_rtt = reg.histogram(
            "serve.dist.rtt_s",
            help="RPC round-trip seconds to this peer (send -> "
                 "matching reply)",
            buckets=(1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3,
                     2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0), **lbl)
        return [self._m_frames, self._m_bytes, self._m_retries,
                self._m_rtt]

    # -- framing ---------------------------------------------------------
    def send(self, kind, obj):
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        head = _HEAD.pack(_MAGIC, PROTO_VERSION, kind,
                          zlib.crc32(payload) & 0xFFFFFFFF,
                          len(payload))
        try:
            self.sock.sendall(head + payload)
        except (OSError, ValueError) as e:
            raise PeerGoneError(
                f"send to peer {self.label or '?'} failed: {e!r}",
                started=None) from e
        if self._m_frames is not None:
            self._m_frames.inc()
            self._m_bytes.inc(_HEAD.size + len(payload))

    def recv(self, timeout=None):
        """One ``(kind, obj)`` frame.  ``timeout`` None blocks
        forever (the worker loop's idle state); a number raises
        :class:`PeerTimeoutError` on expiry."""
        try:
            self.sock.settimeout(timeout)
            head = _recv_exact(self.sock, _HEAD.size)
        except socket.timeout as e:
            raise PeerTimeoutError(
                f"no frame from peer {self.label or '?'} within "
                f"{timeout}s", started=None) from e
        except OSError as e:
            raise PeerGoneError(
                f"recv from peer {self.label or '?'} failed: {e!r}",
                started=None) from e
        magic, proto, kind, crc, length = _HEAD.unpack(head)
        if magic != _MAGIC:
            raise TransportError(
                f"bad frame magic {magic!r} from peer "
                f"{self.label or '?'}: stream framing lost")
        if proto != PROTO_VERSION:
            raise TransportError(
                f"peer {self.label or '?'} speaks proto {proto}, this "
                f"side {PROTO_VERSION}: refuse rather than misparse")
        if length > _MAX_FRAME:
            raise TransportError(
                f"frame length {length} exceeds the {_MAX_FRAME} "
                f"bound: corrupted length field")
        try:
            payload = _recv_exact(self.sock, length)
        except socket.timeout as e:
            raise PeerTimeoutError(
                f"frame body from peer {self.label or '?'} stalled",
                started=None) from e
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise TransportError(
                f"frame crc mismatch from peer {self.label or '?'}: "
                f"payload corrupted in transit")
        self.last_rx = time.monotonic()
        if self._m_frames is not None:
            self._m_frames.inc()
            self._m_bytes.inc(_HEAD.size + length)
        return kind, _loads(payload, self.label)

    def age(self) -> float:
        """Seconds since the last successfully received frame — the
        piggybacked heartbeat the fleet's watchdog reads."""
        return time.monotonic() - self.last_rx

    # -- RPC (caller side) -----------------------------------------------
    def send_call(self, op, payload=None) -> int:
        """Low-level CALL send: allocate the next seq, stamp the
        fencing epoch (when set), RECORD the call as pending (so a
        reconnect knows exactly what to replay), and put the frame on
        the wire.  Returns the seq the caller must await."""
        self._seq += 1
        seq = self._seq
        env = {"seq": seq, "op": op, "payload": payload}
        if self.epoch is not None:
            env["epoch"] = self.epoch
        self._pending = (seq, op, payload)
        self.send(MSG_CALL, env)
        return seq

    def resend_pending(self) -> int:
        """Re-put the pending CALL on the (new, post-resume) wire
        under its ORIGINAL seq — first delivery if it never arrived,
        a reply-cache hit on the worker if it did."""
        seq, op, payload = self._pending
        env = {"seq": seq, "op": op, "payload": payload}
        if self.epoch is not None:
            env["epoch"] = self.epoch
        self.send(MSG_CALL, env)
        return seq

    def wait_reply(self, seq, timeout=60.0):
        """Wait for the REPLY matching ``seq``; clears the pending
        record on success.  Stray one-ways are skipped, a wrong-seq
        reply is a framing loss (TransportError)."""
        while True:
            kind, msg = self.recv(timeout)
            if kind != MSG_REPLY:
                # a stray one-way (late ship abort ack etc.) is not
                # an error; skip it
                continue
            if msg.get("seq") != seq:
                raise TransportError(
                    f"out-of-sequence reply from peer "
                    f"{self.label or '?'}: got {msg.get('seq')}, "
                    f"want {seq}")
            self._pending = None
            return msg

    def call(self, op, payload=None, timeout=60.0, retries=0,
             backoff=0.05, backoff_cap=2.0,
             fault_site="serve.dist.rpc"):
        """Synchronous RPC: send ``CALL {seq, op, ...}``, wait for the
        matching ``REPLY``.  ``retries`` re-sends on TIMEOUT only
        (full-jitter backoff capped at ``backoff_cap`` — lockstep
        retry storms decorrelate) and must only be used for idempotent
        ops — a retried ``submit`` could double-admit.  Checks the
        ``fault_site`` (default ``serve.dist.rpc``) first: a fired
        fault is a modeled partition and surfaces as
        :class:`PeerGoneError` with ``no_resume`` set — injected
        partitions must hit the failover path directly, never the
        reconnect window (the peer's socket never actually broke, so
        no redial is coming).  Telemetry pulls pass their OWN site
        (``serve.dist.telemetry``) so a chaos test partitioning the
        control plane never has its injected fault consumed by a
        background telemetry call instead.
        """
        if _faults._armed:
            try:
                _faults.check(fault_site)
            except Exception as e:
                err = PeerGoneError(
                    f"partition injected on RPC {op!r} to peer "
                    f"{self.label or '?'} ({e!r})", started=None)
                err.no_resume = True
                raise err from e
        attempt = 0
        while True:
            t_send = time.monotonic()
            seq = self.send_call(op, payload)
            try:
                msg = self.wait_reply(seq, timeout)
                if self._m_rtt is not None:
                    self._m_rtt.observe(time.monotonic() - t_send)
                return msg
            except PeerTimeoutError:
                if attempt >= retries:
                    raise
                attempt += 1
                if self._m_retries is not None:
                    self._m_retries.inc()
                self._log.warning(
                    "RPC %s to peer %s timed out; retry %d/%d", op,
                    self.label or "?", attempt, retries)
                time.sleep(_full_jitter(self._rng, backoff,
                                        attempt - 1, backoff_cap))

    def finish_pending(self, peer_last_seq, timeout=60.0):
        """Replay the one unacked in-flight CALL after a resume.

        The worker told us (in its RESUME frame) the last seq it
        EXECUTED.  Three cases against our pending ``(seq, op, ...)``:

        * ``seq <= peer_last_seq`` — the call arrived and ran; only
          the reply was lost.  Resend the SAME seq: the worker's
          reply cache answers from memory without re-executing
          (exactly-once by seq dedupe).
        * ``seq == peer_last_seq + 1`` — the call never arrived.
          Resend the same seq: this is first delivery, not a replay.
        * anything else — the seq spaces diverged (should not happen
          on a serial protocol; defensive).  Idempotent ops re-issue
          under a fresh seq; non-idempotent ops abort typed with
          :class:`NonIdempotentReplayError` so failover reconciles.

        Returns the reply message, or None when nothing was pending.
        """
        if self._pending is None:
            return None
        seq, op, payload = self._pending
        if seq <= peer_last_seq + 1:
            self.resend_pending()
            return self.wait_reply(seq, timeout)
        if op in IDEMPOTENT_OPS:
            self._pending = None
            self._seq = max(self._seq, peer_last_seq)
            return self.call(op, payload, timeout=timeout)
        self._pending = None
        raise NonIdempotentReplayError(
            f"cannot replay non-idempotent RPC {op!r} (seq {seq}) to "
            f"peer {self.label or '?'}: peer last executed seq "
            f"{peer_last_seq}; aborting typed rather than risking a "
            f"double execution", started=None)

    def send_oneway(self, op, payload=None):
        """Fire-and-forget (ship frames, aborts): no reply, no seq.
        Carries the fencing epoch when set — a fenced worker silently
        drops stale one-ways (there is no reply channel to refuse on)."""
        env = {"op": op, "payload": payload}
        if self.epoch is not None:
            env["epoch"] = self.epoch
        self.send(MSG_ONEWAY, env)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class Listener:
    """The fleet's accept side: workers dial back here and prove
    membership — HELLO with the shared ``token`` (compared constant-
    time), RESUME with an HMAC over a per-session nonce.  Nonces are
    single-use per listener: a captured handshake frame replayed
    against the same listener is refused."""

    def __init__(self, host="127.0.0.1", port=0, token=b""):
        self.token = token
        self._log = get_channel("serve")
        #: nonces already accepted — replaying a captured HELLO/RESUME
        #: frame (same nonce) is refused even with a valid token/HMAC
        self._seen_nonces = set()
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(64)
        self.host, self.port = self.sock.getsockname()

    def _check_nonce(self, frame, addr, conn):
        nonce = frame.get("nonce")
        if not isinstance(nonce, str) or not nonce \
                or nonce in self._seen_nonces:
            conn.close()
            raise TransportError(
                f"handshake from {addr} refused: missing or replayed "
                f"session nonce")
        self._seen_nonces.add(nonce)
        # bound the set — a long-lived listener must not grow without
        # limit; dropping ancient nonces only re-opens replay of
        # frames older than 4096 handshakes, far past any socket's TTL
        if len(self._seen_nonces) > 4096:
            self._seen_nonces.pop()

    def accept_any(self, timeout=120.0):
        """Accept one inbound connection and classify its first frame.
        Returns ``(kind, frame, Conn)`` where kind is MSG_HELLO (fresh
        worker) or MSG_RESUME (a worker redialing after a drop) — the
        caller routes them to registration vs session resume.  Both
        handshakes are verified here: token via ``hmac.compare_digest``
        for HELLO, the nonce-keyed HMAC for RESUME."""
        self.sock.settimeout(timeout)
        try:
            sock, addr = self.sock.accept()
        except socket.timeout as e:
            raise PeerTimeoutError(
                f"no worker connected within {timeout}s",
                started=None) from e
        conn = Conn(sock)
        kind, frame = conn.recv(timeout=timeout)
        if kind == MSG_HELLO:
            tok = frame.get("token")
            ours = self.token if isinstance(self.token, bytes) \
                else str(self.token).encode()
            theirs = tok if isinstance(tok, bytes) else \
                str(tok).encode() if tok is not None else b""
            if not hmac.compare_digest(theirs, ours) \
                    or frame.get("proto") != PROTO_VERSION:
                conn.close()
                raise TransportError(
                    f"worker handshake from {addr} refused (token or "
                    f"proto mismatch: proto={frame.get('proto')})")
            self._check_nonce(frame, addr, conn)
        elif kind == MSG_RESUME:
            if frame.get("proto") != PROTO_VERSION:
                conn.close()
                raise TransportError(
                    f"resume from {addr} refused (proto "
                    f"{frame.get('proto')})")
            want = resume_auth(self.token, frame.get("nonce", ""),
                               frame.get("idx", -1),
                               frame.get("epoch", -1),
                               frame.get("last_seq", -1))
            got = frame.get("auth", "")
            if not isinstance(got, str) \
                    or not hmac.compare_digest(got, want):
                conn.close()
                raise TransportError(
                    f"resume from {addr} refused (bad auth)")
            self._check_nonce(frame, addr, conn)
        else:
            conn.close()
            raise TransportError(
                f"first frame from {addr} was kind {kind}, not "
                f"HELLO/RESUME")
        idx = int(frame["idx"])
        conn.label = f"r{idx}"
        self._log.info(
            "worker r%d %s from %s", idx,
            "connected" if kind == MSG_HELLO else "resuming", addr)
        return kind, frame, conn

    def accept_worker(self, timeout=120.0):
        """Accept one FRESH worker connection (HELLO handshake).
        Returns ``(replica_idx, Conn)``.  The generous default timeout
        covers a spawned process importing torch from cold.  A RESUME
        arriving here (a redialing worker racing a fresh spawn) is
        refused — the caller's accept loop owns resume routing."""
        kind, frame, conn = self.accept_any(timeout)
        if kind != MSG_HELLO:
            conn.close()
            raise TransportError(
                f"expected a fresh worker HELLO, got a RESUME from "
                f"r{frame.get('idx')}")
        return int(frame["idx"]), conn

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


def connect_worker(host, port, token, idx, timeout=60.0) -> Conn:
    """Worker side of the handshake: dial the fleet's listener and
    introduce this replica.  The fresh nonce makes the frame single-
    use — captured HELLOs cannot open a second session."""
    sock = socket.create_connection((host, port), timeout=timeout)
    conn = Conn(sock, label="fleet")
    conn.send(MSG_HELLO, {"token": token, "idx": int(idx),
                          "proto": PROTO_VERSION,
                          "nonce": os.urandom(16).hex()})
    return conn


def resume_worker(host, port, token, idx, epoch, last_seq,
                  timeout=5.0):
    """Worker side of session resume: redial the listener and offer to
    continue the existing session — ``epoch`` is the fencing epoch the
    worker last obeyed, ``last_seq`` the last CALL seq it EXECUTED
    (the controller replays anything after it).  Authenticated by an
    HMAC over (nonce, idx, epoch, last_seq) so membership is proven
    without the token itself crossing the wire again.  Returns
    ``(conn, ack)`` where ack is the controller's MSG_RESUME verdict
    — ``{"ok": bool, "epoch": int}``."""
    sock = socket.create_connection((host, port), timeout=timeout)
    conn = Conn(sock, label="fleet")
    nonce = os.urandom(16).hex()
    conn.send(MSG_RESUME, {
        "idx": int(idx), "proto": PROTO_VERSION, "nonce": nonce,
        "epoch": int(epoch), "last_seq": int(last_seq),
        "auth": resume_auth(token, nonce, idx, epoch, last_seq)})
    kind, ack = conn.recv(timeout=timeout)
    if kind != MSG_RESUME:
        conn.close()
        raise TransportError(
            f"resume ack was kind {kind}, not RESUME")
    return conn, ack
