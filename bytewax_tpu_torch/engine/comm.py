"""Inter-process communication for multi-process clusters.

Upstream bytewax forms a full TCP mesh between processes and pickles
payloads at process boundaries (``src/run.rs:257-271``,
``src/pyo3_extensions.rs:94-148``).  Same mesh model here: every
process listens on its address and dials every other; frames are
length-prefixed payloads whose encoding is owned by
:mod:`bytewax_tpu_torch.engine.wire` — a zero-copy columnar framing for
record-batch data, pickle for everything else (upstream's only
encoding).  This mesh carries *host-side* keyed exchange and
control-plane traffic (epoch barriers, EOF coordination); device math
stays on each process's own CUDA device.  Several processes of one
host may share one card: each has its own CUDA context, and keyed
rows reach their owner over this mesh as numpy columns, never as
device tensors.
"""

import os
import selectors
import socket
import struct
import time
from typing import Any, List, Optional, Tuple

from bytewax_tpu_torch.engine import faults as _faults
from bytewax_tpu_torch.engine import flight as _flight
from bytewax_tpu_torch.engine import wire as _wire
from bytewax_tpu_torch.engine.backoff import backoff_delay, seeded_rng
from bytewax_tpu_torch.errors import ClusterPeerDead

__all__ = ["Comm"]

_LEN = struct.Struct("<Q")
#: Per-frame generation tag (see :class:`Comm` ``generation``).
_GEN = struct.Struct("<I")
#: Default handshake budget: how long to keep dialing/accepting peers
#: at startup.  ``BYTEWAX_TPU_DIAL_TIMEOUT_S`` overrides (read per
#: connection, like the other comm knobs) because a loaded host can
#: take longer than this just to start every process's interpreter.
_DIAL_TIMEOUT_S = 30.0
#: In-band liveness frame, swallowed before delivery.
_HB = ("__bytewax_tpu_hb__",)
#: Default heartbeat interval (seconds); a peer silent for
#: ``_HB_MISS`` intervals is declared dead.  The default is
#: deliberately long: a process inside its first kernel build or CUDA
#: start-up sends nothing for tens of seconds and must not be declared
#: dead.
_HB_DEFAULT_S = 30.0
_HB_MISS = 2.5
#: Default per-peer raw receive-buffer cap; reading from a peer
#: pauses above it and resumes once its frames are parsed out, so a
#: fast producer sees TCP backpressure instead of ballooning this
#: process's memory.
_RX_CAP_DEFAULT = 64 * 1024 * 1024


class Comm:
    """Full mesh between cluster processes.

    Handshake: every process listens on ``addresses[proc_id]``; lower
    ids dial higher ids (one socket per pair) and introduce themselves
    with their proc id.

    Receive memory is bounded: each peer's raw rx buffer is capped at
    ``BYTEWAX_TPU_RX_BUFFER_CAP`` bytes (default 64 MiB).  A peer at
    the cap is paused (not selected for reading) until its buffered
    frames are parsed out; between parses its kernel socket buffer
    fills and TCP flow control pushes back on the sender.  While THIS
    process is blocked mid-send it keeps reading regardless (two
    peers bulk-sending to each other must not deadlock) but parses
    complete frames out of over-cap buffers instead of growing raw
    bytes — in-flight data per epoch is bounded by the epoch barrier.

    ``generation`` is the supervised-restart generation of this
    process (the supervisor bumps it per restart).  Every frame is
    tagged with the sender's generation and the handshake pins each
    peer's announced generation; a frame tagged with anything else is
    from a dead generation and is discarded (fenced) instead of
    delivered — belt-and-braces on top of TCP's per-connection
    ordering, so a late frame from before a restart can never leak
    into the resumed execution's epoch accounting.
    """

    def __init__(
        self, addresses: List[str], proc_id: int, generation: int = 0
    ):
        self.proc_id = proc_id
        self.proc_count = len(addresses)
        self.generation = generation
        #: Peer -> the generation it announced at handshake.
        self._peer_gen: dict = {}
        #: Frames discarded by generation fencing (observability).
        self.fenced_frames = 0
        #: Per-mesh wire vocab cache (engine/wire.py): lives and dies
        #: with this Comm, so a restarted generation (new mesh, new
        #: session on both sides) re-ships vocabs from scratch and a
        #: fenced dead-generation frame can never resolve against it.
        self._wire_session = _wire.WireSession()
        self._socks: dict = {}
        self._rx_buf: dict = {}
        self._paused: set = set()
        self._pending: List[Tuple[int, Any]] = []
        self._closed: set = set()
        self._sel = selectors.DefaultSelector()
        self._rx_cap = int(
            os.environ.get("BYTEWAX_TPU_RX_BUFFER_CAP", _RX_CAP_DEFAULT)
        )
        #: High-water mark of any single peer's raw rx buffer (bytes);
        #: test/observability hook.
        self.rx_peak = 0
        #: Heartbeat interval (s); 0 disables liveness checking.
        #: Detection bound: a peer silent for ``_HB_MISS`` intervals
        #: is declared dead — catches frozen/half-open peers that a
        #: TCP close would never report.
        self._hb = float(
            os.environ.get("BYTEWAX_TPU_HEARTBEAT_S", _HB_DEFAULT_S)
        )
        #: Liveness limit (s): a peer silent longer than this is dead.
        #: Defaults to ``_HB_MISS`` heartbeat intervals;
        #: ``BYTEWAX_TPU_HB_S`` overrides it directly — raise it when
        #: long kernel builds keep a process away from ``recv_ready``
        #: (heartbeats are only pumped from there) so a busy-but-alive
        #: peer is not falsely declared dead.
        self._hb_limit = float(
            os.environ.get("BYTEWAX_TPU_HB_S", "0") or 0.0
        ) or self._hb * _HB_MISS
        #: Per-peer last-send instants: liveness is judged per peer,
        #: so idleness must be tracked (and heartbeats sent) per peer
        #: — chatting with one peer must not starve the others.
        self._last_tx: dict = {}
        self._last_rx: dict = {}

        host, _, port = addresses[proc_id].rpartition(":")
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if hasattr(socket, "SO_REUSEPORT") and os.environ.get(
            "BYTEWAX_TPU_REUSEPORT"
        ) == "1":
            # Lets the testing spawner hold each allocated port (non-
            # listening) until this process binds it, closing the
            # port-stealing race between allocation and bind.  Opt-in
            # only (the spawner sets the env var): a production bind
            # must fail fast with EADDRINUSE when two processes are
            # given the same address instead of silently splitting
            # incoming handshake dials between them.
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        listener.bind((host or "0.0.0.0", int(port)))
        listener.listen(self.proc_count)

        # Dial every higher-id peer; accept from every lower-id peer.
        expect_accepts = proc_id
        dial_timeout = float(
            os.environ.get("BYTEWAX_TPU_DIAL_TIMEOUT_S", _DIAL_TIMEOUT_S)
        )
        deadline = time.monotonic() + dial_timeout
        # The shared backoff helper (engine/backoff.py) paces redials:
        # jittered per proc so a whole restarted cluster doesn't
        # re-dial in lockstep, capped low (the handshake budget is
        # seconds, not minutes) and reset per peer.
        dial_rng = seeded_rng("dial", proc_id)
        for peer in range(proc_id + 1, self.proc_count):
            phost, _, pport = addresses[peer].rpartition(":")
            attempt = 0
            while True:
                # A fresh socket per attempt: a socket whose connect()
                # failed (peer not listening yet) is left in an error
                # state, and retrying connect() on the SAME fd can
                # fail forever on some kernels — turning a lost
                # startup race into a spurious dial timeout.
                sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                try:
                    sock.connect((phost or "127.0.0.1", int(pport)))
                    break
                except OSError:
                    sock.close()
                    if time.monotonic() > deadline:
                        msg = f"could not dial cluster peer {addresses[peer]!r}"
                        raise ConnectionError(msg) from None
                    attempt += 1
                    time.sleep(
                        backoff_delay(
                            0.05, attempt, rng=dial_rng, cap=0.5
                        )
                    )
            # Introduce (proc id, restart generation); the acceptor
            # answers with its own generation, pinning what each side
            # expects on every subsequent frame.
            sock.sendall(_LEN.pack(proc_id) + _GEN.pack(self.generation))
            sock.settimeout(self._handshake_budget(deadline))
            try:
                self._peer_gen[peer] = _GEN.unpack(
                    self._read_exact(sock, _GEN.size)
                )[0]
            except (socket.timeout, TimeoutError):
                # socket.timeout is only an alias of TimeoutError on
                # 3.10+; catch both for 3.9.
                raise self._handshake_timeout() from None
            sock.settimeout(None)
            self._register(peer, sock)
        while expect_accepts > 0:
            listener.settimeout(self._handshake_budget(deadline))
            try:
                sock, _addr = listener.accept()
            except (socket.timeout, TimeoutError):
                raise self._handshake_timeout() from None
            try:
                sock.settimeout(self._handshake_budget(deadline))
                raw = self._read_exact(sock, _LEN.size + _GEN.size)
                sock.settimeout(None)
            except (socket.timeout, TimeoutError):
                raise self._handshake_timeout() from None
            except ConnectionError:
                # An accepted connection that closed before
                # introducing itself is not a peer: liveness probes
                # (the autoscaler checks a joining process is at its
                # handshake by connect-and-close) and port scanners
                # must not kill the mesh formation.  Keep accepting.
                sock.close()
                continue
            peer = _LEN.unpack(raw[: _LEN.size])[0]
            self._peer_gen[peer] = _GEN.unpack(raw[_LEN.size :])[0]
            sock.sendall(_GEN.pack(self.generation))
            self._register(peer, sock)
            expect_accepts -= 1
        listener.close()

    @staticmethod
    def _handshake_budget(deadline: float) -> float:
        """Remaining handshake time as a socket timeout; an already
        expired deadline raises rather than degrading to 0.0 (which
        would mean *non-blocking* and surface as a confusing
        BlockingIOError)."""
        left = deadline - time.monotonic()
        if left <= 0:
            raise Comm._handshake_timeout()
        return left

    @staticmethod
    def _handshake_timeout() -> ConnectionError:
        # A ConnectionError (not a bare socket.timeout) so a staggered
        # supervised-restart re-formation — peers re-entering the
        # handshake at different times — stays restartable.
        return ConnectionError(
            "cluster handshake timed out waiting for peers "
            "(BYTEWAX_TPU_DIAL_TIMEOUT_S)"
        )

    @staticmethod
    def _read_exact(sock: socket.socket, n: int) -> bytes:
        chunks = []
        while n > 0:
            chunk = sock.recv(n)
            if not chunk:
                raise ConnectionError("cluster peer closed connection")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def _register(self, peer: int, sock: socket.socket) -> None:
        sock.setblocking(False)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._socks[peer] = sock
        self._rx_buf[peer] = bytearray()
        now = time.monotonic()
        self._last_rx[peer] = now
        self._last_tx[peer] = now
        self._sel.register(sock, selectors.EVENT_READ, peer)

    def send(self, dest: int, msg: Any) -> None:
        """Framed send that drains incoming bytes while its own send
        buffer is full — two peers shipping large batches to each
        other must not deadlock in blocking sends."""
        if _faults.fire("comm.send", peer=dest) == "drop":
            return
        # Payload encoding is owned by engine/wire.py: columnar
        # framing for codable record-batch payloads, whole-frame
        # pickle otherwise (docs/performance.md "Columnar exchange").
        # The session arms the per-(peer, stream) vocab cache.
        payload = _wire.encode(msg, self._wire_session, dest)
        data = memoryview(
            _LEN.pack(len(payload)) + _GEN.pack(self.generation) + payload
        )
        sock = self._socks[dest]
        self._last_tx[dest] = time.monotonic()
        _flight.note_comm("tx", dest, len(data))
        while data:
            try:
                sent = sock.send(data)
                data = data[sent:]
            except BlockingIOError:
                # Our send buffer is full; free the pipeline by
                # buffering whatever peers are sending us (parsed
                # later by recv_ready).  mid_send: never pause peers
                # here — two crossing bulk sends would deadlock — but
                # parse over-cap buffers so raw bytes stay bounded.
                self._drain_into_buffers(0.01, mid_send=True)

    def broadcast(self, msg: Any) -> None:
        for peer in self._socks:
            self.send(peer, msg)

    def _pause(self, peer: int) -> None:
        sock = self._socks.get(peer)
        if sock is None or peer in self._paused or peer in self._closed:
            return
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError):
            return
        self._paused.add(peer)

    def _maybe_resume(self, peer: int) -> None:
        """Resume reading a paused peer after its frames are parsed
        out.  Post-parse the leftover is at most one partial frame
        that can only complete with more bytes, so the resume is
        unconditional; the pause therefore bounds how much is READ
        per drain (one cap's worth between parses), which is what
        bounds raw rx memory — a frame larger than the cap is still
        receivable (effective bound: max(cap, largest frame))."""
        if peer not in self._paused:
            return
        self._paused.discard(peer)
        sock = self._socks.get(peer)
        if sock is not None and peer not in self._closed:
            self._sel.register(sock, selectors.EVENT_READ, peer)

    def _parse_frames(self, peer: int, out: List[Tuple[int, Any]]) -> None:
        buf = self._rx_buf[peer]
        head = _LEN.size + _GEN.size
        while len(buf) >= head:
            (length,) = _LEN.unpack(buf[: _LEN.size])
            if len(buf) < head + length:
                break
            (gen,) = _GEN.unpack(buf[_LEN.size : head])
            frame = bytes(buf[head : head + length])
            del buf[: head + length]
            _flight.note_comm("rx", peer, head + length)
            if gen != self._peer_gen.get(peer):
                # Dead-generation frame: fence it out instead of
                # letting pre-restart traffic corrupt the resumed
                # execution's epoch accounting.
                self.fenced_frames += 1
                _flight.note_fenced(peer, gen)
                continue
            msg = _wire.decode(frame, self._wire_session, peer)
            if msg == _HB:
                continue  # liveness only; never delivered
            out.append((peer, msg))
        self._maybe_resume(peer)

    def _drain_into_buffers(self, timeout: float, mid_send: bool = False) -> None:
        """Read available bytes from all peers into rx buffers without
        parsing (safe to call mid-send).

        A peer whose raw buffer reaches the cap is paused; mid-send
        (when pausing could deadlock two crossing bulk sends) its
        complete frames are parsed into the pending queue instead so
        raw bytes stay bounded either way.
        """
        for key, _events in self._sel.select(timeout):
            peer = key.data
            sock = key.fileobj
            try:
                while True:
                    chunk = sock.recv(1 << 20)
                    if not chunk:
                        try:
                            self._sel.unregister(sock)
                        except (KeyError, ValueError):
                            pass
                        self._paused.discard(peer)
                        self._closed.add(peer)
                        break
                    buf = self._rx_buf[peer]
                    buf.extend(chunk)
                    self._last_rx[peer] = time.monotonic()
                    if len(buf) > self.rx_peak:
                        self.rx_peak = len(buf)
                    if len(buf) >= self._rx_cap:
                        if mid_send:
                            self._parse_frames(peer, self._pending)
                        else:
                            self._pause(peer)
                            break
                    if len(chunk) < (1 << 20):
                        break
            except BlockingIOError:
                pass

    def recv_ready(self, timeout: float = 0.0) -> List[Tuple[int, Any]]:
        """Drain all complete frames currently available.

        A closed peer's already-buffered frames (e.g. its final
        close/abort broadcast) are delivered before the disconnect is
        raised on a later call.

        Also the liveness pump: sends a heartbeat frame to every peer
        when this process has been send-idle for an interval, and
        declares a peer dead after ``_HB_MISS`` silent intervals —
        bounded detection of frozen/half-open peers that never send a
        TCP close (``BYTEWAX_TPU_HEARTBEAT_S``; 0 disables).
        """
        _faults.fire("comm.recv")
        self._drain_into_buffers(timeout)
        if self._hb > 0:
            # After the drain, so buffered-but-unread bytes can never
            # masquerade as peer silence.
            now = time.monotonic()
            for peer in list(self._socks):
                if (
                    peer not in self._closed
                    and now - self._last_tx[peer] >= self._hb
                ):
                    self.send(peer, _HB)
            limit = self._hb_limit
            for peer, last in self._last_rx.items():
                if peer in self._closed or peer in self._paused:
                    continue
                if peer not in self._socks:
                    continue
                if now - last > limit:
                    who = (
                        "cluster coordinator (process 0)"
                        if peer == 0
                        else f"cluster peer {peer}"
                    )
                    msg = (
                        f"{who} sent nothing for {now - last:.1f}s "
                        f"(> {limit:.1f}s heartbeat limit); assuming "
                        "it is dead or frozen"
                    )
                    raise ClusterPeerDead(
                        msg, peer=peer, silence_s=now - last
                    )
        out: List[Tuple[int, Any]]
        if self._pending:
            out, self._pending = self._pending, []
        else:
            out = []
        for peer in list(self._rx_buf):
            self._parse_frames(peer, out)
        if not out and self._closed:
            # A peer died mid-run with nothing left to deliver (a
            # normal shutdown never pumps after its final close).
            peer = next(iter(self._closed))
            raise ClusterPeerDead(
                f"cluster peer {peer} closed connection", peer=peer
            )
        return out

    def closed_peers(self) -> frozenset:
        """Peers whose connection has closed (clean exit or death).
        The driver's sync rounds use this to tell a benign
        completed-the-round exit from a peer that died BEFORE
        delivering — ``recv_ready`` raises for an arbitrary closed
        peer, so the caller must be able to look past one it already
        heard from."""
        return frozenset(self._closed)

    def stale_peers(self) -> frozenset:
        """Live peers silent past the heartbeat limit — the same
        frozen/half-open condition ``recv_ready`` raises for, exposed
        as a set because the raise names an ARBITRARY suspect: a sync
        round looking past a benignly-finished peer must still be
        able to see every OTHER peer that has gone quiet."""
        if self._hb <= 0:
            return frozenset()
        now = time.monotonic()
        limit = self._hb_limit
        return frozenset(
            peer
            for peer, last in self._last_rx.items()
            if peer not in self._closed
            and peer not in self._paused
            and peer in self._socks
            and now - last > limit
        )

    def close(self) -> None:
        for sock in self._socks.values():
            try:
                self._sel.unregister(sock)
            except (KeyError, ValueError):
                pass
            try:
                # Orderly FIN before close: without the shutdown,
                # peers of a cleanly-exiting worker can see an abrupt
                # RST (unread bytes in our kernel rx buffer turn
                # close() into a reset) instead of end-of-stream.
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                # Best-effort on the way out: the peer may already be
                # gone (ENOTCONN et al.), and close() runs in the
                # driver's finally during restartable unwinds — an
                # errno here must never replace the fault being
                # handled.
                pass
            sock.close()
        self._sel.close()
        self._socks.clear()
