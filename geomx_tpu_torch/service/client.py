"""GeoPSClient — worker-side connection to a PS tier (port of
geomx_tpu/service/client.py).  Arrays cross as numpy: a caller holding a
tensor hands ``.detach().cpu().numpy()`` over at this boundary, and
frames never carry a torch tensor.  The fleet round ledger
(``telemetry/ledger.py``) gets a ``push`` hop for every PUSH frame, a
``replay`` hop for a session-resume re-push and the client-side
completion of every round a pull reply proves merged.

The process analogue of the reference's KVWorker
(3rdparty/ps-lite/include/ps/kv_app.h:80-462):

- ``push_async``/``pull_async`` return timestamps; ``wait(ts)`` blocks —
  the reference's ZPush/ZPull + Wait on a Customer timestamp;
- sends drain through a priority queue (native C++ when built), so
  ``priority=-layer_idx`` pushes leave the host in layer order: the P3
  send discipline (threadsafe_queue.h:19-60);
- with P3 enabled (GEOMX_ENABLE_P3/ENABLE_P3, or ``p3_slice_elems``),
  big pushes are sliced into priority-tagged CHUNK messages before they
  enter the send queue, so chunks of a front layer overtake the queued
  tail of a back layer on the wire — the reference's P3_ZPush per-chunk
  scheduling (kvstore_dist.h:835-872; chunk size = bigarray_bound/2);
  the server reassembles;
- a receiver thread matches replies to requests by request id, like the
  Customer recv thread tracking (timestamp -> response) pairs
  (src/customer.cc:13-87).
"""

from __future__ import annotations

import itertools
import os
import pickle
import queue
import random
import socket
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from geomx_tpu_torch.service.protocol import (BATCH_DRAIN_MAX_BYTES,
                                              BATCH_DRAIN_MAX_FRAMES, Msg,
                                              MsgType, _log_msg,
                                              _verbose_level,
                                              batch_drain_enabled,
                                              connect_retry, env_int,
                                              maybe_corrupt_frame,
                                              recv_frame, send_frame,
                                              wire_stats)
from geomx_tpu_torch.service.retry import SeededBackoff, count_retry


def _ledger_push_hop(msg: "Msg", nbytes: int) -> None:
    """Fleet round ledger (telemetry/ledger.py): one ``push`` hop per
    PUSH frame submitted — each P3 chunk is its own hop, so the round's
    causal chain shows the chunk set the wire really carried.  Best-
    effort like every ledger write."""
    rid = msg.meta.get("round")
    if msg.type is not MsgType.PUSH or rid is None or msg.key is None:
        return
    try:
        from geomx_tpu_torch.telemetry.ledger import PUSH, record_hop
        detail = None
        if msg.meta.get("chunk") is not None:
            detail = {"chunk": int(msg.meta["chunk"])}
        record_hop(msg.key, int(rid), PUSH, party=msg.sender,
                   nbytes=nbytes, detail=detail)
    except Exception:
        pass


class _RelayConnectError(OSError):
    """Relay connection could not be established — no bytes were sent, so
    the partial may safely go elsewhere."""


class WrongShardError(RuntimeError):
    """A key-range sharded server refused a request for a key outside
    its owned range (docs/resilience.md "Many-party global tier"): the
    client's shard map is stale.  Carries the server's map version so
    the caller can fetch a map at least that fresh and re-route —
    a redirect, never a wrong-shard merge."""

    def __init__(self, message: str, map_version: int = 0):
        super().__init__(message)
        self.map_version = int(map_version)


class _Pending:
    __slots__ = ("event", "reply", "frame", "priority", "parts")

    def __init__(self):
        self.event = threading.Event()
        self.reply: Optional[Msg] = None
        self.frame: Optional[bytes] = None   # kept for resend
        self.priority: int = 0
        self.parts: Optional[dict] = None    # chunked PULL_REPLY assembly


class GeoPSClient:
    def __init__(self, addr: Tuple[str, int], sender_id: int = 0,
                 resend_timeout_ms: Optional[int] = None,
                 auto_pull: bool = False,
                 p3_slice_elems: Optional[int] = None,
                 ts_node: Optional[int] = None,
                 reconnect: Optional[bool] = None,
                 reconnect_timeout_s: Optional[float] = None):
        """``auto_pull=True`` registers this client for server-initiated
        updates (the TSEngine AutoPull path): after each aggregation round
        the server pushes fresh values in throughput-scheduled order, and
        ``auto_pull(key)`` consumes them instead of issuing a PULL.

        ``ts_node`` (1-based; 0 is the server sink) additionally joins the
        TSEngine push-side overlay: ``ts_push`` announces a ready partial
        via ASK1 and a relay listener accepts peers' partials, which are
        merged and re-announced — the scheduler-chosen aggregation tree of
        the reference (kv_app.h:313-341, kvstore_dist.h:91-169).

        ``reconnect`` (``GEOMX_RECONNECT``; default off) arms the
        session-resume path of docs/resilience.md "Host-plane recovery":
        a dead socket is re-dialed (seeded-jitter backoff, bounded by
        ``GEOMX_RECONNECT_TIMEOUT_S``), the server's generation token is
        compared to detect a *restart*, and on restart the client
        re-syncs its per-key round ids (``query_progress``) and
        idempotently re-pushes the retained in-flight round instead of
        wedging every caller on ``ConnectionError("server closed")``.
        Implies resend (the retransmit dedup the replay rides on)."""
        self.sender_id = sender_id
        self.addr = addr
        if reconnect is None:
            reconnect = bool(env_int(("GEOMX_RECONNECT",), 0))
        self._reconnect = bool(reconnect)
        self._reconnect_timeout_s = float(env_int(
            ("GEOMX_RECONNECT_TIMEOUT_S",), 30)) \
            if reconnect_timeout_s is None else float(reconnect_timeout_s)
        if self._reconnect and resend_timeout_ms is None and not env_int(
                ("GEOMX_RESEND", "PS_RESEND"), 0):
            # reconnect without resend could double-merge a replayed
            # push (no (sender, rid) dedup on the wire): force it on
            resend_timeout_ms = env_int(
                ("GEOMX_RESEND_TIMEOUT", "PS_RESEND_TIMEOUT"), 1000)
        # connection-liveness latch: cleared while a reconnect is in
        # flight; the send loop parks on it instead of dying.
        # _conn_dead latches when reconnection gives up for good.
        self._conn_ok = threading.Event()
        self._conn_ok.set()
        self._conn_dead = False
        self._closing = threading.Event()
        # last server generation token seen in any reply — the restart
        # detector of the session-resume handshake
        self._server_gen: Optional[int] = None
        # key -> (round, [clean frames], priority): the most recent push
        # per key — ONE whole-tensor frame, or the round's full P3 chunk
        # set — retained (reconnect mode only) so a round the dead
        # server incarnation lost can be re-pushed verbatim.  Released
        # when the round's pull reply is consumed (the server journals
        # write-ahead of pull replies, so a reply proves durability);
        # total retained bytes ride geomx_resend_buffer_bytes.
        self._last_push: Dict[str, tuple] = {}
        self._resend_buffer_bytes = 0
        # retain runs on caller threads, release on the recv loop:
        # the byte accounting must not double-subtract a racing entry
        self._buf_lock = threading.Lock()
        from geomx_tpu_torch.telemetry import get_registry
        self._m_resend_buf = get_registry().gauge(
            "geomx_resend_buffer_bytes",
            "Bytes of retained session-resume re-push frames",
            ("sender",)).labels(str(sender_id))
        self._registered_autopull = bool(auto_pull)
        self._autopull: Dict[str, Any] = {}
        self._apevents: Dict[str, threading.Event] = {}
        self._aplock = threading.Lock()
        self._ap_closed = False
        # reliability: when PS_RESEND/GEOMX_RESEND is on (or a timeout is
        # given), un-ACKed requests are retransmitted after
        # PS_RESEND_TIMEOUT ms — the reference Resender (src/resender.h);
        # the server dedups replays by (sender, rid) signature.
        if resend_timeout_ms is None and env_int(
                ("GEOMX_RESEND", "PS_RESEND"), 0):
            resend_timeout_ms = env_int(
                ("GEOMX_RESEND_TIMEOUT", "PS_RESEND_TIMEOUT"), 1000)
        self.resend_timeout_ms = resend_timeout_ms
        # P3 chunking: default on when the reference's env toggle is set,
        # slicing at bigarray_bound/2 elements like P3_EncodeDefaultKey
        if p3_slice_elems is None and env_int(
                ("GEOMX_ENABLE_P3", "ENABLE_P3"), 0):
            p3_slice_elems = env_int(
                ("GEOMX_P3_SLICE_ELEMS",),
                env_int(("GEOMX_BIGARRAY_BOUND",
                         "MXNET_KVSTORE_BIGARRAY_BOUND"), 1_000_000) // 2)
        self.p3_slice_elems = p3_slice_elems
        self._slicer = None
        if p3_slice_elems:
            # P3 chunking composes with session resume: the retained
            # re-push entry for a chunked round holds the round's FULL
            # chunk-frame set (released when the round's pull reply
            # lands), so a restarted server's lost round replays chunk
            # by chunk through the same (sender, rid) / round dedup
            from geomx_tpu_torch.transport import P3Slicer
            self._slicer = P3Slicer(p3_slice_elems)
        self._multi: Dict[int, list] = {}   # meta-rid -> per-chunk rids
        # test/observability hook: when set to a list, PULL replies are
        # logged as (key, chunk_index|None) in arrival order — the pull
        # mirror of the server's push_log
        self.reply_log: Optional[list] = None
        # best-effort DGT stat: deferred blocks shed client-side under
        # send-queue congestion (never even entered the wire)
        self.dgt_shed_blocks = 0
        # per-key push round ids: lets the server dedup a restarted
        # worker's replayed push exactly (see recover())
        self._key_rounds: Dict[str, int] = {}
        # DGT per-key per-block contribution EWMAs (push_dgt)
        self._dgt_contri: Dict[str, np.ndarray] = {}
        # DSCP-marked per-channel sockets for deferred best-effort DGT
        # chunks (reference zmq_van: one UDP socket per channel, each
        # with a descending DSCP mark).  TCP here, but the IP-header
        # marking is real: IP_TOS = dscp << 2 with standard AF classes,
        # so network QoS can demote the deferred channels exactly as in
        # the reference.  GEOMX_DGT_DSCP: comma ladder per channel
        # (default "34,26,18,10" = AF41..AF11), "off"/"0" disables.
        # graftlint: disable=GXL006 — host-plane knob
        self._dgt_dscp = self._parse_dscp(os.environ.get("GEOMX_DGT_DSCP"))
        self._dgt_ch_socks: Dict[int, tuple] = {}
        self._dgt_ch_lock = threading.Lock()
        self._sock = connect_retry(addr)
        self._wlock = threading.Lock()
        # random rid base so a restarted worker reusing a sender_id cannot
        # collide with its predecessor's (sender, rid) dedup signatures
        self._rid = itertools.count(random.getrandbits(31))
        self._pending: Dict[int, _Pending] = {}
        self._plock = threading.Lock()
        self._closed = False

        self._sendq = self._make_queue()
        self._native_q = type(self._sendq).__name__ == "NativePriorityQueue"
        # test/demo hook: while cleared, the sender holds the wire so
        # queued messages re-order by priority (P3 interleaving is
        # observable deterministically)
        self._send_gate = threading.Event()
        self._send_gate.set()
        self._sender = threading.Thread(target=self._send_loop, daemon=True)
        self._sender.start()
        self._receiver = threading.Thread(target=self._recv_loop, daemon=True)
        self._receiver.start()
        self.ts_node = ts_node
        self._ts_buf: Dict[str, list] = {}   # key -> [array, num_merge]
        self._ts_lock = threading.Lock()
        self._ts_peers: Dict[Tuple[str, int], socket.socket] = {}
        self._ts_directives: "queue.Queue" = queue.Queue()
        # relay frames carry a per-sender seq so a timed-out send can be
        # RETRIED at the same peer (which dedups) instead of re-routed —
        # re-routing a possibly-delivered partial would double-count it
        self._relay_seq = itertools.count(1)
        self._relay_seen: Dict[int, set] = {}
        if ts_node is not None:
            self._ts_listener = socket.socket(socket.AF_INET,
                                              socket.SOCK_STREAM)
            self._ts_listener.setsockopt(socket.SOL_SOCKET,
                                         socket.SO_REUSEADDR, 1)
            # graftlint: disable=GXL006 — host-plane knob
            bind_host = os.environ.get("GEOMX_PS_BIND_HOST", "127.0.0.1")
            self._ts_listener.bind((bind_host, 0))
            self._ts_listener.listen(16)
            self._ts_listener.settimeout(0.2)
            self.relay_port = self._ts_listener.getsockname()[1]
            threading.Thread(target=self._relay_accept_loop,
                             daemon=True).start()
            threading.Thread(target=self._ts_dispatch_loop,
                             daemon=True).start()
            # advertise the address PEERS dial: follow the
            # listener's bind — a loopback-bound listener advertises
            # loopback (peers on this host); a wildcard-bound one (the
            # launcher's multi-host setting) advertises THIS PROCESS's
            # reachable address, taken from the local end of the server
            # connection.  When that, too, is loopback (server co-located
            # or reached through a tunnel) nothing on this host can name
            # our reachable address, so the chain falls back to the
            # launcher-set party host — right when workers share the
            # server's machine, wrong across machines: multi-host
            # tunneled workers must set GEOMX_RELAY_HOST explicitly.
            # graftlint: disable=GXL006 — host-plane knob
            adv = os.environ.get("GEOMX_RELAY_HOST")
            if not adv:
                if bind_host in ("127.0.0.1", "localhost", "::1"):
                    adv = "127.0.0.1"
                elif bind_host in ("0.0.0.0", "::"):
                    try:
                        adv = self._sock.getsockname()[0]
                    except OSError:
                        adv = ""
                    if adv in ("0.0.0.0", "::", "", "127.0.0.1", "::1"):
                        # the server was dialed over loopback, which says
                        # nothing about THIS host's reachable address —
                        # fall back to the launcher-set party host, then
                        # loopback (single-host deployments)
                        # graftlint: disable=GXL006 — host-plane knob
                        adv = (os.environ.get("GEOMX_PS_HOST")
                               or "127.0.0.1")
                else:
                    adv = bind_host
            self._relay_adv_host = adv
            self._request(Msg(MsgType.COMMAND,
                              meta={"cmd": "ts_register", "node": ts_node,
                                    "host": adv, "port": self.relay_port}))
        if auto_pull:
            self._request(Msg(MsgType.COMMAND,
                              meta={"cmd": "register_autopull"}))

    @staticmethod
    def _make_queue():
        try:
            from geomx_tpu_torch.runtime import NativePriorityQueue, native_available
            if native_available():
                return NativePriorityQueue()
        except Exception:
            pass
        from geomx_tpu_torch.transport import PrioritySendQueue
        return PrioritySendQueue()

    # ---- send/recv machinery ----------------------------------------------

    def _send_loop(self):
        while True:
            item = self._sendq.pop()
            if item is None:
                return
            self._send_gate.wait()
            frame = item[0] if self._native_q else item
            frames = [frame]
            if batch_drain_enabled():
                # small-key round batching: after the blocking pop
                # returned a head frame, drain whatever else is already
                # queued (timeout=0, never waiting) and ship the whole
                # batch in ONE sendall — many small-key pushes cost one
                # syscall instead of one each.  Each frame keeps its own
                # length prefix, so the receiver is oblivious.
                total = len(frame) + 4
                while (len(frames) < BATCH_DRAIN_MAX_FRAMES
                       and total < BATCH_DRAIN_MAX_BYTES):
                    extra = self._sendq.pop(timeout=0)
                    if extra is None:
                        break
                    ef = extra[0] if self._native_q else extra
                    frames.append(ef)
                    total += len(ef) + 4
            blob = b"".join(len(f).to_bytes(4, "little") + f
                            for f in frames)
            while True:
                with self._wlock:
                    sock = self._sock
                    try:
                        sock.sendall(blob)
                        sent = True
                    except OSError:
                        sent = False
                if sent:
                    break
                if not self._reconnect or self._closed:
                    return
                # session resume: the recv loop owns re-dialing; make
                # sure it notices the breakage (it may be parked in a
                # recv on the same dead socket), then park here until
                # the connection is re-established and retry THIS batch
                # on the fresh socket — the server dedups replays
                try:
                    sock.close()
                except OSError:
                    pass
                if not self._conn_ok.wait(
                        self._reconnect_timeout_s + 5.0) or self._closed \
                        or self._conn_dead:
                    return
                if self._sock is sock:
                    # the recv loop hasn't begun the swap yet (the latch
                    # is still set from before the breakage): don't hot-
                    # spin close/send on the same dead socket
                    time.sleep(0.01)
            if len(frames) == 1:
                wire_stats.add_sent(len(blob))
            else:
                wire_stats.add_sent_batch(len(frames), len(blob))

    def _recv_loop(self):
        while not self._closed:
            try:
                msg = recv_frame(self._sock)
            except (OSError, pickle.UnpicklingError, ValueError):
                # ValueError/UnpicklingError = malformed or rejected frame
                # (see protocol._HeaderUnpickler) and FrameIntegrityError
                # = failed CRC/length check; after any of them the stream
                # position is untrustworthy, so treat like a dead socket —
                # falling through reconnects or releases every waiter
                msg = None
            if msg is None:
                # session resume (docs/resilience.md): re-dial, detect a
                # server restart via the generation token, re-sync round
                # ids and replay what the dead incarnation lost; the
                # resendable waiters stay parked (their frames re-fly),
                # so a mid-run restart is a stall, not an error
                if self._reconnect and not self._closed \
                        and self._reestablish():
                    continue
                # connection closed for good: release every waiter.
                # Entries stay in the dict — wait() pops them — so a
                # reply that landed just before the close is still
                # consumable (reply set + event fired), instead of being
                # wiped into a KeyError.
                self._conn_dead = True
                self._conn_ok.set()  # a parked sender must exit, not hang
                with self._plock:
                    for p in self._pending.values():
                        p.event.set()
                # ... and fail auto_pull() waiters fast instead of letting
                # them poll out their timeout on a dead connection
                with self._aplock:
                    self._ap_closed = True
                    for ev in self._apevents.values():
                        ev.set()
                return
            gen = msg.meta.get("gen")
            if gen is not None and msg.meta.get("chunk") is None:
                # every server/scheduler reply carries its generation
                # token; recording it is what makes the NEXT reconnect
                # able to tell "socket churn" from "process restart".
                # Chunked pull replies are excluded: their "gen" is the
                # reply-slicing generation (ChunkAssembler signature),
                # and recording it here would poison restart detection
                # with a small counter that can collide with a durable
                # generation token.
                self._server_gen = gen
            if msg.type == MsgType.TS_DIRECTIVE:
                # scheduler decided where this node's partial goes; the
                # dispatcher thread moves the data (never the recv loop)
                self._ts_directives.put(msg)
                continue
            if msg.type == MsgType.AUTOPULL:
                # unsolicited server-initiated update (TSEngine AutoPull):
                # no rid — park it for auto_pull() waiters
                with self._aplock:
                    self._autopull[msg.key] = (
                        msg.meta.get("version", 0), msg.array)
                    ev = self._apevents.setdefault(msg.key,
                                                   threading.Event())
                ev.set()
                continue
            rid = msg.meta.get("rid")
            with self._plock:
                p = self._pending.get(rid)
            if p is not None:
                if msg.type == MsgType.PULL_REPLY and \
                        msg.meta.get("chunk") is not None:
                    # P3 pull chunk: assemble; the reply completes when
                    # the set does (reference P3_ZPull reassembly)
                    if self.reply_log is not None:
                        self.reply_log.append((msg.key,
                                               int(msg.meta["chunk"])))
                    msg = self._pull_chunk(p, msg)
                    if msg is None:
                        continue
                elif self.reply_log is not None and \
                        msg.type == MsgType.PULL_REPLY:
                    self.reply_log.append((msg.key, None))
                if msg.type == MsgType.PULL_REPLY and \
                        msg.key is not None:
                    # the reply's "pushed" meta is the requester's
                    # merged-round count at reply time (journaled
                    # write-ahead of the reply): retained re-push
                    # frames for rounds it covers are no longer needed
                    pushed = msg.meta.get("pushed")
                    if self._reconnect:
                        self._release_push(msg.key, proved_round=pushed)
                    if pushed:
                        # ...and it is the WORKER process's completion
                        # proof for its ledger records: a client-side
                        # process never sees the server's merge, so
                        # rounds it opened would otherwise age open
                        # until the orphan bound
                        try:
                            from geomx_tpu_torch.telemetry.ledger import \
                                get_round_ledger
                            get_round_ledger().complete_through(
                                msg.key, int(pushed))
                        except Exception:
                            pass
                p.reply = msg
                p.event.set()

    def _pull_chunk(self, p: _Pending, msg: Msg) -> Optional[Msg]:
        """Fold one PULL_REPLY chunk into the pending entry; returns the
        assembled whole-tensor reply when complete, else None.  The
        shared ChunkAssembler keys the assembly on the server-side
        generation id, so a retransmit-triggered second reply (re-sliced
        from a NEWER value) resets the set instead of blending."""
        if p.parts is None:
            from geomx_tpu_torch.transport import ChunkAssembler
            # reply generations count up: a late chunk of a superseded
            # reply must not reset a newer reply's assembly
            p.parts = ChunkAssembler(monotonic_gen=True)
        out = p.parts.feed(msg.meta, msg.array)
        if out is None:
            return None
        p.parts = None
        meta = {"rid": msg.meta.get("rid")}
        if msg.meta.get("pushed") is not None:
            # the durability proof rides every chunk; keep it on the
            # assembled reply for the retained-frame release
            meta["pushed"] = msg.meta["pushed"]
        return Msg(MsgType.PULL_REPLY, key=msg.key, meta=meta, array=out)

    # ---- session resume (docs/resilience.md "Host-plane recovery") --------

    def _reestablish(self) -> bool:
        """Re-dial the server with seeded-jitter backoff, run the
        resume handshake, swap the socket in, and replay pending
        resendable frames.  Runs on the recv thread (the send loop is
        parked on ``_conn_ok``).  Returns False when the window
        (``GEOMX_RECONNECT_TIMEOUT_S``) expires or the client closed —
        the caller then fails the waiters exactly as before."""
        self._conn_ok.clear()
        try:
            self._sock.close()
        except OSError:
            pass
        backoff = SeededBackoff(seed=0x5E55 + self.sender_id,
                                base_s=0.05, max_s=1.0)
        deadline = time.monotonic() + self._reconnect_timeout_s
        first = True
        while not self._closed:
            remain = deadline - time.monotonic()
            if remain <= 0:
                return False
            if not first:
                count_retry("reconnect")
                if self._closing.wait(min(backoff.next(), remain)):
                    return False
            first = False
            try:
                sock = socket.create_connection(
                    self.addr, timeout=min(5.0, max(0.2, remain)))
            except OSError:
                continue
            try:
                self._resume_session(sock)
            except (OSError, ValueError, pickle.UnpicklingError,
                    RuntimeError):
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            with self._wlock:
                self._sock = sock
            self._replay_pending(sock)
            self._conn_ok.set()
            return True
        return False

    def _direct_send(self, sock: socket.socket, frame: bytes) -> None:
        """Write one pre-encoded frame straight onto a socket (resume
        path): replayed state-restoring frames must reach the server
        BEFORE anything queued during the outage, and the shared send
        queue is FIFO per priority — a pull submitted while the server
        was down would otherwise overtake the replayed push it depends
        on and read pre-crash state."""
        with self._wlock:
            sock.sendall(len(frame).to_bytes(4, "little") + frame)
        wire_stats.add_sent(len(frame) + 4)

    def _direct_rpc(self, sock: socket.socket, msg: Msg) -> Msg:
        """One synchronous request on a NOT-yet-installed socket (the
        resume handshake runs before the recv loop owns it).  Stray
        server-initiated frames that arrive meanwhile (AUTOPULL,
        TS directives) are parked where the recv loop would put them."""
        msg.sender = self.sender_id
        rid = next(self._rid)
        msg.meta["rid"] = rid
        send_frame(sock, msg)
        while True:
            rep = recv_frame(sock)
            if rep is None:
                raise ConnectionError("server closed during resume")
            if rep.type == MsgType.AUTOPULL:
                with self._aplock:
                    self._autopull[rep.key] = (
                        rep.meta.get("version", 0), rep.array)
                    ev = self._apevents.setdefault(rep.key,
                                                   threading.Event())
                ev.set()
                continue
            if rep.type == MsgType.TS_DIRECTIVE:
                self._ts_directives.put(rep)
                continue
            if rep.meta.get("rid") != rid:
                continue  # a late reply to a pre-crash request
            if rep.type == MsgType.ERROR:
                raise RuntimeError(rep.meta.get("error", "resume failed"))
            return rep

    def _resume_session(self, sock: socket.socket) -> None:
        """The handshake itself: learn the server's generation token;
        on a RESTART (token changed), fetch the per-sender merged-round
        counts and re-push any retained round the dead incarnation
        lost — the idempotent replay the per-key round-id dedup
        (``_key_rounds`` / server ``query_progress``) was built for."""
        sock.settimeout(10.0)
        hello = self._direct_rpc(sock, Msg(MsgType.COMMAND,
                                           meta={"cmd": "hello"}))
        gen = hello.meta.get("gen")
        restarted = (gen is not None and self._server_gen is not None
                     and gen != self._server_gen)
        if restarted:
            rep = self._direct_rpc(sock, Msg(MsgType.COMMAND,
                                             meta={"cmd": "query_progress"}))
            prog = {str(k): int(v) for k, v in
                    dict(rep.meta.get("progress", {})).items()}
            for key, held in list(self._last_push.items()):
                rnd, frames, _prio = held
                if prog.get(key, 0) < rnd:
                    # the restarted store is behind this client: the
                    # in-flight round died with the old incarnation —
                    # re-push the retained frame(s) (a P3-chunked round
                    # replays its whole chunk set; the server's
                    # (sender, rid) / round dedup absorbs survivors).
                    # Sent DIRECTLY on the resume socket: a request
                    # queued during the outage must not overtake the
                    # replay it depends on (happens-before).
                    for frame in frames:
                        self._direct_send(sock, frame)
                    try:
                        # ledger: the restart is attributed to the exact
                        # round it interrupted (frames replay verbatim
                        # pre-encoded, so the encode-side accounting
                        # already counted them once; the receiver's
                        # decode counts the re-delivery)
                        from geomx_tpu_torch.telemetry.ledger import (
                            REPLAY, record_hop)
                        record_hop(key, rnd, REPLAY,
                                   party=self.sender_id,
                                   shard=hello.meta.get("shard_index"),
                                   nbytes=sum(len(f) + 4 for f in frames),
                                   detail={"reason": "server_restart",
                                           "generation": gen,
                                           "frames": len(frames)})
                    except Exception:
                        pass
            for key, srv_rnd in prog.items():
                if srv_rnd > self._key_rounds.get(key, 0):
                    # server persisted rounds whose ACKs we never saw:
                    # adopt its count so future pushes take fresh ids
                    self._key_rounds[key] = srv_rnd
        # connection-scoped registrations live in server-side tables
        # keyed by the (old, dead) conn — refresh them on EVERY re-dial
        if self._registered_autopull:
            self._direct_rpc(sock, Msg(MsgType.COMMAND,
                                       meta={"cmd": "register_autopull"}))
        if self.ts_node is not None:
            self._direct_rpc(sock, Msg(
                MsgType.COMMAND,
                meta={"cmd": "ts_register", "node": self.ts_node,
                      "host": self._relay_adv_host,
                      "port": self.relay_port}))
        if gen is not None:
            self._server_gen = gen
        sock.settimeout(None)

    def _replay_pending(self, sock: socket.socket) -> None:
        """Replay every un-answered resendable frame on the fresh
        connection (the server dedups replays); non-resendable control
        requests (INIT/COMMAND/BARRIER) fail fast with the
        ConnectionError they always got.  Replays are written DIRECTLY
        (see :meth:`_direct_send`) so frames submitted pre-crash keep
        their happens-before edge over frames queued during the
        outage; a direct send that fails falls back to the queue — the
        resend timer re-delivers, and a dead socket re-enters
        reestablish anyway."""
        with self._plock:
            entries = list(self._pending.values())
        for p in entries:
            if p.event.is_set():
                continue
            if p.frame is not None:
                try:
                    self._direct_send(sock, p.frame)
                except OSError:
                    self._sendq.push(p.frame, p.priority)
            else:
                p.event.set()

    def _retain_push(self, key: str, rnd: int, frames: list,
                     priority: int) -> None:
        """Session resume: retain the CLEAN frame set of the newest push
        per key, so a round a restarted server lost can be re-pushed
        verbatim (one gradient per key of memory; a P3-chunked push
        retains its full chunk set until the round's pull reply)."""
        nbytes = sum(len(f) for f in frames)
        with self._buf_lock:
            prev = self._last_push.get(key)
            if prev is not None:
                freed = sum(len(f) for f in prev[1])
                self._resend_buffer_bytes -= freed
                self._m_resend_buf.dec(freed)
            self._last_push[key] = (int(rnd), list(frames), priority)
            self._resend_buffer_bytes += nbytes
            self._m_resend_buf.inc(nbytes)

    def _release_push(self, key: str,
                      proved_round: Optional[int] = None) -> None:
        """A pull reply proved the key durable server-side up to
        ``proved_round`` (the requester's merged-round count the reply
        carries, journaled write-ahead of it): release the retained
        re-push frames for rounds it covers (satellite fix: the resend
        buffer previously grew one frame per key forever).  A retained
        round NEWER than the proof — a push pipelined after the pull
        was issued — stays retained."""
        with self._buf_lock:
            held = self._last_push.get(key)
            if held is None:
                return
            if proved_round is not None and held[0] > int(proved_round):
                return
            del self._last_push[key]
            nbytes = sum(len(f) for f in held[1])
            self._resend_buffer_bytes -= nbytes
            self._m_resend_buf.dec(nbytes)

    def _submit(self, msg: Msg, priority: int = 0,
                fire_and_forget: bool = False,
                frame_out: Optional[list] = None) -> int:
        """Enqueue a request; returns its timestamp (request id).

        ``fire_and_forget``: no pending entry, no resend marking — the
        reply (if any) is ignored by the recv loop.  The best-effort DGT
        deferred blocks' lossy-channel send.

        ``frame_out``: when given, the encoded CLEAN frame is appended —
        the chunked-push path collects its chunk set for session-resume
        retention."""
        rid = next(self._rid)
        msg.sender = self.sender_id
        msg.meta["rid"] = rid
        if fire_and_forget:
            frame = msg.encode()
            if _verbose_level() >= 2:  # data-path sends log at ENQUEUE
                _log_msg("ENQ ", msg, len(frame))
            _ledger_push_hop(msg, len(frame) + 4)
            self._sendq.push(maybe_corrupt_frame(msg, frame), priority)
            return rid
        p = _Pending()
        # only data messages are retransmitted: PUSH is deduped server-side
        # (flagged here), PULL is idempotent; control traffic (barrier,
        # stop, command) is neither and is never dropped by fault injection
        resendable = self.resend_timeout_ms is not None and \
            msg.type in (MsgType.PUSH, MsgType.PULL)
        if resendable:
            # marks the frame droppable by fault injection and (for PUSH)
            # enrolls it in the server's replay-dedup signature set
            msg.meta["resend"] = True
        frame = msg.encode()
        if _verbose_level() >= 2:
            # the send loop moves opaque pre-encoded frames, so the
            # data path logs at ENQUEUE time (same wire order: the
            # priority queue is the only reordering stage)
            _log_msg("ENQ ", msg, len(frame))
        if resendable:
            p.frame, p.priority = frame, priority
        if frame_out is not None:
            frame_out.append(frame)
        _ledger_push_hop(msg, len(frame) + 4)
        if self._reconnect and msg.type == MsgType.PUSH \
                and msg.meta.get("round") is not None \
                and msg.meta.get("chunk") is None:
            self._retain_push(msg.key, int(msg.meta["round"]), [frame],
                              priority)
        with self._plock:
            self._pending[rid] = p
        # chaos ``corrupt@``: the queued copy may get one bit flipped;
        # the retained p.frame / _last_push copies stay clean, so the
        # retry path re-delivers an intact frame
        self._sendq.push(maybe_corrupt_frame(msg, frame), priority)
        return rid

    def pause_sending(self) -> None:
        """Hold the wire: queued messages accumulate in the priority queue
        (so their eventual send order is by priority, not submission)."""
        self._send_gate.clear()

    def resume_sending(self) -> None:
        self._send_gate.set()

    def pause_pull_stream(self) -> None:
        """Hold the server's chunked-reply drain for THIS connection:
        queued pull-reply chunks accumulate server-side and leave in
        priority order on resume (test hook, mirror of pause_sending)."""
        self._request(Msg(MsgType.COMMAND, meta={"cmd": "pause_pull_stream"}))

    def resume_pull_stream(self) -> None:
        self._request(Msg(MsgType.COMMAND,
                          meta={"cmd": "resume_pull_stream"}))

    def wait(self, rid: int, timeout: Optional[float] = None) -> Msg:
        """Block until request `rid` completes (reference Customer::Wait).
        With resend enabled, the request is retransmitted each time the
        resend timeout expires without a reply.  A chunked P3 push's
        meta-rid waits on every chunk."""
        subs = self._multi.pop(rid, None)
        if subs is not None:
            import time as _time
            deadline = None if timeout is None else \
                _time.monotonic() + timeout
            reply = None
            for i, r in enumerate(subs):
                remain = None if deadline is None else \
                    max(1e-3, deadline - _time.monotonic())
                try:
                    reply = self._wait_one(r, remain)
                except BaseException:
                    # the push as a whole failed: drop the sibling chunks'
                    # pending entries (each retains its frame for resend)
                    with self._plock:
                        for r2 in subs[i + 1:]:
                            self._pending.pop(r2, None)
                    raise
            return reply
        return self._wait_one(rid, timeout)

    def _wait_one(self, rid: int, timeout: Optional[float] = None) -> Msg:
        with self._plock:
            p = self._pending.get(rid)
        if p is None:
            raise KeyError(f"unknown timestamp {rid}")
        if self.resend_timeout_ms is None or p.frame is None:
            ok = p.event.wait(timeout)
        else:
            import time as _time
            deadline = None if timeout is None else \
                _time.monotonic() + timeout
            slice_s = self.resend_timeout_ms / 1000.0
            while True:
                remain = None if deadline is None else \
                    deadline - _time.monotonic()
                if remain is not None and remain <= 0:
                    ok = p.event.is_set()
                    break
                w = slice_s if remain is None else min(slice_s, remain)
                ok = p.event.wait(w)
                if ok:
                    break
                count_retry("resend")
                self._sendq.push(p.frame, p.priority)  # retransmit
        with self._plock:
            self._pending.pop(rid, None)
        if not ok:
            raise TimeoutError(f"request {rid} timed out")
        if p.reply is None:
            raise ConnectionError("server closed")
        if p.reply.type == MsgType.ERROR:
            if p.reply.meta.get("wrong_shard"):
                raise WrongShardError(
                    p.reply.meta.get("error", "wrong shard"),
                    map_version=int(p.reply.meta.get("map_version", 0)))
            raise RuntimeError(p.reply.meta.get("error", "server error"))
        return p.reply

    def _request(self, msg: Msg, priority: int = 0,
                 timeout: Optional[float] = 60.0) -> Msg:
        return self.wait(self._submit(msg, priority), timeout)

    # ---- KVWorker surface --------------------------------------------------

    def init(self, key: str, value: np.ndarray,
             meta: Optional[dict] = None) -> None:
        self._request(Msg(MsgType.INIT, key=key, meta=dict(meta or {}),
                          array=np.asarray(value, np.float32)))

    def push(self, key: str, grad: np.ndarray, priority: int = 0,
             meta: Optional[dict] = None) -> None:
        self.wait(self.push_async(key, grad, priority, meta=meta))

    def push_async(self, key: str, grad: np.ndarray, priority: int = 0,
                   meta: Optional[dict] = None) -> int:
        g = np.asarray(grad)
        if g.dtype != np.float16:  # fp16 wire payloads keep their dtype
            g = g.astype(np.float32, copy=False)
        m = dict(meta or {})
        if m.get("round") is not None:
            # an explicit round id (a sharded-tier wrapper owning round
            # numbering across re-routes, or a recovery replay) wins;
            # the local counter only ever catches UP to it
            rnd = int(m["round"])
            self._key_rounds[key] = max(self._key_rounds.get(key, 0), rnd)
        else:
            rnd = self._key_rounds.get(key, 0) + 1
            self._key_rounds[key] = rnd
        # round-correlated client span (telemetry/tracing.py): the same
        # round_id the server threads through merge/relay/pull, so a
        # worker-side trace merges onto the WAN round timeline.  No-op
        # unless the process profiler is running.
        from geomx_tpu_torch.utils.profiler import get_profiler
        get_profiler().instant(f"ClientPush:{key}", "kvstore",
                               args={"key": key, "round_id": rnd})
        if self._slicer is not None and g.size > self.p3_slice_elems \
                and not (set(m) - {"round", "reliable"}):
            # P3: slice into priority-tagged chunks; each is an independent
            # resendable PUSH, reassembled server-side.  One key must not
            # have two chunked pushes from the same sender in flight (the
            # training loop pushes each key once per round, as the
            # reference's does).  Routing meta (round/reliable) rides
            # every chunk; any other meta forces the whole-tensor path.
            flat = g.reshape(-1)
            extra = {"reliable": True} if m.get("reliable") else {}
            frames: Optional[list] = [] if self._reconnect else None
            rids = [self._submit(
                Msg(MsgType.PUSH, key=key,
                    meta={"chunk": ch.index, "num_chunks": ch.num_chunks,
                          "start": ch.start, "n_total": int(g.size),
                          "shape": list(g.shape), "round": rnd,
                          # declared payload bytes for THIS chunk: the
                          # ledger reconciles the sum against measured
                          # frame bytes (P3 framing is overhead)
                          "wire_declared":
                              (ch.stop - ch.start) * g.dtype.itemsize,
                          **extra},
                    array=flat[ch.start:ch.stop]),
                priority=priority, frame_out=frames)
                for ch in self._slicer.chunks(key, int(g.size), priority)]
            if frames is not None:
                # session resume for a CHUNKED round: retain the whole
                # clean chunk set until the round's pull reply lands
                self._retain_push(key, rnd, frames, priority)
            mrid = next(self._rid)
            self._multi[mrid] = rids
            return mrid
        m.setdefault("round", rnd)
        # the sender-declared wire cost: what the payload claims to be
        # (for a pre-compressed pair push this IS the compressor's
        # declared bytes) — the ledger's honesty ratio reconciles the
        # measured frame bytes against it (docs/telemetry.md)
        m.setdefault("wire_declared", int(g.nbytes))
        return self._submit(Msg(MsgType.PUSH, key=key, meta=m, array=g),
                            priority=priority)

    # DSCP class names -> codepoints (AFxy = 8x + 2y, CSx = 8x, EF = 46)
    _DSCP_NAMES = {
        **{f"AF{x}{y}": 8 * x + 2 * y
           for x in (1, 2, 3, 4) for y in (1, 2, 3)},
        **{f"CS{x}": 8 * x for x in range(8)},
        "EF": 46,
    }

    @classmethod
    def _parse_dscp(cls, spec):
        """GEOMX_DGT_DSCP -> list of per-channel DSCP codepoints.
        Accepts integers 0-63 and standard class names (EF, AFxy, CSx).
        Default descending assured-forwarding ladder AF41/AF31/AF21/AF11;
        "off"/"0"/"" disables the per-channel sockets entirely."""
        if spec is None or spec.strip() == "":
            return [34, 26, 18, 10]
        if spec.strip().lower() in ("off", "0", "none"):
            return []
        out = []
        for tok in spec.split(","):
            tok = tok.strip()
            if not tok:
                continue
            name = cls._DSCP_NAMES.get(tok.upper())
            if name is not None:
                out.append(name)
                continue
            try:
                v = int(tok)
            except ValueError:
                raise ValueError(
                    f"GEOMX_DGT_DSCP: {tok!r} is neither a DSCP "
                    "codepoint (0-63) nor a class name (EF/AFxy/CSx)")
            if not 0 <= v <= 63:
                raise ValueError(
                    f"GEOMX_DGT_DSCP: {v} outside the 6-bit field 0-63")
            out.append(v)
        return out

    def _evict_channel(self, ch: int, s) -> None:
        with self._dgt_ch_lock:
            cur = self._dgt_ch_socks.get(ch)
            if cur is not None and cur[0] is s:
                del self._dgt_ch_socks[ch]
        try:
            s.close()
        except OSError:
            pass

    def _dgt_channel_send(self, msg: Msg, ch: int) -> bool:
        """Handle a deferred chunk on channel ``ch``'s own DSCP-marked
        socket: lazily connected, a drain thread discards the ACKs (so
        the server's replies never back-pressure its handler) and evicts
        the entry at EOF so a restarted server gets a fresh connection.
        Sends carry a short timeout — a blocked channel SHEDS the chunk
        (best-effort semantics; mid-frame state is unrecoverable, so the
        socket is evicted too) instead of wedging the pusher.  Returns
        True when the chunk was handled here (sent or shed); False =
        channel path unavailable, caller falls back to the main socket's
        priority queue — same send-order discipline, no IP marking."""
        if not self._dgt_dscp:
            return False
        with self._dgt_ch_lock:
            if self._closed:
                return False
            entry = self._dgt_ch_socks.get(ch)
        if entry is None:
            try:
                s = socket.create_connection(self.addr, timeout=5.0)
            except OSError:
                return False
            s.settimeout(2.0)
            dscp = self._dgt_dscp[min(max(ch, 1) - 1,
                                      len(self._dgt_dscp) - 1)]
            try:
                s.setsockopt(socket.IPPROTO_IP, socket.IP_TOS, dscp << 2)
            except OSError:
                pass  # marking is best-effort (e.g. odd stacks)

            def _drain(sock=s, ch=ch):
                try:
                    while recv_frame(sock) is not None:
                        pass
                except (OSError, ValueError, pickle.UnpicklingError):
                    pass
                self._evict_channel(ch, sock)

            with self._dgt_ch_lock:
                if self._closed or ch in self._dgt_ch_socks:
                    # lost a race with close() or another sender
                    entry = self._dgt_ch_socks.get(ch)
                    try:
                        s.close()
                    except OSError:
                        pass
                    if entry is None:
                        return False
                else:
                    entry = self._dgt_ch_socks[ch] = (s, threading.Lock())
                    threading.Thread(target=_drain, daemon=True).start()
        s, lk = entry
        msg.sender = self.sender_id
        msg.meta["rid"] = next(self._rid)
        try:
            with lk:
                send_frame(s, msg)
            return True
        except socket.timeout:
            self.dgt_shed_blocks += 1
            self._evict_channel(ch, s)
            return True
        except OSError:
            self._evict_channel(ch, s)
            return False

    def push_dgt(self, key: str, grad: np.ndarray, priority: int = 0,
                 k: Optional[float] = None, block_elems: Optional[int] = None,
                 channels: Optional[int] = None,
                 alpha: Optional[float] = None, wait: bool = True,
                 reliable: bool = False, best_effort: Optional[bool] = None,
                 timeout: Optional[float] = 120.0):
        """DGT on the host wire (reference kv_app.h:1088-1196,
        van.cc:723-846, re-expressed for a reliable transport): the
        gradient is sliced into blocks, each block's contribution is an
        EWMA of its mean |g|, and blocks ship as chunks whose *send
        priority* follows contribution — the top round(k*nblocks) blocks
        take the wire first at full precision (the reference's TCP channel
        0), the rest queue behind them on descending 'channels' (its UDP
        DSCP ladder) and are fp16-encoded (its low-bit encode()).  All
        blocks are resend-protected, i.e. DGT-with-reliable-resend — the
        convergence-safe configuration; the server reassembles via the
        chunk path.  Defaults mirror DMLC_K=0.8, DGT_BLOCK_SIZE=4096B,
        DMLC_UDP_CHANNEL_NUM=3, DGT_CONTRI_ALPHA=0.3.

        ``best_effort=True`` (or GEOMX_DGT_BEST_EFFORT=1) is the
        reference's actual lossy-channel bet (van.cc:723-846): deferred
        (below-k) blocks ship fire-and-forget — droppable on the wire,
        never retransmitted, never waited on, and shed client-side when
        the send queue is congested (GEOMX_DGT_MAX_QUEUE frames) — while
        the top-k blocks stay reliable.  The server finalizes the push
        after a deadline, treating missing blocks as zeros; the error
        lands in the next round's contribution EWMA."""
        from geomx_tpu_torch.config import _env
        if best_effort is None:
            best_effort = bool(_env(("GEOMX_DGT_BEST_EFFORT",), 0, int))
        if k is None:
            k = _env(("GEOMX_DGT_K", "DMLC_K"), 0.8, float)
        if block_elems is None:
            block_elems = _env(("GEOMX_DGT_BLOCK_ELEMS",), 1024, int)
        if channels is None:
            channels = _env(("GEOMX_UDP_CHANNEL_NUM",
                             "DMLC_UDP_CHANNEL_NUM"), 3, int)
        if alpha is None:
            alpha = _env(("GEOMX_DGT_CONTRI_ALPHA", "DGT_CONTRI_ALPHA"),
                         0.3, float)
        g = np.asarray(grad, np.float32)
        flat = g.reshape(-1)
        n = flat.size
        nb = max(1, -(-n // block_elems))
        mag = np.array([np.abs(flat[b * block_elems:
                                    (b + 1) * block_elems]).mean()
                        for b in range(nb)], np.float32)
        prev = self._dgt_contri.get(key)
        contri = mag if prev is None else alpha * prev + (1 - alpha) * mag
        self._dgt_contri[key] = contri
        order = np.argsort(-contri, kind="stable")
        kn = max(1, int(round(k * nb)))

        rnd = self._key_rounds.get(key, 0) + 1
        self._key_rounds[key] = rnd
        # graftlint: disable=GXL006 — host-plane knob
        max_q = int(os.environ.get("GEOMX_DGT_MAX_QUEUE", "256"))
        rids = []
        shed = 0
        for rank, b in enumerate(np.asarray(order)):
            start = int(b) * block_elems
            stop = min(n, start + block_elems)
            payload = flat[start:stop]
            deferred = rank >= kn
            if not deferred:
                pr = priority + 1
            else:
                ch = 1 + (rank - kn) % max(1, channels)
                pr = priority - ch
                payload = payload.astype(np.float16)  # low-bit encode
            m = {"chunk": int(b), "num_chunks": nb, "start": start,
                 "n_total": n, "shape": list(g.shape), "round": rnd}
            if best_effort:
                m["num_required"] = kn
                m["required"] = not deferred
            if reliable:
                m["reliable"] = True  # e.g. the WAN relay hop: exempt
                # from drop injection like every other relay message
            if best_effort and deferred:
                # lossy channel: fire-and-forget.  Droppable on the
                # wire, no pending entry (the ACK, if any, is ignored),
                # and shed outright under send-queue congestion.
                m["best_effort"] = True
                try:
                    congested = len(self._sendq) >= max_q
                except TypeError:
                    congested = False
                if congested:
                    shed += 1
                    continue
                # channel's own DSCP-marked socket first (the reference's
                # per-channel UDP + descending DSCP); main-queue fallback
                msg = Msg(MsgType.PUSH, key=key, meta=m, array=payload)
                if not self._dgt_channel_send(msg, ch):
                    self._submit(msg, priority=pr, fire_and_forget=True)
                continue
            rids.append(self._submit(
                Msg(MsgType.PUSH, key=key, meta=m, array=payload),
                priority=pr))
        self.dgt_shed_blocks += shed
        mrid = next(self._rid)
        self._multi[mrid] = rids
        if not wait:
            return mrid
        self.wait(mrid, timeout)  # bounded: a hung server must raise,
        return None               # not wedge the caller forever

    def pull(self, key: str, priority: int = 0,
             timeout: Optional[float] = 60.0,
             meta: Optional[dict] = None) -> np.ndarray:
        """Synchronous pull.  Advertises ``sparse_ok``: a server holding
        a sparse-merged round (compressed-domain aggregation,
        docs/performance.md) replies with the (value, index) pair set
        instead of the dense tensor, and THIS is the single decompress
        of the whole round trip.  Raw `pull_async` + `wait` callers
        keep the dense wire (they never advertise)."""
        m = dict(meta or {})
        m.setdefault("sparse_ok", 1)
        reply = self.wait(self.pull_async(key, priority, meta=m), timeout)
        return self._decode_pull_reply(reply)

    @staticmethod
    def _decode_pull_reply(reply) -> np.ndarray:
        if reply.meta.get("comp") == "bsc":
            from geomx_tpu_torch.compression.sparseagg import (
                                                               decode_pairs_payload, densify_pairs_host)
            vals, idx = decode_pairs_payload(reply.array)
            out = densify_pairs_host(vals, idx, int(reply.meta["n"]))
            return out.reshape(reply.meta["shape"])
        return np.asarray(reply.array, np.float32)

    def pull_async(self, key: str, priority: int = 0,
                   meta: Optional[dict] = None) -> int:
        m = dict(meta or {})
        if self._slicer is not None:
            # P3 pull-side chunking: ask the server to slice a big reply
            # into priority-tagged chunks through its send queue, so a
            # front layer's weights can overtake a queued back-layer
            # reply (reference P3_ZPull, kv_app.h:246-306)
            m.setdefault("p3_chunk_elems", self.p3_slice_elems)
            m.setdefault("priority", priority)
        return self._submit(Msg(MsgType.PULL, key=key, meta=m),
                            priority=priority)

    def auto_pull(self, key: str, min_version: int = 0,
                  timeout: Optional[float] = 60.0) -> np.ndarray:
        """Wait for a server-initiated update of ``key`` with version >=
        ``min_version`` (reference KVWorker::AutoPull, kv_app.h:364: the
        worker blocks until the TSEngine dissemination reaches it)."""
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            with self._aplock:
                got = self._autopull.get(key)
                ev = self._apevents.setdefault(key, threading.Event())
                if got is not None and got[0] >= min_version:
                    return np.asarray(got[1], np.float32)
                if self._ap_closed:
                    raise ConnectionError("server closed")
                ev.clear()
            remain = None if deadline is None else \
                deadline - _time.monotonic()
            if remain is not None and remain <= 0:
                raise TimeoutError(f"auto_pull({key!r}) timed out")
            ev.wait(remain if remain is None else min(remain, 1.0))

    # ---- row-sparse path (reference EncodeRowSparseKey + dist push/pull,
    # src/kvstore/kvstore_dist.h:874-906) --------------------------------

    def push_row_sparse(self, key: str, row_ids, values,
                        priority: int = 0,
                        timeout: Optional[float] = 60.0) -> None:
        """Push only the touched rows of a 2D+ parameter across the dist
        plane: row ids travel in the header, row values as the payload —
        the wire moves k rows, not the whole tensor."""
        rows = np.asarray(row_ids, np.int64).ravel()
        vals = np.asarray(values, np.float32)
        vals = vals.reshape((len(rows),) + vals.shape[1:] if vals.ndim > 1
                            else (len(rows),))
        rnd = self._key_rounds.get(key, 0) + 1
        self._key_rounds[key] = rnd
        self.wait(self._submit(
            Msg(MsgType.PUSH, key=key,
                meta={"rows": [int(r) for r in rows], "round": rnd},
                array=vals),
            priority=priority), timeout)

    def pull_row_sparse(self, key: str, row_ids,
                        priority: int = 0,
                        timeout: Optional[float] = 60.0) -> np.ndarray:
        """Pull only the requested rows (the reference's workers pull just
        the embedding rows their batch touches)."""
        rows = [int(r) for r in np.asarray(row_ids, np.int64).ravel()]
        reply = self.wait(self._submit(
            Msg(MsgType.PULL, key=key, meta={"rows": rows}),
            priority=priority), timeout)
        return np.asarray(reply.array, np.float32)

    def recover(self) -> Dict[str, int]:
        """Reconnect-and-resume for a restarted worker: fetch how many
        rounds this sender id already contributed per key and resume the
        client-side round counters from there, so a replayed in-flight
        push dedups server-side instead of double-merging (the recovery
        state re-send of the reference's scheduler, van.cc:165-212)."""
        reply = self._request(Msg(MsgType.COMMAND,
                                  meta={"cmd": "query_progress"}))
        prog = {str(k): int(v)
                for k, v in dict(reply.meta.get("progress", {})).items()}
        self._key_rounds.update(prog)
        return prog

    def evict_worker(self, node_id: int) -> int:
        """Ask the server to evict a dead worker from the sync gate
        (resilience/ — server-side eviction): the remaining workers'
        rounds complete at the smaller count instead of stalling.
        Returns the server's new num_workers."""
        reply = self._request(Msg(MsgType.COMMAND, meta={
            "cmd": "evict_worker", "node": int(node_id)}))
        return int(reply.meta["num_workers"])

    # ---- TSEngine push-side overlay (ASK1 aggregation tree) ---------------

    def ts_push(self, key: str, grad: np.ndarray, num_merge: int = 1) -> None:
        """Merge a partial aggregate into the local buffer and announce it
        to the scheduler (reference TS_ZPush, kv_app.h:313-341: stash via
        the request handle, then Ask1).  The data moves later, when a
        TS_DIRECTIVE pairs this node — to a peer (relay merge) or to the
        server (sink) with the accumulated num_merge count.  Completion is
        observed via auto_pull / a min_round-gated pull, not a per-push
        ACK."""
        if self.ts_node is None:
            raise RuntimeError("client not in TS mode (pass ts_node=)")
        g = np.asarray(grad, np.float32)
        with self._ts_lock:
            buf = self._ts_buf.get(key)
            if buf is None:
                self._ts_buf[key] = [g.copy(), int(num_merge)]
            else:
                buf[0] = buf[0] + g
                buf[1] += int(num_merge)
        self._request(Msg(MsgType.COMMAND,
                          meta={"cmd": "ts_ask1", "node": self.ts_node,
                                "key": key}))

    def _relay_accept_loop(self):
        while not self._closed:
            try:
                conn, _ = self._ts_listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)
            threading.Thread(target=self._relay_serve, args=(conn,),
                             daemon=True).start()

    def _relay_serve(self, conn: socket.socket):
        """Accept peers' partials: merge-and-forward (the WorkersMerge
        role, kvstore_dist.h:91-169) — merge into the local buffer, ACK,
        re-announce via ASK1."""
        while not self._closed:
            try:
                msg = recv_frame(conn)
            except (OSError, pickle.UnpicklingError, ValueError):
                return
            if msg is None:
                return
            if msg.type != MsgType.RELAY:
                continue
            # dedup by (sender node, seq): a peer whose ACK timed out
            # retransmits the same frame (possibly on a fresh connection)
            # — merge once, re-ACK always
            frm, seq = msg.meta.get("from"), msg.meta.get("seq")
            dup = False
            if frm is not None and seq is not None:
                with self._ts_lock:
                    seen = self._relay_seen.setdefault(int(frm), set())
                    dup = seq in seen
                    if not dup:
                        seen.add(seq)
                        while len(seen) > 128:
                            seen.discard(min(seen))
            if not dup:
                self.ts_push(msg.key, msg.array,
                             num_merge=int(msg.meta.get("num_merge", 1)))
            try:
                send_frame(conn, Msg(MsgType.ACK, key=msg.key))
            except OSError:
                return

    def _ts_dispatch_loop(self):
        while not self._closed:
            try:
                d = self._ts_directives.get(timeout=0.2)
            except queue.Empty:
                continue
            key = d.key
            with self._ts_lock:
                buf = self._ts_buf.pop(key, None)
            if buf is None:
                # ghost directive: the buffer already shipped under an
                # earlier pairing (a RELAY merge landed between the
                # scheduler's decision and this pop).  The pairing consumed
                # the designated receiver's ask, so without a rescue the
                # receiver would never be directed again and the round
                # stalls — tell the server so drain_key
                # redirects the stranded receiver to the sink.
                to = int(d.meta.get("to", 0))
                if to != 0:
                    self._notify_relay_failed(key, to)
                continue
            arr, m = buf
            to = int(d.meta.get("to", 0))
            if to == 0:
                self.push(key, arr, meta={"num_merge": m})
                continue
            addr = (d.meta["host"], int(d.meta["port"]))
            # one seq for every attempt at this partial: the receiver
            # dedups retransmits by (from, seq)
            seq = next(self._relay_seq)
            # graftlint: disable=GXL006 — host-plane knob
            retries = int(os.environ.get("GEOMX_RELAY_RETRIES", "3"))
            t0 = time.monotonic()
            delivered = False
            backoff = SeededBackoff(seed=(self.ts_node or 0) * 131 + seq,
                                    base_s=0.05, max_s=0.5)
            for attempt in range(1 + retries):
                if attempt:
                    # shared retry discipline (service/retry.py): count
                    # it, then the seeded-jitter pause
                    count_retry("ts_relay")
                    time.sleep(backoff.next())
                try:
                    self._relay_send(addr, key, arr, m, seq)
                    delivered = True
                    break
                except _RelayConnectError:
                    break  # nothing was sent: safe to re-route at once
                except OSError:
                    # timeout OR reset after the frame went out: it may
                    # already be delivered AND merged, so it must NEVER
                    # be re-routed (that would double-count it at the
                    # sink) — retry the SAME peer, which dedups by
                    # (from, seq) on a fresh connection
                    continue
            if not delivered:
                # unreachable (or persistently hung — presumed dead, its
                # buffer lost with it): sink our own partial directly AND
                # tell the scheduler, which directs the stranded receiver
                # (whose ask was consumed by this pairing) straight to the
                # sink — otherwise its buffered partial never moves and
                # the round cannot complete
                self.push(key, arr, meta={"num_merge": m})
                self._notify_relay_failed(key, to)
                continue
            dt = max(time.monotonic() - t0, 1e-9)
            try:  # throughput feedback steers future pairings
                self._request(Msg(MsgType.COMMAND, meta={
                    "cmd": "ts_report", "sender": self.ts_node,
                    "receiver": to, "throughput": arr.nbytes / dt}))
            except Exception:
                pass

    def _notify_relay_failed(self, key: str, receiver: int) -> None:
        """Best-effort: tell the scheduler a pairing broke so drain_key
        redirects the stranded receiver (and the rest of the round's
        queue) to the sink."""
        try:
            self._request(Msg(MsgType.COMMAND, meta={
                "cmd": "ts_relay_failed", "key": key,
                "receiver": receiver}))
        except Exception:
            pass

    def _relay_send(self, addr, key: str, arr: np.ndarray, m: int,
                    seq: Optional[int] = None):
        sock = self._ts_peers.get(addr)
        if sock is None:
            try:
                sock = connect_retry(addr, total_timeout_s=10.0)
            except OSError as e:
                # no frame left this host: the caller may re-route the
                # partial without any double-count risk
                raise _RelayConnectError(str(e)) from e
            # a peer that accepted but hung must raise (socket.timeout is
            # an OSError) rather than wedge the single dispatch thread
            # forever; the dispatcher retries the same
            # (from, seq) frame so a slow-but-alive peer dedups
            # graftlint: disable=GXL006 — host-plane knob
            sock.settimeout(float(os.environ.get(
                "GEOMX_RELAY_TIMEOUT_S", "30")))
            self._ts_peers[addr] = sock
        msg = Msg(MsgType.RELAY, key=key,
                  meta={"num_merge": m, "from": self.ts_node, "seq": seq},
                  array=arr)
        msg.sender = self.sender_id
        try:
            send_frame(sock, msg)
            rep = recv_frame(sock)
        except OSError:
            self._ts_peers.pop(addr, None)
            try:
                sock.close()
            except OSError:
                pass
            raise
        if rep is None or rep.type != MsgType.ACK:
            self._ts_peers.pop(addr, None)
            raise OSError(f"relay to {addr} rejected: {rep}")

    def barrier(self, timeout: Optional[float] = 120.0) -> None:
        """Tier-wide barrier (reference kvstore.py:_barrier): returns once
        every expected worker has entered."""
        reply = self._request(Msg(MsgType.BARRIER), timeout=timeout)
        if reply.type != MsgType.BARRIER_RELEASE:
            raise ConnectionError(f"barrier failed: {reply}")

    def set_optimizer(self, name: str, **kwargs) -> None:
        self._request(Msg(MsgType.COMMAND,
                          meta={"cmd": "set_optimizer", "name": name,
                                "kwargs": kwargs}))

    def set_gradient_compression(self, spec: str) -> None:
        self._request(Msg(MsgType.COMMAND,
                          meta={"cmd": "set_gradient_compression",
                                "spec": spec}))

    # ---- remote profiler control (reference kSetProfilerParams,
    # kvstore_dist.h:197-203: a worker configures/starts/dumps profilers on
    # remote servers) ------------------------------------------------------
    def set_profiler_params(self, **params) -> None:
        self._request(Msg(MsgType.COMMAND,
                          meta={"cmd": "set_profiler_params",
                                "params": params}))

    def profiler_start(self) -> None:
        self._request(Msg(MsgType.COMMAND, meta={"cmd": "profiler_start"}))

    def profiler_stop(self) -> None:
        self._request(Msg(MsgType.COMMAND, meta={"cmd": "profiler_stop"}))

    def profiler_dump(self) -> str:
        reply = self._request(Msg(MsgType.COMMAND,
                                  meta={"cmd": "profiler_dump"}))
        return reply.meta["path"]

    def wire_stats(self) -> dict:
        """The SERVER process's sent/received byte+message counters (the
        reference Van's send_bytes_/recv_bytes_, van.h:182-183).  This
        process's own counters are
        ``geomx_tpu_torch.service.protocol.wire_stats.snapshot()``."""
        reply = self._request(Msg(MsgType.COMMAND,
                                  meta={"cmd": "wire_stats"}))
        return dict(reply.meta["stats"])

    def metrics_text(self) -> str:
        """The SERVER process's live Prometheus exposition
        (telemetry/export.py) — ``COMMAND {cmd: "metrics"}``, the
        wire-protocol twin of the scheduler's GET /metrics."""
        reply = self._request(Msg(MsgType.COMMAND,
                                  meta={"cmd": "metrics"}))
        return str(reply.meta["text"])

    def num_dead_nodes(self, timeout: Optional[float] = None) -> int:
        reply = self._request(Msg(MsgType.COMMAND,
                                  meta={"cmd": "num_dead_nodes",
                                        "timeout": timeout}))
        return len(reply.meta["dead"])

    def heartbeat(self) -> None:
        self._request(Msg(MsgType.HEARTBEAT))

    def stop_server(self) -> bool:
        """Send kStopServer; True iff the server ACKed it.  False means
        the STOP may never have left this client (e.g. it timed out in a
        send queue that close() is about to discard) — a caller tearing
        down a tier must retry on a fresh connection or the server
        strands listening forever."""
        try:
            self._request(Msg(MsgType.STOP), timeout=5.0)
            return True
        except (ConnectionError, OSError, TimeoutError):
            return False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # return this client's retained re-push bytes to the shared
        # gauge (same sender label may outlive us — e.g. a failover
        # rebuild — and must not inherit a dead client's balance)
        with self._buf_lock:
            freed = sum(sum(len(f) for f in h[1])
                        for h in self._last_push.values())
            self._last_push.clear()
            if freed:
                self._resend_buffer_bytes -= freed
                self._m_resend_buf.dec(freed)
        self._closing.set()     # abort an in-flight reconnect promptly
        self._conn_ok.set()     # ... and a sender parked on it
        self._send_gate.set()  # release a paused sender so it can exit
        self._sendq.close()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._dgt_ch_lock:
            for s, _lk in self._dgt_ch_socks.values():
                try:
                    s.close()
                except OSError:
                    pass
            self._dgt_ch_socks.clear()
        if self.ts_node is not None:
            try:
                self._ts_listener.close()
            except OSError:
                pass
            for s in self._ts_peers.values():
                try:
                    s.close()
                except OSError:
                    pass
        # free the native queue only after the sender can no longer touch it
        self._sender.join(timeout=2.0)
        if self._native_q and not self._sender.is_alive():
            self._sendq.destroy()
