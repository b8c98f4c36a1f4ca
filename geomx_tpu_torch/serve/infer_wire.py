"""Native binary inference lane: persistent sockets, zero-copy frames
(port of geomx_tpu/serve/infer_wire.py; INFER and INFER_REPLY frames
are byte-identical to the JAX package's).

The serving fast path's front door for high-QPS clients.  The HTTP
``POST /infer`` door pays a TCP connect + JSON encode/decode per
request; this lane speaks the service plane's v0x02 zero-copy TLV wire
(service/protocol.py) over ONE persistent connection per client:

- request: ``Msg(INFER, key="infer", meta={"rid", "wire_declared"},
  array=float32[rows, feat])`` — the payload crosses as raw fp32 and
  decodes as a zero-copy ``np.frombuffer`` view straight into the
  gateway's queue (the batch assembler's row copy is the only copy);
- reply: ``Msg(INFER_REPLY, meta={"rid", "version", "round",
  "batch_sizes", "staleness_s", "layer_rounds", "wire_declared"},
  array=float32[rows, out])`` — the freshness-provenance keys are
  additive (old clients ignore them: mixed-fleet safe) — or an
  error meta (``shed`` / ``timeout`` / the exception repr) instead of
  a torn socket, mirroring the registry's ERROR-frame discipline;
- both directions land in the process-global RequestLedger's byte-true
  wire accounting: actual on-wire frame bytes (length prefix included)
  against the sender's ``wire_declared`` payload claim — the same
  honesty audit the gradient plane runs, here bounding inference frame
  overhead (the ≤ 1.02 serving acceptance gate).

Both doors feed the SAME gateway queue and the same continuous-
batching worker — the lane changes transport cost, never semantics:
shedding, timeouts, the request ledger and the SLO policy see one
unified request stream, each record labeled with its transport.

Host-plane Python only (numpy + sockets, no torch at import).
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Optional, Tuple

import numpy as np

from geomx_tpu_torch.serve.gateway import InferenceGateway
from geomx_tpu_torch.service.protocol import (Msg, MsgType, connect_retry,
                                        recv_frame_sized, send_frame)


def _account(direction: str, nbytes: int, declared=None) -> None:
    try:
        from geomx_tpu_torch.telemetry.ledger import get_request_ledger
        get_request_ledger().account_wire("native", direction, nbytes,
                                          declared=declared)
    except Exception:
        pass


class NativeInferenceServer:
    """TCP front for one :class:`InferenceGateway` — the service-plane
    accept/serve/dispatch socket loop (the RegistryServer idiom), one
    daemon thread per persistent client connection."""

    def __init__(self, gateway: InferenceGateway, port: int = 0,
                 bind_host: Optional[str] = None):
        self.gateway = gateway
        if bind_host is None:
            # host-plane bind knob, parity with GeoPSServer/Registry
            # graftlint: disable=GXL006 — host-plane knob
            bind_host = os.environ.get("GEOMX_PS_BIND_HOST", "127.0.0.1")
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        from geomx_tpu_torch.service.server import GeoPSServer
        GeoPSServer._bind_with_retry(self._srv, bind_host, int(port))
        self._srv.listen(64)
        self._srv.settimeout(0.2)
        self.addr = self._srv.getsockname()
        self.port = self.addr[1]
        self._running = True
        self._conns: set = set()
        self.frames_served = 0
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="infer-accept", daemon=True)

    def start(self) -> "NativeInferenceServer":
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        for sock in [self._srv] + list(self._conns):
            try:
                sock.close()
            except OSError:
                pass

    def join(self, timeout: Optional[float] = None) -> None:
        self._accept_thread.join(timeout)

    # ---- networking --------------------------------------------------------

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        try:
            while self._running:
                got = recv_frame_sized(conn)
                if got is None:
                    return
                if not self._dispatch(conn, *got):
                    return
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            self._conns.discard(conn)
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, conn: socket.socket, msg: Msg,
                  nbytes: int) -> bool:
        if msg.type != MsgType.INFER:
            send_frame(conn, Msg(
                MsgType.ERROR, sender=-1,
                meta={"error": f"unhandled {msg.type.name}",
                      "rid": msg.meta.get("rid", 0)}))
            return True
        rid = msg.meta.get("rid", 0)
        _account("rx", nbytes, declared=msg.meta.get("wire_declared"))
        # a malformed batch answers an INFER_REPLY error frame, never a
        # torn socket — the client would otherwise retry the identical
        # frame and see an opaque ConnectionError instead of the cause
        try:
            arr = np.asarray(msg.array, np.float32)
            if arr.ndim == 1:
                arr = arr[None, :]
            if arr.ndim < 2 or arr.shape[0] < 1:
                raise ValueError(f"bad inference batch shape {arr.shape}")
        except (TypeError, ValueError) as e:
            tx = send_frame(conn, Msg(
                MsgType.INFER_REPLY, sender=-1,
                meta={"rid": rid, "error": f"bad request: {e!r}"}))
            _account("tx", tx)
            return True
        gw = self.gateway
        reqs = [gw.submit(arr[i], transport="native")
                for i in range(arr.shape[0])]
        gw.wait_requests(reqs)
        if any(r.error == "shed" for r in reqs):
            tx = send_frame(conn, Msg(
                MsgType.INFER_REPLY, sender=-1,
                meta={"rid": rid, "error": "shed",
                      "shed": sum(1 for r in reqs
                                  if r.error == "shed")}))
            _account("tx", tx)
            return True
        if any(r.error or r.result is None for r in reqs):
            tx = send_frame(conn, Msg(
                MsgType.INFER_REPLY, sender=-1,
                meta={"rid": rid,
                      "error": next((r.error or "timeout") for r in reqs
                                    if r.error or r.result is None)}))
            _account("tx", tx)
            return True
        out = np.ascontiguousarray(
            np.stack([np.asarray(r.result) for r in reqs]), np.float32)
        stale = gw.replica.staleness_s()
        tx = send_frame(conn, Msg(
            MsgType.INFER_REPLY, key="infer", sender=-1,
            # staleness_s + layer_rounds are additive freshness
            # provenance: the v0x02 TLV meta codec ships unknown keys
            # through its generic fallback, so an old client decodes
            # the frame unchanged and simply ignores them (mixed-fleet
            # safe — pinned by test_infer_reply_provenance_wire_safe)
            meta={"rid": rid, "version": gw.replica.version,
                  "round": gw.replica.last_round(),
                  "batch_sizes": [r.batch_size for r in reqs],
                  "staleness_s": (None if stale == float("inf")
                                  else float(stale)),
                  "layer_rounds": gw.replica.layer_rounds(),
                  "wire_declared": int(out.nbytes)},
            array=out))
        _account("tx", tx, declared=int(out.nbytes))
        self.frames_served += 1
        return True


class NativeInferenceClient:
    """One persistent connection to a :class:`NativeInferenceServer`.

    Synchronous request/reply; thread-UNSAFE by design (one client per
    load thread — a lock would serialize exactly the concurrency the
    lane exists to win).  A send that dies mid-flight reconnects once
    and replays: inference is idempotent, so the retry is safe."""

    def __init__(self, addr: Tuple[str, int], timeout_s: float = 30.0):
        self.addr = (str(addr[0]), int(addr[1]))
        self.timeout_s = float(timeout_s)
        self._sock: Optional[socket.socket] = None
        self._rid = 0

    def _conn(self) -> socket.socket:
        if self._sock is None:
            self._sock = connect_retry(self.addr,
                                       total_timeout_s=self.timeout_s)
            self._sock.settimeout(self.timeout_s)
            self._sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def infer(self, x: np.ndarray, retries: int = 1) -> dict:
        """One inference batch (``[rows, feat]`` float32; a single row
        is auto-batched).  Returns ``{"outputs": float32[rows, out],
        "version", "round", "batch_sizes", "staleness_s",
        "layer_rounds"}``, or ``{"error": ...}``
        (plus ``"shed"`` count when shed) — explicit refusal, never a
        dropped request."""
        arr = np.ascontiguousarray(x, np.float32)
        if arr.ndim == 1:
            arr = arr[None, :]
        self._rid += 1
        msg = Msg(MsgType.INFER, key="infer", sender=0,
                  meta={"rid": self._rid,
                        "wire_declared": int(arr.nbytes)},
                  array=arr)
        for attempt in range(retries + 1):
            try:
                sock = self._conn()
                send_frame(sock, msg)
                got = recv_frame_sized(sock)
                if got is None:
                    raise ConnectionError("infer lane closed mid-reply")
                rep, _ = got
                break
            except (ConnectionError, OSError, TimeoutError):
                self.close()
                if attempt >= retries:
                    raise
        if rep.type == MsgType.ERROR:
            return {"error": rep.meta.get("error", "server error")}
        out = dict(rep.meta)
        if rep.array is not None:
            out["outputs"] = np.asarray(rep.array, np.float32)
        return out


def serve_native(gateway: InferenceGateway, port: int = 0,
                 bind_host: Optional[str] = None
                 ) -> Optional[NativeInferenceServer]:
    """Start the native lane next to the HTTP door, honoring the
    ``GEOMX_SERVE_NATIVE_WIRE`` knob (None when disabled).  The caller
    owns ``stop()``, mirroring :meth:`InferenceGateway.serve_http`."""
    from geomx_tpu_torch.config import GeoConfig
    if not GeoConfig.from_env().serve_native_wire:
        return None
    return NativeInferenceServer(gateway, port=port,
                                 bind_host=bind_host).start()
