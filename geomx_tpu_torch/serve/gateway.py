"""Batched inference gateway: POST /infer -> bounded queue -> the forward
(port of geomx_tpu/serve/gateway.py).

The gateway is the serving plane's front door.  Requests arrive over
the shared HTTP exporter
(:func:`~geomx_tpu_torch.telemetry.export.start_http_exporter` — the
same plumbing behind the scheduler's ``/metrics``/``/healthz``) or the
native binary ``/infer`` lane (serve/infer_wire.py), coalesce into one
bounded queue, and a continuous-batching worker drains them:

- **coalescing, deadline-or-full**: the worker takes the first waiting
  request, then absorbs arrivals until the batch FILLS or ``queue_ms``
  expires — a full batch closes the instant it fills, it never sleeps
  out the window;
- **pipelined double-buffered dispatch**: on the card a batch's forward
  is queued on the gateway's own CUDA stream and returns at once; while
  batch *t* runs on the device the worker is already draining and
  assembling batch *t+1* into a persistent pre-allocated padded bucket
  buffer (pinned, one copy per request) — host assembly and device
  compute overlap instead of serializing;
- **one captured CUDA graph a bucket**: :meth:`warmup` (run by
  :meth:`start` when input shapes are known) runs every (bucket, input
  shape) forward once eagerly on a side stream and captures it as a
  CUDA graph, so no served request pays a kernel build, an allocation or
  a Python dispatch of the model: a batch copies its rows into the
  graph's static input and replays it.  Counted in the
  ``geomx_serve_warmup_compiles`` gauge; :meth:`jit_cache_size` counts
  the captured keys.  On the CPU the forward runs eagerly, keyed the
  same way;
- **padded buckets, bounded graph cache**: a batch pads up to the next
  power-of-two bucket ≤ ``max_batch``, so the cache holds at most
  ``len(buckets)`` graphs per input shape — request count can be
  anything, capture count cannot;
- **atomic weights**: the forward reads
  :meth:`~geomx_tpu_torch.serve.replica.ServingReplica.params` once per
  batch.  A graph reads static weight tensors, so a new weight set is
  copied INTO them (never rebound) on the serving stream ahead of the
  replay that first reads it — stream order puts every earlier replay
  before the copy and every later one after it, so no batch sees a mix
  of two weight sets.  The replica's dict stays referenced until its
  copy has finished on the device: the replica's refcount gate then
  never writes a buffer the copy still reads;
- **the output survives the next replay**: each replay is followed, on
  the same stream, by a copy of the graph's static output into the
  batch's own pinned host tensor and an event; batch *t+1*'s replay
  queues behind that copy;
- **deterministic shedding**: the SLO policy's ``set_shed_fraction``
  sheds by fractional accumulator (every shed is an explicit 503 the
  client sees and the ``geomx_serve_requests_total{status="shed"}``
  counter records — a shed request is refused, never lost);
- **causal request ledger**: every request lands in the process-global
  :class:`~geomx_tpu_torch.telemetry.ledger.RequestLedger` with its
  enqueue -> batch -> forward -> reply phase seconds and transport
  lane, the p50/p99 surface ``GET /ledger`` serves.

All latency/deadline arithmetic runs on ``time.monotonic()`` — a wall
clock step mid-run must not corrupt p50/p99 or the request deadline;
wall clock survives only as the ledger record's enqueue anchor.

The forward is a zoo ``nn.Module`` of the port in eval mode under
``torch.inference_mode`` (the SeqClassifier's attention runs the flash
forward without the logsumexp, ``ops.flash_attention``), or an injected
``apply_fn(named_tensors, xb)``.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from geomx_tpu_torch.serve import register_serving_surface
from geomx_tpu_torch.serve.replica import ServingReplica

BATCH_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


# ---------------------------------------------------------------------------
# params tree <-> named-layer dict (the registry's schema).  Names are
# the JAX package's: a zero-padded leaf index (4 digits, wider when the
# tree needs it) and the leaf's key path (``['params']['Dense_0']
# ['kernel']``), leaves in ``jax.tree_util`` order (dict keys sorted at
# every level) — so dict insertion order == leaf order == the P3 "early
# layers first" refresh priority, and a model published by either
# package serves in the other.  ``unflatten_params`` rebuilds by parsing
# the integer prefix — NOT a lexicographic name sort, which would put
# "10000..." before "9999..." and silently reorder leaves.
# ---------------------------------------------------------------------------

def _leaf_index(name: str) -> int:
    """The integer leaf index a :func:`flatten_params` name starts with."""
    i = 0
    while i < len(name) and name[i].isdigit():
        i += 1
    if i == 0:
        raise ValueError(f"param name {name!r} has no leaf-index prefix")
    return int(name[:i])


class TreeDef:
    """The structure :func:`flatten_params` took apart: nested dicts,
    lists and tuples with the leaves left out, and the leaves' key
    paths in order."""

    def __init__(self, skeleton, paths: List[str]):
        self.skeleton = skeleton
        self.paths = paths


_LEAF = object()


def _variables(model) -> dict:
    """An ``nn.Module`` as the flax variables it corresponds to:
    ``{"params": nested, "batch_stats": nested}`` (the port keeps flax's
    names as dotted paths; ``batch_stats`` only when it has buffers)."""
    def nest(flat):
        out: dict = {}
        for path, t in flat.items():
            node = out
            *head, last = path.split(".")
            for part in head:
                node = node.setdefault(part, {})
            node[last] = t
        return out

    persistent = set(model.state_dict().keys())
    out = {"params": nest(dict(model.named_parameters()))}
    bufs = {n: b for n, b in model.named_buffers() if n in persistent}
    if bufs:
        out["batch_stats"] = nest(bufs)
    return out


def _to_numpy(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf, np.float32)


def flatten_params(tree) -> Tuple[Dict[str, np.ndarray], TreeDef]:
    """A params tree (an ``nn.Module``, or nested dicts / lists / tuples
    of arrays or tensors) as ``({name: np.float32 array}, treedef)``."""
    if hasattr(tree, "named_parameters"):
        tree = _variables(tree)
    leaves: List[Tuple[str, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(node[k], f"{path}[{k!r}]")
                    for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{path}[{i}]")
                              for i, v in enumerate(node))
        leaves.append((path, node))
        return _LEAF

    skeleton = walk(tree, "")
    named = {f"{i:04d}{path}": _to_numpy(leaf)
             for i, (path, leaf) in enumerate(leaves)}
    return named, TreeDef(skeleton, [p for p, _ in leaves])


def unflatten_params(treedef: TreeDef, named: Dict[str, np.ndarray]):
    """Inverse of :func:`flatten_params` (names sort by their integer
    leaf-index prefix; the sequence must be contiguous from 0)."""
    keys = sorted(named, key=_leaf_index)
    if [_leaf_index(k) for k in keys] != list(range(len(keys))):
        raise ValueError(
            "named params do not form a contiguous 0..n-1 leaf-index "
            "sequence — refusing to rebuild a reordered tree")
    if len(keys) != len(treedef.paths):
        raise ValueError(f"{len(keys)} named params for a tree of "
                         f"{len(treedef.paths)} leaves")
    it = iter(named[k] for k in keys)

    def build(node):
        if node is _LEAF:
            return next(it)
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return type(node)(build(v) for v in node)

    return build(treedef.skeleton)


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to (and including) ``max_batch``."""
    out = []
    b = 1
    while b < int(max_batch):
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return tuple(sorted(set(out)))


class _Request:
    __slots__ = ("x", "event", "result", "error", "rid", "t_enqueue",
                 "t_enqueue_unix", "t_batch", "batch_size", "bucket",
                 "transport", "model_version", "model_round",
                 "layer_rounds", "staleness_s", "_taken_lock", "_taken")

    def __init__(self, x: np.ndarray, rid: int,
                 transport: str = "local"):
        self.x = x
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[str] = None
        self.rid = rid
        # monotonic for every latency/deadline computation; wall clock
        # kept ONLY as the ledger record's anchor
        self.t_enqueue = time.monotonic()
        self.t_enqueue_unix = time.time()
        self.t_batch: Optional[float] = None
        self.batch_size = 0
        self.bucket = 0
        self.transport = transport
        # freshness provenance, stamped at dispatch from the weight set
        # the batch actually ran on (None until then / on non-ok ends)
        self.model_version: Optional[str] = None
        self.model_round: Optional[int] = None
        self.layer_rounds: Optional[Dict[str, int]] = None
        self.staleness_s: Optional[float] = None
        self._taken_lock = threading.Lock()
        self._taken = False

    def take(self) -> bool:
        """Claim terminal ownership — exactly one caller wins.  The
        batch worker takes before dispatching; the HTTP thread takes on
        client-deadline expiry — so a request that timed out while
        queued is skipped by a later batch (and counted "timeout"),
        never double-finished or counted "ok" after its 500."""
        with self._taken_lock:
            if self._taken:
                return False
            self._taken = True
            return True


class _Done:
    """A forward whose result is already on the host (the CPU path)."""

    __slots__ = ("out",)

    def __init__(self, out: np.ndarray):
        self.out = out

    def result(self) -> np.ndarray:
        return self.out


class _InFlight:
    """A replay queued on the serving stream: its output's pinned host
    copy and the event recorded after that copy."""

    __slots__ = ("host", "event")

    def __init__(self, host, event):
        self.host = host
        self.event = event

    def result(self) -> np.ndarray:
        self.event.synchronize()
        return self.host.numpy()


class _EagerForward:
    """One (bucket, input shape) key on the CPU: the forward runs when
    called."""

    def __init__(self, gw: "InferenceGateway"):
        self.gw = gw

    def __call__(self, named, xb: np.ndarray) -> _Done:
        import torch
        self.gw._load_weights(named)
        with torch.inference_mode():
            out = self.gw._run(torch.from_numpy(np.asarray(xb)))
        return _Done(out.numpy().copy())


class _GraphForward:
    """One (bucket, input shape) key on the card: a captured CUDA graph
    over static input, weight and output tensors."""

    def __init__(self, gw: "InferenceGateway", key: tuple):
        import torch
        self.gw = gw
        self.key = key
        dev = gw.device
        self.x = torch.zeros(key, dtype=torch.float32, device=dev)
        # every bucket runs once eagerly on a side stream before its
        # capture (PyTorch's graph rules): kernels build, lazy state
        # settles, the allocator warms
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), torch.inference_mode():
            for _ in range(2):
                gw._run(self.x)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        from geomx_tpu_torch import ops
        before = {**ops.launch_counts(), **ops.variant_launch_counts()}
        self.graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(
                self.graph, capture_error_mode="thread_local"):
            self.out = gw._run(self.x)
        torch.cuda.synchronize(dev)
        after = {**ops.launch_counts(), **ops.variant_launch_counts()}
        # the kernel nodes of each wrapper the capture recorded: a replay
        # launches exactly these and runs no Python, so the wrappers'
        # counters see none of it
        self.kernel_nodes = {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}
        self.replays = 0
        gw.graph_captures += 1

    def __call__(self, named, xb: np.ndarray) -> _InFlight:
        import torch
        gw = self.gw
        with torch.cuda.stream(gw._stream):
            gw._load_weights(named)
            self.x.copy_(torch.from_numpy(np.asarray(xb)),
                         non_blocking=True)
            self.graph.replay()
            self.replays += 1
            host = torch.empty(self.out.shape, dtype=self.out.dtype,
                               pin_memory=True)
            host.copy_(self.out, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(gw._stream)
        return _InFlight(host, ev)


class InferenceGateway:
    """Continuous-batching inference over one serving replica.

    ``device`` is the card unless the caller asks for the CPU
    (``device="cpu"``).  ``model`` (an ``nn.Module``) overrides
    ``model_name``.  Requests always cross the wire as fp32; the forward
    casts a batch to int32 token ids for the SeqClassifier."""

    def __init__(self, replica: ServingReplica, treedef,
                 model_name: str = "mlp", num_classes: int = 10,
                 max_batch: int = 8, queue_ms: float = 2.0,
                 queue_cap: int = 256,
                 buckets: Optional[Tuple[int, ...]] = None,
                 apply_fn: Optional[Callable] = None,
                 request_timeout_s: Optional[float] = None,
                 warmup_shapes: Optional[List[tuple]] = None,
                 warmup: Optional[bool] = None,
                 device=None, model=None):
        from geomx_tpu_torch.device import resolve_device
        self.replica = replica
        self.treedef = treedef
        self.model_name = str(model_name)
        self.num_classes = int(num_classes)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            import torch
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.max_batch = max(1, int(max_batch))
        self.queue_ms = max(0.0, float(queue_ms))
        self.buckets = tuple(sorted(buckets)) if buckets \
            else default_buckets(self.max_batch)
        if self.buckets[-1] < self.max_batch:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} < max_batch "
                f"{self.max_batch}: a full batch would have no bucket")
        if request_timeout_s is None or warmup is None:
            from geomx_tpu_torch.config import GeoConfig
            cfg = GeoConfig.from_env()
            if request_timeout_s is None:
                request_timeout_s = cfg.serve_timeout_s
            if warmup is None:
                warmup = cfg.serve_warmup
        self.request_timeout_s = max(0.001, float(request_timeout_s))
        self.warmup_shapes = [tuple(int(d) for d in s)
                              for s in (warmup_shapes or [])]
        self._warmup_enabled = bool(warmup)
        self._apply_fn = apply_fn          # overrides the model (tests)
        self._model = model
        self._input_dtype = None
        self._queue: "queue.Queue[Optional[_Request]]" = \
            queue.Queue(maxsize=max(1, int(queue_cap)))
        self._jit_cache: Dict[tuple, Any] = {}
        # the static weight tensors the forward reads, by registry name
        # (the model's own parameters on the model path), the replica
        # dict last copied into them and the event after that copy
        self._weights: Optional[Dict[str, Any]] = None
        self._loaded = None
        self._loaded_event = None
        self._stream = None
        if self.device.type == "cuda":
            import torch
            self._stream = torch.cuda.Stream(device=self.device)
        # persistent padded host buffers, two per (bucket, feat shape)
        # key: the worker assembles batch t+1 into the OTHER buffer
        # while batch t's host->device copy may still be reading its
        # own — ping-pong, never a per-batch np.stack allocation
        self._host_bufs: Dict[tuple, List[np.ndarray]] = {}
        self._buf_flip: Dict[tuple, int] = {}
        self._lock = threading.Lock()
        self._rid = 0
        self._shed_fraction = 0.0
        self._shed_acc = 0.0
        self._running = False
        self._worker: Optional[threading.Thread] = None
        self.requests_ok = 0
        self.requests_shed = 0
        self.requests_error = 0
        self.requests_timeout = 0
        self.batches_dispatched = 0
        self.warmup_compiles = 0
        self.weight_loads = 0
        self.graph_captures = 0

    # ---- lifecycle ---------------------------------------------------------

    def start(self) -> "InferenceGateway":
        if self._warmup_enabled and self.warmup_shapes:
            # build BEFORE the worker serves: first-request captures
            # would otherwise land inside request latency
            self.warmup()
        self._running = True
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="serve-batcher", daemon=True)
        self._worker.start()
        register_serving_surface("gateway", self.surface_snapshot)
        return self

    def warmup(self, input_shapes: Optional[List[tuple]] = None) -> int:
        """Build (and execute once, on zeros) every (bucket, input
        shape) forward — on the card, capture its graph — so no served
        request ever pays one.  Returns the number of NEW keys built;
        the cumulative count exports as the
        ``geomx_serve_warmup_compiles`` gauge.  The cache bound is
        untouched — warmup populates exactly the same bounded (bucket,
        shape) key set the serving path would."""
        shapes = [tuple(int(d) for d in s)
                  for s in (input_shapes
                            if input_shapes is not None
                            else self.warmup_shapes)]
        named = self.replica.params()
        if not shapes or not named:
            return 0
        compiles = 0
        for shape in shapes:
            for b in self.buckets:
                key = (int(b),) + shape
                fresh = key not in self._jit_cache
                fn = self._forward_fn(b, shape)
                xb = np.zeros((int(b),) + shape, np.float32)
                fn(named, xb).result()      # block: the build (and
                #                             first run) happens HERE
                if fresh:
                    compiles += 1
        self.warmup_compiles += compiles
        try:
            from geomx_tpu_torch.telemetry.registry import get_registry
            get_registry().gauge(
                "geomx_serve_warmup_compiles",
                "Bucket executables compiled up front by gateway "
                "warmup").set(float(self.warmup_compiles))
        except Exception:
            pass
        return compiles

    def stop(self) -> None:
        self._running = False
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        if self._worker is not None:
            self._worker.join(timeout=10.0)
        register_serving_surface("gateway", None)

    # ---- SLO hooks (control/policy.py SloPolicy actuates these) ------------

    def set_shed_fraction(self, fraction: float) -> None:
        with self._lock:
            self._shed_fraction = min(1.0, max(0.0, float(fraction)))

    def shed_fraction(self) -> float:
        with self._lock:
            return self._shed_fraction

    def serving_stats(self) -> dict:
        """The observation the SLO policy consumes: request-ledger
        percentiles + live queue depth + the current shed fraction."""
        from geomx_tpu_torch.telemetry.ledger import get_request_ledger
        s = get_request_ledger().summary()
        return {"p50_s": s.get("total_p50_s"),
                "p99_s": s.get("total_p99_s"),
                "qps": s.get("qps"),
                "queue_depth": self._queue.qsize(),
                "shed_fraction": self.shed_fraction()}

    # ---- submission --------------------------------------------------------

    def submit(self, x: np.ndarray,
               transport: str = "local") -> _Request:
        """Enqueue one example.  A full queue or an active shed marks
        the request shed immediately (explicit refusal, never silent
        loss).  ``transport`` labels the request's ledger record with
        the lane it arrived on (``http`` / ``native`` / ``local``)."""
        with self._lock:
            self._rid += 1
            rid = self._rid
            shed = False
            if self._shed_fraction > 0.0:
                self._shed_acc += self._shed_fraction
                if self._shed_acc >= 1.0:
                    self._shed_acc -= 1.0
                    shed = True
        req = _Request(np.asarray(x, np.float32), rid,
                       transport=transport)
        if shed:
            self._finish_shed(req)
            return req
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self._finish_shed(req)
            return req
        self._observe_queue_depth()
        return req

    def _finish_shed(self, req: _Request) -> None:
        req.take()          # fresh request, unqueued: always wins
        req.error = "shed"
        req.event.set()
        # every ThreadingHTTPServer thread calls submit concurrently —
        # the counter bump must sit under the gateway lock or the
        # read-modify-write race loses sheds from the zero-lost books
        with self._lock:
            self.requests_shed += 1
        self._count_request("shed")
        self._ledger_observe(req, status="shed", forward_s=0.0,
                             reply_s=0.0)

    def _finish_timeout(self, req: _Request) -> bool:
        """Finish a request whose client deadline expired while it was
        still queued.  False = a batch worker already claimed it (the
        forward is in flight and the result/event are imminent)."""
        if not req.take():
            return False
        req.error = "timeout"
        req.event.set()
        with self._lock:
            self.requests_timeout += 1
        self._count_request("timeout")
        self._ledger_observe(req, status="timeout", forward_s=0.0,
                             reply_s=0.0)
        return True

    # ---- the pipelined continuous-batching worker --------------------------

    def _worker_loop(self) -> None:
        """Double-buffered dispatch: on the card ``_dispatch_async``
        returns while batch *t* still runs on the device; the worker
        immediately drains and assembles batch *t+1*, and only then
        blocks on *t*'s result in ``_finalize`` — host batch assembly
        hides behind device compute.  With nothing queued, an in-flight
        batch finalizes immediately (no latency tax at light load)."""
        if self.device.type == "cuda":
            import torch
            torch.cuda.set_device(self.device)
        pending = None      # (batch, in_flight, t_f0)
        stopping = False
        while self._running and not stopping:
            if pending is None:
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
            else:
                try:
                    first = self._queue.get_nowait()
                except queue.Empty:
                    self._finalize(*pending)
                    pending = None
                    continue
            if first is None:
                break
            batch = [first]
            # deadline-or-full coalescing: a full batch closes the
            # moment it fills; while a batch is already in flight the
            # device is the clock — absorb whatever is queued right
            # now without sleeping out the window
            deadline = time.monotonic() + self.queue_ms / 1000.0
            while len(batch) < self.max_batch:
                try:
                    if pending is not None:
                        nxt = self._queue.get_nowait()
                    else:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    stopping = True
                    break
                batch.append(nxt)
            new_pending = self._dispatch_async(batch)
            if pending is not None:
                self._finalize(*pending)
            pending = new_pending
        if pending is not None:
            self._finalize(*pending)
        # drain on stop: whatever is queued still gets an answer
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is not None:
                done = self._dispatch_async([req])
                if done is not None:
                    self._finalize(*done)

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def jit_cache_size(self) -> int:
        """Built (bucket, input shape) forwards: captured graphs on the
        card, eager keys on the CPU."""
        return len(self._jit_cache)

    def graph_launches(self) -> Dict[str, int]:
        """Kernel launches the captured graphs made, by wrapper name:
        each graph's recorded kernel nodes times its replays (a replay
        runs no Python, so the wrappers' own counters miss it)."""
        out: Dict[str, int] = {}
        for fn in self._jit_cache.values():
            for name, n in getattr(fn, "kernel_nodes", {}).items():
                out[name] = out.get(name, 0) + n * fn.replays
        return out

    # ---- the forward -------------------------------------------------------

    def model(self, feat_shape: Optional[tuple] = None):
        """The zoo model the forward runs (built from the first input
        shape when it sizes its layers from the input), on the
        gateway's device, in eval mode, its parameters frozen."""
        import torch
        if self._model is None:
            from geomx_tpu_torch.models import get_model
            self._model = get_model(self.model_name,
                                    num_classes=self.num_classes)
        m = self._model
        if not getattr(m, "_gx_serving", False):
            if hasattr(m, "built") and not m.built:
                if feat_shape is None:
                    raise RuntimeError(
                        f"{type(m).__name__} sizes its layers from the "
                        "input: give the gateway an input shape first")
                m.build(tuple(feat_shape))
            m.to(self.device).eval()
            for p in m.parameters():
                p.requires_grad_(False)
            m._gx_serving = True
        if self._input_dtype is None:
            from geomx_tpu_torch.models import SeqClassifier
            self._input_dtype = torch.int32 \
                if isinstance(m, SeqClassifier) else torch.float32
        return m

    def _weight_targets(self, named) -> Dict[str, Any]:
        """Registry name -> the static tensor the forward reads."""
        import torch
        if self._apply_fn is not None:
            return {k: torch.zeros(np.shape(v), dtype=torch.float32,
                                   device=self.device)
                    for k, v in named.items()}
        m = self.model()
        treedef = self.treedef
        if treedef is None:
            _, treedef = flatten_params(m)
        from geomx_tpu_torch.tree import from_nested
        tree = unflatten_params(treedef, {k: k for k in named})
        owned = {**dict(m.named_parameters()), **dict(m.named_buffers())}
        out = {}
        for section in ("params", "batch_stats"):
            for path, name in from_nested(tree.get(section) or {}).items():
                if path not in owned:
                    raise KeyError(f"{name!r} names no tensor of "
                                   f"{type(m).__name__} ({path!r})")
                out[name] = owned[path]
        if len(out) != len(named):
            raise KeyError(f"{len(named) - len(out)} published layers "
                           "fall outside the params/batch_stats sections")
        return out

    def _load_weights(self, named) -> None:
        """Copy a replica weight set into the static tensors, on the
        current (serving) stream, when it is not the set copied last.
        The previous set's dict is released only after its own copy has
        finished on the device."""
        if named is self._loaded:
            return
        import torch
        if self._weights is None or set(self._weights) != set(named) or \
                any(tuple(self._weights[k].shape) != tuple(np.shape(v))
                    for k, v in named.items()):
            if self._jit_cache and self.device.type == "cuda":
                # the captured graphs read the static tensors of the
                # first layer set: a base of other layers or shapes
                # needs a gateway of its own
                raise RuntimeError(
                    "the replica's layer set or shapes changed under "
                    "captured graphs; start a new gateway for it")
            self._weights = self._weight_targets(named)
        cuda = self.device.type == "cuda"
        with torch.no_grad(), warnings.catch_warnings():
            # a base from the wire is a read-only view; it is only read
            warnings.filterwarnings("ignore", message=".*not writable.*")
            for k, v in named.items():
                self._weights[k].copy_(
                    torch.from_numpy(np.ascontiguousarray(v, np.float32)),
                    non_blocking=cuda)
        if self._loaded_event is not None:
            self._loaded_event.synchronize()
        self._loaded = named
        self._loaded_event = None
        if cuda:
            self._loaded_event = torch.cuda.Event()
            self._loaded_event.record()
        self.weight_loads += 1

    def _run(self, xb):
        """The forward of one padded batch already on the device (the
        static weights loaded): fp32 outputs."""
        if self._apply_fn is not None:
            return self._apply_fn(self._weights, xb).float()
        m = self.model()
        return m(xb.to(self._input_dtype)).float()

    def eager_forward(self, named, xb: np.ndarray) -> np.ndarray:
        """The same forward without the graph, on the gateway's stream
        (the card) or the CPU: what a replay must equal bit for bit."""
        import torch
        if self.device.type == "cuda":
            with torch.cuda.stream(self._stream):
                self._load_weights(named)
                with torch.inference_mode():
                    out = self._run(torch.from_numpy(
                        np.asarray(xb, np.float32)).to(self.device))
                host = out.cpu()
            return host.numpy()
        self._load_weights(named)
        with torch.inference_mode():
            return self._run(torch.from_numpy(
                np.asarray(xb, np.float32))).numpy().copy()

    def _forward_fn(self, bucket: int, feat_shape: tuple):
        """The forward for one padded bucket size (bounded cache: one
        entry per (bucket, input feature shape)); on the card a captured
        graph, built on first use if warmup did not build it."""
        key = (int(bucket),) + tuple(feat_shape)
        fn = self._jit_cache.get(key)
        if fn is not None:
            return fn
        if self._apply_fn is None:
            self.model(tuple(feat_shape))
        if self.device.type == "cuda":
            import torch
            named = self.replica.params()
            with torch.cuda.stream(self._stream):
                self._load_weights(named)
            self._stream.synchronize()
            fn = _GraphForward(self, key)
        else:
            fn = _EagerForward(self)
        self._jit_cache[key] = fn
        return fn

    def _assemble(self, bucket: int, batch: List[_Request],
                  feat_shape: tuple) -> np.ndarray:
        """Copy the batch into a persistent pre-allocated padded bucket
        buffer: one row copy per request, pad rows zeroed — never a
        per-batch ``np.stack`` + ``np.concatenate`` allocation pair.
        Buffers ping-pong per (bucket, shape): the previous batch's
        host->device copy may still be in flight on its buffer while
        this one fills the other (pinned on the card, so that copy is
        truly asynchronous)."""
        key = (int(bucket),) + tuple(feat_shape)
        bufs = self._host_bufs.get(key)
        if bufs is None:
            shape = (int(bucket),) + tuple(feat_shape)
            if self.device.type == "cuda":
                import torch
                bufs = [torch.zeros(shape, dtype=torch.float32,
                                    pin_memory=True).numpy()
                        for _ in range(2)]
            else:
                bufs = [np.zeros(shape, np.float32) for _ in range(2)]
            self._host_bufs[key] = bufs
            self._buf_flip[key] = 0
        flip = self._buf_flip[key] ^ 1
        self._buf_flip[key] = flip
        buf = bufs[flip]
        n = len(batch)
        for i, r in enumerate(batch):
            buf[i] = r.x        # raises on a shape mismatch -> error
            #                     fan-out upstream, same as np.stack did
        if n < bucket:
            buf[n:] = 0.0
        return buf

    def _dispatch_async(self, batch: List[_Request]):
        """Claim + assemble + dispatch one batch; returns the in-flight
        ``(batch, in_flight, t_f0)`` triple for ``_finalize`` — on the
        card the replay is queued, not finished.  None = nothing
        survived claiming or the dispatch itself failed (already
        error-finished)."""
        # claim each request first: one that timed out while queued was
        # already finished (500 + "timeout" accounting) by the HTTP
        # thread — running it anyway would count it "ok" after the
        # client gave up
        batch = [r for r in batch if r.take()]
        if not batch:
            self._observe_queue_depth()
            return None
        t_batch = time.monotonic()
        n = len(batch)
        bucket = self.bucket_for(n)
        for r in batch:
            r.t_batch = t_batch
            r.batch_size = n
            r.bucket = bucket
        try:
            feat_shape = tuple(np.shape(batch[0].x))
            xb = self._assemble(bucket, batch, feat_shape)
            # freshness provenance: the version/rounds/staleness of the
            # weight set THIS batch runs on, read with the params under
            # the replica's lock, so reply and ledger describe the
            # weights actually used, not whatever the replica holds at
            # reply time
            named, rnd, layer_rounds = self.replica.params_stamp()
            ver = self.replica.version
            stale = self.replica.staleness_s()
            for r in batch:
                r.model_version = ver
                r.model_round = rnd
                r.layer_rounds = layer_rounds
                r.staleness_s = None if stale == float("inf") \
                    else float(stale)
            fn = self._forward_fn(bucket, feat_shape)
            t_f0 = time.monotonic()
            return (batch, fn(named, xb), t_f0)
        except Exception as e:
            self._finish_error(batch, e)
            return None

    def _finalize(self, batch: List[_Request], in_flight, t_f0) -> None:
        """Block on an in-flight batch's result and fan out the
        replies + terminal accounting."""
        try:
            out = in_flight.result()        # the block point
            forward_s = time.monotonic() - t_f0
            self.batches_dispatched += 1
            self._observe_batch(len(batch))
            t_reply0 = time.monotonic()
            for i, r in enumerate(batch):
                r.result = out[i].copy()
                r.event.set()
            reply_s = time.monotonic() - t_reply0
            for r in batch:
                self.requests_ok += 1
                self._count_request("ok")
                self._ledger_observe(r, status="ok",
                                     forward_s=forward_s,
                                     reply_s=reply_s)
            # propagation join's terminal hop: this batch served its
            # round, per transport (the tracker keeps only the first)
            try:
                from geomx_tpu_torch.telemetry.fleetscope import \
                    note_propagation
                for r in batch:
                    if r.model_round:
                        note_propagation(r.model_round, "served",
                                         transport=r.transport)
            except Exception:
                pass
        except Exception as e:
            self._finish_error(batch, e)
        self._observe_queue_depth()
        self._observe_staleness()

    def _finish_error(self, batch: List[_Request], e: Exception) -> None:
        for r in batch:
            r.error = repr(e)
            r.event.set()
            self.requests_error += 1
            self._count_request("error")
            self._ledger_observe(r, status="error", forward_s=0.0,
                                 reply_s=0.0)
        self._observe_queue_depth()

    # ---- telemetry ---------------------------------------------------------

    def _count_request(self, status: str) -> None:
        try:
            from geomx_tpu_torch.telemetry.registry import get_registry
            get_registry().counter(
                "geomx_serve_requests_total",
                "Inference requests by terminal status",
                ("status",)).labels(status=status).inc()
        except Exception:
            pass

    def _observe_batch(self, n: int) -> None:
        try:
            from geomx_tpu_torch.telemetry.registry import get_registry
            get_registry().histogram(
                "geomx_serve_batch_size",
                "Dispatched inference batch sizes (pre-padding)",
                buckets=BATCH_SIZE_BUCKETS).observe(float(n))
        except Exception:
            pass

    def _observe_queue_depth(self) -> None:
        try:
            from geomx_tpu_torch.telemetry.registry import get_registry
            get_registry().gauge(
                "geomx_serve_queue_depth",
                "Inference requests waiting in the gateway queue"
            ).set(float(self._queue.qsize()))
        except Exception:
            pass

    def _observe_staleness(self) -> None:
        try:
            from geomx_tpu_torch.telemetry.registry import get_registry
            s = self.replica.staleness_s()
            if s != float("inf"):
                get_registry().gauge(
                    "geomx_serve_replica_staleness_seconds",
                    "Seconds since the serving replica's last "
                    "successful weight refresh").set(float(s))
        except Exception:
            pass

    def _ledger_observe(self, req: _Request, status: str,
                        forward_s: float, reply_s: float) -> None:
        try:
            from geomx_tpu_torch.telemetry.ledger import get_request_ledger
            t_batch = req.t_batch if req.t_batch is not None \
                else req.t_enqueue
            # queue_s from the monotonic pair; the record's anchor
            # stays wall clock (the one place wall time belongs)
            get_request_ledger().observe(
                rid=req.rid, t_enqueue=req.t_enqueue_unix,
                queue_s=max(0.0, t_batch - req.t_enqueue),
                forward_s=forward_s, reply_s=reply_s,
                batch_size=req.batch_size, bucket=req.bucket,
                status=status, transport=req.transport,
                model_version=req.model_version,
                model_round=req.model_round,
                staleness_s=req.staleness_s)
        except Exception:
            pass

    # ---- surfaces ----------------------------------------------------------

    def wait_requests(self, reqs: List[_Request]) -> None:
        """Wait a submitted group out under ONE shared client deadline
        (both the HTTP door and the native lane use this): a request
        still unanswered at the deadline is claimed as a timeout —
        unless a batch worker claimed it first, in which case the
        result is imminent and fabricating a timeout would race the
        ok-accounting."""
        deadline = time.monotonic() + self.request_timeout_s
        for r in reqs:
            if not r.event.wait(max(0.0, deadline - time.monotonic())):
                if not self._finish_timeout(r):
                    r.event.wait(self.request_timeout_s)

    def surface_snapshot(self) -> dict:
        """The ``/healthz`` serving block: published versions the
        replica tracks, freshness, queue depth, terminal counts."""
        return {"replica": self.replica.snapshot(),
                "queue_depth": self._queue.qsize(),
                "max_batch": self.max_batch,
                "queue_ms": self.queue_ms,
                "request_timeout_s": self.request_timeout_s,
                "buckets": list(self.buckets),
                "jit_cache_size": self.jit_cache_size(),
                "warmup_compiles": self.warmup_compiles,
                "shed_fraction": self.shed_fraction(),
                "requests": {"ok": self.requests_ok,
                             "shed": self.requests_shed,
                             "error": self.requests_error,
                             "timeout": self.requests_timeout},
                "batches": self.batches_dispatched}

    def infer_route(self, body: bytes) -> Tuple[int, bytes, str]:
        """The ``POST /infer`` handler: ``{"inputs": [[...feature
        vector...], ...]}`` in, one output row per input out.
        Shed/overflow is an explicit 503."""
        try:
            doc = json.loads(body.decode("utf-8"))
            rows = doc["inputs"] if "inputs" in doc else [doc["input"]]
            xs = [np.asarray(r, np.float32) for r in rows]
        except (ValueError, KeyError, TypeError) as e:
            return (400, json.dumps(
                {"error": f"bad request: {e!r}"}).encode("utf-8"),
                "application/json")
        self._account_wire("http", "rx", len(body))
        reqs = [self.submit(x, transport="http") for x in xs]
        self.wait_requests(reqs)
        if any(r.error == "shed" for r in reqs):
            return (503, json.dumps(
                {"error": "shed", "shed": sum(1 for r in reqs
                                              if r.error == "shed")}
            ).encode("utf-8"), "application/json")
        if any(r.error or r.result is None for r in reqs):
            return (500, json.dumps(
                {"error": next((r.error or "timeout") for r in reqs
                               if r.error or r.result is None)}
            ).encode("utf-8"), "application/json")
        stale = self.replica.staleness_s()
        out = {"outputs": [np.asarray(r.result).tolist() for r in reqs],
               "version": self.replica.version,
               "round": self.replica.last_round(),
               "batch_sizes": [r.batch_size for r in reqs],
               # freshness provenance (additive — old clients that only
               # read outputs/version/round are untouched)
               "staleness_s": (None if stale == float("inf")
                               else round(float(stale), 3)),
               "layer_rounds": self.replica.layer_rounds()}
        payload = json.dumps(out).encode("utf-8")
        self._account_wire("http", "tx", len(payload))
        return (200, payload, "application/json")

    def _account_wire(self, transport: str, direction: str,
                      nbytes: int, declared=None) -> None:
        try:
            from geomx_tpu_torch.telemetry.ledger import get_request_ledger
            get_request_ledger().account_wire(transport, direction,
                                              nbytes, declared=declared)
        except Exception:
            pass

    def serve_http(self, bind_host: str = "127.0.0.1", port: int = 0):
        """Start the gateway's HTTP surface on the shared exporter:
        ``POST /infer`` plus the standard ``GET`` routes (/metrics,
        /healthz with the serving block, /ledger with the request
        section).  Returns the server (caller owns shutdown)."""
        from geomx_tpu_torch.serve import serving_surface
        from geomx_tpu_torch.telemetry.export import start_http_exporter

        def health():
            out = {"status": "ok"}
            s = serving_surface()
            if s is not None:
                out["serving"] = s
            return out

        return start_http_exporter(
            bind_host, int(port), health_fn=health,
            post_routes={"/infer": self.infer_route},
            thread_name="serve-http")

    def register_with_scheduler(self, scheduler_addr, http_port: int,
                                host: str = "127.0.0.1",
                                tag: str = "gateway",
                                heartbeat_interval_s: Optional[float]
                                = None):
        """Join the scheduler roster as node kind ``"serve"`` (the
        registered port IS the node's HTTP surface, so FleetScope
        discovery needs no side-channel config) and start the standard
        heartbeat — a dead gateway becomes a *named* death in the
        scheduler's ``/healthz`` instead of silently missing traffic.
        Returns the :class:`SchedulerClient`; the caller owns
        ``close()``."""
        from geomx_tpu_torch.service.scheduler import SchedulerClient
        client = SchedulerClient((str(scheduler_addr[0]),
                                  int(scheduler_addr[1])))
        client.register("serve", host=host, port=int(http_port),
                        tag=str(tag))
        client.start_heartbeat(heartbeat_interval_s)
        return client
