"""Telemetry read side: Prometheus text exposition + bounded JSONL events
(port of geomx_tpu/telemetry/export.py; the same registry contents
render to byte-identical text in both packages).

Two export surfaces over the process-global registry
(:mod:`geomx_tpu_torch.telemetry.registry`):

- :func:`render_prometheus` emits the Prometheus text exposition format
  (version 0.0.4), served live from the scheduler's HTTP endpoint
  (``GeoScheduler(metrics_port=...)`` -> ``GET /metrics``) and over the
  framework wire protocol as ``COMMAND {cmd: "metrics"}`` on both
  ``GeoPSServer`` and ``GeoScheduler`` — so a worker behind the PS
  protocol and an operator with curl read the same series;
- :class:`EventLog` appends structured JSON lines (one event per line)
  to a size-bounded file with single-generation rotation — the
  machine-readable trail of step probes, membership transitions and
  relay failures that outlives the process.

:func:`parse_prometheus_text` is the minimal parser the test suite (and
``bench.py --compare-telemetry``) round-trips the exposition through —
it understands exactly what :func:`render_prometheus` can produce, which
is the point: a rendering the parser rejects is a bug in the renderer.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from geomx_tpu_torch.telemetry.registry import (HistogramChild, MetricRegistry,
                                                get_registry)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _fmt_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_str(names, values, extra: Tuple[str, str] = None) -> str:
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    if extra is not None:
        pairs.append(f'{extra[0]}="{_escape_label(extra[1])}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render_prometheus(registry: Optional[MetricRegistry] = None) -> str:
    """The registry as Prometheus text exposition (format 0.0.4)."""
    registry = registry if registry is not None else get_registry()
    out: List[str] = []
    for fam in registry.collect():
        out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        out.append(f"# TYPE {fam.name} {fam.type}")
        for values, child in fam.children():
            if isinstance(child, HistogramChild):
                cum, total, count = child.snapshot()
                bounds = [_fmt_value(b) for b in child.upper_bounds]
                bounds.append("+Inf")
                for ub, c in zip(bounds, cum):
                    out.append(
                        f"{fam.name}_bucket"
                        f"{_labels_str(fam.label_names, values, ('le', ub))}"
                        f" {c}")
                ls = _labels_str(fam.label_names, values)
                out.append(f"{fam.name}_sum{ls} {_fmt_value(total)}")
                out.append(f"{fam.name}_count{ls} {count}")
            else:
                out.append(f"{fam.name}"
                           f"{_labels_str(fam.label_names, values)} "
                           f"{_fmt_value(child.value)}")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# the minimal parser the exposition round-trips through
# ---------------------------------------------------------------------------

def _parse_value(s: str) -> float:
    if s == "+Inf":
        return float("inf")
    if s == "-Inf":
        return float("-inf")
    if s == "NaN":
        return float("nan")
    return float(s)


def _parse_labels(s: str) -> Dict[str, str]:
    """Parse '{a="x",b="y"}' honoring \\" escapes."""
    labels: Dict[str, str] = {}
    i = 0
    s = s.strip()
    if not s:
        return labels
    if s[0] != "{" or s[-1] != "}":
        raise ValueError(f"malformed label set {s!r}")
    s = s[1:-1]
    while i < len(s):
        eq = s.index("=", i)
        name = s[i:eq].strip().lstrip(",").strip()
        if s[eq + 1] != '"':
            raise ValueError(f"unquoted label value at {s[eq:]!r}")
        j = eq + 2
        buf = []
        while True:
            c = s[j]
            if c == "\\":
                nxt = s[j + 1]
                buf.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
                continue
            if c == '"':
                break
            buf.append(c)
            j += 1
        labels[name] = "".join(buf)
        i = j + 1
    return labels


def parse_prometheus_text(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse exposition text into
    ``{family: {"type", "help", "samples": [(name, labels, value)]}}``.

    Strict about what the renderer is allowed to emit: every sample must
    belong to a family announced by a preceding ``# TYPE`` line
    (histogram samples match via the _bucket/_sum/_count suffixes), and
    histogram series must carry ``le`` labels with non-decreasing
    cumulative counts ending in ``+Inf``.
    """
    families: Dict[str, Dict[str, Any]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_ = rest.partition(" ")
            families.setdefault(name, {"type": None, "help": "",
                                       "samples": []})["help"] = help_
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, type_ = rest.partition(" ")
            type_ = type_.strip()
            if type_ not in ("counter", "gauge", "histogram"):
                raise ValueError(f"unknown TYPE {type_!r} for {name}")
            families.setdefault(name, {"type": None, "help": "",
                                       "samples": []})["type"] = type_
            continue
        if line.startswith("#"):
            continue
        # sample: name{labels} value
        brace = line.find("{")
        if brace >= 0:
            close = line.rindex("}")
            sname = line[:brace]
            labels = _parse_labels(line[brace:close + 1])
            value = _parse_value(line[close + 1:].strip().split()[0])
        else:
            sname, _, rest = line.partition(" ")
            labels = {}
            value = _parse_value(rest.strip().split()[0])
        fam = None
        for cand in (sname, sname.rsplit("_bucket", 1)[0],
                     sname.rsplit("_sum", 1)[0],
                     sname.rsplit("_count", 1)[0]):
            if cand in families:
                fam = cand
                break
        if fam is None:
            raise ValueError(f"sample {sname!r} has no TYPE line")
        families[fam]["samples"].append((sname, labels, value))
    # histogram invariants
    for name, fam in families.items():
        if fam["type"] != "histogram":
            continue
        series: Dict[tuple, List[Tuple[float, float]]] = {}
        for sname, labels, value in fam["samples"]:
            if sname != f"{name}_bucket":
                continue
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            series.setdefault(key, []).append(
                (_parse_value(labels["le"]), value))
        for key, pts in series.items():
            pts.sort(key=lambda p: p[0])
            if not pts or pts[-1][0] != float("inf"):
                raise ValueError(f"{name}: bucket series {key} lacks +Inf")
            counts = [c for _le, c in pts]
            if any(b < a for a, b in zip(counts, counts[1:])):
                raise ValueError(f"{name}: non-cumulative buckets {key}")
    return families


# ---------------------------------------------------------------------------
# shared HTTP export surface (scheduler AND GeoPSServer serve the same
# routes, so fleet scrapers need not speak the wire protocol to reach a
# shard's registry)
# ---------------------------------------------------------------------------

def ledger_document(summary_only: bool = False,
                    max_records: int = 0) -> Dict[str, Any]:
    """The ``GET /ledger`` body: round-ledger records + summary, plus
    the serving plane's request section when a request ledger exists.
    ``summary=1`` drops the record arrays entirely and ``n=K`` bounds
    them to the most recent K — FleetScope polls every interval, and
    shipping the full ring each tick is O(GEOMX_LEDGER_ROUNDS) of JSON
    per node per poll."""
    from geomx_tpu_torch.telemetry.ledger import (get_round_ledger,
                                                  peek_request_ledger)

    def _section(led) -> Dict[str, Any]:
        sec: Dict[str, Any] = {"summary": led.summary()}
        if not summary_only:
            recs = led.records()
            if max_records > 0:
                recs = recs[-max_records:]
            sec["records"] = recs
        return sec

    doc = _section(get_round_ledger())
    req_led = peek_request_ledger()
    if req_led is not None:
        doc["requests"] = _section(req_led)
    return doc


def start_http_exporter(bind_host: str, port: int, health_fn=None,
                        routes: Optional[Dict[str, Any]] = None,
                        post_routes: Optional[Dict[str, Any]] = None,
                        thread_name: str = "metrics-http"):
    """Serve the standard observability routes from a daemon HTTP
    thread: ``GET /metrics`` (Prometheus text exposition of the
    process-global registry), ``GET /healthz`` (``health_fn()`` as
    JSON), and ``GET /ledger`` (the process-global fleet round
    ledger's records + summary plus the serving plane's per-request
    ledger when one exists, telemetry/ledger.py; ``?summary=1`` drops
    the record arrays, ``?n=K`` bounds them — the FleetScope poll
    shapes).  ``routes`` maps
    extra GET paths to zero-arg callables returning ``(body_bytes,
    content_type)`` or ``(body_bytes, content_type, status)`` (the
    scheduler adds ``/control``, a 501 in the port); ``post_routes``
    maps POST paths to one-arg callables ``body_bytes -> (status,
    body_bytes, content_type)`` (the serving gateway adds ``/infer``).
    Returns the ``ThreadingHTTPServer`` (``.server_address[1]`` is the
    bound port; callers own ``shutdown()``/``server_close()``)."""
    import json as _json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    extra = dict(routes or {})
    extra_post = dict(post_routes or {})

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(h):  # noqa: N805 — http.server handler convention
            route, _, query = h.path.partition("?")
            route = route.rstrip("/")
            status = 200
            try:
                if route in ("", "/metrics"):
                    body = render_prometheus().encode("utf-8")
                    ctype = CONTENT_TYPE
                elif route == "/healthz" and health_fn is not None:
                    body = _json.dumps(
                        health_fn(), default=_json_default).encode("utf-8")
                    ctype = "application/json"
                elif route == "/ledger":
                    from urllib.parse import parse_qs
                    params = parse_qs(query)
                    summary_only = params.get(
                        "summary", ["0"])[-1] in ("1", "true", "yes")
                    try:
                        max_records = int(params.get("n", ["0"])[-1])
                    except ValueError:
                        max_records = 0
                    doc = ledger_document(summary_only=summary_only,
                                          max_records=max_records)
                    body = _json.dumps(
                        doc, default=_json_default).encode("utf-8")
                    ctype = "application/json"
                elif route in extra:
                    res = extra[route]()
                    body, ctype = res[0], res[1]
                    if len(res) > 2:
                        status = int(res[2])
                else:
                    h.send_response(404)
                    h.end_headers()
                    return
            except Exception:
                h.send_response(500)
                h.end_headers()
                return
            h.send_response(status)
            h.send_header("Content-Type", ctype)
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)

        def do_POST(h):  # noqa: N805 — http.server handler convention
            route = h.path.partition("?")[0].rstrip("/")
            fn = extra_post.get(route)
            if fn is None:
                h.send_response(404)
                h.end_headers()
                return
            try:
                n = int(h.headers.get("Content-Length") or 0)
                payload = h.rfile.read(n) if n > 0 else b""
                status, body, ctype = fn(payload)
            except Exception:
                h.send_response(500)
                h.end_headers()
                return
            h.send_response(int(status))
            h.send_header("Content-Type", ctype)
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)

        def log_message(self, *args):  # no per-scrape stderr noise
            pass

    srv = ThreadingHTTPServer((bind_host, port), _Handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, name=thread_name,
                     daemon=True).start()
    return srv


# ---------------------------------------------------------------------------
# bounded JSONL structured event log
# ---------------------------------------------------------------------------

class EventLog:
    """Append-only JSON-lines event log with a byte cap.

    Each event is one line ``{"ts": <unix seconds>, "kind": ..., ...}``.
    When the file would exceed ``max_bytes`` the current file rotates to
    ``<path>.1`` (one generation — the log is bounded at ~2x max_bytes
    on disk, never unbounded) and a fresh file starts with a ``rotated``
    marker event.  Writes are line-atomic under an internal lock; the
    rotation itself uses ``os.replace`` so a crash never leaves a
    half-moved file.

    Emitting is BEST-EFFORT: an IO failure (full disk, revoked
    directory) drops the event and bumps ``write_errors`` instead of
    raising — telemetry must never take down the subsystem it observes
    (a membership publish aborted by its own event write would disable
    the resilience plane mid-failure).
    """

    def __init__(self, path: str, max_bytes: int = 16 * 1024 * 1024,
                 max_event_bytes: int = 64 * 1024):
        if max_bytes <= 0:
            raise ValueError("max_bytes must be > 0")
        self.path = path
        self.max_bytes = int(max_bytes)
        self.max_event_bytes = int(max_event_bytes)
        self._lock = threading.Lock()
        self.write_errors = 0
        self.rotations = 0
        self.dropped_records = 0
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._size = os.path.getsize(path) if os.path.exists(path) else 0
        # per-generation record counts, tracked IN MEMORY so a rotation
        # never reads a generation file back while holding the emit
        # lock (the one-time init scan of pre-existing files is the
        # only read).  _rot1_records is what the NEXT rotation loses.
        self._gen_records = self._count_records(path)
        self._rot1_records = self._count_records(path + ".1")

    @staticmethod
    def _count_records(path: str) -> int:
        """Newline count of a generation file (one record per line) —
        used only at construction to adopt pre-existing generations.
        Bounded by max_bytes, so the read is bounded too."""
        n = 0
        try:
            with open(path, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        return n
                    n += chunk.count(b"\n")
        except OSError:
            return 0

    def emit(self, kind: str, **fields) -> None:
        rec = {"ts": round(time.time(), 6), "kind": kind}
        rec.update(fields)
        try:
            line = json.dumps(rec, default=_json_default) + "\n"
        except (TypeError, ValueError):
            line = json.dumps({"ts": rec["ts"], "kind": kind,
                               "error": "unserializable event"}) + "\n"
        if len(line) > self.max_event_bytes:
            line = json.dumps({"ts": rec["ts"], "kind": kind,
                               "error": "event too large",
                               "bytes": len(line)}) + "\n"
        data = line.encode("utf-8")
        with self._lock:
            if self._size + len(data) > self.max_bytes:
                # the outgoing .1 generation's records are about to be
                # discarded by the replace below — count the loss
                # (tracked in memory; no file read under this lock)
                # instead of silently dropping the tail of history
                lost = self._rot1_records
                try:
                    os.replace(self.path, self.path + ".1")
                except OSError:
                    # rotation failed (e.g. <path>.1 is a directory):
                    # appending anyway would break the byte-cap contract,
                    # and zeroing _size would break it silently — drop
                    # the event and surface the failure in the counter
                    self.write_errors += 1
                    return
                self._size = 0
                self.rotations += 1
                self.dropped_records += lost
                self._rot1_records = self._gen_records
                self._gen_records = 0
                # a rotation discards a generation of history — publish
                # it so operators learn about the loss from a scrape,
                # not from a forensics dead end (best-effort like the
                # write itself: a foreign schema conflict on the name
                # must not take down the subsystem being observed)
                try:
                    reg = get_registry()
                    reg.counter(
                        "geomx_eventlog_rotations_total",
                        "Event-log rotations (each discards the "
                        "previous rotated generation)").inc()
                    if lost:
                        reg.counter(
                            "geomx_eventlog_dropped_records_total",
                            "Event records lost when rotation discarded "
                            "the previous generation").inc(lost)
                except ValueError:
                    pass
                marker = json.dumps({"ts": rec["ts"],
                                     "kind": "rotated"}) + "\n"
                data = marker.encode("utf-8") + data
            try:
                with open(self.path, "a") as f:
                    f.write(data.decode("utf-8"))
            except OSError:
                self.write_errors += 1
                return
            self._size += len(data)
            self._gen_records += data.count(b"\n")

    def read(self) -> List[dict]:
        """Parse the current generation back (tests/diagnostics)."""
        out = []
        try:
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        out.append(json.loads(line))
        except FileNotFoundError:
            pass
        return out


def _json_default(o):
    # numpy / jax scalars land here; anything with item() flattens
    item = getattr(o, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return repr(o)


# process-global event log, configured from the environment
# (GEOMX_TELEMETRY_EVENTS=<path>; empty/unset disables) or installed
# explicitly (set_default_event_log — the GeoConfig(telemetry_events=...)
# path, so subsystems without config access, e.g. the liveness
# controller's membership transitions, land in the SAME file)
_event_log: Optional[EventLog] = None
_event_log_key: Optional[tuple] = None
_default_log: Optional[EventLog] = None
_event_log_lock = threading.Lock()


def set_default_event_log(log: Optional[EventLog]) -> None:
    """Install (or clear, with None) the process-default event log.
    Takes precedence over the env-derived one."""
    global _default_log
    with _event_log_lock:
        _default_log = log


def get_event_log() -> Optional[EventLog]:
    global _event_log, _event_log_key
    # graftlint: disable=GXL006 — config-less surface
    path = os.environ.get("GEOMX_TELEMETRY_EVENTS") or ""
    # graftlint: disable=GXL006 — config-less surface
    raw_cap = os.environ.get("GEOMX_TELEMETRY_EVENTS_MAX_BYTES") or ""
    with _event_log_lock:
        if _default_log is not None:
            return _default_log
        key = (path, raw_cap)
        if key != _event_log_key:
            if not path:
                _event_log = None
                _event_log_key = key
            else:
                # parse + construct BEFORE committing the cache key: a
                # failed init (bad cap value, uncreatable directory)
                # must raise on EVERY call, not poison the cache into
                # silently returning a stale/None log forever
                try:
                    cap = int(float(raw_cap)) if raw_cap \
                        else 16 * 1024 * 1024
                except ValueError:
                    raise ValueError(
                        "Bad value for env var "
                        f"GEOMX_TELEMETRY_EVENTS_MAX_BYTES: {raw_cap!r}")
                log = EventLog(path, max_bytes=cap)
                _event_log = log
                _event_log_key = key
        return _event_log


def log_event(kind: str, **fields) -> None:
    """Append to the configured event log; no-op when none is set."""
    log = get_event_log()
    if log is not None:
        log.emit(kind, **fields)
