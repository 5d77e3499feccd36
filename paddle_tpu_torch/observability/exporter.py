"""Stdlib-only Prometheus text-exposition exporter (a copy of
``paddle_tpu.observability.exporter``).

:func:`render_text` turns a :class:`~paddle_tpu_torch.observability.metrics.
MetricRegistry` snapshot into Prometheus text format 0.0.4 (``# HELP`` /
``# TYPE`` lines; histograms as cumulative ``_bucket{le=...}`` series plus
``_sum``/``_count``). :class:`MetricsServer` serves it on ``/metrics``
with a ``/healthz`` liveness endpoint, on a daemon thread — no external
dependencies, safe to run inside a trainer or serving process.

Dotted registry names (``serving.requests_total``) are sanitized to the
Prometheus grammar (``serving_requests_total``).

:func:`parse_text_exposition` is the strict inverse used by the golden
tests and ``chip_smoke.py`` — it rejects samples without a ``TYPE``,
malformed lines, non-monotone ``le`` edges, and missing ``+Inf`` buckets.
"""

from __future__ import annotations

import json
import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.observability import metrics as obs_metrics

__all__ = [
    "render_text",
    "parse_text_exposition",
    "MetricsServer",
    "CONTENT_TYPE",
    "JSON_CONTENT_TYPE",
]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
JSON_CONTENT_TYPE = "application/json; charset=utf-8"

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_PAIR = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _sanitize_name(name: str) -> str:
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not out or not re.match(r"[a-zA-Z_:]", out[0]):
        out = "_" + out
    return out


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(pairs: Tuple[Tuple[str, str], ...]) -> str:
    if not pairs:
        return ""
    inner = ",".join(
        f'{_sanitize_name(k)}="{_escape_label(str(v))}"' for k, v in pairs)
    return "{" + inner + "}"


def _fmt_le(edge: float) -> str:
    # integral edges print bare ("1" not "1.0") to match client_golang style
    return str(int(edge)) if edge == int(edge) else repr(float(edge))


def render_text(registry: Optional[obs_metrics.MetricRegistry] = None) -> str:
    """Render the registry in Prometheus text exposition format 0.0.4."""
    registry = registry or obs_metrics.default_registry()
    lines: List[str] = []
    for fam in registry.collect():
        pname = _sanitize_name(fam.name)
        help_text = fam.help or f"paddle_tpu metric {fam.name}"
        lines.append(f"# HELP {pname} {help_text}")
        lines.append(f"# TYPE {pname} {fam.kind}")
        if fam.kind == obs_metrics.HISTOGRAM:
            for labels, h in fam.samples:
                base = dict(labels)
                for edge, cum in zip(fam.buckets, h["cumulative"]):
                    le = tuple(sorted({**base, "le": _fmt_le(edge)}.items()))
                    lines.append(f"{pname}_bucket{_fmt_labels(le)} {cum}")
                inf = tuple(sorted({**base, "le": "+Inf"}.items()))
                lines.append(f"{pname}_bucket{_fmt_labels(inf)} {h['count']}")
                lines.append(
                    f"{pname}_sum{_fmt_labels(labels)} {_fmt_value(h['sum'])}")
                lines.append(f"{pname}_count{_fmt_labels(labels)} {h['count']}")
        else:
            for labels, value in fam.samples:
                lines.append(
                    f"{pname}{_fmt_labels(labels)} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


class ExpositionError(ValueError):
    """The scraped text is not valid Prometheus exposition."""


def _parse_value(raw: str) -> float:
    if raw == "+Inf":
        return math.inf
    if raw == "-Inf":
        return -math.inf
    if raw == "NaN":
        return math.nan
    try:
        return float(raw)
    except ValueError:
        raise ExpositionError(f"bad sample value {raw!r}")


def parse_text_exposition(text: str) -> Dict[str, dict]:
    """Strictly parse exposition text into
    ``{family: {"type", "help", "samples": [(name, labels, value)]}}``.
    Validates: every sample belongs to a TYPE-declared family; histogram
    ``le`` edges are monotone increasing and terminate at ``+Inf``;
    cumulative bucket counts are non-decreasing and the ``+Inf`` bucket
    equals ``_count``."""
    families: Dict[str, dict] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 3 or not _NAME_OK.match(parts[2]):
                raise ExpositionError(f"line {lineno}: malformed HELP: {line!r}")
            families.setdefault(parts[2], {"samples": []})["help"] = (
                parts[3] if len(parts) > 3 else "")
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                name, kind = parts[2], parts[3]
                if not _NAME_OK.match(name):
                    raise ExpositionError(
                        f"line {lineno}: bad family name {name!r}")
                if kind not in ("counter", "gauge", "histogram", "summary",
                                "untyped"):
                    raise ExpositionError(
                        f"line {lineno}: bad family type {kind!r}")
                families.setdefault(name, {"samples": []})["type"] = kind
            continue  # other comments are legal and ignored
        m = _SAMPLE_LINE.match(line.strip())
        if not m:
            raise ExpositionError(f"line {lineno}: malformed sample: {line!r}")
        sname, labelblob, rawval = m.group(1), m.group(2), m.group(3)
        labels: Dict[str, str] = {}
        if labelblob:
            consumed = 0
            for lm in _LABEL_PAIR.finditer(labelblob):
                labels[lm.group(1)] = (
                    lm.group(2).replace('\\"', '"')
                    .replace("\\n", "\n").replace("\\\\", "\\"))
                consumed += len(lm.group(0))
            stripped = re.sub(r"[,\s]", "", labelblob)
            rebuilt = re.sub(r"[,\s]", "", "".join(
                lm.group(0) for lm in _LABEL_PAIR.finditer(labelblob)))
            if stripped != rebuilt:
                raise ExpositionError(
                    f"line {lineno}: malformed labels: {labelblob!r}")
        value = _parse_value(rawval)
        base = sname
        for suffix in ("_bucket", "_sum", "_count"):
            if sname.endswith(suffix) and sname[: -len(suffix)] in families \
                    and families[sname[: -len(suffix)]].get("type") == "histogram":
                base = sname[: -len(suffix)]
                break
        fam = families.get(base)
        if fam is None or "type" not in fam:
            raise ExpositionError(
                f"line {lineno}: sample {sname!r} has no TYPE declaration")
        fam["samples"].append((sname, labels, value))
    _validate_histograms(families)
    return families


def _validate_histograms(families: Dict[str, dict]) -> None:
    for name, fam in families.items():
        if fam.get("type") != "histogram":
            continue
        # group bucket samples by their non-le labels
        series: Dict[tuple, list] = {}
        sums: Dict[tuple, float] = {}
        counts: Dict[tuple, float] = {}
        for sname, labels, value in fam["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
            if sname == name + "_bucket":
                if "le" not in labels:
                    raise ExpositionError(f"{name}: bucket sample missing le")
                series.setdefault(key, []).append(
                    (_parse_value(labels["le"]), value))
            elif sname == name + "_sum":
                sums[key] = value
            elif sname == name + "_count":
                counts[key] = value
        if not series:
            raise ExpositionError(f"{name}: histogram with no buckets")
        for key, buckets in series.items():
            edges = [e for e, _ in buckets]
            if edges != sorted(edges):
                raise ExpositionError(f"{name}: le edges not monotone: {edges}")
            if not math.isinf(edges[-1]):
                raise ExpositionError(f"{name}: missing +Inf terminal bucket")
            cums = [c for _, c in buckets]
            if any(b < a for a, b in zip(cums, cums[1:])):
                raise ExpositionError(
                    f"{name}: cumulative bucket counts decrease: {cums}")
            if key not in counts or key not in sums:
                raise ExpositionError(f"{name}: missing _sum/_count series")
            if counts[key] != cums[-1]:
                raise ExpositionError(
                    f"{name}: _count {counts[key]} != +Inf bucket {cums[-1]}")


class _Handler(BaseHTTPRequestHandler):
    registry: obs_metrics.MetricRegistry = None  # set per-server subclass

    def do_GET(self):  # noqa: N802 (http.server API)
        split = urlsplit(self.path)
        path, query = split.path, parse_qs(split.query)
        if path == "/metrics":
            body = render_text(self.registry).encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
        elif path == "/healthz":
            body = b'{"status":"ok"}\n'
            self.send_response(200)
            self.send_header("Content-Type", JSON_CONTENT_TYPE)
        elif path == "/runlog/tail":
            body, status = self._runlog_tail(query)
            self.send_response(status)
            self.send_header("Content-Type", JSON_CONTENT_TYPE)
        elif path == "/trace":
            body, status = self._trace()
            self.send_response(status)
            self.send_header("Content-Type", JSON_CONTENT_TYPE)
        elif path.startswith("/trace/"):
            body, status = self._trace_by_id(path[len("/trace/"):])
            self.send_response(status)
            self.send_header("Content-Type", JSON_CONTENT_TYPE)
        elif path == "/fleet":
            body, status = self._fleet()
            self.send_response(status)
            self.send_header("Content-Type", JSON_CONTENT_TYPE)
        elif path == "/alerts":
            body, status = self._alerts(query)
            self.send_response(status)
            self.send_header("Content-Type", JSON_CONTENT_TYPE)
        elif path == "/slo":
            body, status = self._slo()
            self.send_response(status)
            self.send_header("Content-Type", JSON_CONTENT_TYPE)
        elif path == "/tenants":
            body, status = self._tenants()
            self.send_response(status)
            self.send_header("Content-Type", JSON_CONTENT_TYPE)
        elif path == "/locks":
            body, status = self._locks()
            self.send_response(status)
            self.send_header("Content-Type", JSON_CONTENT_TYPE)
        elif path == "/roofline":
            body, status = self._roofline()
            self.send_response(status)
            self.send_header("Content-Type", JSON_CONTENT_TYPE)
        elif path.startswith("/waterfall/"):
            body, status = self._waterfall_by_rid(path[len("/waterfall/"):])
            self.send_response(status)
            self.send_header("Content-Type", JSON_CONTENT_TYPE)
        else:
            body = b"not found\n"
            self.send_response(404)
            self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    @staticmethod
    def _runlog_tail(query) -> Tuple[bytes, int]:
        """Last ``n`` runlog events (default 50) as a JSON array — the
        quick "what just happened" debug view next to /metrics."""
        from paddle_tpu_torch.observability import runlog as _runlog

        try:
            n = int(query.get("n", ["50"])[0])
        except ValueError:
            return (json.dumps({"error": "n must be an integer"}).encode() +
                    b"\n", 400)
        if n < 0:
            return (json.dumps({"error": "n must be >= 0"}).encode() + b"\n",
                    400)
        log = _runlog.get_runlog()
        if log is None:
            return (json.dumps({"error": "no runlog installed"}).encode() +
                    b"\n", 404)
        try:
            events = _runlog.read_runlog(log.path)
        except (OSError, ValueError) as e:
            return (json.dumps({"error": str(e)}).encode() + b"\n", 500)
        return json.dumps(events[-n:] if n else []).encode() + b"\n", 200

    @staticmethod
    def _alerts(query) -> Tuple[bytes, int]:
        """Recent alerts from the default :mod:`paddle_tpu_torch.watch` hub as a
        JSON array (``?n=`` most recent, ``?source=`` filter)."""
        from paddle_tpu_torch.watch import alerts as _alerts

        try:
            n = int(query.get("n", ["50"])[0])
        except ValueError:
            return (json.dumps({"error": "n must be an integer"}).encode() +
                    b"\n", 400)
        if n < 0:
            return (json.dumps({"error": "n must be >= 0"}).encode() + b"\n",
                    400)
        source = query.get("source", [None])[0]
        hub = _alerts.default_hub()
        items = [a.as_dict() for a in hub.alerts(n or None, source=source)]
        return json.dumps(items).encode() + b"\n", 200

    @staticmethod
    def _slo() -> Tuple[bytes, int]:
        """Current status of every installed SLO engine's objectives."""
        from paddle_tpu_torch.watch import slo as _slo

        try:
            statuses = [s for engine in _slo.installed_engines()
                        for s in engine.status()]
        except Exception as e:  # never take the exporter down with watch
            return (json.dumps({"error": repr(e)}).encode() + b"\n", 500)
        return json.dumps(statuses).encode() + b"\n", 200

    @staticmethod
    def _tenants() -> Tuple[bytes, int]:
        """Per-tenant admission/scheduling state of every installed
        serving admission controller: quotas, queue depths, admitted/shed
        counts, brownout level."""
        from paddle_tpu_torch.serving import admission as _admission

        try:
            snaps = [c.snapshot()
                     for c in _admission.installed_controllers()]
        except Exception as e:  # never take the exporter down with serving
            return (json.dumps({"error": repr(e)}).encode() + b"\n", 500)
        return json.dumps(snaps).encode() + b"\n", 200

    @staticmethod
    def _locks() -> Tuple[bytes, int]:
        """The ``core.locks`` view of the process: whether order checking
        is on, every held instrumented lock (owner, hold seconds,
        waiters), the observed lock-order graph, and any recorded
        order violations — the first page to pull on a live stall."""
        from paddle_tpu_torch.core import locks as _locks

        try:
            doc = {
                "enabled": _locks.enabled(),
                "held": _locks.held_snapshot(),
                "order_graph": _locks.graph_snapshot(),
                "violations": [
                    {k: v for k, v in rec.items()
                     if k not in ("stack", "other_stack")}
                    for rec in _locks.violations()
                ],
                "violation_count": len(_locks.violations()),
            }
        except Exception as e:  # never take the exporter down with locks
            return (json.dumps({"error": repr(e)}).encode() + b"\n", 500)
        return json.dumps(doc).encode() + b"\n", 200

    @staticmethod
    def _trace() -> Tuple[bytes, int]:
        """The current merged Chrome-trace document — save the response
        body and load it straight into chrome://tracing / Perfetto."""
        from paddle_tpu_torch import tracing

        try:
            doc = tracing.chrome_trace_doc()
        except Exception as e:  # never take the exporter down with tracing
            return (json.dumps({"error": repr(e)}).encode() + b"\n", 500)
        return json.dumps(doc).encode() + b"\n", 200

    @staticmethod
    def _trace_by_id(trace_id: str) -> Tuple[bytes, int]:
        """One request's cross-engine timeline: all spans for the trace
        id, the engine hop order, ``validate_trace(multi_engine=True)``
        problems (empty = no orphans), and correlated runlog events."""
        from paddle_tpu_torch.observability import fleet as _fleet

        if not re.fullmatch(r"[0-9a-f]{32}", trace_id):
            return (json.dumps(
                {"error": "trace id must be 32 lowercase hex chars"}
            ).encode() + b"\n", 400)
        try:
            doc = _fleet.trace_doc(trace_id)
        except Exception as e:  # never take the exporter down with tracing
            return (json.dumps({"error": repr(e)}).encode() + b"\n", 500)
        if not doc["spans"] and not doc["events"]:
            return (json.dumps({"error": "unknown trace id",
                                "trace_id": trace_id}).encode() + b"\n", 404)
        return json.dumps(doc).encode() + b"\n", 200

    @staticmethod
    def _roofline() -> Tuple[bytes, int]:
        """The kernel cost ledger with roofline verdicts: per compiled
        executable, cost-model FLOPs / bytes, arithmetic intensity,
        achieved-vs-peak rates, and a ``compute_bound`` /
        ``memory_bound`` / ``overhead_bound`` classification."""
        from paddle_tpu_torch.observability import roofline as _roofline

        try:
            doc = {
                "enabled": _roofline.enabled(),
                "summary": _roofline.summary(),
                "entries": _roofline.snapshot(),
            }
        except Exception as e:  # never take the exporter down with roofline
            return (json.dumps({"error": repr(e)}).encode() + b"\n", 500)
        return json.dumps(doc).encode() + b"\n", 200

    @staticmethod
    def _waterfall_by_rid(rid: str) -> Tuple[bytes, int]:
        """One decode request's token-latency waterfall: TTFT, per-token
        TPOT samples (speculation-aware), jitter, and the raw iteration
        event timeline."""
        from paddle_tpu_torch import tracing

        if not re.fullmatch(r"[A-Za-z0-9._:-]{1,128}", rid):
            return (json.dumps({"error": "malformed request id"}
                               ).encode() + b"\n", 400)
        try:
            doc = tracing.waterfall.doc(rid)
        except Exception as e:  # never take the exporter down with tracing
            return (json.dumps({"error": repr(e)}).encode() + b"\n", 500)
        if doc is None:
            return (json.dumps({"error": "unknown request id",
                                "rid": rid}).encode() + b"\n", 404)
        return json.dumps(doc).encode() + b"\n", 200

    @staticmethod
    def _fleet() -> Tuple[bytes, int]:
        """Merged fleet rollups from every installed
        :class:`~paddle_tpu_torch.observability.fleet.FleetView` — the
        ``serving.fleet.*`` numbers plus per-engine snapshots."""
        from paddle_tpu_torch.observability import fleet as _fleet

        try:
            views = _fleet.installed_views()
            doc = [v.doc() for v in views]
        except Exception as e:  # never take the exporter down with serving
            return (json.dumps({"error": repr(e)}).encode() + b"\n", 500)
        if not doc:
            return (json.dumps({"error": "no fleet views installed"}
                               ).encode() + b"\n", 404)
        return json.dumps(doc).encode() + b"\n", 200

    def log_message(self, fmt, *args):  # quiet: route through framework log
        ptlog.vlog(2, "metrics exporter: " + fmt, *args)


class MetricsServer:
    """Daemon-thread HTTP server exposing ``/metrics`` and ``/healthz``,
    plus debug endpoints: ``/runlog/tail?n=`` (last n runlog events as
    JSON), ``/trace`` (the current merged Chrome-trace document from
    ``paddle_tpu_torch.tracing``), ``/alerts?n=&source=`` (recent alerts from
    the ``paddle_tpu_torch.watch`` hub), ``/slo`` (installed SLO engines'
    current compliance/burn-rate status), ``/tenants`` (installed
    serving admission controllers' per-tenant quotas, queue depths, and
    shed/brownout state), ``/locks`` (the ``core.locks``
    held-locks registry, lock-order graph, and any recorded order
    violations), ``/fleet`` (installed ``FleetView`` rollups: merged
    ``serving.fleet.*`` numbers plus per-engine snapshots),
    ``/trace/<trace_id>`` (one request's cross-engine span timeline,
    hop order, validation problems, and correlated runlog events),
    ``/roofline`` (the cost ledger: per-callable FLOPs/bytes,
    arithmetic intensity, achieved-vs-peak rates, and compute/memory/
    overhead-bound verdicts), and ``/waterfall/<rid>`` (one decode
    request's token-latency waterfall: TTFT, speculation-aware per-token
    TPOT samples, jitter, and the iteration event timeline)."""

    def __init__(self, registry: Optional[obs_metrics.MetricRegistry] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry or obs_metrics.default_registry()
        handler = type("_BoundHandler", (_Handler,),
                       {"registry": self.registry})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        """The bound port (resolved when constructed with port=0)."""
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MetricsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="paddle_tpu-metrics-exporter", daemon=True)
            self._thread.start()
            ptlog.info("metrics exporter listening on %s/metrics", self.url)
        return self

    def close(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._httpd.server_close()
