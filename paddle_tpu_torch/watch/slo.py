"""Declarative SLOs with multi-window burn rates and error budgets,
evaluated straight from the metric registry.

An :class:`SLO` names an objective over metrics the stack already
collects; the :class:`SloEngine` samples those metrics on every ``tick``,
keeps a time-stamped ring of samples, and answers three questions per SLO:

* **compliance now** — is the current value inside the objective?
* **error budget** — over the trailing ``window_s``, what fraction of the
  allowed badness (``1 - objective`` for ratio SLOs) has been spent?
* **burn rate** — how fast is the budget burning over a short and a long
  sub-window (the Google-SRE multi-window rule: alert only when BOTH burn
  fast, so a single bad scrape cannot page and a slow leak still does)?

Three SLO kinds cover the stack's metric shapes:

- ``latency``  — a histogram family + quantile: ``quantile(q) <= threshold``
  (e.g. serving p99 request latency). Windowed stats come from cumulative
  histogram deltas between ring samples, so long-running processes judge
  *recent* latency, not the lifetime distribution.
- ``error_rate`` — two counter families: ``bad / total <= objective``
  (e.g. serving errors per response). Counters are windowed by delta too.
- ``gauge_bound`` — a gauge family vs a floor/ceiling (e.g. trainer
  ``goodput_frac >= 0.9``; MFU floors). Budget burn = fraction of recent
  samples out of bounds.

``clock`` is injectable so tests drive windows without sleeping. Breaches
emit through :mod:`paddle_tpu_torch.watch.alerts` (runlog ``alert`` events,
``watch.alert.*`` counters, ``/alerts``); engines registered with
:func:`install` additionally serve their status at the exporter's ``/slo``
endpoint.

A copy of ``paddle_tpu.watch.slo`` for the PyTorch port.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core.enforce import enforce, enforce_in
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.watch import alerts as alerts_mod

__all__ = ["SLO", "SloEngine", "install", "uninstall", "installed_engines",
           "serving_slos", "disagg_slos", "decode_token_slos"]

LATENCY = "latency"
ERROR_RATE = "error_rate"
GAUGE_BOUND = "gauge_bound"
_KINDS = (LATENCY, ERROR_RATE, GAUGE_BOUND)


class SLO:
    """One declarative objective (see module docstring for kinds).

    ``metric``: the primary family — histogram (latency), bad-counter
    (error_rate), or gauge (gauge_bound). ``total_metric``: the
    denominator counter for error_rate. ``objective``: threshold seconds
    (latency), max bad fraction (error_rate), or the bound (gauge_bound,
    with ``bound="min"|"max"``)."""

    def __init__(
        self,
        name: str,
        kind: str,
        metric: str,
        objective: float,
        window_s: float = 3600.0,
        quantile: float = 0.99,
        total_metric: Optional[str] = None,
        bound: str = "min",
        labels: Optional[Dict[str, str]] = None,
        burn_alert: float = 2.0,
        severity: str = alerts_mod.WARNING,
    ):
        enforce_in(kind, _KINDS, "SLO kind")
        enforce(bool(name), "SLO needs a name")
        enforce(window_s > 0, f"window_s must be > 0, got {window_s}")
        if kind == LATENCY:
            enforce(0.0 < quantile < 1.0,
                    f"quantile must be in (0, 1), got {quantile}")
            enforce(objective > 0, "latency objective must be > 0 seconds")
        if kind == ERROR_RATE:
            enforce(total_metric,
                    "error_rate SLO needs total_metric (the denominator)")
            enforce(0.0 <= objective < 1.0,
                    f"error_rate objective must be in [0, 1), got {objective}")
        enforce_in(bound, ("min", "max"), "gauge bound")
        enforce(burn_alert > 0, f"burn_alert must be > 0, got {burn_alert}")
        self.name = name
        self.kind = kind
        self.metric = metric
        self.objective = float(objective)
        self.window_s = float(window_s)
        self.quantile = float(quantile)
        self.total_metric = total_metric
        self.bound = bound
        self.labels = dict(labels or {})
        self.burn_alert = float(burn_alert)
        self.severity = severity

    def __repr__(self):
        return (f"SLO({self.name!r}, {self.kind}, metric={self.metric!r}, "
                f"objective={self.objective})")


class _Ring:
    """Time-stamped sample ring, pruned to the SLO window on append."""

    def __init__(self):
        self.samples: deque = deque()  # (ts, payload)

    def append(self, ts: float, payload, window_s: float) -> None:
        self.samples.append((ts, payload))
        # keep one sample OLDER than the window so deltas span the full
        # window instead of starting at the oldest in-window sample
        while len(self.samples) >= 2 and self.samples[1][0] <= ts - window_s:
            self.samples.popleft()

    def at_or_before(self, ts: float):
        """Newest sample with timestamp <= ts (None when all are newer)."""
        found = None
        for s_ts, payload in self.samples:
            if s_ts <= ts:
                found = (s_ts, payload)
            else:
                break
        return found


class SloEngine:
    """Evaluate a set of SLOs against a registry on every ``tick()``.

    ``tick`` is cheap (one histogram/counter snapshot per SLO) and
    rate-limited by ``min_interval_s``, so callers can invoke it from hot
    paths (the trainer's step record, a serving worker loop) without
    thinking about cadence."""

    def __init__(
        self,
        registry: Optional[obs_metrics.MetricRegistry] = None,
        hub: Optional[alerts_mod.AlertHub] = None,
        clock=time.monotonic,
        min_interval_s: float = 0.5,
    ):
        self.registry = registry or obs_metrics.default_registry()
        self.hub = hub or alerts_mod.default_hub()
        self._clock = clock
        self.min_interval_s = float(min_interval_s)
        self._lock = locks.Lock("watch.slo_engine")
        self._slos: List[SLO] = []
        self._rings: Dict[str, _Ring] = {}
        self._last_tick = -1e18
        self._breached: Dict[str, bool] = {}  # edge-triggered alerting

    def add(self, slo: SLO) -> "SloEngine":
        with self._lock:
            enforce(
                all(s.name != slo.name for s in self._slos),
                f"duplicate SLO name {slo.name!r}")
            self._slos.append(slo)
            self._rings[slo.name] = _Ring()
        return self

    @property
    def slos(self) -> List[SLO]:
        with self._lock:
            return list(self._slos)

    # -- sampling ----------------------------------------------------------

    def _sample(self, slo: SLO):
        """One point-in-time payload for this SLO's ring."""
        if slo.kind == LATENCY:
            return self.registry.histogram_snapshot(
                slo.metric, slo.labels or None)
        if slo.kind == ERROR_RATE:
            return (self.registry.get(slo.metric, slo.labels or None),
                    self.registry.get(slo.total_metric, slo.labels or None))
        # default=None: a gauge that has never been written is "no data",
        # not a 0.0 violating a min-bound during warmup
        return self.registry.get(slo.metric, slo.labels or None, default=None)

    def tick(self, force: bool = False) -> Optional[List[dict]]:
        """Sample + evaluate every SLO. Returns the status list, or None
        when rate-limited (``force=True`` bypasses the limiter)."""
        now = self._clock()
        with self._lock:
            if not force and now - self._last_tick < self.min_interval_s:
                return None
            self._last_tick = now
            slos = list(self._slos)
        statuses = []
        for slo in slos:
            payload = self._sample(slo)
            ring = self._rings[slo.name]
            with self._lock:
                ring.append(now, payload, slo.window_s)
            status = self._evaluate(slo, ring, now)
            statuses.append(status)
            self._maybe_alert(slo, status)
        return statuses

    # -- evaluation --------------------------------------------------------

    @staticmethod
    def _hist_delta(older, newer) -> Tuple[list, int]:
        """Cumulative-bucket and count deltas between two histogram
        snapshots (older may be None or empty: delta from zero)."""
        if newer is None:
            return [], 0
        if older is None:
            return list(newer["cumulative"]), int(newer["count"])
        cum = [int(b) - int(a)
               for a, b in zip(older["cumulative"], newer["cumulative"])]
        return cum, int(newer["count"]) - int(older["count"])

    def _window_value(self, slo: SLO, ring: _Ring, now: float,
                      window_s: float) -> Optional[float]:
        """The SLO's judged value over the trailing ``window_s``:
        latency → windowed quantile; error_rate → windowed bad fraction;
        gauge_bound → fraction of window samples OUT of bounds."""
        newest = ring.samples[-1][1] if ring.samples else None
        anchor = ring.at_or_before(now - window_s)
        older = anchor[1] if anchor is not None else None
        if slo.kind == LATENCY:
            cum, count = self._hist_delta(older, newest)
            if count <= 0 or newest is None:
                return None
            return obs_metrics.histogram_quantile(
                newest["edges"], cum, count, slo.quantile)
        if slo.kind == ERROR_RATE:
            if newest is None:
                return None
            bad_old, tot_old = older if older is not None else (0.0, 0.0)
            bad_new, tot_new = newest
            d_tot = tot_new - tot_old
            if d_tot <= 0:
                return None
            return max(0.0, bad_new - bad_old) / d_tot
        # gauge_bound: fraction of in-window samples violating the bound
        vals = [p for ts, p in ring.samples if ts > now - window_s
                and p is not None]
        if not vals:
            return None
        if slo.bound == "min":
            bad = sum(1 for v in vals if v < slo.objective)
        else:
            bad = sum(1 for v in vals if v > slo.objective)
        return bad / len(vals)

    def _burn_rate(self, slo: SLO, value: Optional[float]) -> Optional[float]:
        """Budget burn: consumption rate relative to 'spend the whole
        budget exactly over the window' (1.0 = on-track, >1 = burning)."""
        if value is None:
            return None
        if slo.kind == LATENCY:
            # latency SLOs have no natural bad-fraction: burn is the ratio
            # of observed quantile to the objective (2x objective = 2.0)
            return value / slo.objective if slo.objective > 0 else None
        if slo.kind == ERROR_RATE:
            budget = 1.0 - slo.objective
            base = max(slo.objective, 1e-12) if slo.objective > 0 else budget
            # fraction-bad over allowed-bad; objective 0 burns against the
            # full budget so a zero-tolerance SLO still yields finite rates
            return value / base
        # gauge_bound: value IS the bad fraction; any violation burns
        return value

    def _evaluate(self, slo: SLO, ring: _Ring, now: float) -> dict:
        short_w = max(slo.window_s / 12.0, self.min_interval_s)
        value_long = self._window_value(slo, ring, now, slo.window_s)
        value_short = self._window_value(slo, ring, now, short_w)
        burn_long = self._burn_rate(slo, value_long)
        burn_short = self._burn_rate(slo, value_short)
        if slo.kind == LATENCY:
            compliant = value_long is None or value_long <= slo.objective
            budget_spent = (min(1.0, burn_long) if burn_long is not None
                            else 0.0)
        elif slo.kind == ERROR_RATE:
            compliant = value_long is None or value_long <= slo.objective
            budget = 1.0 - slo.objective
            budget_spent = (min(1.0, value_long / budget)
                            if value_long is not None and budget > 0 else 0.0)
        else:
            current = ring.samples[-1][1] if ring.samples else None
            if current is None:
                compliant = True
            elif slo.bound == "min":
                compliant = current >= slo.objective
            else:
                compliant = current <= slo.objective
            budget_spent = value_long if value_long is not None else 0.0
        # multi-window rule: breach only when BOTH windows burn past the
        # alert rate (short window proves it is happening NOW, long window
        # proves it is not one bad scrape)
        burning = (
            burn_long is not None and burn_long > slo.burn_alert
            and burn_short is not None and burn_short > slo.burn_alert
        )
        return {
            "name": slo.name,
            "kind": slo.kind,
            "metric": slo.metric,
            "objective": slo.objective,
            "window_s": slo.window_s,
            "compliant": bool(compliant),
            "value": value_long,
            "value_short_window": value_short,
            "burn_rate": burn_long,
            "burn_rate_short_window": burn_short,
            "budget_spent_frac": round(float(budget_spent), 6),
            "breached": bool(burning or not compliant),
        }

    def _maybe_alert(self, slo: SLO, status: dict) -> None:
        breached = status["breached"]
        prof_labels = {"slo": slo.name}
        from paddle_tpu_torch.core import profiler as prof

        prof.set_gauge("watch.slo.compliant",
                       0.0 if breached else 1.0, labels=prof_labels)
        if status["budget_spent_frac"] is not None:
            prof.set_gauge("watch.slo.budget_spent_frac",
                           status["budget_spent_frac"], labels=prof_labels)
        was = self._breached.get(slo.name, False)
        self._breached[slo.name] = breached
        if breached and not was:  # edge-triggered: one alert per episode
            self.hub.emit(alerts_mod.Alert(
                source=f"slo.{slo.name}",
                key=slo.metric,
                severity=slo.severity,
                message=(
                    f"SLO {slo.name} breached: value="
                    f"{status['value']} objective={slo.objective} "
                    f"burn_rate={status['burn_rate']}"),
                value=status["value"] or 0.0,
                baseline=slo.objective,
                score=status["burn_rate"] or 0.0,
                labels=dict(slo.labels),
            ))

    def status(self) -> List[dict]:
        """Latest evaluation without advancing the rings (fresh tick when
        none has happened yet)."""
        now = self._clock()
        with self._lock:
            slos = list(self._slos)
        return [self._evaluate(slo, self._rings[slo.name], now)
                for slo in slos]


def serving_slos(
    engine_label: str,
    p99_objective_s: float = 0.25,
    error_rate_objective: float = 0.05,
    window_s: float = 60.0,
    severity: str = alerts_mod.WARNING,
) -> List[SLO]:
    """The standard serving objectives for one engine, labeled with its
    ``engine`` tag so the engine's brownout hook (which matches alerts by
    that label) reacts only to its own breaches: p99 request latency and
    error rate. Feed the result to ``WatchConfig(slos=...)``::

        ServingConfig(watch=WatchConfig(
            enabled=True, slos=serving_slos("serving0", 0.25)))
    """
    labels = {"engine": engine_label}
    return [
        SLO(f"serving_{engine_label}_p99_latency", LATENCY,
            "serving.request_latency_seconds", p99_objective_s,
            window_s=window_s, quantile=0.99, labels=labels,
            severity=severity),
        SLO(f"serving_{engine_label}_error_rate", ERROR_RATE,
            "serving.errors_total", error_rate_objective,
            total_metric="serving.responses_total",
            window_s=window_s, labels=labels, severity=severity),
    ]


def decode_token_slos(
    engine_label: str,
    ttft_p99_objective_s: float = 1.0,
    tpot_p99_objective_s: float = 0.1,
    window_s: float = 60.0,
    cls: str = "default",
    severity: str = alerts_mod.WARNING,
) -> List[SLO]:
    """The default token-latency objectives for one decode engine: p99
    TTFT (submit → first token, queue wait included) and p99 TPOT
    (per-generated-token latency after the first; speculation-aware — a
    verify step accepting N tokens booked N samples, so the objective
    means the same thing spec-on and spec-off). Burn-rate alerting rides
    the standard multi-window rule. The labels must match what
    ``DecodeMetrics`` stamps on the histograms: the ``engine`` tag plus
    the priority class (``"default"`` unless requests set one)::

        DecodeConfig(watch=WatchConfig(
            enabled=True, slos=decode_token_slos("decode0")))
    """
    labels = {"engine": engine_label, "cls": cls}
    return [
        SLO(f"decode_{engine_label}_{cls}_ttft_p99", LATENCY,
            "serving.decode.ttft_seconds", ttft_p99_objective_s,
            window_s=window_s, quantile=0.99, labels=labels,
            severity=severity),
        SLO(f"decode_{engine_label}_{cls}_tpot_p99", LATENCY,
            "serving.decode.tpot_seconds", tpot_p99_objective_s,
            window_s=window_s, quantile=0.99, labels=labels,
            severity=severity),
    ]


def disagg_slos(
    decode_labels: List[str],
    p99_objective_s: float = 0.25,
    window_s: float = 60.0,
    severity: str = alerts_mod.WARNING,
) -> List[SLO]:
    """Interactive decode p99 objectives for a disaggregated fleet: one
    latency SLO per decode-role worker label. These are what the
    :class:`~paddle_tpu_torch.serving.disagg.Autoscaler` burns against — point
    ``AutoscalerConfig(slo_name=...)`` at one of the returned names
    (``disagg_<label>_decode_p99``). The disaggregation headline is that
    a prefill storm must not move these."""
    return [
        SLO(f"disagg_{lbl}_decode_p99", LATENCY,
            "serving.request_latency_seconds", p99_objective_s,
            window_s=window_s, quantile=0.99,
            labels={"engine": lbl}, severity=severity)
        for lbl in decode_labels
    ]


# -- process-wide install (what the exporter's /slo endpoint serves) --------

_installed_lock = locks.Lock("watch.slo_install")
_installed: List[SloEngine] = []


def install(engine: SloEngine) -> SloEngine:
    """Register an engine for the exporter's ``/slo`` endpoint."""
    with _installed_lock:
        if engine not in _installed:
            _installed.append(engine)
    return engine


def uninstall(engine: SloEngine) -> None:
    with _installed_lock:
        if engine in _installed:
            _installed.remove(engine)


def installed_engines() -> List[SloEngine]:
    with _installed_lock:
        return list(_installed)
