"""Declarative SLO alert engine over the metrics registry snapshot.

Metrics answer questions when someone asks; alerts ask the questions
continuously. This engine evaluates a small set of declarative rules
against the SAME registry snapshot both ``/metrics`` formats render
(serving/app.py ``_metrics_doc``) — so an alert can never fire on a
number the operator cannot see — and keeps firing/resolved state with
hysteresis on both edges:

- a **threshold rule** (serving p99 over its SLO, queue rejection rate)
  must be bad for ``for_windows`` consecutive evaluation windows before
  it fires — one jittery scrape pages nobody;
- an **event rule** (pod degraded, disk under its watermark, corruption
  or read-worker-error counter increments) fires on a single window —
  these are never jitter;
- a firing alert resolves only after ``clear_windows`` consecutive clean
  windows — a flapping condition stays visibly FIRING instead of
  strobing.

Evaluation is *read-driven*, the Prometheus model: each ``/metrics`` /
``/alerts`` / ``/healthz`` / status-page read advances at most one
window (``LO_TPU_ALERT_WINDOW_S``), so scrape cadence is evaluation
cadence and an unwatched server burns zero cycles on rules. Transitions
log through structlog (WARNING on fire, INFO on resolve) with the rule
name, value, and threshold — greppable next to the traces.

Rules read the snapshot, never mutate it, and keep their cross-window
state (previous counter values, streak counts) inside the engine — a
rule evaluated against two different App instances' snapshots never
bleeds state between them because each App owns its engine.

**Multi-window burn rates**: with a telemetry history store
attached (utils/timeseries.py), the serving SLO rules
(``serving_p99_slo``, ``serving_reject_rate``,
``serving_deadline_exceeded_rate``) stop judging one instantaneous
snapshot and judge the HISTORY instead, over two windows at once:

- the **slow window** (``LO_TPU_SLO_BURN_SLOW_S``, default 1 h) owns
  the error budget (``LO_TPU_SLO_BURN_BUDGET``): a spike that consumed
  almost none of it reads a burn rate < 1 and pages nobody, however
  dramatic its instantaneous value was;
- the **fast window** (``LO_TPU_SLO_BURN_FAST_S``, default 5 min)
  guards recency: a burn that already stopped reads < 1 there and
  resolves promptly instead of paging for an hour-old incident.

A rule's value is ``min(burn_fast, burn_slow)`` and it fires above 1.0
— so a sustained burn fires within the fast window (its slow-window
budget is consumed quickly at a high burn rate) while brief spikes and
stale incidents both stay silent. The history store, not scrape
cadence, is the evaluation substrate: the background telemetry sampler
keeps feeding it even when nothing scrapes ``/metrics``. Without a
history store (or with a burn window knob at 0) the legacy
single-window samplers above apply unchanged.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.utils.structlog import get_logger

log = get_logger("alerts")


def _path(snapshot: Dict[str, Any], *keys: str) -> Optional[float]:
    """Numeric value at a nested path, or None when absent."""
    cur: Any = snapshot
    for k in keys:
        if not isinstance(cur, dict) or k not in cur:
            return None
        cur = cur[k]
    if isinstance(cur, bool) or not isinstance(cur, (int, float)):
        return None
    return float(cur)


def counter_delta(*keys: str) -> Callable:
    """Sample fn: per-window increase of a cumulative counter at
    ``keys``. The previous value lives in the per-rule ``state`` dict
    the engine owns. First observation establishes the baseline (delta
    None — a server restarting with a nonzero counter must not fire)."""

    def sample(snapshot: Dict[str, Any],
               state: Dict[str, Any]) -> Optional[float]:
        cur = _path(snapshot, *keys)
        if cur is None:
            return None
        prev = state.get("prev")
        state["prev"] = cur
        if prev is None:
            return None
        return max(0.0, cur - prev)

    return sample


@dataclass
class AlertRule:
    """One declarative rule: ``sample(snapshot, state)`` produces the
    measured value (None = no data this window → streaks hold), which
    fires when ``value <op> threshold``."""

    name: str
    severity: str                 # "critical" degrades /healthz; "warning"
    summary: str
    sample: Callable[[Dict[str, Any], Dict[str, Any]], Optional[float]]
    threshold: float
    op: str = ">"                 # ">" or "<"
    #: None = engine default (cfg.alert_for_windows); event rules pin 1.
    for_windows: Optional[int] = None

    def bad(self, value: float) -> bool:
        return value < self.threshold if self.op == "<" \
            else value > self.threshold


@dataclass
class _RuleState:
    firing: bool = False
    bad_streak: int = 0
    ok_streak: int = 0
    since: Optional[float] = None       # wall time of the last transition
    last_value: Optional[float] = None
    fired_count: int = 0
    state: Dict[str, Any] = field(default_factory=dict)


class AlertEngine:
    """Firing/resolved state machine over a rule list. One instance per
    App — rule state (counter baselines, streaks) is App-scoped."""

    def __init__(self, rules: List[AlertRule], window_s: float = 15.0,
                 for_windows: int = 2, clear_windows: int = 2):
        self.rules = list(rules)
        self.window_s = max(0.0, float(window_s))
        self.for_windows = max(1, int(for_windows))
        self.clear_windows = max(1, int(clear_windows))
        self._lock = threading.Lock()
        self._states: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules}
        self._last_eval: Optional[float] = None
        self._counters = {"evaluations": 0, "fired_total": 0,
                          "resolved_total": 0}

    # -- evaluation ----------------------------------------------------------

    def observe(self, snapshot: Dict[str, Any],
                now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Window-gated evaluation: advances one window when at least
        ``window_s`` elapsed since the last one (0 = every call).
        Returns the transitions of this window ([] when gated out)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if (self._last_eval is not None
                    and now - self._last_eval < self.window_s):
                return []
            self._last_eval = now
        return self.evaluate(snapshot)

    def evaluate(self, snapshot: Dict[str, Any]) -> List[Dict[str, Any]]:
        """One evaluation window, unconditionally (tests drive this
        directly). Returns fired/resolved transition docs."""
        transitions: List[Dict[str, Any]] = []
        with self._lock:
            self._counters["evaluations"] += 1
            for rule in self.rules:
                st = self._states[rule.name]
                value = rule.sample(snapshot, st.state)
                if value is None:
                    continue                  # no data: streaks hold
                st.last_value = value
                need = rule.for_windows or self.for_windows
                if rule.bad(value):
                    st.bad_streak += 1
                    st.ok_streak = 0
                    if not st.firing and st.bad_streak >= need:
                        st.firing = True
                        st.since = time.time()
                        st.fired_count += 1
                        self._counters["fired_total"] += 1
                        transitions.append(
                            {"alert": rule.name, "to": "firing",
                             "value": value,
                             "threshold": rule.threshold})
                else:
                    st.ok_streak += 1
                    st.bad_streak = 0
                    if st.firing and st.ok_streak >= self.clear_windows:
                        st.firing = False
                        st.since = time.time()
                        self._counters["resolved_total"] += 1
                        transitions.append(
                            {"alert": rule.name, "to": "resolved",
                             "value": value,
                             "threshold": rule.threshold})
        for t in transitions:
            if t["to"] == "firing":
                log.warning(
                    "alert %s FIRING: value %.6g vs threshold %.6g",
                    t["alert"], t["value"], t["threshold"])
            else:
                log.info(
                    "alert %s resolved: value %.6g vs threshold %.6g",
                    t["alert"], t["value"], t["threshold"])
        return transitions

    # -- views ---------------------------------------------------------------

    def firing(self, severity: Optional[str] = None) -> List[str]:
        by_rule = {r.name: r for r in self.rules}
        with self._lock:
            return [name for name, st in self._states.items()
                    if st.firing and (severity is None
                                      or by_rule[name].severity == severity)]

    def snapshot(self) -> Dict[str, Any]:
        """The ``alerts`` section of ``/metrics`` and the ``GET /alerts``
        body: per-rule state plus engine counters."""
        rules: Dict[str, Any] = {}
        with self._lock:
            for rule in self.rules:
                st = self._states[rule.name]
                rules[rule.name] = {
                    "severity": rule.severity,
                    "summary": rule.summary,
                    "threshold": rule.threshold,
                    "op": rule.op,
                    "for_windows": rule.for_windows or self.for_windows,
                    "firing": st.firing,
                    "value": st.last_value,
                    "since": st.since,
                    "fired_count": st.fired_count,
                }
                # Burn-rate rules stash their per-window detail: the
                # operator sees WHICH window is (not) burning.
                if "burn" in st.state:
                    rules[rule.name]["burn"] = dict(st.state["burn"])
            counters = dict(self._counters)
        return {
            "firing": sorted(n for n, doc in rules.items()
                             if doc["firing"]),
            "rules": rules,
            "window_s": self.window_s,
            "clear_windows": self.clear_windows,
            **counters,
        }


# -- multi-window burn-rate samplers (over the telemetry history) -------------

def _expected_samples(samples, window_s: float) -> float:
    """How many samples the window WOULD hold at the observed cadence —
    the denominator that makes absent history count as in-SLO. A young
    server (or one whose history only spans minutes of a 1 h window)
    must not read its few samples as the whole window: a 1-minute blip
    on a 2-minute-old process is still a blip, not a 50% burn."""
    n = len(samples)
    if n < 2:
        return float(n)
    span = samples[-1][0] - samples[0][0]
    if span <= 0:
        return float(n)
    gap = span / (n - 1)
    return max(float(n), float(window_s) / gap)


def _p99_bad_fraction(history, window_s: float, slo_ms: float) -> \
        Optional[float]:
    """Fraction of the trailing window where ANY model with recent
    traffic ran its p99 above the SLO — judged against the sample count
    the FULL window would hold (missing history counts as in-SLO). None
    without samples (no data: streaks hold, like every sampler)."""
    samples = history.window(window_s)
    if not samples:
        return None
    bad = 0
    for _t, values in samples:
        for name, val in values.items():
            if not (name.startswith("serving.models.")
                    and name.endswith(".p99_ms")):
                continue
            qps = values.get(name[: -len(".p99_ms")] + ".qps") or 0.0
            if qps > 0 and val > slo_ms:
                bad += 1
                break
    return bad / _expected_samples(samples, window_s)


def _ratio_bad_fraction(history, window_s: float, bad_key: str,
                        ok_key: str, threshold: float) -> Optional[float]:
    """Fraction of the window's sample-to-sample intervals whose
    ``Δbad / (Δbad + Δok)`` ratio exceeded ``threshold`` — the same
    "how much of this window was out of SLO" unit the p99 rule
    measures, so every burn rule divides by one budget. Counters that
    moved backwards (process restart) clamp to 0 for that interval;
    traffic-free intervals count as in-SLO. None without at least two
    samples carrying both counters."""
    samples = history.window(window_s)
    points = [(t, v) for t, v in samples
              if bad_key in v and ok_key in v]
    if len(points) < 2:
        return None
    bad_intervals = 0
    for (_t0, prev), (_t1, cur) in zip(points, points[1:]):
        d_bad = max(0.0, cur[bad_key] - prev[bad_key])
        d_ok = max(0.0, cur[ok_key] - prev[ok_key])
        offered = d_bad + d_ok
        if offered > 0 and (d_bad / offered) > threshold:
            bad_intervals += 1
    # Same missing-history-is-in-SLO denominator as the p99 rule.
    return bad_intervals / max(len(points) - 1.0,
                               _expected_samples(points, window_s) - 1.0)


def burn_rate_sample(history, cfg: Settings,
                     bad_fraction_fn: Callable) -> Callable:
    """Build a multi-window burn-rate sampler. ``bad_fraction_fn(history,
    window_s)`` measures the out-of-SLO fraction of one window; the
    sample is ``min(fast, slow) / budget`` — both windows must be
    burning for the rule to read above its 1.0 firing line. The last
    per-window burns land in the rule's state dict, which the snapshot
    surfaces for operators."""
    fast_s = float(cfg.slo_burn_fast_s)
    slow_s = float(cfg.slo_burn_slow_s)
    budget = max(1e-9, float(cfg.slo_burn_budget))

    def sample(_snapshot: Dict[str, Any],
               state: Dict[str, Any]) -> Optional[float]:
        fast = bad_fraction_fn(history, fast_s)
        slow = bad_fraction_fn(history, slow_s)
        if fast is None or slow is None:
            return None
        burn_fast, burn_slow = fast / budget, slow / budget
        state["burn"] = {"fast": round(burn_fast, 4),
                         "slow": round(burn_slow, 4),
                         "fast_window_s": fast_s, "slow_window_s": slow_s}
        return min(burn_fast, burn_slow)

    return sample


def _burn_windows_enabled(cfg: Settings, history) -> bool:
    # A DISABLED history store (LO_TPU_TELEMETRY_SAMPLE_S < 0: window()
    # forever empty) must fall back to the legacy instantaneous
    # samplers — burn rules over it would return None every window and
    # silently never fire any serving SLO alert.
    return (history is not None and getattr(history, "enabled", True)
            and cfg.slo_burn_fast_s > 0 and cfg.slo_burn_slow_s > 0)


# -- the default rule set -----------------------------------------------------

def _serving_worst_p99(snapshot: Dict[str, Any],
                       _state: Dict[str, Any]) -> Optional[float]:
    """Worst per-model recent-window p99 (ms) — the SLO is per model, so
    one degraded model fires even while healthy ones dilute the mean.
    Only models with recent traffic count: an idle model's ``p99_ms``
    falls back to its LIFETIME histogram shape (batcher._Stats), and a
    cold-load spike in there would otherwise keep the alert lit forever
    on a healthy, idle server. No model serving ⇒ 0.0 (no breach — and
    a firing alert resolves when traffic stops instead of latching)."""
    models = ((snapshot.get("serving") or {}).get("models") or {})
    worst = None
    for m in models.values():
        p99 = m.get("p99_ms")
        if not (m.get("qps") or 0) > 0:
            continue
        if isinstance(p99, (int, float)) and (worst is None or p99 > worst):
            worst = float(p99)
    return 0.0 if worst is None else worst


def _reject_rate(snapshot: Dict[str, Any],
                 state: Dict[str, Any]) -> Optional[float]:
    """Per-window rejected / offered ratio for the online predict tier.
    A window with no offered traffic reads 0.0 (no data ≠ bad)."""
    serving = snapshot.get("serving") or {}
    rej = serving.get("rejected")
    req = serving.get("requests")
    if not isinstance(rej, (int, float)) or not isinstance(
            req, (int, float)):
        return None
    prev = state.get("prev")
    state["prev"] = (float(rej), float(req))
    if prev is None:
        return None
    d_rej = max(0.0, float(rej) - prev[0])
    d_req = max(0.0, float(req) - prev[1])
    offered = d_rej + d_req
    return (d_rej / offered) if offered > 0 else 0.0


def _deadline_rate(snapshot: Dict[str, Any],
                   state: Dict[str, Any]) -> Optional[float]:
    """Per-window deadline-expired / offered ratio for the online
    predict tier — sustained misses mean callers are abandoning answers
    faster than the tier can produce them. Offered = completed +
    expired this window; an idle window reads 0.0 (no data ≠ bad)."""
    serving = snapshot.get("serving") or {}
    ded = serving.get("deadline_exceeded")
    req = serving.get("requests")
    if not isinstance(ded, (int, float)) or not isinstance(
            req, (int, float)):
        return None
    prev = state.get("prev")
    state["prev"] = (float(ded), float(req))
    if prev is None:
        return None
    d_ded = max(0.0, float(ded) - prev[0])
    d_req = max(0.0, float(req) - prev[1])
    offered = d_ded + d_req
    return (d_ded / offered) if offered > 0 else 0.0


def _quarantined_models(snapshot: Dict[str, Any],
                        _state: Dict[str, Any]) -> Optional[float]:
    """How many models are currently quarantined (dispatcher crashed
    past its threshold and predicts answer the terminal 503). Level, not
    delta: the alert stays FIRING for as long as any quarantine stands,
    and resolves when a DELETE/re-save lifts the last one."""
    serving = snapshot.get("serving") or {}
    q = serving.get("quarantined")
    if not isinstance(q, (int, float)) or isinstance(q, bool):
        return None
    return float(q)


def _pod_degraded(snapshot: Dict[str, Any],
                  _state: Dict[str, Any]) -> Optional[float]:
    pod = snapshot.get("pod") or {}
    return 1.0 if pod.get("error") else 0.0


def _disk_free(snapshot: Dict[str, Any],
               _state: Dict[str, Any]) -> Optional[float]:
    return _path(snapshot, "resources", "disk", "free_bytes")


def _under_replicated(snapshot: Dict[str, Any],
                      _state: Dict[str, Any]) -> Optional[float]:
    """(dataset, peer) pairs with committed-but-unacked journal bytes
    whose last push FAILED — the store does not flag transient lag from
    an in-flight push, so this level is burn-rate friendly: it holds
    through a real outage and drops to zero the moment re-replication
    catches up. None (rule skips the window) when no peers are
    configured."""
    rep = snapshot.get("replication") or {}
    if not rep.get("enabled"):
        return None
    return float(len(rep.get("under_replicated") or []))


def default_rules(cfg: Settings, history=None) -> List[AlertRule]:
    """The shipped rule table (docs/observability.md). Thresholds come
    from Settings; a 0 threshold knob drops its rule entirely. With a
    telemetry ``history`` store attached (and burn windows enabled),
    the three serving SLO rules evaluate as multi-window burn rates
    over it — value ``min(burn_fast, burn_slow)``, firing line 1.0 —
    instead of the legacy instantaneous single-window samplers."""
    burn = _burn_windows_enabled(cfg, history)
    rules: List[AlertRule] = []
    if cfg.slo_p99_ms > 0:
        slo_ms = float(cfg.slo_p99_ms)
        if burn:
            rules.append(AlertRule(
                name="serving_p99_slo", severity="warning",
                summary="online predict p99 burning its error budget: "
                        f"out-of-SLO (> {slo_ms:g}ms) fraction of both "
                        "the fast and the slow history window exceeds "
                        "the budget (brief spikes stay silent; "
                        "sustained burns fire within the fast window)",
                sample=burn_rate_sample(
                    history, cfg,
                    lambda h, w, slo=slo_ms: _p99_bad_fraction(h, w, slo)),
                threshold=1.0, for_windows=1))
        else:
            rules.append(AlertRule(
                name="serving_p99_slo", severity="warning",
                summary="online predict recent-window p99 above its SLO "
                        "for the worst model",
                sample=_serving_worst_p99, threshold=slo_ms))
    if cfg.slo_reject_rate > 0:
        if burn:
            rate = float(cfg.slo_reject_rate)
            rules.append(AlertRule(
                name="serving_reject_rate", severity="warning",
                summary="predict-queue rejection rate burning its error "
                        "budget over both history windows (capacity, "
                        "not a blip)",
                sample=burn_rate_sample(
                    history, cfg,
                    lambda h, w, r=rate: _ratio_bad_fraction(
                        h, w, "serving.rejected", "serving.requests", r)),
                threshold=1.0, for_windows=1))
        else:
            rules.append(AlertRule(
                name="serving_reject_rate", severity="warning",
                summary="predict queue rejecting a sustained fraction of "
                        "offered requests (capacity, not a blip)",
                sample=_reject_rate, threshold=float(cfg.slo_reject_rate)))
    if cfg.slo_deadline_rate > 0:
        if burn:
            rate = float(cfg.slo_deadline_rate)
            rules.append(AlertRule(
                name="serving_deadline_exceeded_rate", severity="warning",
                summary="deadline-miss rate burning its error budget "
                        "over both history windows — callers abandon "
                        "answers faster than the tier produces them",
                sample=burn_rate_sample(
                    history, cfg,
                    lambda h, w, r=rate: _ratio_bad_fraction(
                        h, w, "serving.deadline_exceeded",
                        "serving.requests", r)),
                threshold=1.0, for_windows=1))
        else:
            rules.append(AlertRule(
                name="serving_deadline_exceeded_rate", severity="warning",
                summary="a sustained fraction of predict requests is "
                        "dying at its deadline (admission or in-queue "
                        "expiry) — callers abandon answers faster than "
                        "the tier produces them",
                sample=_deadline_rate,
                threshold=float(cfg.slo_deadline_rate)))
    rules.append(AlertRule(
        name="serving_quarantined", severity="warning",
        summary="a model's dispatcher crashed past its quarantine "
                "threshold; its predicts answer a terminal 503 until "
                "the model is re-saved or deleted",
        sample=_quarantined_models, threshold=0.5, for_windows=1))
    rules.append(AlertRule(
        name="job_watchdog_fired", severity="critical",
        summary="the job watchdog killed a hung device program this "
                "window (no progress past LO_TPU_JOB_DEADLINE_S); the "
                "pod is poisoned pending a supervisor restart and the "
                "retried job will resume from its fit checkpoint",
        sample=counter_delta("job_fault", "watchdog_fired_total"),
        threshold=0.0, for_windows=1))
    rules.append(AlertRule(
        name="pod_degraded", severity="critical",
        summary="a pod worker died mid-job; mesh jobs fail fast until "
                "the supervisor restarts the pod",
        sample=_pod_degraded, threshold=0.5, for_windows=1))
    if cfg.disk_free_watermark_mb > 0:
        rules.append(AlertRule(
            name="disk_free_low", severity="critical",
            summary="chunk-store filesystem below its free-space "
                    "watermark; ingest/journal writes are about to fail",
            sample=_disk_free,
            threshold=float(cfg.disk_free_watermark_mb) * (1 << 20),
            op="<", for_windows=1))
    rules.append(AlertRule(
        name="integrity_corrupt", severity="critical",
        summary="chunk corruption detected this window (CRC mismatch "
                "on read or scrub)",
        sample=counter_delta("integrity", "chunks_corrupt"),
        threshold=0.0, for_windows=1))
    rules.append(AlertRule(
        name="data_under_replicated", severity="critical",
        summary="committed journal bytes are not replicated to every "
                "peer and the last push failed — a host loss right now "
                "loses the unacked suffix; check peer liveness, lag "
                "drains automatically once a push succeeds "
                "(docs/fault_tolerance.md §9)",
        sample=_under_replicated, threshold=0.0, for_windows=1))
    rules.append(AlertRule(
        name="readpipe_worker_errors", severity="warning",
        summary="chunk-read pipeline workers raised this window "
                "(failures re-raise consumer-side; investigate disk)",
        sample=counter_delta("read_pipeline", "worker_errors"),
        threshold=0.0, for_windows=1))
    return rules


def default_engine(cfg: Settings, history=None) -> AlertEngine:
    return AlertEngine(default_rules(cfg, history=history),
                       window_s=cfg.alert_window_s,
                       for_windows=cfg.alert_for_windows,
                       clear_windows=cfg.alert_clear_windows)
