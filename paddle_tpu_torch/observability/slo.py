"""Declarative SLOs evaluated over the federated scrape, with
multi-window multi-burn-rate alerting.

The rest of the package is the sensor plane — per-process registries, the
`FederatedScraper` merging every pserver/worker/replica into one
document, derived ``autoscale/*`` gauges, live ``perf/*`` roofline
numbers. This module is the judgment layer on top: an `SloSpec` says
*what good looks like* ("p99 pull latency under 100 ms per shard",
"serving error ratio under 0.1%", "rows visible in serving within 2 s
of publish"), and an `SloEngine` compiles the specs into recording
rules evaluated on every scrape sweep, maintaining the standard SRE
multi-window burn-rate formulation:

    burn rate = (observed bad fraction) / (error budget)
    page  when burn(1h)  > 14.4  AND burn(5m)  > 14.4
    warn  when burn(6h)  >  6.0  AND burn(30m) >  6.0

The AND of a long and a short window is what makes this both fast and
quiet: a hard outage pushes the short window to enormous burn within a
sweep or two (pages immediately), while a slow leak has to sustain
long enough to move the 1 h window (no flapping on blips); recovery
clears the short window first, resolving the page promptly.

Wall-clock windows are impractical in tests and bench chaos cells, so
the engine takes a ``window_scale``: the *rule* stays "1 h / 5 m" (and
is labelled that way in the ``slo/burn_rate{window=...}`` recording
gauges), but the engine evaluates it over ``window * scale`` seconds.
The bench kills a pserver and proves the page fires within two sweeps
at scale ~1/720 — identical code path, compressed time.

Indicator modes:

* ``min_above``  — bad when value < bound (availability ``ps/shard_up``,
  ``perf/mfu`` floors);
* ``max_below``  — bad when value > bound (latency p99 / step-time
  ceilings; ``field`` picks the summary percentile);
* ``age_below``  — the metric is a unix-time "freshness clock" gauge
  (``staleness/last_visible_ts``); bad when now − value > bound. This
  is what makes train→serve staleness alertable: when delta flow
  stalls, no new e2e histogram samples arrive at all, but the clock's
  age grows without bound;
* ``ratio``      — error/total counter pair; each sweep contributes
  bad = Δerror/Δtotal weighted by Δtotal (request-weighted burn, the
  canonical availability SLI).

``group_by`` evaluates the spec per distinct label value (per shard,
per tenant, per table) so the resulting alert's labels *name the
offender* — the bench asserts the flight dump of a pserver SIGKILL
carries the dead shard's id.

The port's copy of ``paddle_tpu.observability.slo``, stdlib only.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

from .registry import Registry, get_registry

__all__ = ["SloSpec", "SloEngine", "default_slos", "BURN_RATE_WINDOWS"]

# (severity, long_window_s, short_window_s, burn_rate_threshold) — the
# standard SRE multiwindow table (SNIPPETS-independent; Google SRE
# workbook chapter 5 values).
BURN_RATE_WINDOWS: Tuple[tuple, ...] = (
    ("page", 3600.0, 300.0, 14.4),
    ("warn", 21600.0, 1800.0, 6.0),
)

Registry.describe(
    "slo/bad_fraction",
    "recording rule: this sweep's bad fraction per SLO (and group)")
Registry.describe(
    "slo/burn_rate",
    "recording rule: error-budget burn rate per SLO over each alert "
    "window (window label names the logical, unscaled window)")
Registry.describe(
    "staleness/e2e_ms",
    "true train-to-serve staleness: trainer push to visible in the "
    "serving row cache, per delta row")
Registry.describe(
    "staleness/last_visible_ts",
    "freshness clock: unix time of the last delta batch applied to the "
    "serving cache; its age is what DeltaStaleness alerts on")

_MODES = ("min_above", "max_below", "age_below", "ratio")


def _wlabel(seconds: float) -> str:
    s = int(seconds)
    if s % 3600 == 0:
        return f"{s // 3600}h"
    if s % 60 == 0:
        return f"{s // 60}m"
    return f"{s}s"


class SloSpec:
    """One service-level objective, declaratively.

    Parameters
    ----------
    name : alert name (``PsShardAvailability`` style — what pages).
    metric : series name of the indicator (for ``ratio``, the error
        counter; ``total_metric`` holds the denominator).
    mode : one of ``min_above`` / ``max_below`` / ``age_below`` /
        ``ratio`` (see module doc).
    bound : threshold for the threshold modes (same unit as the metric;
        seconds for ``age_below``). Unused for ``ratio``.
    objective : target good fraction; the error budget is
        ``1 - objective`` and burn rates are measured against it.
    field : ``"value"`` for counters/gauges or a summary key
        (``"p99"``, ``"p95"``, ``"mean"``) for histogram series.
    group_by : evaluate per distinct value of this label (alert labels
        carry it), or None for one global series.
    match : optional label subset a series must carry to count.
    missing : ``"ignore"`` (no observation when the metric is absent —
        the default) or ``"bad"`` (absence of a previously-seen group
        counts as a bad sample: a target that stops reporting is
        treated as out of SLO).
    description : human text, carried into alert annotations.
    """

    def __init__(self, name: str, metric: str, mode: str,
                 bound: Optional[float] = None, objective: float = 0.999,
                 field: str = "value", group_by: Optional[str] = None,
                 total_metric: Optional[str] = None,
                 match: Optional[dict] = None, missing: str = "ignore",
                 description: str = ""):
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        if mode == "ratio" and not total_metric:
            raise ValueError("ratio mode requires total_metric")
        if mode != "ratio" and bound is None:
            raise ValueError(f"mode {mode!r} requires a bound")
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        if missing not in ("ignore", "bad"):
            raise ValueError(f"missing must be 'ignore'|'bad', "
                             f"got {missing!r}")
        self.name = str(name)
        self.metric = str(metric)
        self.mode = mode
        self.bound = None if bound is None else float(bound)
        self.objective = float(objective)
        self.field = str(field)
        self.group_by = group_by
        self.total_metric = total_metric
        self.match = dict(match or {})
        self.missing = missing
        self.description = str(description)

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    # ------------------------------------------------------ factory sugar
    @classmethod
    def floor(cls, name, metric, bound, **kw):
        """Bad when the metric drops below `bound` (availability, MFU)."""
        return cls(name, metric, "min_above", bound=bound, **kw)

    @classmethod
    def ceiling(cls, name, metric, bound, **kw):
        """Bad when the metric exceeds `bound` (queue depth, step time)."""
        return cls(name, metric, "max_below", bound=bound, **kw)

    @classmethod
    def latency(cls, name, metric, budget_ms, field="p99",
                objective=0.99, **kw):
        """Bad when the chosen percentile exceeds `budget_ms`."""
        return cls(name, metric, "max_below", bound=float(budget_ms),
                   field=field, objective=objective, **kw)

    @classmethod
    def freshness(cls, name, metric, budget_ms, objective=0.999, **kw):
        """`metric` is a unix-time gauge stamped on each update; bad
        when its age exceeds `budget_ms`."""
        return cls(name, metric, "age_below", bound=float(budget_ms) / 1e3,
                   objective=objective, **kw)

    @classmethod
    def ratio(cls, name, error_metric, total_metric, objective=0.999, **kw):
        """Request-weighted error-ratio SLI over a counter pair."""
        return cls(name, error_metric, "ratio", total_metric=total_metric,
                   objective=objective, **kw)

    def doc(self) -> dict:
        return {"name": self.name, "metric": self.metric, "mode": self.mode,
                "bound": self.bound, "objective": self.objective,
                "field": self.field, "group_by": self.group_by,
                "total_metric": self.total_metric, "missing": self.missing,
                "description": self.description}


def _flatten(doc) -> List[dict]:
    """Fleet doc (or plain series list) -> one series list with each
    target's process/role/shard labels merged in (series' own labels
    win on collision), so ``group_by="process"`` etc. work."""
    if isinstance(doc, list):
        return doc
    out: List[dict] = []
    for r in doc.get("targets", ()):
        base = {"process": r.get("process"), "role": r.get("role")}
        if r.get("shard") is not None:
            base["shard"] = str(r["shard"])
        for s in r.get("series", ()):
            labels = dict(base)
            labels.update(s.get("labels") or {})
            s2 = dict(s)
            s2["labels"] = labels
            out.append(s2)
    return out


def _series_field(s: dict, field: str):
    if field == "value":
        v = s.get("value")
        if v is None and s.get("summary"):
            v = s["summary"].get("mean")
        return v if isinstance(v, (int, float)) else None
    summ = s.get("summary") or {}
    v = summ.get(field)
    return v if isinstance(v, (int, float)) else None


class SloEngine:
    """Evaluates a list of `SloSpec`s over each federated sweep and
    drives an `alerts.AlertManager`. Attach to a scraper via
    ``engine.attach(scraper)`` (rides `add_sweep_listener`) or call
    ``observe(doc)`` directly."""

    def __init__(self, specs, alert_manager=None, window_scale: float = 1.0,
                 windows=BURN_RATE_WINDOWS,
                 registry: Optional[Registry] = None):
        self.specs: List[SloSpec] = list(specs)
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.window_scale = float(window_scale)
        self.windows = tuple(windows)
        self._am = alert_manager
        self._reg = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        # (spec.name, group) -> deque[(t, bad, weight)]
        self._rings: Dict[tuple, "collections.deque"] = {}
        # ratio mode: (spec.name, group) -> (prev_err, prev_total)
        self._prev: Dict[tuple, Tuple[float, float]] = {}
        self._max_window = (max(w[1] for w in self.windows)
                            * self.window_scale)

    # --------------------------------------------------------- evaluation
    def observe(self, doc, now: Optional[float] = None,
                now_wall: Optional[float] = None) -> dict:
        """One sweep: evaluate every spec against `doc` (a ``/fleet``
        document or a plain series list), update rings, recording
        gauges, and the alert manager. `now` is the monotonic rule
        clock (injectable for tests); `now_wall` the wall clock used by
        ``age_below`` freshness rules."""
        now = time.monotonic() if now is None else float(now)
        now_wall = time.time() if now_wall is None else float(now_wall)
        flat = _flatten(doc)
        out = {}
        with self._lock:
            for spec in self.specs:
                out[spec.name] = self._observe_spec(spec, flat, now,
                                                    now_wall)
        return out

    def _observe_spec(self, spec: SloSpec, flat: List[dict],
                      now: float, now_wall: float) -> dict:
        samples = self._evaluate(spec, flat, now_wall)
        known = {g for (n, g) in self._rings if n == spec.name}
        if spec.missing == "bad":
            for g in known - set(samples):
                samples[g] = (1.0, 1.0, None)
        for group, (bad, weight, _val) in samples.items():
            if weight <= 0:
                continue
            ring = self._rings.setdefault(
                (spec.name, group), collections.deque())
            ring.append((now, bad, weight))
        # evaluate every group that still has samples in its ring (a
        # vanished group keeps decaying until its ring drains, so its
        # alert resolves rather than freezing in the firing state)
        result = {}
        for key in [k for k in list(self._rings) if k[0] == spec.name]:
            group = key[1]
            ring = self._rings[key]
            horizon = now - self._max_window - 1e-9
            while ring and ring[0][0] < horizon:
                ring.popleft()
            glabels = {spec.group_by: group} if spec.group_by else {}
            if not ring:
                del self._rings[key]
                self._reg.remove("slo/bad_fraction", slo=spec.name,
                                 **glabels)
                for _, long_s, short_s, _ in self.windows:
                    for w in (long_s, short_s):
                        self._reg.remove("slo/burn_rate", slo=spec.name,
                                         window=_wlabel(w), **glabels)
                if self._am is not None:
                    for severity, _, _, _ in self.windows:
                        self._am.update(
                            spec.name, False, severity=severity,
                            labels={"slo": spec.name, **glabels}, now=now)
                continue
            cur_bad = samples.get(group, (ring[-1][1], 0, None))[0]
            raw_val = samples.get(group, (None, 0, None))[2]
            self._reg.gauge("slo/bad_fraction", slo=spec.name,
                            **glabels).set(cur_bad)
            burns = {}
            for severity, long_s, short_s, threshold in self.windows:
                b_long = self._burn(ring, now, long_s * self.window_scale,
                                    spec.budget)
                b_short = self._burn(ring, now,
                                     short_s * self.window_scale,
                                     spec.budget)
                burns[severity] = (b_long, b_short)
                self._reg.gauge("slo/burn_rate", slo=spec.name,
                                window=_wlabel(long_s),
                                **glabels).set(b_long)
                self._reg.gauge("slo/burn_rate", slo=spec.name,
                                window=_wlabel(short_s),
                                **glabels).set(b_short)
                if self._am is not None:
                    active = b_long > threshold and b_short > threshold
                    ann = {"slo": spec.description or spec.name,
                           "objective": spec.objective,
                           "bound": spec.bound,
                           "metric": spec.metric,
                           f"burn_{_wlabel(long_s)}": round(b_long, 3),
                           f"burn_{_wlabel(short_s)}": round(b_short, 3)}
                    if raw_val is not None:
                        ann["value"] = raw_val
                    self._am.update(
                        spec.name, active, severity=severity,
                        labels={"slo": spec.name, **glabels},
                        value=round(b_short, 3), annotations=ann, now=now)
            result[group] = {"bad": cur_bad, "burns": burns,
                             "value": raw_val}
        return result

    @staticmethod
    def _burn(ring, now: float, window: float, budget: float) -> float:
        lo = now - window
        n = w = 0.0
        for t, bad, weight in reversed(ring):
            if t < lo:
                break
            n += bad * weight
            w += weight
        if w <= 0:
            return 0.0
        return (n / w) / max(budget, 1e-9)

    def _evaluate(self, spec: SloSpec, flat: List[dict],
                  now_wall: float) -> Dict[str, tuple]:
        """group -> (bad_fraction, weight, raw_value) for this sweep."""

        def matches(s, metric):
            if s.get("name") != metric:
                return False
            labels = s.get("labels") or {}
            return all(labels.get(k) == str(v)
                       for k, v in spec.match.items())

        def group_of(s):
            if spec.group_by is None:
                return ""
            g = (s.get("labels") or {}).get(spec.group_by)
            return None if g is None else str(g)

        out: Dict[str, tuple] = {}
        if spec.mode == "ratio":
            errs: Dict[str, float] = {}
            tots: Dict[str, float] = {}
            for s in flat:
                g = group_of(s)
                if g is None:
                    continue
                v = _series_field(s, "value")
                if v is None:
                    continue
                if matches(s, spec.metric):
                    errs[g] = errs.get(g, 0.0) + v
                elif matches(s, spec.total_metric):
                    tots[g] = tots.get(g, 0.0) + v
            for g, tot in tots.items():
                err = errs.get(g, 0.0)
                prev = self._prev.get((spec.name, g))
                self._prev[(spec.name, g)] = (err, tot)
                if prev is None:
                    continue
                d_err, d_tot = err - prev[0], tot - prev[1]
                if d_tot <= 0 or d_err < 0:  # idle sweep / counter reset
                    continue
                frac = min(1.0, d_err / d_tot)
                out[g] = (frac, d_tot, frac)
            return out

        # threshold modes: aggregate matching series per group, worst wins
        vals: Dict[str, float] = {}
        for s in flat:
            if not matches(s, spec.metric):
                continue
            g = group_of(s)
            if g is None:
                continue
            v = _series_field(s, spec.field)
            if v is None:
                continue
            if g in vals:
                # worst-case merge: lowest for floors/freshness clocks,
                # highest for ceilings
                vals[g] = (min(vals[g], v)
                           if spec.mode in ("min_above", "age_below")
                           else max(vals[g], v))
            else:
                vals[g] = float(v)
        for g, v in vals.items():
            if spec.mode == "min_above":
                bad = 1.0 if v < spec.bound else 0.0
                out[g] = (bad, 1.0, v)
            elif spec.mode == "max_below":
                bad = 1.0 if v > spec.bound else 0.0
                out[g] = (bad, 1.0, v)
            else:  # age_below: v is a unix timestamp
                age = max(0.0, now_wall - v)
                bad = 1.0 if age > spec.bound else 0.0
                out[g] = (bad, 1.0, age)
        return out

    # -------------------------------------------------------------- wiring
    def attach(self, scraper) -> "SloEngine":
        """Evaluate on every `FederatedScraper` sweep."""
        scraper.add_sweep_listener(self.observe)
        return self

    def status(self) -> dict:
        """Current burn state per (slo, group) — the ops console reads
        this shape out of the recording gauges when remote, or directly
        here in-process."""
        with self._lock:
            keys = sorted(self._rings)
        return {"specs": [s.doc() for s in self.specs],
                "window_scale": self.window_scale,
                "groups": [{"slo": n, "group": g} for n, g in keys]}


def default_slos(serving_p99_ms: float = 50.0,
                 ps_pull_p99_ms: float = 100.0,
                 staleness_budget_ms: float = 2000.0,
                 step_time_ms: Optional[float] = None,
                 mfu_floor: Optional[float] = None) -> List[SloSpec]:
    """The stock objectives over this runtime's own metric names —
    serving latency/availability per tenant, PS pull p99 and liveness
    per shard, train→serve delta freshness per table, and optional
    training step-time / MFU floors (opt-in: their budgets are
    model-specific). See docs/migration.md "SLOs and alerting"."""
    specs = [
        SloSpec.floor(
            "PsShardAvailability", "ps/shard_up", 1.0, group_by="shard",
            objective=0.999,
            description="every PS shard answers health pings"),
        SloSpec.latency(
            "PsPullLatency", "ps/shard_pull_ms", ps_pull_p99_ms,
            group_by="shard", objective=0.99,
            description="per-shard pull p99 under budget"),
        SloSpec.ratio(
            "ServingAvailability", "serving/errors", "serving/requests",
            objective=0.999,
            description="serving error ratio within budget"),
        SloSpec.latency(
            "ServingTenantLatency", "fleet/tenant_latency_ms",
            serving_p99_ms, group_by="tenant", objective=0.99,
            description="per-tenant serving p99 under budget"),
        SloSpec.ratio(
            "ServingTenantAvailability", "fleet/tenant_throttled",
            "fleet/tenant_requests", group_by="tenant", objective=0.999,
            description="per-tenant admission within budget"),
        SloSpec.freshness(
            "DeltaStaleness", "staleness/last_visible_ts",
            staleness_budget_ms, group_by="table", objective=0.999,
            description="train-to-serve delta visibility within the "
                        "staleness budget"),
        # the root-cause loop's paging signal: when straggler steps blow
        # this budget, the page arrives pre-annotated with culprit
        # kernels by the installed ProfileTrigger (see
        # docs/migration.md "The root-cause loop")
        SloSpec.ratio(
            "StepAnomalyRatio", "steps/anomalies", "steps/total",
            objective=0.99,
            description="straggler-step ratio within budget"),
    ]
    if step_time_ms is not None:
        specs.append(SloSpec.latency(
            "TrainStepTime", "steps/wall_ms", step_time_ms,
            objective=0.99,
            description="training step wall-time p99 under budget"))
    if mfu_floor is not None:
        specs.append(SloSpec.floor(
            "MfuFloor", "perf/mfu", mfu_floor, objective=0.99,
            description="model FLOPs utilization above floor"))
    return specs
