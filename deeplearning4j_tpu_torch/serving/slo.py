"""SLO attainment + multi-window burn rates (counterpart of
``deeplearning4j_tpu/serving/slo.py``: the same windows, report keys and
``slo_*`` Prometheus families).

An SLO-feedback autoscaler needs one signal:
per-model SLO attainment and burn rate, computed over the traffic a model
ACTUALLY saw — fleet-wide when fed by the
:class:`~deeplearning4j_tpu_torch.serving.router.FleetRouter` (which sees every
client request regardless of which worker served it), per-worker when fed
by a :class:`~deeplearning4j_tpu_torch.serving.server.ModelServer`.

Definitions (the Google-SRE shape, ``docs/observability.md``):

- an :class:`SLOTarget` declares an **availability** objective (fraction
  of requests answered successfully) and a **latency** objective
  (fraction of successful answers under ``latency_ms``),
- **attainment** over a window is the measured fraction,
- **burn rate** over a window is ``(1 - attainment) / (1 - target)`` —
  the rate at which the error budget is being spent: 1.0 = exactly on
  budget, 14.4 = the classic "page now" fast-burn threshold. Burn is
  reported over SEVERAL windows at once (default 1m / 5m / 1h) because a
  fast window catches an outage in seconds while a slow window catches a
  simmering degradation a fast window forgives.

Implementation: a per-model ring of per-second buckets (same idiom as
``ServingMetrics``'s QPS ring) holding (total, bad, ok, ok_slow) counts;
window sums walk the ring at read time, so recording is O(1) and needs no
timer thread. The clock is injectable (``now_fn``) so burn-rate math is
testable against hand-computed windows without sleeping.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple


class SLOTarget:
    """One model's declared objectives. ``availability`` and
    ``latency_target`` are fractions in (0, 1); ``latency_ms`` is the
    per-request threshold the latency objective counts against."""

    __slots__ = ("availability", "latency_ms", "latency_target")

    def __init__(self, availability: float = 0.999,
                 latency_ms: float = 250.0,
                 latency_target: float = 0.99):
        if not 0.0 < availability < 1.0:
            raise ValueError(f"availability must be in (0,1): {availability}")
        if not 0.0 < latency_target < 1.0:
            raise ValueError(
                f"latency_target must be in (0,1): {latency_target}")
        self.availability = float(availability)
        self.latency_ms = float(latency_ms)
        self.latency_target = float(latency_target)

    def to_dict(self) -> Dict[str, float]:
        return {"availability": self.availability,
                "latency_ms": self.latency_ms,
                "latency_target": self.latency_target}


class _ModelWindow:
    """Per-second ring of (total, bad, ok, ok_slow) counts."""

    __slots__ = ("horizon", "times", "total", "bad", "ok", "ok_slow")

    def __init__(self, horizon_s: int):
        self.horizon = int(horizon_s)
        self.times = [-1] * self.horizon
        self.total = [0] * self.horizon
        self.bad = [0] * self.horizon
        self.ok = [0] * self.horizon
        self.ok_slow = [0] * self.horizon

    def record(self, now_s: int, ok: bool, slow: bool) -> None:
        i = now_s % self.horizon
        if self.times[i] != now_s:
            self.times[i] = now_s
            self.total[i] = self.bad[i] = self.ok[i] = self.ok_slow[i] = 0
        self.total[i] += 1
        if ok:
            self.ok[i] += 1
            if slow:
                self.ok_slow[i] += 1
        else:
            self.bad[i] += 1

    def snapshot(self) -> "_ModelWindow":
        """Consistent copy of the ring (C-speed list copies — call under
        the recording lock; the expensive summation walk then runs on
        the copy OUTSIDE it, so a /metrics scrape never stalls the
        request threads feeding :meth:`record`)."""
        snap = _ModelWindow.__new__(_ModelWindow)
        snap.horizon = self.horizon
        snap.times = self.times.copy()
        snap.total = self.total.copy()
        snap.bad = self.bad.copy()
        snap.ok = self.ok.copy()
        snap.ok_slow = self.ok_slow.copy()
        return snap

    def sums(self, now_s: int, window_s: int) -> Tuple[int, int, int, int]:
        return self.multi_sums(now_s, (window_s,))[int(window_s)]

    def multi_sums(self, now_s: int,
                   windows_s: Sequence[int]
                   ) -> Dict[int, Tuple[int, int, int, int]]:
        """Sums for SEVERAL windows in ONE ring walk: each live bucket is
        classified once into the SMALLEST window containing its age, then
        a suffix accumulation folds it into every larger window (a bucket
        younger than w is younger than every w' > w). The read path runs
        under the recording lock, so one pass — with stale/empty slots
        skipped in O(1) — keeps /metrics scrapes from stalling request
        threads."""
        ws = sorted(set(int(w) for w in windows_s))
        acc = [[0, 0, 0, 0] for _ in ws]
        times = self.times
        horizon = ws[-1]
        for i in range(self.horizon):
            age = now_s - times[i]
            if age < 0 or age >= horizon:
                continue  # future-skewed or stale (incl. never-written)
            a = acc[bisect.bisect_right(ws, age)]
            a[0] += self.total[i]
            a[1] += self.bad[i]
            a[2] += self.ok[i]
            a[3] += self.ok_slow[i]
        for j in range(1, len(ws)):  # suffix: larger windows include smaller
            for k in range(4):
                acc[j][k] += acc[j - 1][k]
        return {w: tuple(a) for w, a in zip(ws, acc)}


class SLOMonitor:
    """Fold request outcomes into per-model SLO attainment and
    multi-window burn rates; render on ``/metrics``.

    ``record(model, ok, latency_s)`` is the single feed point (the server
    and the router call it per terminal response). ``windows_s`` are the
    burn-rate windows; the ring horizon is their max.
    """

    def __init__(self, target: Optional[SLOTarget] = None,
                 windows_s: Sequence[int] = (60, 300, 3600),
                 now_fn: Callable[[], float] = time.monotonic,
                 max_models: int = 256):
        self.default_target = target or SLOTarget()
        self.windows_s = tuple(int(w) for w in windows_s)
        if not self.windows_s or min(self.windows_s) <= 0:
            raise ValueError(f"bad windows {windows_s!r}")
        self._horizon = max(self.windows_s)
        self._now_fn = now_fn
        self._lock = threading.Lock()  # guards: _models
        self._models: Dict[str, _ModelWindow] = {}
        self._targets: Dict[str, SLOTarget] = {}
        # hard cap on tracked model names: each window ring is ~5 lists x
        # horizon ints, and the feed point can see arbitrary client-sent
        # names — outcomes for names past the cap are dropped so memory
        # and /metrics cardinality stay bounded no matter the traffic
        self.max_models = int(max_models)

    def set_target(self, model: str, target: SLOTarget) -> None:
        with self._lock:
            self._targets[str(model)] = target

    def target_for(self, model: str) -> SLOTarget:
        return self._targets.get(str(model), self.default_target)

    # ------------------------------------------------------------ recording
    def record(self, model: str, ok: bool,
               latency_s: Optional[float] = None,
               create: bool = True) -> None:
        """One terminal request outcome. ``ok`` is the availability bit
        (served successfully); ``latency_s`` (ok responses only) feeds the
        latency objective. ``create=False`` records only for models
        already tracked — the router passes ``create=(status == 200)`` so
        junk client-sent names that never served cannot occupy slots
        under :attr:`max_models` (once a name HAS served, its failures
        count in full)."""
        now_s = int(self._now_fn())
        target = self.target_for(model)
        slow = (ok and latency_s is not None
                and latency_s * 1e3 > target.latency_ms)
        with self._lock:
            win = self._models.get(model)
            if win is None:
                if not create or len(self._models) >= self.max_models:
                    return  # cardinality cap: never grow without bound
                win = self._models[model] = _ModelWindow(self._horizon)
            win.record(now_s, ok, slow)

    # -------------------------------------------------------------- reading
    def recent_counts(self, model: str, seconds: int) -> list:
        """Per-second request totals for ``model`` over the last
        ``seconds`` FULL seconds, oldest first (the current partial
        second is excluded — it systematically undercounts). This is the
        short-horizon traffic-forecast feed: the autoscaler
        fits a trend over these samples to pre-scale BEFORE a burn-rate
        breach. Seconds with no traffic read 0; an untracked model reads
        all zeros."""
        seconds = max(1, min(int(seconds), self._horizon))
        now_s = int(self._now_fn())
        with self._lock:
            win = self._models.get(str(model))
            snap = win.snapshot() if win is not None else None
        out = [0] * seconds
        if snap is None:
            return out
        for i in range(snap.horizon):
            age = now_s - snap.times[i]
            if 1 <= age <= seconds:
                out[seconds - age] += snap.total[i]
        return out

    def report(self, models: Optional[Sequence[str]] = None
               ) -> Dict[str, Dict[str, Any]]:
        """Per-model, per-window attainment + burn rates.

        ``availability_burn = (bad/total) / (1 - availability_target)``;
        ``latency_burn = (ok_slow/ok) / (1 - latency_target)``. Empty
        windows report attainment 1.0 and burn 0.0 (no traffic spends no
        budget). ``models`` restricts the report (and the ring-walk cost)
        to the named models — the autoscaler's per-tick read passes its
        filter so a 256-model fleet does not pay 256 ring walks per
        control tick."""
        now_s = int(self._now_fn())
        wanted = None if models is None else {str(m) for m in models}
        # SNAPSHOT the rings under the lock (record() recycles a stale
        # slot by writing times[i] before zeroing its counts, so an
        # unlocked reader could count an hour-old bucket as current),
        # then run the expensive one-pass walk on the copies OUTSIDE it —
        # a scrape must never stall the request threads feeding record()
        with self._lock:
            snaps = {model: win.snapshot()
                     for model, win in sorted(self._models.items())
                     if wanted is None or model in wanted}
        sums = {model: snap.multi_sums(now_s, self.windows_s)
                for model, snap in snaps.items()}
        out: Dict[str, Dict[str, Any]] = {}
        for model, per_window in sums.items():
            target = self.target_for(model)
            rep: Dict[str, Any] = {"target": target.to_dict(), "windows": {}}
            for w in self.windows_s:
                t, b, o, s = per_window[w]
                avail = 1.0 - (b / t) if t else 1.0
                lat_att = 1.0 - (s / o) if o else 1.0
                rep["windows"][f"{w}s"] = {
                    "requests": t,
                    "availability": round(avail, 6),
                    "availability_burn_rate": round(
                        (1.0 - avail) / (1.0 - target.availability), 4),
                    "latency_attainment": round(lat_att, 6),
                    "latency_burn_rate": round(
                        (1.0 - lat_att) / (1.0 - target.latency_target), 4),
                }
            out[model] = rep
        return out

    def render_prometheus(self, prefix: str = "slo") -> str:
        rep = self.report()
        if not rep:
            return ""
        lines = [f"# TYPE {prefix}_availability_burn_rate gauge"]
        for model, r in rep.items():
            t = r["target"]
            lines.append(f'{prefix}_target_availability{{model="{model}"}} '
                         f"{t['availability']}")
            lines.append(f'{prefix}_target_latency_ms{{model="{model}"}} '
                         f"{t['latency_ms']}")
            for wname, w in r["windows"].items():
                lbl = f'{{model="{model}",window="{wname}"}}'
                lines.append(f"{prefix}_requests_total{lbl} {w['requests']}")
                lines.append(f"{prefix}_availability{lbl} "
                             f"{w['availability']}")
                lines.append(f"{prefix}_availability_burn_rate{lbl} "
                             f"{w['availability_burn_rate']}")
                lines.append(f"{prefix}_latency_attainment{lbl} "
                             f"{w['latency_attainment']}")
                lines.append(f"{prefix}_latency_burn_rate{lbl} "
                             f"{w['latency_burn_rate']}")
        return "\n".join(lines) + "\n"
