"""Fixed-grid time-series telemetry + Chrome trace-event primitives.

This module is the *format* half of FleetScope (the observability layer;
serving.telemetry is the recording half).  It knows nothing about
engines or meters: everything here operates on plain numpy arrays and
python scalars, so `core` stays importable without the serving stack and
without torch.

Two artifacts are defined:

* `MetricsTimeline` — per-pool series (watts, per-phase joules, tokens,
  occupancy, in-flight decode population, queue depth, online-instance
  count) sampled on a fixed sim-time grid, built by pro-rating charge
  intervals onto bins (`bin_intervals`).  tok/W(t), ramp lag and the
  stacked energy decomposition are all row-reads of this structure.
* Chrome trace-event JSON builders (`span_event` / `instant_event` /
  `counter_event` / `meta_event` / `chrome_trace_doc`) — the dialect
  Perfetto ingests: one "process" per pool, one "thread" per instance,
  counter tracks for power and occupancy.  Times are seconds in, the
  builders convert to the microsecond `ts` the format requires.

Both JSON shapes carry the reference's schema versions, so a consumer of
either package's artifacts can detect drift.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

# bump when the exported JSON shape changes incompatibly
TRACE_SCHEMA_VERSION = 1       # chrome_trace_doc / Perfetto export
TIMELINE_SCHEMA_VERSION = 1    # MetricsTimeline.to_json

# --- request-lifecycle event kinds --------------------------------------
# One int per lifecycle edge.  The *lifecycle* set is emitted by both
# engines (scalar `PoolEngine`, batched `BatchedPoolEngine`) and by
# FleetSim's router; the *detail* extras are ADMIT and PREFILL chunks.
(EV_ARRIVE, EV_ROUTE, EV_ADMIT, EV_PREFILL, EV_FIRST_TOKEN, EV_HANDOFF,
 EV_ESCALATE, EV_OVERFLOW, EV_COMPLETE) = range(9)

EVENT_NAMES = ("arrive", "route", "admit", "prefill", "first_token",
               "handoff", "escalate", "overflow", "complete")

LIFECYCLE_KINDS = frozenset((EV_ARRIVE, EV_ROUTE, EV_FIRST_TOKEN,
                             EV_HANDOFF, EV_ESCALATE, EV_OVERFLOW,
                             EV_COMPLETE))

# energy phases as recorded by the meter hooks; decode charges carry the
# MoE dispatch share separately (dispatch rides *inside* decode energy,
# never additive — see serving.energy)
PHASES = ("decode", "prefill", "idle", "handoff")


def bin_intervals(start, dur, weight, edges: np.ndarray,
                  out: np.ndarray) -> None:
    """Pro-rate interval weights onto a fixed bin grid, in place.

    Each interval [start, start+dur) deposits `weight` into `out`,
    split across the bins it overlaps in proportion to overlap length;
    the part of an interval outside [edges[0], edges[-1]] is dropped.
    Zero-length intervals (point charges) land whole in their bin.
    The common case — interval inside one bin — is fully vectorized;
    only straddlers (rare: long idle skips, handoff walls) loop.
    """
    start = np.atleast_1d(np.asarray(start, np.float64))
    dur = np.atleast_1d(np.asarray(dur, np.float64))
    weight = np.atleast_1d(np.asarray(weight, np.float64))
    start, dur, weight = np.broadcast_arrays(start, dur, weight)
    end = start + dur
    t0, t1 = float(edges[0]), float(edges[-1])
    keep = (end > t0) & (start < t1) | ((dur == 0.0)
                                        & (start >= t0) & (start <= t1))
    if not keep.all():
        start, dur, end, weight = (a[keep] for a in
                                   (start, dur, end, weight))
    if not len(start):
        return
    n = len(edges) - 1
    lo = np.clip(np.searchsorted(edges, start, side="right") - 1, 0, n - 1)
    hi = np.clip(np.searchsorted(edges, end, side="left") - 1, 0, n - 1)
    inside = (lo == hi) & (start >= t0) & (end <= t1)
    np.add.at(out, lo[inside], weight[inside])
    for i in np.flatnonzero(~inside):
        s, e, w = start[i], end[i], weight[i]
        span = e - s
        if span <= 0.0:                       # point charge at a seam
            out[lo[i]] += w
            continue
        for b in range(int(lo[i]), int(hi[i]) + 1):
            ov = min(e, edges[b + 1]) - max(s, edges[b])
            if ov > 0.0:
                out[b] += w * (ov / span)


# series keys every pool dict carries
SERIES_KEYS = ("watts", "joules", "decode_j", "prefill_j", "idle_j",
               "handoff_j", "dispatch_j", "tokens", "occupancy",
               "inflight", "queue_depth", "online")


def empty_series(n_bins: int) -> Dict[str, np.ndarray]:
    return {k: np.zeros(n_bins, np.float64) for k in SERIES_KEYS}


@dataclasses.dataclass
class MetricsTimeline:
    """Per-pool fleet series on a fixed sim-time grid [t0, t1]."""

    t0: float
    t1: float
    n_bins: int
    pools: Dict[str, Dict[str, np.ndarray]]
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def edges(self) -> np.ndarray:
        return np.linspace(self.t0, self.t1, self.n_bins + 1)

    @property
    def centers(self) -> np.ndarray:
        e = self.edges
        return 0.5 * (e[:-1] + e[1:])

    @property
    def bin_s(self) -> float:
        return (self.t1 - self.t0) / self.n_bins

    def fleet(self, key: str) -> np.ndarray:
        """Sum a series across pools (fleet-wide curve)."""
        out = np.zeros(self.n_bins, np.float64)
        for series in self.pools.values():
            out += series[key]
        return out

    def tok_per_watt(self, pool: Optional[str] = None) -> np.ndarray:
        """tok/W(t): per-bin decode tokens over per-bin total energy.
        Bins with no energy are NaN (no data, not zero efficiency)."""
        if pool is None:
            tok, j = self.fleet("tokens"), self.fleet("joules")
        else:
            tok, j = self.pools[pool]["tokens"], self.pools[pool]["joules"]
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(j > 0.0, tok / np.maximum(j, 1e-300), np.nan)

    def to_json(self) -> dict:
        """JSON-safe dict (schema `TIMELINE_SCHEMA_VERSION`)."""
        def col(a):
            return [None if not np.isfinite(v) else round(float(v), 6)
                    for v in a]
        return {
            "schema_version": TIMELINE_SCHEMA_VERSION,
            "t0": self.t0, "t1": self.t1, "n_bins": self.n_bins,
            "bin_s": self.bin_s,
            "meta": dict(self.meta),
            "pools": {
                name: {k: col(series[k]) for k in SERIES_KEYS}
                for name, series in self.pools.items()},
            "fleet": {
                "tokens": col(self.fleet("tokens")),
                "joules": col(self.fleet("joules")),
                "watts": col(self.fleet("watts")),
                "online": col(self.fleet("online")),
                "cum_tokens": col(np.cumsum(self.fleet("tokens"))),
                "cum_joules": col(np.cumsum(self.fleet("joules"))),
                "tok_per_watt": col(self.tok_per_watt()),
            },
        }


# --- Chrome trace-event builders ----------------------------------------
# https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU
# (the subset Perfetto's JSON importer understands).  `ts`/`dur` are in
# microseconds; pids map to pools, tids to instances.

_US = 1e6


def span_event(name: str, pid: int, tid: int, t0_s: float, dur_s: float,
               cat: str = "request", args: Optional[dict] = None) -> dict:
    ev = {"name": name, "cat": cat, "ph": "X", "pid": pid, "tid": tid,
          "ts": t0_s * _US, "dur": max(dur_s, 0.0) * _US}
    if args:
        ev["args"] = args
    return ev


def instant_event(name: str, pid: int, tid: int, t_s: float,
                  cat: str = "request",
                  args: Optional[dict] = None) -> dict:
    ev = {"name": name, "cat": cat, "ph": "i", "s": "t", "pid": pid,
          "tid": tid, "ts": t_s * _US}
    if args:
        ev["args"] = args
    return ev


def counter_event(name: str, pid: int, t_s: float, values: dict) -> dict:
    return {"name": name, "cat": "counter", "ph": "C", "pid": pid,
            "tid": 0, "ts": t_s * _US,
            "args": {k: float(v) for k, v in values.items()}}


def meta_event(pid: int, tid: int = 0, process_name: Optional[str] = None,
               thread_name: Optional[str] = None) -> dict:
    if process_name is not None:
        return {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": process_name}}
    return {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": thread_name or f"instance {tid}"}}


def chrome_trace_doc(events: List[dict],
                     meta: Optional[dict] = None) -> dict:
    """Wrap event dicts into the Perfetto-ingestable JSON document."""
    other = {"schema_version": TRACE_SCHEMA_VERSION}
    if meta:
        other.update(meta)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}
