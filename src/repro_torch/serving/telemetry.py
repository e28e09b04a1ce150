"""FleetScope recording layer: request-lifecycle + charge tracing.

`TraceRecorder` is the single sink every engine and meter emits through.
It is strictly opt-in: engines hold `trace = None` by default and every
hook is an `is not None` guard around reads of host ints and floats, so
with telemetry off every schedule and meter is bit-identical, and a traced
model-mode engine launches and synchronizes exactly what an untraced one
does.

Two channels, two cost classes:

* **events** — per-request lifecycle edges `(t, rid, kind, pool,
  instance)` appended by the engines' existing per-event paths (admit,
  first token, handoff, escalate, overflow, complete) and by FleetSim's
  router (arrive, route).  O(1) python tuples per request edge at both
  levels.  The *canonically ordered* stream (sorted by `(t, rid, kind)`:
  engines append in different global orders) is bit-identical between
  the scalar and SoA engines, and between a model-mode engine and an
  analytical replay of its schedule.
* **charges** (level="detail" only) — vectorized array-chunk appends
  from the `EnergyMeter`/`MeterBank` charge methods: one tuple per
  charge call carrying the *same* float64 energy values the meters
  accumulate.  Summing the channel therefore reconciles with the meter
  lifetime totals to float rounding (`reconcile_energy`).

`build_timeline` bins both channels onto a fixed sim-time grid
(`core.timeline.MetricsTimeline`); `to_perfetto` renders events as one
Perfetto track per pool/instance with power/occupancy counter tracks.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..core.timeline import (
    EV_ADMIT, EV_ARRIVE, EV_ESCALATE, EV_FIRST_TOKEN, EV_OVERFLOW,
    EV_PREFILL, EV_ROUTE, EVENT_NAMES, LIFECYCLE_KINDS, MetricsTimeline,
    bin_intervals, chrome_trace_doc, counter_event, empty_series,
    instant_event, meta_event, span_event)

__all__ = ["TraceRecorder", "build_timeline", "to_perfetto",
           "phase_totals", "reconcile_energy"]


def _chunk_total(ref, val) -> float:
    """Total deposited by one charge chunk: scalar values replicate
    across the rows they were applied to (numpy fancy-index `+= e`
    broadcasts), arrays sum directly."""
    v = np.asarray(val, np.float64)
    if v.ndim == 0:
        r = np.asarray(ref, np.float64)
        return float(v) * (r.size if r.ndim else 1)
    return float(v.sum())


class TraceRecorder:
    """Append-only event/charge sink shared by every engine of a run.

    level="lifecycle": per-request edges only (cheap enough to ride the
    full quick bench inside the 1.5x wall budget).
    level="detail": adds admit/prefill-chunk events plus the vectorized
    charge and occupancy channels that power `build_timeline`,
    per-phase energy reconciliation, and the Perfetto counter tracks.
    """

    __slots__ = ("level", "detail", "events", "charges", "occupancy",
                 "pool_names", "_pool_ids", "pool_instances")

    def __init__(self, level: str = "lifecycle"):
        if level not in ("lifecycle", "detail"):
            raise ValueError(f"unknown trace level {level!r} "
                             "(expected 'lifecycle' or 'detail')")
        self.level = level
        self.detail = level == "detail"
        # (t, rid, kind, pool_id, instance) — tuple order IS the
        # canonical sort key prefix
        self.events: List[Tuple[float, int, int, int, int]] = []
        # (pool_id, phase, instance_rows, start, dur, joules, tokens,
        #  dispatch) — scalars or row-aligned arrays, appended verbatim
        self.charges: list = []
        # (pool_id, instance_rows, start, dur, n_occupied)
        self.occupancy: list = []
        self.pool_names: List[str] = []
        self._pool_ids: Dict[str, int] = {}
        self.pool_instances: Dict[int, int] = {}

    # --- recording ------------------------------------------------------

    def pool_id(self, name: str, instances: Optional[int] = None) -> int:
        pid = self._pool_ids.get(name)
        if pid is None:
            pid = self._pool_ids[name] = len(self.pool_names)
            self.pool_names.append(name)
        if instances is not None:
            self.pool_instances[pid] = int(instances)
        return pid

    def event(self, kind: int, rid: int, pool: int, instance: int,
              t: float) -> None:
        self.events.append((t, rid, kind, pool, instance))

    def charge(self, pool: int, phase: str, instance, start, dur, joules,
               tokens=None, dispatch=None) -> None:
        self.charges.append((pool, phase, instance, start, dur, joules,
                             tokens, dispatch))

    def occupancy_sample(self, pool: int, instance, start, dur,
                         n_occupied) -> None:
        self.occupancy.append((pool, instance, start, dur, n_occupied))

    # --- views ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.events)

    def sorted_events(self, lifecycle_only: bool = False) \
            -> List[Tuple[float, int, int, int, int]]:
        """Events in canonical `(t, rid, kind)` order.  Engines append
        in different global orders (scalar per-instance loops, SoA
        lockstep); event *times* are bit-identical between them, so this
        order is their cross-engine golden stream."""
        evs = self.events
        if lifecycle_only:
            evs = [e for e in evs if e[2] in LIFECYCLE_KINDS]
        return sorted(evs)

    def golden_stream(self) -> List[Tuple[float, int, str, str, int]]:
        """Canonical lifecycle stream with names resolved — the unit the
        cross-engine parity tests compare."""
        return [(t, rid, EVENT_NAMES[kind], self.pool_names[pool], inst)
                for t, rid, kind, pool, inst
                in self.sorted_events(lifecycle_only=True)]

    def counts(self) -> Dict[str, int]:
        out = {name: 0 for name in EVENT_NAMES}
        for _, _, kind, _, _ in self.events:
            out[EVENT_NAMES[kind]] += 1
        return out

    def energy_by_phase(self, pool: Optional[int] = None) \
            -> Dict[str, float]:
        """Per-phase joules summed from the charge channel (lifetime,
        i.e. comparable to the meters' un-windowed totals).  `dispatch`
        is the MoE all-to-all share *inside* decode, never additive."""
        out = {"decode": 0.0, "prefill": 0.0, "idle": 0.0,
               "handoff": 0.0, "dispatch": 0.0, "total": 0.0}
        for p, phase, _, start, _, joules, _, dispatch in self.charges:
            if pool is not None and p != pool:
                continue
            e = _chunk_total(start, joules)
            out[phase] += e
            out["total"] += e
            if dispatch is not None:
                out["dispatch"] += _chunk_total(start, dispatch)
        return out


# --- meter-side totals + reconciliation ---------------------------------

def phase_totals(meters: Iterable) -> Dict[str, float]:
    """Lifetime per-phase joules summed over `EnergyMeter`/`MeterBank`
    objects.  Decode is the residual by construction (serving.energy
    keeps no separate decode accumulator): decode = total - prefill -
    idle - handoff; dispatch rides inside decode."""
    tot = {"total": 0.0, "prefill": 0.0, "idle": 0.0, "handoff": 0.0,
           "dispatch": 0.0}
    for m in meters:
        tot["total"] += float(np.sum(m.joules))
        tot["prefill"] += float(np.sum(m.prefill_joules))
        tot["idle"] += float(np.sum(m.idle_joules))
        tot["handoff"] += float(np.sum(m.handoff_joules))
        tot["dispatch"] += float(np.sum(m.dispatch_joules))
    tot["decode"] = (tot["total"] - tot["prefill"] - tot["idle"]
                     - tot["handoff"])
    return tot


def reconcile_energy(rec: TraceRecorder, meters: Iterable) \
        -> Dict[str, dict]:
    """Per-phase {trace, meter, rel_err} comparing the charge channel
    against the meters' lifetime totals.  The hooks record the *same*
    float64 values the meters accumulate, so rel_err is float-rounding
    small."""
    trace = rec.energy_by_phase()
    meter = phase_totals(meters)
    out = {}
    for phase in ("total", "decode", "prefill", "idle", "handoff",
                  "dispatch"):
        t, m = trace[phase], meter[phase]
        denom = max(abs(m), 1e-12)
        out[phase] = {"trace_j": t, "meter_j": m,
                      "rel_err": abs(t - m) / denom if (t or m) else 0.0}
    return out


# --- timeline construction ----------------------------------------------

_PHASE_SERIES = {"decode": "decode_j", "prefill": "prefill_j",
                 "idle": "idle_j", "handoff": "handoff_j"}


def build_timeline(rec: TraceRecorder, *, t0: float = 0.0,
                   t1: Optional[float] = None, n_bins: int = 96,
                   schedules: Optional[dict] = None) -> MetricsTimeline:
    """Bin both recorder channels onto a fixed [t0, t1] grid.

    `schedules` maps pool name -> `serving.autoscale.InstanceSchedule`;
    pools without one get their registered static instance count as a
    flat online curve.  Queue depth needs the detail-level ADMIT events
    (route enqueues, admit dequeues) — without them the series stays
    zero rather than counting a queue that never drains.
    """
    if t1 is None:
        t1 = t0
        for _, _, _, start, dur, _, _, _ in rec.charges:
            s = np.asarray(start, np.float64)
            d = np.asarray(dur, np.float64)
            if s.size:
                t1 = max(t1, float(np.max(s + d)))
        for t, _, _, _, _ in rec.events:
            t1 = max(t1, t)
        if t1 <= t0:
            t1 = t0 + 1.0
    edges = np.linspace(t0, t1, n_bins + 1)
    bin_s = (t1 - t0) / n_bins
    pools = {name: empty_series(n_bins) for name in rec.pool_names}
    by_id = [pools[name] for name in rec.pool_names]

    for pid, phase, _, start, dur, joules, tokens, dispatch \
            in rec.charges:
        s = by_id[pid]
        bin_intervals(start, dur, joules, edges, s[_PHASE_SERIES[phase]])
        bin_intervals(start, dur, joules, edges, s["joules"])
        if phase == "decode":
            if tokens is not None:
                tok = np.asarray(tokens, np.float64)
                bin_intervals(start, dur, tok, edges, s["tokens"])
                # decoding-population seconds -> mean in-flight per bin
                bin_intervals(start, dur,
                              tok * np.asarray(dur, np.float64),
                              edges, s["inflight"])
            if dispatch is not None:
                bin_intervals(start, dur, dispatch, edges,
                              s["dispatch_j"])

    for pid, _, start, dur, n_occ in rec.occupancy:
        d = np.asarray(dur, np.float64)
        bin_intervals(start, dur, np.asarray(n_occ, np.float64) * d,
                      edges, by_id[pid]["occupancy"])

    # queue depth as a step function sampled at bin centers:
    # ROUTE enqueues (+1), ADMIT dequeues (-1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    routes: Dict[int, list] = {}
    admits: Dict[int, list] = {}
    for t, _, kind, pid, _ in rec.events:
        if kind == EV_ROUTE:
            routes.setdefault(pid, []).append(t)
        elif kind == EV_ADMIT:
            admits.setdefault(pid, []).append(t)
    for pid, rts in routes.items():
        ads = admits.get(pid)
        if not ads:
            continue        # lifecycle level: no dequeue edge recorded
        r = np.sort(np.asarray(rts))
        a = np.sort(np.asarray(ads))
        by_id[pid]["queue_depth"][:] = (
            np.searchsorted(r, centers, side="right")
            - np.searchsorted(a, centers, side="right"))

    for pid, name in enumerate(rec.pool_names):
        sched = (schedules or {}).get(name)
        if sched is not None:
            by_id[pid]["online"][:] = sched.online_at(centers)
        else:
            by_id[pid]["online"][:] = rec.pool_instances.get(pid, 0)
        s = by_id[pid]
        s["watts"] = s["joules"] / bin_s
        s["occupancy"] = s["occupancy"] / bin_s
        s["inflight"] = s["inflight"] / bin_s

    return MetricsTimeline(
        t0=float(t0), t1=float(t1), n_bins=n_bins, pools=pools,
        meta={"level": rec.level, "n_events": len(rec.events),
              "n_charge_chunks": len(rec.charges)})


# --- Perfetto export ----------------------------------------------------

def to_perfetto(rec: TraceRecorder, *, schedules: Optional[dict] = None,
                counter_bins: int = 240) -> dict:
    """Chrome trace-event document: one process per pool, one thread per
    instance, an "X" slice per request visit (queue->terminal) with the
    full edge list in its args, instants for first-token/evictions, and
    per-pool power/occupancy counter tracks when the detail charge
    channel is present.  Load the JSON straight into ui.perfetto.dev."""
    evs: List[dict] = []
    for pid, name in enumerate(rec.pool_names):
        evs.append(meta_event(pid, process_name=name))
    tids_seen = set()

    visits: Dict[Tuple[int, int], list] = {}
    for t, rid, kind, pid, inst in rec.events:
        visits.setdefault((rid, pid), []).append((t, kind, inst))
    for (rid, pid), items in sorted(visits.items()):
        items.sort()
        tid = max(max(i for _, _, i in items), 0)
        tids_seen.add((pid, tid))
        t_first, t_last = items[0][0], items[-1][0]
        kinds = {k for _, k, _ in items}
        if kinds <= {EV_ARRIVE}:     # fleet-track arrival marker
            evs.append(instant_event("arrive", pid, tid, t_first))
            continue
        evs.append(span_event(
            f"r{rid}", pid, tid, t_first, t_last - t_first,
            args={"events": [[EVENT_NAMES[k], round(t, 6)]
                             for t, k, _ in items]}))
        for t, k, _ in items:
            if k in (EV_FIRST_TOKEN, EV_ESCALATE, EV_OVERFLOW):
                evs.append(instant_event(EVENT_NAMES[k], pid, tid, t))
    for pid, tid in sorted(tids_seen):
        evs.append(meta_event(pid, tid=tid,
                              thread_name=f"instance {tid}"))

    if rec.charges or rec.occupancy:
        tl = build_timeline(rec, n_bins=counter_bins,
                            schedules=schedules)
        edges = tl.edges
        for name, series in tl.pools.items():
            pid = rec._pool_ids[name]
            if not (series["joules"].any() or series["occupancy"].any()):
                continue
            for b in range(tl.n_bins):
                evs.append(counter_event(
                    f"{name} power (W)", pid, edges[b],
                    {"watts": series["watts"][b]}))
                evs.append(counter_event(
                    f"{name} occupancy", pid, edges[b],
                    {"slots": series["occupancy"][b],
                     "inflight": series["inflight"][b]}))

    return chrome_trace_doc(evs, meta={"level": rec.level,
                                       "pools": list(rec.pool_names)})
