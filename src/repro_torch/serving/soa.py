"""Structure-of-arrays pool engine: a whole provisioned pool in lockstep.

`PoolEngine` (serving.engine) simulates ONE instance with slot-batched
numpy arrays; an SLO-sized fleet pool is 20-100+ instances, and stepping
them in per-engine Python loops made the Python interpreter — not the
simulation — the bottleneck (each ~15-numpy-op step costs ~170 us on
arrays of 5-256 slots).  `BatchedPoolEngine` extends those slot arrays
with an **instance axis**: all `instances x n_slots` slots of a pool live
in one set of (I, S) arrays, and one global step advances *every* busy
instance by one continuous-batching iteration.  Instances are mutually
independent (cross-instance flow exists only between pools, handled by
FleetSim after a pool drains), so lockstep stepping replays exactly the
per-instance event sequences the scalar engines would have produced — the
clocks simply diverge per row, carried in a `MeterBank` row per instance.

Parity contract (the reference's SoA parity suite, mirrored for the port
in tests/test_torch_fleetsim.py): for any
request stream, the batched engine reproduces the scalar `PoolEngine`
semantics *bit-for-bit* per instance — admission order, chunked-prefill
interleave, window-ceiling eviction, escalation detection and backout,
prefill-phase FIFO draining, and every meter counter.  The vectorized
arithmetic in `MeterBank` evaluates the same float64 expressions in the
same order as `EnergyMeter`, so this is an equality, not a tolerance.

Hot-path structure per global step (decode phase):

  * idle-skip, admission gating, decode charge, token/position advance,
    completion/escalation/ceiling masks: vectorized over (I, S);
  * per-*event* work (a request finishing, evicting, escalating, or
    draining its last prefill chunk) stays in Python — events are O(one
    per request), not O(steps);
  * the chunked-prefill drain takes a vectorized fast path for the
    overwhelmingly common case (the row's first pending slot absorbs the
    whole chunk budget without draining) and falls back to the scalar
    loop otherwise.

Analytical mode only: model-mode serving keeps the scalar `PoolEngine`,
which remains the reference implementation.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.fleet import PREFILL_MFU
from ..core.profiles import BaseProfile
from ..core.timeline import (EV_ADMIT, EV_COMPLETE, EV_ESCALATE,
                             EV_FIRST_TOKEN, EV_HANDOFF, EV_OVERFLOW,
                             EV_PREFILL)

from .energy import MeterBank
from .engine import (_LCG_A, _LCG_C, _NEVER, DrainTruncatedError,
                     resolve_prefill_chunk)
from .request import Request


class BatchedPoolEngine:
    """All `instances` replicas of one pool as (instances, n_slots) SoA."""

    def __init__(self, *, instances: int, window: int,
                 profile: BaseProfile, n_slots: Optional[int] = None,
                 name: str = "pool", rng_seed: int = 0,
                 seed_stride: int = 7919,
                 prefill_chunk: Optional[int] = None,
                 evict_on_overflow: bool = False,
                 respect_arrival: bool = False,
                 streamed_params: Optional[float] = None,
                 vocab: int = 32000, phase: str = "decode",
                 prefill_mfu: Optional[float] = None,
                 dispatch_ms: float = 0.0):
        if instances < 1:
            raise ValueError("need at least one instance")
        if streamed_params is None:
            raise ValueError("analytical mode needs streamed_params")
        if phase not in ("decode", "prefill"):
            raise ValueError(f"unknown engine phase {phase!r}")
        self.instances = instances
        self.window = window
        self.name = name
        self.profile = profile
        self.n_slots = n_slots if n_slots is not None \
            else max(profile.n_max(window), 1)
        self.phase = phase
        self.prefill_chunk = resolve_prefill_chunk(profile, prefill_chunk,
                                                   phase)
        self.prefill_mfu = PREFILL_MFU if prefill_mfu is None else prefill_mfu
        self.evict_on_overflow = evict_on_overflow
        self.respect_arrival = respect_arrival
        self.vocab = vocab
        self._streamed_params = float(streamed_params)
        self.dispatch_ms = dispatch_ms
        I, S = instances, self.n_slots
        self.bank = MeterBank(profile, I)
        self.bank.dispatch_s = max(dispatch_ms, 0.0) * 1e-3
        # per-(instance, slot) state — the scalar engine's arrays + 1 axis
        self.pos = np.zeros((I, S), np.int32)
        self.tokens = np.zeros((I, S), np.int64)
        self.gen_count = np.zeros((I, S), np.int32)
        self.m_gen = np.zeros((I, S), np.int32)
        self.max_new = np.zeros((I, S), np.int32)
        self.prefill_left = np.zeros((I, S), np.int64)
        self.escalate_at = np.full((I, S), _NEVER, np.int32)
        self.ready_ts = np.zeros((I, S), np.float64)  # prefill-phase FIFO
        self._active = np.zeros((I, S), bool)
        self.slots: List[List[Optional[Request]]] = \
            [[None] * S for _ in range(I)]
        # per-instance state
        self.seeds = np.int64(rng_seed) \
            + np.int64(seed_stride) * np.arange(I, dtype=np.int64)
        self.queues: List[List[Request]] = [[] for _ in range(I)]
        self.preempted = np.zeros(I, np.int64)
        self.n_escalated = np.zeros(I, np.int64)
        self.slot_seconds = np.zeros(I, np.float64)
        # steady-state-windowed occupancy integral (pro-rated by overlap
        # with the bank's measurement window, like the m_* counters) —
        # the SLO loop's HOL calibration reads populations from this so
        # ramp-in/drain transients don't deflate the measurement
        self.m_slot_seconds = np.zeros(I, np.float64)
        self.completed: List[List[Request]] = [[] for _ in range(I)]
        self.overflowed: List[List[Request]] = [[] for _ in range(I)]
        self.escalated: List[List[Request]] = [[] for _ in range(I)]
        self.handoff: List[List[Request]] = [[] for _ in range(I)]
        self.relayed: List[List[Request]] = [[] for _ in range(I)]
        # autoscaling (serving.autoscale): per-row online windows.  None
        # (the default) means every row is online for the whole run —
        # the exact pre-autoscale behaviour, down to the float ops.
        self.online_from: Optional[np.ndarray] = None
        self.online_until: Optional[np.ndarray] = None
        # admission bookkeeping, built by _freeze() at run start
        self.qpos = np.zeros(I, np.int64)
        self.qlen = np.zeros(I, np.int64)
        self.head_ready = np.full(I, np.inf)
        self.min_ready = np.full(I, np.inf)
        self._ready_arr: List[np.ndarray] = [np.empty(0)] * I
        self._sufmin: List[np.ndarray] = [np.empty(0)] * I
        # FleetScope sink (serving.telemetry.TraceRecorder): None =
        # telemetry off; every hook is an `is not None` guard around
        # pure reads, so disabled runs are bit-identical
        self.trace = None
        self._trace_pool = 0

    def attach_trace(self, recorder, *,
                     name: Optional[str] = None) -> None:
        """Opt the pool into FleetScope tracing.  Lifecycle events ride
        the per-event Python paths (O(1) per request edge); the
        vectorized charge/occupancy channels are wired only at
        level="detail" so lifecycle tracing never touches the hot
        array path."""
        self.trace = recorder
        self._trace_pool = recorder.pool_id(name or self.name,
                                            instances=self.instances)
        self.bank.trace = recorder if recorder.detail else None
        self.bank.trace_pool = self._trace_pool

    # --- submission -----------------------------------------------------

    @staticmethod
    def _ready(req: Request) -> float:
        return req.ready_time if req.ready_time is not None \
            else req.arrival_time

    def submit(self, req: Request, instance: int) -> None:
        req.pool = f"{self.name}#{instance}"
        self.queues[instance].append(req)

    def set_online_windows(self, online_from, online_until, *,
                           load_s: float = 0.0) -> None:
        """Configure per-row `[online_from, online_until)` availability
        (serving.autoscale).  Each row's clock starts at its online time
        — the hours before a scale-up incarnation exists are simply
        never simulated, so no idle accrues for them — and every live
        late-start row is charged `load_s` of weight-streaming idle draw
        ending exactly at its online instant.  Call after the bank's
        measurement window is set (the load charge pro-rates against
        it) and before any submission."""
        self.online_from = np.asarray(online_from, np.float64)
        self.online_until = np.asarray(online_until, np.float64)
        if self.online_from.shape != (self.instances,) \
                or self.online_until.shape != (self.instances,):
            raise ValueError("online windows must be (instances,) arrays")
        self.bank.sim_time_s[:] = np.maximum(self.online_from, 0.0)
        live = (self.online_from > 0) \
            & (self.online_until > self.online_from)
        if load_s > 0 and live.any():
            rows = np.flatnonzero(live)
            self.bank.sim_time_s[rows] = self.online_from[rows] - load_s
            self.bank.charge_idle_rows(rows, np.full(rows.size, load_s))

    def sort_queues(self) -> None:
        """Stable time-sort every instance queue (head-gated admission) —
        the batched twin of FleetSim's per-engine inbox re-sort."""
        for q in self.queues:
            q.sort(key=self._ready)

    def _freeze(self) -> None:
        """Queues are static once the pool runs (all routing and inbox
        injection happen first): precompute per-row ready arrays and
        suffix minima so head gating and idle-skip are O(1) lookups."""
        for i, q in enumerate(self.queues):
            r = np.array([self._ready(x) for x in q], np.float64)
            self._ready_arr[i] = r
            self._sufmin[i] = np.minimum.accumulate(r[::-1])[::-1] \
                if len(r) else r
            self.qlen[i] = len(q)
        self.qpos[:] = 0
        self._refresh_heads(np.arange(self.instances))

    def _refresh_heads(self, rows) -> None:
        for i in np.atleast_1d(rows):
            k = int(self.qpos[i])
            if k < self.qlen[i]:
                self.head_ready[i] = self._ready_arr[i][k]
                self.min_ready[i] = self._sufmin[i][k]
            else:
                self.head_ready[i] = self.min_ready[i] = np.inf

    # --- admission ------------------------------------------------------

    def _admit_all(self) -> None:
        gate = (self.qpos < self.qlen) & ~self._active.all(axis=1)
        if self.respect_arrival:
            gate &= self.head_ready <= self.bank.sim_time_s
        if not gate.any():
            return
        for i in np.flatnonzero(gate):
            self._admit_row(int(i))

    def _admit_row(self, i: int) -> None:
        q = self.queues[i]
        while self.qpos[i] < self.qlen[i]:
            inactive = np.flatnonzero(~self._active[i])
            if not inactive.size:
                break
            req = q[int(self.qpos[i])]
            if self.respect_arrival \
                    and self._ready(req) > self.bank.sim_time_s[i]:
                break
            self.qpos[i] += 1
            s = int(inactive[0])
            plen = req.prompt_len
            if self.trace is not None and self.trace.detail:
                self.trace.event(EV_ADMIT, req.rid, self._trace_pool, i,
                                 float(self.bank.sim_time_s[i]))
            self.slots[i][s] = req
            self._active[i, s] = True
            self.pos[i, s] = plen
            self.max_new[i, s] = req.max_new_tokens
            self.ready_ts[i, s] = self._ready(req)
            if req.prefill_done:
                # disagg decode pool: prompt drained upstream, KV arrived
                # over the interconnect — no prefill work or charge here
                self.prefill_left[i, s] = 0
                self.gen_count[i, s] = 1
                self.escalate_at[i, s] = req.escalate_at \
                    if req.escalate_at is not None else _NEVER
                self.tokens[i, s] = int(req.generated[0]) if req.generated \
                    else int((np.int64(req.rid) * _LCG_A + self.seeds[i]
                              + _LCG_C) % self.vocab)
                continue
            first_tok = int((np.int64(req.rid) * _LCG_A + self.seeds[i]
                             + _LCG_C) % self.vocab)
            self.escalate_at[i, s] = req.escalate_at \
                if req.escalate_at is not None else _NEVER
            if self.prefill_chunk:
                self.prefill_left[i, s] = plen
                self.gen_count[i, s] = 0
                self.tokens[i, s] = first_tok
                req.generated = []
            else:
                self.bank.charge_prefill_one(
                    i, plen, mfu=self.prefill_mfu,
                    streamed_params=self._streamed_params)
                self.prefill_left[i, s] = 0
                self.gen_count[i, s] = 1
                self.tokens[i, s] = first_tok
                req.generated = [first_tok]
                req.n_generated = 1
                req.first_token_time = float(self.bank.sim_time_s[i])
                if self.trace is not None:
                    self.trace.event(EV_FIRST_TOKEN, req.rid,
                                     self._trace_pool, i,
                                     req.first_token_time)
        self._refresh_heads(i)

    # --- per-event bookkeeping (Python: O(1) per request lifetime) ------

    def _clear_slot(self, i: int, s: int) -> None:
        self.slots[i][s] = None
        self._active[i, s] = False
        self.prefill_left[i, s] = 0
        self.gen_count[i, s] = 0
        self.m_gen[i, s] = 0
        self.escalate_at[i, s] = _NEVER

    def _finish(self, i: int, s: int) -> None:
        req = self.slots[i][s]
        req.n_generated = int(self.gen_count[i, s])
        req.generated = None          # analytical mode: ids are synthetic
        req.finish_time = float(self.bank.sim_time_s[i])
        if self.trace is not None:
            self.trace.event(EV_COMPLETE, req.rid, self._trace_pool, i,
                             req.finish_time)
        self.completed[i].append(req)
        self._clear_slot(i, s)

    def _back_out_and_evict(self, i: int, s: int) -> Request:
        req = self.slots[i][s]
        self.bank.tokens[i] -= max(int(self.gen_count[i, s]) - 1, 0)
        self.bank.m_tokens[i] -= int(self.m_gen[i, s])
        req.generated = None
        req.prefill_done = False
        req.preemptions += 1
        req.ready_time = float(self.bank.sim_time_s[i])
        req.escalate_at = None
        self._clear_slot(i, s)
        self.preempted[i] += 1
        return req

    def _evict_overflow(self, i: int, s: int) -> None:
        req = self._back_out_and_evict(i, s)
        if self.trace is not None:
            self.trace.event(EV_OVERFLOW, req.rid, self._trace_pool, i,
                             req.ready_time)
        self.overflowed[i].append(req)

    def _evict_escalation(self, i: int, s: int) -> None:
        req = self._back_out_and_evict(i, s)
        req.escalations += 1
        self.n_escalated[i] += 1
        if self.trace is not None:
            self.trace.event(EV_ESCALATE, req.rid, self._trace_pool, i,
                             req.ready_time)
        self.escalated[i].append(req)

    def _finish_prefill(self, i: int, s: int) -> None:
        req = self.slots[i][s]
        t = float(self.bank.sim_time_s[i])
        req.n_generated = 1
        req.generated = [int(self.tokens[i, s])]
        req.first_token_time = t
        req.prefill_done = True
        req.ready_time = t
        if self.trace is not None:
            self.trace.event(EV_FIRST_TOKEN, req.rid, self._trace_pool,
                             i, req.first_token_time)
            self.trace.event(EV_HANDOFF, req.rid, self._trace_pool, i,
                             req.ready_time)
        self.handoff[i].append(req)
        self.relayed[i].append(req)
        self._clear_slot(i, s)

    # --- the lockstep step ----------------------------------------------

    def _step_all(self) -> bool:
        active_any = self._active.any(axis=1)
        has_q = self.qpos < self.qlen
        alive = active_any | has_q
        if not alive.any():
            return False
        if self.respect_arrival:
            # event-driven idle skip: rows with nothing in flight jump to
            # their queue's next arrival (idle power accrues over the gap)
            idle = ~active_any & has_q
            if idle.any():
                rows = np.flatnonzero(idle)
                dt = self.min_ready[rows] - self.bank.sim_time_s[rows]
                fwd = dt > 0
                if fwd.any():
                    self.bank.charge_idle_rows(rows[fwd], dt[fwd])
        t_start = self.bank.sim_time_s.copy()
        self._admit_all()
        if self.phase == "prefill":
            self._step_prefill_rows(t_start)
            return True
        n_occ = self._active.sum(axis=1)
        dec = self._active & (self.prefill_left == 0)
        n_dec = dec.sum(axis=1)
        drows = np.flatnonzero(n_dec > 0)
        tau_full = np.zeros(self.instances)
        if drows.size:
            toks = self.tokens[drows]
            nxt = (toks * _LCG_A + _LCG_C + self.seeds[drows, None]) \
                % self.vocab
            d = dec[drows]
            nd = n_dec[drows]
            mean_ctx = (self.pos[drows] * d).sum(axis=1, dtype=np.int64) \
                / nd
            tau = self.bank.charge_decode_rows(drows, nd.astype(np.int64),
                                               mean_ctx)
            tau_full[drows] = tau
            in_win = self.bank.last_charge_in_window[drows]
            self.m_gen[drows] += d & in_win[:, None]
            self.tokens[drows] = np.where(d, nxt, toks)
            self.gen_count[drows] += d
            self.pos[drows] += d
            gc = self.gen_count[drows]
            done = d & (gc >= self.max_new[drows])
            escalate = d & ~done & (gc >= self.escalate_at[drows])
            at_ceiling = d & ~done & ~escalate \
                & (self.pos[drows] >= self.window - 1)
            if not self.evict_on_overflow:
                done = done | at_ceiling
            if done.any():
                for r, s in np.argwhere(done):
                    self._finish(int(drows[r]), int(s))
            if escalate.any():
                for r, s in np.argwhere(escalate):
                    self._evict_escalation(int(drows[r]), int(s))
            if self.evict_on_overflow and at_ceiling.any():
                for r, s in np.argwhere(at_ceiling):
                    self._evict_overflow(int(drows[r]), int(s))
        if self.prefill_chunk:
            self._drain_chunks(tau_full)
        self._accrue_occupancy(n_occ, t_start)
        return True

    def _accrue_occupancy(self, n_occ: np.ndarray,
                          t_start: np.ndarray) -> None:
        b = self.bank
        self.slot_seconds += n_occ * (b.sim_time_s - t_start)
        overlap = np.maximum(
            0.0, np.minimum(b.measure_t1, b.sim_time_s)
            - np.maximum(b.measure_t0, t_start))
        self.m_slot_seconds += n_occ * overlap
        if self.trace is not None and self.trace.detail:
            dt = b.sim_time_s - t_start
            live = dt > 0
            if live.any():
                rows = np.flatnonzero(live)
                self.trace.occupancy_sample(self._trace_pool, rows,
                                            t_start[rows], dt[rows],
                                            n_occ[rows])

    def _drain_chunks(self, tau_full: np.ndarray) -> None:
        """Chunked-prefill interleave across all rows.  Fast path: the
        row's first pending slot (lowest index, as in the scalar drain)
        absorbs the whole budget without draining — one vectorized charge
        riding that row's decode tau.  Anything else (a slot completes, or
        budget spills to the next slot) replays the scalar loop."""
        chunk = self.prefill_chunk
        pend = self._active & (self.prefill_left > 0)
        rows = np.flatnonzero(pend.any(axis=1))
        if not rows.size:
            return
        first = np.argmax(pend[rows], axis=1)
        pl = self.prefill_left[rows, first]
        fast = pl > chunk
        frows = rows[fast]
        if frows.size:
            if self.trace is not None and self.trace.detail:
                fslots = first[fast]
                for k, i in enumerate(frows):
                    self.trace.event(
                        EV_PREFILL, self.slots[int(i)][int(fslots[k])].rid,
                        self._trace_pool, int(i),
                        float(self.bank.sim_time_s[i]))
            self.bank.charge_prefill_rows(
                frows, np.full(frows.size, chunk, np.int64),
                mfu=self.prefill_mfu, streamed_params=self._streamed_params,
                overlap_s=tau_full[frows])
            self.prefill_left[frows, first[fast]] -= chunk
        for i in rows[~fast]:
            i = int(i)
            budget = chunk
            overlap = float(tau_full[i])
            for s in np.flatnonzero(pend[i]):
                if budget <= 0:
                    break
                s = int(s)
                take = int(min(budget, self.prefill_left[i, s]))
                if self.trace is not None and self.trace.detail:
                    self.trace.event(EV_PREFILL, self.slots[i][s].rid,
                                     self._trace_pool, i,
                                     float(self.bank.sim_time_s[i]))
                self.bank.charge_prefill_one(
                    i, take, mfu=self.prefill_mfu,
                    streamed_params=self._streamed_params,
                    overlap_s=overlap)
                overlap = 0.0         # one chunk rides each decode pass
                self.prefill_left[i, s] -= take
                budget -= take
                if self.prefill_left[i, s] == 0:
                    req = self.slots[i][s]
                    self.gen_count[i, s] = 1
                    req.generated = [int(self.tokens[i, s])]
                    req.n_generated = 1
                    req.first_token_time = float(self.bank.sim_time_s[i])
                    if self.trace is not None:
                        self.trace.event(EV_FIRST_TOKEN, req.rid,
                                         self._trace_pool, i,
                                         req.first_token_time)

    def _step_prefill_rows(self, t_start: np.ndarray) -> None:
        """Prefill-phase lockstep: each busy row drains up to one chunk
        budget across its occupied slots, oldest request first (the
        scalar engine's FIFO over slot recycling).  Fast path: the
        oldest pending slot alone absorbs the budget."""
        chunk = self.prefill_chunk
        n_occ = self._active.sum(axis=1)
        pend = self._active & (self.prefill_left > 0)
        rows = np.flatnonzero(pend.any(axis=1))
        if rows.size:
            rts = np.where(pend[rows], self.ready_ts[rows], np.inf)
            first = np.argmin(rts, axis=1)    # oldest; ties -> lowest slot
            pl = self.prefill_left[rows, first]
            fast = pl > chunk
            frows = rows[fast]
            if frows.size:
                if self.trace is not None and self.trace.detail:
                    fslots = first[fast]
                    for k, i in enumerate(frows):
                        self.trace.event(
                            EV_PREFILL,
                            self.slots[int(i)][int(fslots[k])].rid,
                            self._trace_pool, int(i),
                            float(self.bank.sim_time_s[i]))
                self.bank.charge_prefill_rows(
                    frows, np.full(frows.size, chunk, np.int64),
                    mfu=self.prefill_mfu,
                    streamed_params=self._streamed_params,
                    overlap_s=np.zeros(frows.size))
                self.prefill_left[frows, first[fast]] -= chunk
            for i in rows[~fast]:
                i = int(i)
                budget = chunk
                order = np.flatnonzero(pend[i])
                order = order[np.argsort(self.ready_ts[i, order],
                                         kind="stable")]
                for s in order:
                    if budget <= 0:
                        break
                    s = int(s)
                    take = int(min(budget, self.prefill_left[i, s]))
                    if self.trace is not None and self.trace.detail:
                        self.trace.event(EV_PREFILL, self.slots[i][s].rid,
                                         self._trace_pool, i,
                                         float(self.bank.sim_time_s[i]))
                    self.bank.charge_prefill_one(
                        i, take, mfu=self.prefill_mfu,
                        streamed_params=self._streamed_params)
                    self.prefill_left[i, s] -= take
                    budget -= take
                    if self.prefill_left[i, s] == 0:
                        self._finish_prefill(i, s)
        self._accrue_occupancy(n_occ, t_start)

    # --- drive ----------------------------------------------------------

    def run_until_drained(self, max_iters: int = 100_000) -> None:
        self._freeze()
        it = 0
        while it < max_iters:
            if not self._step_all():
                break
            it += 1
        if self.busy:
            qleft = sum(len(q) - int(p)
                        for q, p in zip(self.queues, self.qpos))
            raise DrainTruncatedError(
                self.name, max_iters,
                f"{qleft} queued, {int(self._active.sum())} in flight")

    # --- aggregates -----------------------------------------------------

    @property
    def busy(self) -> bool:
        return bool(self._active.any()
                    or any(self.qpos[i] < len(self.queues[i])
                           for i in range(self.instances)))

    def occupancy(self) -> np.ndarray:
        denom = self.n_slots * self.bank.sim_time_s
        return np.divide(self.slot_seconds, denom,
                         out=np.zeros(self.instances), where=denom > 0)
