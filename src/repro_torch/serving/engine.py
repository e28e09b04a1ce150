"""Continuous-batching decode engine.

One `PoolEngine` is one "instance" in the paper's terms: a model replica
serving one context window.  It owns:

  * a slotted KV/state cache slab of exactly `n_slots` sequences — Eq. 3's
    concurrency ceiling enforced as the scheduler's admission limit; one
    (n_repeat, n_slots, T, K, hd) K and V tensor per attention block and
    the O(1) state of each recurrent block, updated in place (the
    reference returns new JAX arrays from every step instead);
  * a decode step over all slots (inactive slots compute masked garbage, as
    real continuous-batching engines do);
  * an EnergyMeter charging every iteration P(b) * tau.

The engine runs in one of two modes:

  model mode      — cfg/params given: real prefill + decode over the slab
                    on the device the params live on; token streams are
                    exact greedy generations.
  analytical mode — cfg=None: no neural net, no tensor and no device;
                    token ids come from a deterministic LCG stream and only
                    the scheduler and the EnergyMeter run.

And (orthogonally) serves one of two phases:

  decode phase  — the default: continuous-batching token generation with
                  (optionally chunked) prefill riding the decode passes.
  prefill phase — `phase="prefill"`: a dedicated compute-bound chunk
                  processor.  No decode iteration ever runs; each step
                  drains up to `prefill_chunk` prompt tokens across the
                  occupied slots (oldest request first) at the engine's
                  `prefill_mfu`, and a slot whose prompt drains emits the
                  request's first token and moves it to the `handoff`
                  outbox for a paired decode pool.  Analytical mode only:
                  a model-mode prefill phase would need real KV transport.

Under memory pressure a running request can be preempted back to the
queue (its KV is dropped and it re-prefills on re-admission), and a
request can leave its pool mid-flight: at the window ceiling when
`evict_on_overflow` is set (`overflowed`, to be re-served one rung up) and
after `escalate_at` decode tokens when the router misrouted it
(`escalated`, to be re-served by the large model); the evicted slot's
decode tokens are backed out of the meter.  A re-admitted request's slot
keeps the stale K/V rows of whatever it held before past the new prompt:
the decode kernel's `lengths` (`models.attention.decode_index`) masks them,
and the O(1) state of recurrent blocks is written whole by the splice.

Prefill: in model mode K/V is computed per request at admission and
spliced into the slab.  Energy/time accounting supports two policies:
immediate (the whole prompt charged at admission) and chunked interleave
(`prefill_chunk` tokens ride along each decode iteration, the
Sarathi-style schedule; the request holds its slot but emits no tokens
until its prefill budget drains).  The decode pass runs over every slot;
the O(1) state of recurrent blocks (Mamba2, RWKV6) in slots still waiting
on their chunked prefill is kept as the prefill left it, so their streams
equal those of immediate prefill (the reference steps that state: ROADMAP
C8).

All post-decode bookkeeping is slot-batched over numpy arrays; Python
loops only touch the slots that complete or leave on a given iteration.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..core.fleet import PREFILL_MFU
from ..core.hardware import H100
from ..core.profiles import BaseProfile
from ..models import model as M
from .energy import EnergyMeter
from .request import Request, latency_percentiles

RECURRENT = ("mamba2", "rwkv6")     # blocks that carry O(1) state
_LCG_A, _LCG_C = 1664525, 1013904223   # Numerical Recipes LCG
_NEVER = np.iinfo(np.int32).max        # escalate_at sentinel: no escalation


class DrainTruncatedError(RuntimeError):
    """`run_until_drained` hit its iteration cap with work still queued or
    in flight.  A truncated drain has charged energy for only part of the
    request stream, so every downstream ratio would be plausible but wrong:
    callers must treat this as a hard failure, never as a result."""

    def __init__(self, name: str, max_iters: int, detail: str = ""):
        self.pool = name
        self.max_iters = max_iters
        super().__init__(
            f"pool {name!r} still busy after max_iters={max_iters}"
            f"{': ' + detail if detail else ''} — raise max_iters; a"
            " truncated drain under-counts tokens and energy")


def resolve_prefill_chunk(profile: BaseProfile,
                          prefill_chunk: Optional[int],
                          phase: str) -> Optional[int]:
    """The engines' prefill-chunk fallback.  Decode engines keep the
    caller's value (None/0 = unchunked immediate prefill).  Prefill-phase
    engines always work chunkwise (a 0 budget would never drain), so a
    missing chunk falls back to `scaled_prefill_chunk(profile)`."""
    if not prefill_chunk and phase == "prefill":
        return scaled_prefill_chunk(profile)
    return prefill_chunk


def scaled_prefill_chunk(profile: BaseProfile, base: int = 512,
                         floor: int = 64) -> int:
    """Prefill-chunk budget scaled by the profile's HBM bandwidth relative
    to the H100 the base chunk was calibrated on: a faster generation's
    decode iterations are shorter in proportion to its bandwidth, so a
    constant chunk would cap prefill throughput at the H100 rate; scaling
    it keeps prefill tokens per second generation-invariant."""
    ratio = profile.chip.mem_bw_Bps / H100.mem_bw_Bps
    return max(int(round(base * ratio)), floor)


class PoolEngine:
    """In model mode `params` live on the device the engine runs on;
    several engines may share one set of weights."""

    def __init__(self, cfg, params, *, window: int,
                 profile: BaseProfile, n_slots: Optional[int] = None,
                 name: str = "pool", rng_seed: int = 0,
                 prefill_chunk: Optional[int] = None,
                 evict_on_overflow: bool = False,
                 respect_arrival: bool = False,
                 streamed_params: Optional[float] = None,
                 vocab: int = 32000, phase: str = "decode",
                 prefill_mfu: Optional[float] = None,
                 dispatch_ms: float = 0.0):
        self.cfg, self.params = cfg, params
        self.window = window
        self.name = name
        self.profile = profile
        self.n_slots = n_slots if n_slots is not None \
            else max(profile.n_max(window), 1)
        if phase not in ("decode", "prefill"):
            raise ValueError(f"unknown engine phase {phase!r}")
        if phase == "prefill" and cfg is not None:
            raise ValueError("prefill-phase engines are analytical-only")
        self.phase = phase
        self.prefill_chunk = resolve_prefill_chunk(profile, prefill_chunk,
                                                   phase)
        self.prefill_mfu = PREFILL_MFU if prefill_mfu is None else prefill_mfu
        self.evict_on_overflow = evict_on_overflow
        self.respect_arrival = respect_arrival
        self.vocab = vocab
        self.meter = EnergyMeter(profile)
        # MoE all-to-all attribution: the floor is already inside the
        # profile roofline's w_ms (core.moe.with_dispatch_floor); telling
        # the meter lets it label that share of every decode charge
        self.meter.dispatch_s = max(dispatch_ms, 0.0) * 1e-3
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * self.n_slots
        n = self.n_slots
        self.pos = np.zeros(n, np.int32)            # next write position
        self.tokens = np.zeros(n, np.int64)         # last emitted token
        self.gen_count = np.zeros(n, np.int32)      # emitted tokens per slot
        self.m_gen = np.zeros(n, np.int32)          # ...metered in-window
        self.max_new = np.zeros(n, np.int32)
        self.prefill_left = np.zeros(n, np.int64)   # unmetered prefill tokens
        self.escalate_at = np.full(n, _NEVER, np.int32)  # misroute detection
        self._active = np.zeros(n, bool)
        self.preempted = 0
        self.n_escalated = 0                        # misroutes evicted here
        self.slot_seconds = 0.0                     # occupancy integral
        self.completed: List[Request] = []
        self.overflowed: List[Request] = []         # evicted at the window
        self.escalated: List[Request] = []          # semantic misroutes out
        self.handoff: List[Request] = []            # prefill-phase outbox
        self.relayed: List[Request] = []            # all handed-off (stats)
        # decode iterations run, and (model mode) their wall time on the
        # host clock (each ends in a device-to-host copy of the tokens)
        self.decode_steps = 0
        self.decode_wall_s = 0.0
        if cfg is not None:
            self._streamed_params = cfg.analytical_spec().streamed_params
            self._init_model(cfg, params)
        else:
            if streamed_params is None:
                raise ValueError("analytical mode needs streamed_params")
            self._streamed_params = float(streamed_params)
            self.cache = None
            self._gen_buf = None
        self._seed = np.int64(rng_seed)

    def _init_model(self, cfg, params) -> None:
        self.device = params["embed"].device
        self.cache = M.init_cache(cfg, self.n_slots, self.window,
                                  device=self.device)
        # the O(1) state a decode pass must not advance for waiting slots
        self._state = [t for i, b in enumerate(cfg.unit)
                       if b.kind in RECURRENT
                       for t in self.cache[f"b{i}_{b.kind}"].values()]
        # exact token streams are kept per slot; grown on demand in _admit
        self._gen_buf = np.zeros((self.n_slots, 64), np.int64)

    # --- admission ------------------------------------------------------
    @property
    def n_active(self) -> int:
        return int(self._active.sum())

    @property
    def busy(self) -> bool:
        return bool(self.queue or self._active.any())

    def submit(self, req: Request) -> None:
        req.pool = self.name
        self.queue.append(req)

    def _ready(self, req: Request) -> float:
        return req.ready_time if req.ready_time is not None \
            else req.arrival_time

    def advance_to(self, t: float) -> None:
        """Idle the engine forward to wall time t (idle power accrues)."""
        if t > self.meter.sim_time_s:
            self.meter.charge_idle(t - self.meter.sim_time_s)

    def _lcg_first(self, req: Request) -> int:
        return int((np.int64(req.rid) * _LCG_A + self._seed + _LCG_C)
                   % self.vocab)

    def _admit(self) -> None:
        while self.queue and not self._active.all():
            req = self.queue[0]
            if self.respect_arrival \
                    and self._ready(req) > self.meter.sim_time_s:
                break
            self.queue.popleft()
            slot = int(np.flatnonzero(~self._active)[0])
            plen = req.prompt_len
            if req.prefill_done:
                # disagg decode pool: the prompt was drained by a dedicated
                # prefill pool and its KV arrived over the interconnect —
                # no prefill work, charge or first-token emission here
                if self.cfg is not None:
                    raise ValueError(
                        "prefilled admission is analytical-mode only")
                self.slots[slot] = req
                self._active[slot] = True
                self.pos[slot] = plen
                self.max_new[slot] = req.max_new_tokens
                self.prefill_left[slot] = 0
                self.gen_count[slot] = 1
                self.escalate_at[slot] = req.escalate_at \
                    if req.escalate_at is not None else _NEVER
                self.tokens[slot] = int(req.generated[0]) if req.generated \
                    else self._lcg_first(req)
                continue
            if self.cfg is not None:
                prompt = torch.as_tensor(req.prompt[None, :],
                                         device=self.device)
                logits, cache = M.forward(self.params, self.cfg, prompt,
                                          mode="prefill")
                self._splice(cache, slot)
                first_tok = int(logits[0, -1].argmax())
                if self._gen_buf.shape[1] < req.max_new_tokens:
                    grow = np.zeros((self.n_slots, req.max_new_tokens),
                                    np.int64)
                    grow[:, :self._gen_buf.shape[1]] = self._gen_buf
                    self._gen_buf = grow
                self._gen_buf[slot, 0] = first_tok
            else:
                # analytical mode: deterministic LCG token stream
                first_tok = self._lcg_first(req)
            self.slots[slot] = req
            self._active[slot] = True
            self.pos[slot] = plen
            self.max_new[slot] = req.max_new_tokens
            self.escalate_at[slot] = req.escalate_at \
                if req.escalate_at is not None else _NEVER
            if self.prefill_chunk:
                # chunked interleave: prefill energy rides decode iterations
                self.prefill_left[slot] = plen
                self.gen_count[slot] = 0
                self.tokens[slot] = first_tok  # emitted when prefill drains
                req.generated = []
            else:
                self.meter.charge_prefill(
                    plen, mfu=self.prefill_mfu,
                    streamed_params=self._streamed_params)
                self.prefill_left[slot] = 0
                self.gen_count[slot] = 1
                self.tokens[slot] = first_tok
                req.generated = [first_tok]
                req.n_generated = 1
                req.first_token_time = self.meter.sim_time_s

    def _splice(self, prefill_cache, slot: int) -> None:
        """Write a single-sequence prefill cache into slab slot `slot`.

        Attention K/V: the first t = min(S', T) positions get the prompt's
        last t entries (SWA caches arrive already ring-aligned from
        attention_full); rows past t keep what the slot held before, which
        the decode kernel's `lengths` masks.  O(1) state (Mamba2 conv/ssm,
        RWKV6 wkv/shifts) is written whole, as the reference's `put` does;
        the Mamba2 conv state of a prompt shorter than d_conv - 1 arrives
        right-aligned behind zeros from the prefill (the reference writes
        its rows at the start of the slot instead: ROADMAP C7)."""
        for name, slab in self.cache.items():
            for key, dst in slab.items():
                piece = prefill_cache[name][key][:, 0]
                if key in ("k", "v"):                   # (R, S', K, hd)
                    t = min(piece.shape[1], dst.shape[2])
                    dst[:, slot, :t] = piece[:, -t:]
                else:
                    dst[:, slot] = piece

    # --- preemption (paper §10.1: "KV-cache eviction under memory
    # pressure ... reduces achievable throughput") ------------------------
    def _clear_slot(self, slot: int) -> None:
        self.slots[slot] = None
        self._active[slot] = False
        self.prefill_left[slot] = 0
        self.gen_count[slot] = 0
        self.m_gen[slot] = 0
        self.escalate_at[slot] = _NEVER

    def preempt(self, slot: int) -> None:
        """Evict a running request back to the queue (its KV is dropped;
        it will re-prefill on re-admission — the real cost of eviction)."""
        req = self.slots[slot]
        if req is None:
            return
        req.generated = None      # restart generation on re-admission
        req.preemptions += 1
        self.queue.appendleft(req)
        self._clear_slot(slot)
        self.preempted += 1

    def shrink(self, new_slots: int) -> None:
        """Memory-pressure response: reduce live concurrency by evicting
        the youngest requests (least wasted work)."""
        while self.n_active > new_slots:
            ages = [(self.pos[i] - s.prompt_len, i)
                    for i, s in enumerate(self.slots) if s is not None]
            _, victim = min(ages)
            self.preempt(victim)

    def _back_out_and_evict(self, slot: int) -> Request:
        """Shared eviction bookkeeping: the slot's decode work so far is
        wasted (the request re-prefills elsewhere), so its decode tokens
        are backed out of the meter; the energy stays, it was spent."""
        req = self.slots[slot]
        # metered decode tokens only: the first token came from prefill;
        # the windowed counter gives back exactly the slot's in-window share
        self.meter.tokens -= max(int(self.gen_count[slot]) - 1, 0)
        self.meter.m_tokens -= int(self.m_gen[slot])
        req.generated = None
        req.prefill_done = False    # its KV is dropped: the destination
        req.preemptions += 1        # (re-)prefills from scratch
        req.ready_time = self.meter.sim_time_s
        req.escalate_at = None      # any eviction lands the request in the
        self._clear_slot(slot)      # large pool: never re-escalate there
        self.preempted += 1
        return req

    def _evict_overflow(self, slot: int) -> None:
        """FleetOpt migration: the request hit the pool window mid-flight
        and re-prefills one rung up the ladder."""
        self.overflowed.append(self._back_out_and_evict(slot))

    def _evict_escalation(self, slot: int) -> None:
        """Semantic misroute detected after `escalate_at` decode tokens:
        the request leaves to be re-served from scratch by the large
        model; its wasted small-pool tokens were backed out."""
        req = self._back_out_and_evict(slot)   # clears the escalation tag
        req.escalations += 1
        self.n_escalated += 1
        self.escalated.append(req)

    # --- one continuous-batching iteration ------------------------------
    def _next_tokens(self) -> np.ndarray:
        """(n_slots,) next token per slot: the greedy argmax of a decode
        step in model mode, the LCG stream in analytical mode.  In model
        mode the recurrent state of slots still waiting on their chunked
        prefill comes out as it went in (their attention K/V row at `pos`
        is written, and overwritten by their first real decode step)."""
        self.decode_steps += 1
        if self.cfg is None:
            return (self.tokens * _LCG_A + _LCG_C + self._seed) % self.vocab
        t0 = time.perf_counter()
        toks = torch.as_tensor(self.tokens[:, None], device=self.device)
        waiting = np.flatnonzero(self._active & (self.prefill_left > 0))
        kept = []
        if self._state and waiting.size:
            rows = torch.as_tensor(waiting, device=self.device)
            kept = [(t, t[:, rows].clone()) for t in self._state]
        logits, self.cache = M.decode_step(self.params, self.cfg, toks,
                                           self.cache, self.pos)
        for t, old in kept:
            t[:, rows] = old
        nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()
        self.decode_wall_s += time.perf_counter() - t0
        return nxt

    def _drain_prefill_chunk(self, overlap_s: float = 0.0) -> None:
        """Meter up to `prefill_chunk` pending prefill tokens riding this
        iteration; slots whose budget drains emit their first token.  The
        first chunk hides behind this iteration's decode tau (`overlap_s`)
        — compute-bound prefill piggybacking on the memory-bound decode."""
        budget = self.prefill_chunk
        pending = np.flatnonzero(self._active & (self.prefill_left > 0))
        for i in pending:           # few slots are ever mid-prefill
            if budget <= 0:
                break
            take = int(min(budget, self.prefill_left[i]))
            self.meter.charge_prefill(
                take, mfu=self.prefill_mfu,
                streamed_params=self._streamed_params,
                overlap_s=overlap_s)
            overlap_s = 0.0         # only one chunk rides each decode pass
            self.prefill_left[i] -= take
            budget -= take
            if self.prefill_left[i] == 0:
                req = self.slots[i]
                self.gen_count[i] = 1
                req.generated = [int(self.tokens[i])] \
                    if self._gen_buf is None else [int(self._gen_buf[i, 0])]
                req.n_generated = 1
                req.first_token_time = self.meter.sim_time_s

    def _finish_prefill(self, slot: int) -> None:
        """Prefill-phase completion: the prompt drained and its first token
        was emitted; the request leaves for the paired decode pool through
        the `handoff` outbox."""
        req = self.slots[slot]
        req.n_generated = 1
        req.generated = [int(self.tokens[slot])]
        req.first_token_time = self.meter.sim_time_s
        req.prefill_done = True
        req.ready_time = self.meter.sim_time_s
        self.handoff.append(req)
        self.relayed.append(req)
        self._clear_slot(slot)

    def _step_prefill(self) -> int:
        """One prefill-phase iteration: drain up to `prefill_chunk` prompt
        tokens across the occupied slots, oldest request first (slot
        indices recycle, so raw index order would let a fresh giant prompt
        starve an almost-drained older one)."""
        t_start = self.meter.sim_time_s
        self._admit()
        n_occupied = int(self._active.sum())
        pending = sorted(
            np.flatnonzero(self._active & (self.prefill_left > 0)),
            key=lambda i: self._ready(self.slots[int(i)]))
        budget = self.prefill_chunk
        n_work = 0
        for i in pending:
            if budget <= 0:
                break
            take = int(min(budget, self.prefill_left[i]))
            self.meter.charge_prefill(
                take, mfu=self.prefill_mfu,
                streamed_params=self._streamed_params)
            self.prefill_left[i] -= take
            budget -= take
            n_work += take
            if self.prefill_left[i] == 0:
                self._finish_prefill(int(i))
        self.slot_seconds += n_occupied * (self.meter.sim_time_s - t_start)
        return n_work

    @torch.inference_mode()
    def step(self) -> int:
        if self.phase == "prefill":
            return self._step_prefill()
        t_start = self.meter.sim_time_s
        self._admit()
        # occupancy counts every held slot — including those still waiting
        # on chunked prefill — for however long this iteration takes
        n_occupied = int(self._active.sum())
        dec = self._active & (self.prefill_left == 0)
        n_dec = int(dec.sum())
        tau = 0.0
        if n_dec:
            nxt = self._next_tokens()
            mean_ctx = float(self.pos[dec].mean())
            tau = self.meter.charge_decode_step(n_dec, mean_ctx)
            if self.meter.last_charge_in_window:
                self.m_gen[dec] += 1
            self.tokens[dec] = nxt[dec]
            if self._gen_buf is not None:
                self._gen_buf[dec, self.gen_count[dec]] = nxt[dec]
            self.gen_count[dec] += 1
            self.pos[dec] += 1
            done = dec & (self.gen_count >= self.max_new)
            # semantic misroute detection fires before the window ceiling:
            # a misrouted giant prompt escalates on quality, not on length
            # (a request that finishes under the detection latency simply
            # completes).  The ceiling stops a slot whose last write was
            # row window - 2, so no decode write lands past the slab.
            escalate = dec & ~done & (self.gen_count >= self.escalate_at)
            at_ceiling = dec & ~done & ~escalate \
                & (self.pos >= self.window - 1)
            if not self.evict_on_overflow:
                done |= at_ceiling      # truncate at the window
            for i in np.flatnonzero(done):  # touches finishing slots only
                self._finish(int(i))
            for i in np.flatnonzero(escalate):
                self._evict_escalation(int(i))
            if self.evict_on_overflow:
                for i in np.flatnonzero(at_ceiling):
                    self._evict_overflow(int(i))
        if self.prefill_chunk:
            self._drain_prefill_chunk(overlap_s=tau)
        self.slot_seconds += n_occupied * (self.meter.sim_time_s - t_start)
        return n_dec

    def _finish(self, slot: int) -> None:
        req = self.slots[slot]
        n = int(self.gen_count[slot])
        req.n_generated = n
        if self._gen_buf is not None:
            req.generated = [int(t) for t in self._gen_buf[slot, :n]]
        else:
            req.generated = None    # analytical mode: ids are synthetic
        req.finish_time = self.meter.sim_time_s
        self.completed.append(req)
        self._clear_slot(slot)

    def run_until_drained(self, max_iters: int = 100_000) -> None:
        it = 0
        while self.busy and it < max_iters:
            if self.respect_arrival and self.n_active == 0 and self.queue:
                # event-driven idle skip: jump to the next arrival
                self.advance_to(min(self._ready(r) for r in self.queue))
            self.step()
            it += 1
        if self.busy:
            raise DrainTruncatedError(
                self.name, max_iters,
                f"{len(self.queue)} queued, {self.n_active} in flight")

    def latency_percentiles(self) -> Dict[str, float]:
        return latency_percentiles(self.completed)

    def measured_totals(self) -> Dict[str, float]:
        """Unrounded steady-state-windowed (tokens, joules) — the fleet
        roll-up sums these so report paths agree exactly."""
        return dict(tokens=self.meter.m_tokens, joules=self.meter.m_joules)

    @property
    def occupancy(self) -> float:
        """Mean fraction of the slot slab in use while the clock ran."""
        denom = self.n_slots * self.meter.sim_time_s
        return self.slot_seconds / denom if denom else 0.0

    def stats(self) -> Dict[str, float]:
        return dict(name=self.name, window=self.window,
                    n_slots=self.n_slots,
                    completed=len(self.completed),
                    relayed=len(self.relayed),
                    preempted=self.preempted,
                    tokens=self.meter.tokens,
                    joules=round(self.meter.joules, 1),
                    # steady-state-windowed counters (mirror the totals when
                    # the meter window is left at its (0, inf) default)
                    m_tokens=self.meter.m_tokens,
                    m_joules=round(self.meter.m_joules, 1),
                    tok_per_watt=round(self.meter.tok_per_watt, 3),
                    sim_time_s=round(self.meter.sim_time_s, 3),
                    occupancy=round(self.occupancy, 3),
                    **self.latency_percentiles())
