"""Continuous-batching decode engine over the model, on the card.

One `PoolEngine` is one "instance" in the paper's terms: a model replica
serving one context window.  It owns:

  * a slotted KV/state cache slab of exactly `n_slots` sequences — Eq. 3's
    concurrency ceiling enforced as the scheduler's admission limit; one
    (n_repeat, n_slots, T, K, hd) K and V tensor per attention block and
    the O(1) state of each recurrent block on the card, updated in place
    (the reference returns new JAX arrays from every step instead);
  * a decode step over all slots (inactive slots compute masked garbage, as
    real continuous-batching engines do);
  * an EnergyMeter charging every iteration P(b) * tau.

Token streams are exact greedy generations.  Prefill runs per request at
admission and its K/V is spliced into the slab.  Energy/time accounting
supports two policies: immediate (the whole prompt charged at admission)
and chunked interleave (`prefill_chunk` tokens ride along each decode
iteration, the Sarathi-style schedule; the request holds its slot but emits
no tokens until its prefill budget drains).  The decode pass runs over
every slot; the O(1) state of recurrent blocks (Mamba2, RWKV6) in slots
still waiting on their chunked prefill is kept as the prefill left it, so
their streams equal those of immediate prefill (the reference steps that
state: ROADMAP C8).

All post-decode bookkeeping is slot-batched over numpy arrays; Python
loops only touch the slots that complete on a given iteration.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..core.profiles import BaseProfile
from ..models import model as M
from .energy import EnergyMeter
from .request import Request, latency_percentiles

PREFILL_MFU = 0.8     # MFU every prefill charge is drawn at
RECURRENT = ("mamba2", "rwkv6")     # blocks that carry O(1) state


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


class PoolEngine:
    """`params` live on the device the engine runs on; several engines may
    share one set of weights."""

    def __init__(self, cfg, params, *, window: int, profile: BaseProfile,
                 n_slots: Optional[int] = None, name: str = "pool",
                 prefill_chunk: Optional[int] = None,
                 dispatch_ms: float = 0.0):
        self.cfg, self.params = cfg, params
        self.window = window
        self.name = name
        self.profile = profile
        self.n_slots = n_slots if n_slots is not None \
            else max(profile.n_max(window), 1)
        self.prefill_chunk = prefill_chunk
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
        self._active = np.zeros(n, bool)
        self.slot_seconds = 0.0                     # occupancy integral
        self.completed: List[Request] = []
        self._streamed_params = cfg.analytical_spec().streamed_params
        self.device = params["embed"].device
        self.cache = M.init_cache(cfg, n, window, device=self.device)
        # the O(1) state a decode pass must not advance for waiting slots
        self._state = [t for i, b in enumerate(cfg.unit)
                       if b.kind in RECURRENT
                       for t in self.cache[f"b{i}_{b.kind}"].values()]
        # exact token streams are kept per slot; grown on demand in _admit
        self._gen_buf = np.zeros((n, 64), np.int64)
        # decode iterations run and their wall time on the host clock
        # (each ends in a device-to-host copy of the next tokens)
        self.decode_steps = 0
        self.decode_wall_s = 0.0

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

    def _admit(self) -> None:
        while self.queue and not self._active.all():
            req = self.queue.popleft()
            slot = int(np.flatnonzero(~self._active)[0])
            plen = req.prompt_len
            prompt = torch.as_tensor(req.prompt[None, :], device=self.device)
            logits, cache = M.forward(self.params, self.cfg, prompt,
                                      mode="prefill")
            self._splice(cache, slot)
            first_tok = int(logits[0, -1].argmax())
            if self._gen_buf.shape[1] < req.max_new_tokens:
                grow = np.zeros((self.n_slots, req.max_new_tokens), np.int64)
                grow[:, :self._gen_buf.shape[1]] = self._gen_buf
                self._gen_buf = grow
            self._gen_buf[slot, 0] = first_tok
            self.slots[slot] = req
            self._active[slot] = True
            self.pos[slot] = plen
            self.max_new[slot] = req.max_new_tokens
            self.tokens[slot] = first_tok
            if self.prefill_chunk:
                # chunked interleave: prefill energy rides decode iterations
                self.prefill_left[slot] = plen
                self.gen_count[slot] = 0  # first token emitted on drain
                req.generated = []
            else:
                self.meter.charge_prefill(
                    plen, mfu=PREFILL_MFU,
                    streamed_params=self._streamed_params)
                self.prefill_left[slot] = 0
                self.gen_count[slot] = 1
                req.generated = [first_tok]
                req.n_generated = 1
                req.first_token_time = self.meter.sim_time_s

    def _splice(self, prefill_cache, slot: int) -> None:
        """Write a single-sequence prefill cache into slab slot `slot`.

        Attention K/V: the first t = min(S', T) positions get the prompt's
        last t entries (SWA caches arrive already ring-aligned from
        attention_full).  O(1) state (Mamba2 conv/ssm, RWKV6 wkv/shifts)
        is written whole, as the reference's `put` does; the Mamba2 conv
        state of a prompt shorter than d_conv - 1 arrives right-aligned
        behind zeros from the prefill (the reference writes its rows at
        the start of the slot instead: ROADMAP C7)."""
        for name, slab in self.cache.items():
            for key, dst in slab.items():
                piece = prefill_cache[name][key][:, 0]
                if key in ("k", "v"):                   # (R, S', K, hd)
                    t = min(piece.shape[1], dst.shape[2])
                    dst[:, slot, :t] = piece[:, -t:]
                else:
                    dst[:, slot] = piece

    def _clear_slot(self, slot: int) -> None:
        self.slots[slot] = None
        self._active[slot] = False
        self.prefill_left[slot] = 0
        self.gen_count[slot] = 0
        self.m_gen[slot] = 0

    # --- one continuous-batching iteration ------------------------------
    def _next_tokens(self) -> np.ndarray:
        """(n_slots,) greedy next token per slot.  The recurrent state of
        slots still waiting on their chunked prefill comes out as it went
        in (their attention K/V row at `pos` is written, and overwritten by
        their first real decode step)."""
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
        self.decode_steps += 1
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
                take, mfu=PREFILL_MFU,
                streamed_params=self._streamed_params,
                overlap_s=overlap_s)
            overlap_s = 0.0         # only one chunk rides each decode pass
            self.prefill_left[i] -= take
            budget -= take
            if self.prefill_left[i] == 0:
                req = self.slots[i]
                self.gen_count[i] = 1
                req.generated = [int(self._gen_buf[i, 0])]
                req.n_generated = 1
                req.first_token_time = self.meter.sim_time_s

    @torch.inference_mode()
    def step(self) -> int:
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
            self._gen_buf[dec, self.gen_count[dec]] = nxt[dec]
            self.gen_count[dec] += 1
            self.pos[dec] += 1
            # finish at max_new, or truncate at the window ceiling (which
            # also keeps every decode write inside the slab)
            done = dec & ((self.gen_count >= self.max_new)
                          | (self.pos >= self.window - 1))
            for i in np.flatnonzero(done):  # touches finishing slots only
                self._finish(int(i))
        if self.prefill_chunk:
            self._drain_prefill_chunk(overlap_s=tau)
        self.slot_seconds += n_occupied * (self.meter.sim_time_s - t_start)
        return n_dec

    def _finish(self, slot: int) -> None:
        req = self.slots[slot]
        n = int(self.gen_count[slot])
        req.n_generated = n
        req.generated = [int(t) for t in self._gen_buf[slot, :n]]
        req.finish_time = self.meter.sim_time_s
        self.completed.append(req)
        self._clear_slot(slot)

    def run_until_drained(self, max_iters: int = 100_000) -> None:
        it = 0
        while self.busy and it < max_iters:
            self.step()
            it += 1
        if self.busy:
            raise DrainTruncatedError(
                self.name, max_iters,
                f"{len(self.queue)} queued, {self.n_active} in flight")

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
        # relayed / preempted stay 0 here (no prefill handoff, no
        # preemption) and keep the reference report's keys
        return dict(name=self.name, window=self.window,
                    n_slots=self.n_slots,
                    completed=len(self.completed),
                    relayed=0,
                    preempted=0,
                    tokens=self.meter.tokens,
                    joules=round(self.meter.joules, 1),
                    m_tokens=self.meter.m_tokens,
                    m_joules=round(self.meter.m_joules, 1),
                    tok_per_watt=round(self.meter.tok_per_watt, 3),
                    sim_time_s=round(self.meter.sim_time_s, 3),
                    occupancy=round(self.occupancy, 3),
                    **latency_percentiles(self.completed))
