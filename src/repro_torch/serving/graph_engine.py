"""The compiled fleet drain: a float64 torch step replayed as CUDA graphs.

Counterpart of the reference's `serving/jax_engine.py`.  `GraphPoolEngine`
extends `serving.soa.BatchedPoolEngine` (which stays the bit-exact parity
oracle against the scalar `PoolEngine`) with a drain that runs on the
card: the (I, S) slot arrays plus the MeterBank rows become tensors that
one step function, `body`, updates in place, and the pools of many
scenarios concatenate along the instance axis so a grid of fleet
configurations (different chips, misroute rates, dispatch floors, pool
counts) drains in a handful of calls instead of hundreds of Python step
loops.

How the drain runs
  * All state is float64, with int32 where the reference uses `i32` (token
    counts, positions, step indices) and bool masks.  Integer quotients
    are cast to float64 first: torch's `int / int` is float32.
  * The reference's `lax.while_loop(cond, body)` becomes `STEPS_PER_REPLAY`
    calls of a gated step: every update of a step, `it` included, is
    `torch.where(go, new, old)` with `go = cond(st)` computed on the
    device, so a step taken after the drain has ended changes nothing.
    `cond` stays global: every row of a merged batch steps until all rows
    are done, so `it` and the event tape's `out_step` follow the
    reference's order.
  * On the card those steps are captured once per shape class
    (phase, I, S, Q) as one CUDA graph; the host copies the packed queue
    arrays into the graph's static inputs, resets the state, and replays
    the graph until the `alive` flag it writes is false: one host sync per
    `STEPS_PER_REPLAY` steps.  On the CPU the same steps run eagerly with
    the same check.

Layout / padding / masking (as the reference)
  * Queues are frozen to (I, Q) arrays at drain start (FleetSim injects and
    sorts before a pool runs, exactly like the numpy engine's `_freeze`).
  * Ragged dims are padded to the batch max, bucketed to powers of two so
    nearby shapes reuse one graph: padded queue entries carry `ready = inf`
    and sit beyond `qlen`; padded slots are masked by `n_slots`; padded
    instances have `qlen = 0` and never wake up.  Masked lanes add exactly
    `+0.0` / `+0` to every accumulator, which float64 keeps exact.
  * Per-event Python work (finish / evict / escalate / handoff) moves to
    post-hoc reconstruction: the step logs one terminal event per queue
    entry into (I, Q) out-arrays (kind, time, first-token time, token
    count, step, slot), every queue entry gathering from the slot it was
    admitted to, and `_finalize` replays them in (step, time, slot) order
    — the numpy engine's per-category append order — onto the live
    `Request` objects, the numpy `MeterBank` and the trace hooks, so
    FleetSim's cross-pool flow (overflow / escalation / KV handoff) is
    identical downstream.

Parity contract: every meter expression replicates `energy.MeterBank` in
float64.  The only divergence is accumulation *order* on multi-slot chunk
spills (the numpy slow path charges sequentially; the drain sums a masked
cumsum) and the closed-form `coast` over event-free decode spans, which is
last-ulp noise: integer and ordering fields equal the numpy oracle's and
meters agree at rtol 1e-9.  The decode-token LCG stream is elided: token
values never feed back into any meter or event, except a prefill
handoff's first token, a pure function of (rid, seed) re-derived at
reconstruction.

Not supported (use the numpy oracle): the unchunked immediate-prefill
decode path (`prefill_chunk in (0, None)`), whose admission loop advances
the clock mid-admission, model mode, and per-row online windows
(autoscaling) — the drain starts every row's clock at zero.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core.timeline import (EV_COMPLETE, EV_ESCALATE, EV_FIRST_TOKEN,
                             EV_HANDOFF, EV_OVERFLOW)

from .engine import _LCG_A, _LCG_C, _NEVER, DrainTruncatedError
from .soa import BatchedPoolEngine

_EV_NONE, _EV_DONE, _EV_OVERFLOW, _EV_ESCALATE, _EV_HANDOFF = 0, 1, 2, 3, 4

# per-instance accumulator rows the device fills and _finalize copies back
_METER_KEYS = ("joules", "idle_joules", "prefill_joules", "dispatch_joules",
               "m_joules", "m_prefill_joules", "m_idle_joules",
               "m_dispatch_joules", "tokens", "m_tokens", "prefill_tokens")
_INT_METERS = ("tokens", "m_tokens", "prefill_tokens")

# gated steps per graph replay (and per `alive` read on the host).  The
# closed-form coast makes a Table E drain 30-100 steps long, so 16 keeps
# the no-op tail of the last replay (at most 15 steps) small, while one
# host sync per 16 steps costs little against their thousands of kernels
STEPS_PER_REPLAY = 16

F64, I32 = torch.float64, torch.int32
_TORCH_DTYPE = {np.dtype(np.float64): F64, np.dtype(np.int32): I32,
                np.dtype(bool): torch.bool}


def _bucket(n: int, floor: int = 8) -> int:
    """Round a ragged dim up to a power of two (>= floor) so stacked
    grids of nearby shapes reuse one captured drain."""
    return max(floor, 1 << max(int(n) - 1, 0).bit_length())


# --------------------------------------------------------------------------
# the drain: one row-concatenated batch of pools, STEPS_PER_REPLAY steps
# --------------------------------------------------------------------------

def _state_spec(I: int, S: int, Q: int) -> Dict[str, tuple]:
    """(shape, dtype, initial value) of every piece of drain state."""
    spec = dict(
        sim_time=((I,), F64, 0), qpos=((I,), I32, 0), it=((), I32, 0),
        active=((I, S), torch.bool, False),
        pos=((I, S), I32, 0), gen_count=((I, S), I32, 0),
        m_gen=((I, S), I32, 0), max_new=((I, S), I32, 0),
        prefill_left=((I, S), I32, 0), esc=((I, S), I32, _NEVER),
        ready_ts=((I, S), F64, 0), slot_q=((I, S), I32, 0),
        slot_seconds=((I,), F64, 0), m_slot_seconds=((I,), F64, 0),
        preempted=((I,), I32, 0), n_escalated=((I,), I32, 0),
        out_kind=((I, Q), I32, 0), out_time=((I, Q), F64, 0),
        out_first=((I, Q), F64, -1.0), out_ngen=((I, Q), I32, 0),
        out_step=((I, Q), I32, 0), out_slot=((I, Q), I32, 0),
        q_slot=((I, Q), I32, 0))
    for k in _METER_KEYS:
        spec[k] = ((I,), I32 if k in _INT_METERS else F64, 0)
    return spec


def _reset(st: Dict[str, torch.Tensor], I: int, S: int, Q: int) -> None:
    for k, (_, _, v) in _state_spec(I, S, Q).items():
        st[k].fill_(v)


def _drain_one(p: Dict[str, torch.Tensor], st: Dict[str, torch.Tensor], *,
               phase: str, n_slots_pad: int) -> torch.Tensor:
    """`STEPS_PER_REPLAY` gated steps of one drain over a row-concatenated
    batch of pools, in place on `st`; returns `cond` after them (the
    `alive` flag).

    Every piece of engine state is per-instance, so *many* pools — across
    scenarios, chips, even flag combinations — concatenate along the
    instance axis into a single (I, S) / (I, Q) problem: per-pool scalars
    (roofline/power constants, window, chunk, the evict/respect flags)
    ride in `p` as (I,) tensors, so shape (I, S, Q) is the only thing that
    calls for another captured graph.  Issues no host sync, so a CUDA
    graph can capture it."""
    S = n_slots_pad
    evict = p["evict"]
    respect = p["respect"]
    I, Q = p["q_ready"].shape
    dev = p["q_ready"].device
    inf = float("inf")
    qidx = torch.arange(Q, dtype=I32, device=dev)[None, :]
    sidx = torch.arange(S, dtype=I32, device=dev)[None, :]
    slot_ok = sidx < p["n_slots"][:, None]

    def emit(st, mask, kind, time_val, ngen=None, first=None):
        """Record one terminal/drain event per masked slot into the
        queue-indexed out arrays.  Event masks/values live in slot space
        (I, S); every queue entry *gathers* from the slot recorded in
        `q_slot` at its admission.  A gather lane is live only while
        `slot_q` still points back at the entry (its slot has not been
        recycled), which makes the stale-mapping check one (I, Q)
        compare."""
        sq = st["q_slot"].long()

        def g(v):                      # (I,S) slot values at each entry
            return torch.gather(v.expand(I, S), 1, sq)

        hit = g(mask) & (g(st["slot_q"]) == qidx)
        if kind is not None:
            k = g(kind) if torch.is_tensor(kind) else kind
            st["out_kind"] = torch.where(hit, k, st["out_kind"])
            st["out_time"] = torch.where(hit, g(time_val), st["out_time"])
            st["out_step"] = torch.where(hit, st["it"], st["out_step"])
            st["out_slot"] = torch.where(hit, sq.to(I32), st["out_slot"])
        if ngen is not None:
            v = g(ngen) if torch.is_tensor(ngen) else ngen
            st["out_ngen"] = torch.where(hit, v, st["out_ngen"])
        if first is not None:
            st["out_first"] = torch.where(hit, g(first), st["out_first"])
        return st

    def window_overlap(start, end):
        t0, t1 = p["t0"], p["t1"]
        if start.dim() == 2:              # (I, S) spans vs (I,) windows
            t0, t1 = t0[:, None], t1[:, None]
        return torch.clamp_min(torch.minimum(t1, end)
                               - torch.maximum(t0, start), 0.0)

    def charge_prefill_span(st, take, overlap_s, sim):
        """Vectorized twin of the numpy engine's sequential per-slot chunk
        charges: per-slot work times via `MeterBank.charge_prefill_rows`'s
        expressions, per-slot charge instants via an exclusive cumsum of
        the clock advances (the numpy slow path's sequential `sim_time`).
        Returns (st, sim', t_after) with t_after the post-charge instant
        per slot (first-token / handoff timestamps)."""
        t = (p["pf_num"][:, None] * take) / p["pf_den"][:, None]
        e = p["p_nom"][:, None] * t
        hidden = torch.minimum(overlap_s, t)
        dt = t - hidden
        cum_dt_excl = torch.cumsum(dt, dim=1) - dt
        t_before = sim[:, None] + cum_dt_excl
        ovl = window_overlap(t_before - hidden, t_before + dt)
        safe_t = torch.where(t > 0, t, 1.0)
        e_in = torch.where((ovl > 0) & (t > 0),
                           e * torch.clamp_max(ovl / safe_t, 1.0), 0.0)
        st["m_joules"] = st["m_joules"] + e_in.sum(1)
        st["m_prefill_joules"] = st["m_prefill_joules"] + e_in.sum(1)
        st["joules"] = st["joules"] + e.sum(1)
        st["prefill_joules"] = st["prefill_joules"] + e.sum(1)
        st["prefill_tokens"] = st["prefill_tokens"] + take.sum(1, dtype=I32)
        return st, sim + dt.sum(1), t_before + dt

    def admit(st, sim):
        """Head-gated FIFO admission of the ready queue prefix into the
        lowest free slots (chunked mode never advances the clock here, so
        the whole wave vectorizes: the j-th admitted entry lands in the
        j-th lowest inactive slot)."""
        qpos = st["qpos"]
        rem = (qidx >= qpos[:, None]) & (qidx < p["qlen"][:, None])
        # respect=False degenerates to "whole queue is ready now"
        notready = rem & (p["q_ready"] > sim[:, None]) & respect[:, None]
        first_nr = torch.argmax(notready.to(I32), dim=1).to(I32)
        prefix_end = torch.where(notready.any(1), first_nr, p["qlen"])
        n_ready = torch.clamp_min(prefix_end - qpos, 0)
        free = (~st["active"]) & slot_ok
        cum_free = torch.cumsum(free, dim=1, dtype=I32)
        n_admit = torch.minimum(n_ready, cum_free[:, -1])
        free_rank = cum_free - free.to(I32)
        adm = free & (free_rank < n_admit[:, None])
        src = torch.clamp(qpos[:, None] + free_rank, 0, Q - 1).long()
        # inverse mapping for `emit`: the j-th admitted queue entry lands
        # in the j-th lowest free slot = first s with cum_free[s] == j+1
        adm_q = (qidx >= qpos[:, None]) & (qidx < (qpos + n_admit)[:, None])
        ranks = (qidx - qpos[:, None] + 1).contiguous()
        slot_of_q = torch.searchsorted(cum_free.contiguous(), ranks,
                                       right=False).to(I32)
        st["q_slot"] = torch.where(adm_q, torch.clamp(slot_of_q, 0, S - 1),
                                   st["q_slot"])

        def gather(a):
            return torch.gather(a, 1, src)

        a_plen = gather(p["q_plen"])
        a_pd = gather(p["q_pdone"])
        st["active"] = st["active"] | adm
        st["pos"] = torch.where(adm, a_plen, st["pos"])
        st["max_new"] = torch.where(adm, gather(p["q_maxnew"]),
                                    st["max_new"])
        st["ready_ts"] = torch.where(adm, gather(p["q_ready"]),
                                     st["ready_ts"])
        st["esc"] = torch.where(adm, gather(p["q_esc"]), st["esc"])
        st["slot_q"] = torch.where(adm, src.to(I32), st["slot_q"])
        st["gen_count"] = torch.where(adm, a_pd.to(I32), st["gen_count"])
        st["prefill_left"] = torch.where(
            adm, torch.where(a_pd, 0, a_plen), st["prefill_left"])
        st["m_gen"] = torch.where(adm, 0, st["m_gen"])
        st["qpos"] = qpos + n_admit
        return st

    def logistic_power(nf):
        safe_b = torch.clamp_min(nf, 1e-9)
        return p["p_range"] / (
            1.0 + torch.exp(-p["k"] * (torch.log2(safe_b) - p["x0"])))

    def decode_step(st, sim):
        n_occ = st["active"].sum(1, dtype=I32)
        dec = st["active"] & (st["prefill_left"] == 0)
        n_dec = dec.sum(1, dtype=I32)
        has_dec = n_dec > 0
        nf = n_dec.to(F64)
        mean_ctx = (st["pos"] * dec).sum(1).to(F64) \
            / torch.where(has_dec, n_dec, 1).to(F64)
        tau_ms = p["w_ms"] + (p["h0_ms"] * (mean_ctx / p["l_calib"])) * nf
        tau_s = tau_ms * 1e-3
        power = torch.where(nf <= 0, p["p_idle"],
                            p["p_idle"] + logistic_power(nf))
        mid = sim + 0.5 * tau_s
        in_win = (p["t0"] <= mid) & (mid <= p["t1"])
        e = power * tau_s
        dj = power * torch.minimum(p["dispatch_s"], tau_s)
        win = has_dec & in_win
        st["m_tokens"] = st["m_tokens"] + torch.where(win, n_dec, 0)
        st["m_joules"] = st["m_joules"] + torch.where(win, e, 0.0)
        st["m_dispatch_joules"] = st["m_dispatch_joules"] \
            + torch.where(win, dj, 0.0)
        st["joules"] = st["joules"] + torch.where(has_dec, e, 0.0)
        st["dispatch_joules"] = st["dispatch_joules"] \
            + torch.where(has_dec, dj, 0.0)
        st["tokens"] = st["tokens"] + torch.where(has_dec, n_dec, 0)
        tau_full = torch.where(has_dec, tau_s, 0.0)
        sim = sim + tau_full
        # post-decode bookkeeping + terminal events
        st["m_gen"] = st["m_gen"] + (dec & win[:, None]).to(I32)
        st["gen_count"] = st["gen_count"] + dec.to(I32)
        st["pos"] = st["pos"] + dec.to(I32)
        gc = st["gen_count"]
        done = dec & (gc >= st["max_new"])
        escalate = dec & ~done & (gc >= st["esc"])
        at_ceiling = dec & ~done & ~escalate \
            & (st["pos"] >= p["window"][:, None] - 1)
        # no-evict pools finish a request at the context ceiling instead
        done = done | (at_ceiling & ~evict[:, None])
        at_ceiling = at_ceiling & evict[:, None]
        ev = escalate | at_ceiling
        # one fused emit for all three terminal kinds: reconstruction only
        # reads ngen on DONE rows, so charging it unconditionally is free
        kind = torch.where(done, _EV_DONE,
                           torch.where(escalate, _EV_ESCALATE,
                                       _EV_OVERFLOW)).to(I32)
        st = emit(st, done | ev, kind, sim[:, None], ngen=gc)
        # eviction backout: decode tokens beyond the (uncharged) first are
        # clawed back so escalated/overflowed output is never double-counted
        st["tokens"] = st["tokens"] \
            - (torch.clamp_min(gc - 1, 0) * ev).sum(1, dtype=I32)
        st["m_tokens"] = st["m_tokens"] - (st["m_gen"] * ev).sum(1, dtype=I32)
        st["preempted"] = st["preempted"] + ev.sum(1, dtype=I32)
        st["n_escalated"] = st["n_escalated"] + escalate.sum(1, dtype=I32)
        clr = done | ev
        st["active"] = st["active"] & ~clr
        st["prefill_left"] = torch.where(clr, 0, st["prefill_left"])
        st["gen_count"] = torch.where(clr, 0, st["gen_count"])
        st["m_gen"] = torch.where(clr, 0, st["m_gen"])
        st["esc"] = torch.where(clr, _NEVER, st["esc"])
        # chunked-prefill interleave riding this row's decode tau: the
        # chunk budget spills across pending slots in slot order, only the
        # first charge hides behind the decode pass
        pend = st["active"] & (st["prefill_left"] > 0)
        pl = torch.where(pend, st["prefill_left"], 0)
        cum_excl = torch.cumsum(pl, dim=1, dtype=I32) - pl
        take = torch.minimum(pl, torch.clamp_min(p["chunk"][:, None]
                                                 - cum_excl, 0))
        charged = take > 0
        ci = charged.to(I32)
        is_first = charged & ((torch.cumsum(ci, dim=1, dtype=I32) - ci) == 0)
        ov = torch.where(is_first, tau_full[:, None], 0.0)
        st, sim, t_after = charge_prefill_span(st, take, ov, sim)
        drained = charged & (take == pl)
        st = emit(st, drained, None, None, first=t_after)
        st["gen_count"] = torch.where(drained, 1, st["gen_count"])
        st["prefill_left"] = st["prefill_left"] - take
        return st, sim, n_occ

    def coast(st, sim):
        """Event-free fast-forward for decode rows.  When a row's in-flight
        set is static — no slot will reach done/escalate/ceiling, no prompt
        chunks are pending, no admission can land, and every step midpoint
        stays on one side of the measurement window — the decode recurrence
        is closed-form: batch size and power are constant and the mean
        context grows by exactly one per step, so tau is linear in the step
        index and each accumulator advance is an arithmetic series.  The
        jump length is bounded conservatively (tau at the last candidate
        step upper-bounds every step), so a window/arrival/dispatch
        boundary is approached in a few geometrically-shrinking coasts and
        crossed by normal single steps.  Rows coast independently — all
        engine state is per-row, and per-row event order only needs `it`
        to grow per step — so the jumped state matches the stepped oracle
        to accumulation-order ulps."""
        act = st["active"]
        n = act.sum(1, dtype=I32)
        has_act = n > 0
        nf = n.to(F64)
        no_pf = ~(act & (st["prefill_left"] > 0)).any(1)
        c0 = (st["pos"] * act).sum(1).to(F64) \
            / torch.where(has_act, n, 1).to(F64)
        tau1 = (p["w_ms"] + (p["h0_ms"] * (c0 / p["l_calib"])) * nf) * 1e-3
        dtau = (p["h0_ms"] / p["l_calib"]) * nf * 1e-3
        big = 1 << 30
        bigf = float(1 << 30)

        def floor_div(x, y):
            return torch.floor(torch.clamp_max(x / y, bigf)).to(I32)

        # steps until the first slot event: done at max_new-gc, escalate at
        # esc-gc, ceiling at (window-1)-pos; coast strictly before the min
        rem = torch.minimum(torch.minimum(st["max_new"] - st["gen_count"],
                                          st["esc"] - st["gen_count"]),
                            (p["window"][:, None] - 1) - st["pos"])
        j_ev = torch.where(act, rem, big).amin(1) - 1

        remq = (qidx >= st["qpos"][:, None]) & (qidx < p["qlen"][:, None])
        has_q = remq.any(1)
        free_any = ((~act) & slot_ok).any(1)
        gap_a = torch.where(respect,                  # else "ready now"
                            torch.where(remq, p["q_ready"], inf).amin(1)
                            - sim, 0.0)
        after = sim > p["t1"]
        inwin = ~after & (sim >= p["t0"])
        gap_w = torch.where(inwin, p["t1"] - sim, p["t0"] - sim)
        d = p["dispatch_s"]

        def bounds(t_ub):
            j_win = torch.where(after, big, floor_div(gap_w, t_ub))
            # an arrival only binds while a free slot could accept it
            j_arr = torch.where(has_q & free_any,
                                floor_div(torch.clamp_min(gap_a, 0.0), t_ub),
                                big)
            # min(dispatch_s, tau) must not switch branch mid-jump
            j_dis = torch.where((d > tau1) & (dtau > 0),
                                floor_div(d - tau1, dtau) + 1, big)
            return torch.minimum(torch.minimum(j_win, j_arr), j_dis)

        t_ub = torch.clamp_min(tau1 + torch.clamp_min(j_ev - 1, 0) * dtau,
                               1e-12)
        j = torch.minimum(j_ev, bounds(t_ub))
        t_ub = torch.clamp_min(tau1 + torch.clamp_min(j - 1, 0) * dtau,
                               1e-12)
        j = torch.minimum(j_ev, bounds(t_ub))     # tightening pass
        go = has_act & no_pf & (j >= 1)
        jn = torch.where(go, j, 0)
        jf = jn.to(F64)
        span = jf * tau1 + dtau * (jf * (jf - 1) * 0.5)
        power = p["p_idle"] + logistic_power(nf)
        e = power * span
        dj = power * torch.where(d <= tau1, jf * d, span)
        win = go & inwin
        st["tokens"] = st["tokens"] + torch.where(go, jn * n, 0)
        st["joules"] = st["joules"] + torch.where(go, e, 0.0)
        st["dispatch_joules"] = st["dispatch_joules"] \
            + torch.where(go, dj, 0.0)
        st["m_tokens"] = st["m_tokens"] + torch.where(win, jn * n, 0)
        st["m_joules"] = st["m_joules"] + torch.where(win, e, 0.0)
        st["m_dispatch_joules"] = st["m_dispatch_joules"] \
            + torch.where(win, dj, 0.0)
        adv = torch.where(go, span, 0.0)
        st["slot_seconds"] = st["slot_seconds"] + nf * adv
        st["m_slot_seconds"] = st["m_slot_seconds"] \
            + nf * window_overlap(sim, sim + adv)
        coasted = act & go[:, None]
        st["gen_count"] = st["gen_count"] \
            + torch.where(coasted, jn[:, None], 0)
        st["pos"] = st["pos"] + torch.where(coasted, jn[:, None], 0)
        st["m_gen"] = st["m_gen"] \
            + torch.where(coasted & win[:, None], jn[:, None], 0)
        return st, sim + adv

    def prefill_step(st, sim):
        """Prefill-phase lockstep: drain up to one chunk across occupied
        slots oldest-first (stable sort on ready_ts, ties to the lowest
        slot); a slot whose prompt drains emits its handoff event."""
        n_occ = st["active"].sum(1, dtype=I32)
        pend = st["active"] & (st["prefill_left"] > 0)
        key = torch.where(pend, st["ready_ts"], inf)
        order = torch.argsort(key, dim=1, stable=True)
        inv = torch.argsort(order, dim=1)
        pl_srt = torch.gather(torch.where(pend, st["prefill_left"], 0), 1,
                              order)
        cum_excl = torch.cumsum(pl_srt, dim=1, dtype=I32) - pl_srt
        take_srt = torch.minimum(
            pl_srt, torch.clamp_min(p["chunk"][:, None] - cum_excl, 0))
        st, sim, t_after_srt = charge_prefill_span(
            st, take_srt, torch.zeros((I, S), dtype=F64, device=dev), sim)
        drained_srt = (take_srt > 0) & (take_srt == pl_srt)

        def unsort(a):
            return torch.gather(a, 1, inv)

        take = unsort(take_srt)
        drained = unsort(drained_srt)
        t_after = unsort(t_after_srt)
        st["prefill_left"] = st["prefill_left"] - take
        st = emit(st, drained, _EV_HANDOFF, t_after, ngen=1, first=t_after)
        st["active"] = st["active"] & ~drained
        st["gen_count"] = torch.where(drained, 0, st["gen_count"])
        st["esc"] = torch.where(drained, _NEVER, st["esc"])
        return st, sim, n_occ

    def body(st):
        st = dict(st)
        sim = st["sim_time"]
        active_any = st["active"].any(1)
        has_q = st["qpos"] < p["qlen"]
        # event-driven idle skip (respect_arrival only): rows with nothing
        # in flight jump to their queue's next arrival, idle power
        # accruing over the gap
        rem = (qidx >= st["qpos"][:, None]) & (qidx < p["qlen"][:, None])
        min_ready = torch.where(rem, p["q_ready"], inf).amin(1)
        dt = min_ready - sim
        do = respect & (~active_any) & has_q & (dt > 0)
        dtc = torch.where(do, dt, 0.0)
        e = p["p_idle"] * dtc
        ovl = window_overlap(sim, sim + dtc)
        e_in = torch.where(do & (ovl > 0), p["p_idle"] * ovl, 0.0)
        st["m_joules"] = st["m_joules"] + e_in
        st["m_idle_joules"] = st["m_idle_joules"] + e_in
        st["joules"] = st["joules"] + torch.where(do, e, 0.0)
        st["idle_joules"] = st["idle_joules"] + torch.where(do, e, 0.0)
        sim = sim + dtc
        t_start = sim
        st = admit(st, sim)
        if phase == "prefill":
            st, sim, n_occ = prefill_step(st, sim)
        else:
            st, sim, n_occ = decode_step(st, sim)
        st["slot_seconds"] = st["slot_seconds"] + n_occ * (sim - t_start)
        st["m_slot_seconds"] = st["m_slot_seconds"] \
            + n_occ * window_overlap(t_start, sim)
        if phase != "prefill":
            st, sim = coast(st, sim)
        st["sim_time"] = sim
        st["it"] = st["it"] + 1
        return st

    def cond(st):
        alive = st["active"].any() | (st["qpos"] < p["qlen"]).any()
        return alive & (st["it"] < p["max_iters"])

    for _ in range(STEPS_PER_REPLAY):
        go = cond(st)
        new = body(st)
        for k, v in st.items():
            v.copy_(torch.where(go, new[k], v))
    return cond(st)


class _Drain:
    """One shape class's static tensors: the packed inputs `p`, the state
    `st` and the `alive` flag, plus, on the card, the CUDA graph of
    `STEPS_PER_REPLAY` gated steps over them (captured on first use)."""

    def __init__(self, phase: str, I: int, S: int, Q: int,
                 like: Dict[str, np.ndarray], device: torch.device):
        self.phase, self.shape, self.device = phase, (I, S, Q), device
        self.p = {k: torch.empty(np.shape(v), dtype=_TORCH_DTYPE[
            np.asarray(v).dtype], device=device) for k, v in like.items()}
        self.st = {k: torch.empty(shape, dtype=dt, device=device)
                   for k, (shape, dt, _) in _state_spec(I, S, Q).items()}
        self.alive = torch.ones((), dtype=torch.bool, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def _steps(self) -> None:
        self.alive.copy_(_drain_one(self.p, self.st, phase=self.phase,
                                    n_slots_pad=self.shape[1]))

    def _capture(self) -> None:
        # warm up on a side stream (as CUDA-graph capture asks), then
        # capture; the warm-up's steps are undone by the caller's reset
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._steps()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._steps()

    def run(self, merged: Dict[str, np.ndarray], *,
            replay: bool = True) -> Dict[str, np.ndarray]:
        """Drain `merged` (packed arrays of this class's shape) to its end
        and return the final state on the host.  `replay=False` runs the
        steps eagerly on the card too (the graph's bit-equality check)."""
        for k, v in merged.items():
            self.p[k].copy_(torch.from_numpy(np.asarray(v)))
        use_graph = replay and self.device.type == "cuda"
        if use_graph and self.graph is None:
            _reset(self.st, *self.shape)
            self._capture()
        _reset(self.st, *self.shape)
        while True:
            if use_graph:
                self.graph.replay()
            else:
                self._steps()
            if not bool(self.alive):
                break
        return {k: v.cpu().numpy() for k, v in self.st.items()}


_DRAIN_CACHE: Dict[tuple, _Drain] = {}


def _get_drain(phase: str, i_pad: int, s_pad: int, q_pad: int,
               like: Dict[str, np.ndarray], device: torch.device) -> _Drain:
    key = (phase, i_pad, s_pad, q_pad, str(device))
    d = _DRAIN_CACHE.get(key)
    if d is None:
        d = _DRAIN_CACHE[key] = _Drain(phase, i_pad, s_pad, q_pad, like,
                                       device)
    return d


# --------------------------------------------------------------------------
# host side: pack queues, batch drains, reconstruct events
# --------------------------------------------------------------------------

# row-pad fills: benign values for instance rows that exist only to pad
# the concatenated batch up to its bucketed shape (qlen=0 / n_slots=0
# keeps them permanently idle; 1.0 in the divisor constants avoids
# spurious NaNs in their — discarded — accumulator rows)
_PAD_ONES = ("w_ms", "h0_ms", "l_calib", "pf_den")


def _merge(packed: List[Dict[str, np.ndarray]], i_pad: int,
           q_pad: int) -> Dict[str, np.ndarray]:
    """Stack packed pools row-wise into one (i_pad, q_pad) batch."""
    merged = {}
    for k in packed[0]:
        rows = [pk[k] for pk in packed]
        if np.ndim(rows[0]) == 0:       # max_iters: shared scalar
            merged[k] = np.asarray(max(rows), np.int32)
            continue
        if rows[0].ndim == 2:
            fill = np.inf if k == "q_ready" else (
                _NEVER if k == "q_esc" else 0)
            a = np.full((i_pad, q_pad), fill, rows[0].dtype)
        else:
            a = np.full((i_pad,), 1 if k in _PAD_ONES else 0, rows[0].dtype)
        off = 0
        for r in rows:
            n = r.shape[0]
            if r.ndim == 2:
                a[off:off + n, :r.shape[1]] = r
            else:
                a[off:off + n] = r
            off += n
        merged[k] = a
    return merged


def drain_engines(engines: Sequence["GraphPoolEngine"], *,
                  max_iters: int = 100_000,
                  pad_floors: Optional[Sequence[tuple]] = None) -> None:
    """Drain many pools (typically one per grid scenario) as a handful of
    graph-replayed calls.  Every piece of engine state is per-instance, so
    the pools *concatenate along the instance axis*: engines are grouped
    by device and padded (S, Q), their packed arrays stacked row-wise
    (per-pool scalars were broadcast to (I,) rows by `_pack`), and each
    group drains as one batch over the merged (sum-of-I, S/Q) arrays.
    Results are staged on each engine by row span; its next
    `run_until_drained` call finalizes instead of re-simulating.  Rows
    never pay padding for a neighbor pool's instance count or flag/chip
    constants — only S and Q are padded, and the row total rounds up to a
    power-of-two bucket.

    `pad_floors` is an optional list of (i_floor, s_cap, q_cap) shape
    classes: each engine joins the cheapest (s_cap, q_cap) class that
    fits it (falling back to per-engine power-of-two buckets), and the
    class's merged row count pads to at least `i_floor` so calls of
    slightly different pool mixtures land on one captured graph."""
    groups: Dict[tuple, List[GraphPoolEngine]] = {}
    packed = {}
    for eng in engines:
        params = eng._pack(max_iters)
        packed[id(eng)] = params
        S, Q = eng.n_slots, params["q_ready"].shape[1]
        dims = None
        if pad_floors:
            fits = [c for c in pad_floors if S <= c[1] and Q <= c[2]]
            if fits:        # cheapest by per-row footprint, then row floor
                dims = min(fits, key=lambda c: (c[1] + c[2], c[0]))
        if dims is None:
            dims = (1, _bucket(S), _bucket(Q))
        groups.setdefault((eng.phase, str(eng.device), *dims), []).append(eng)
    for (phase, _, i_floor, s_pad, q_pad), engs in groups.items():
        i_pad = _bucket(max(sum(e.instances for e in engs), i_floor))
        merged = _merge([packed[id(e)] for e in engs], i_pad, q_pad)
        out = _get_drain(phase, i_pad, s_pad, q_pad, merged,
                         engs[0].device).run(merged)
        off = 0
        for eng in engs:
            I, S = eng.instances, eng.n_slots
            Q = packed[id(eng)]["q_ready"].shape[1]
            res = {}
            for k, v in out.items():
                if v.ndim == 0:             # the shared `it` counter
                    res[k] = v
                    continue
                s = v[off:off + I]
                if s.ndim == 2:
                    s = s[:, :Q] if (k.startswith("out_")
                                     or k == "q_slot") else s[:, :S]
                res[k] = s
            eng._staged = res
            off += I


class GraphPoolEngine(BatchedPoolEngine):
    """Drop-in `BatchedPoolEngine` whose drive loop runs as torch steps,
    replayed as CUDA graphs on the card.

    Construction, submission, queue sorting, the outboxes and every
    aggregate the fleet simulator reads are inherited; only
    `run_until_drained` is replaced by pack -> drain -> reconstruct.
    `drain_engines` batches the drains of many engines (a scenario grid)
    into single calls and stages the results, which this method then just
    finalizes.  `device` defaults to "cuda" and raises without a card;
    `device="cpu"` runs the same steps eagerly."""

    def __init__(self, *, device="cuda", **kw):
        self.device = resolve_device(device)
        super().__init__(**kw)
        if self.phase != "prefill" and not self.prefill_chunk:
            raise NotImplementedError(
                "the unchunked immediate-prefill decode path advances the "
                "clock mid-admission and is not vectorizable; use the "
                "numpy BatchedPoolEngine or pass a prefill_chunk")
        self._staged: Optional[Dict[str, np.ndarray]] = None

    # --- pack -----------------------------------------------------------

    def _pack(self, max_iters: int) -> Dict[str, np.ndarray]:
        """Freeze queues into drain-ready arrays + per-row scalar params
        (the rows drain_engines stacks along the instance axis)."""
        self._freeze()
        I = self.instances
        Q = max(1, int(self.qlen.max()))
        q_ready = np.full((I, Q), np.inf)
        q_plen = np.zeros((I, Q), np.int32)
        q_maxnew = np.zeros((I, Q), np.int32)
        q_esc = np.full((I, Q), _NEVER, np.int32)
        q_pdone = np.zeros((I, Q), bool)
        for i, q in enumerate(self.queues):
            for j, r in enumerate(q):
                q_ready[i, j] = self._ready(r)
                q_plen[i, j] = r.prompt_len
                q_maxnew[i, j] = r.max_new_tokens
                if r.escalate_at is not None:
                    q_esc[i, j] = r.escalate_at
                q_pdone[i, j] = r.prefill_done
        prof, pm, rl = self.profile, self.profile.power_model, \
            self.profile.roofline

        # pool-level constants broadcast to (I,) so row-concatenated pools
        # with different chips/flags share one captured drain
        def ff(v):
            return np.full(I, v, np.float64)

        def fi(v):
            return np.full(I, v, np.int32)

        return dict(
            q_ready=q_ready, q_plen=q_plen, q_maxnew=q_maxnew, q_esc=q_esc,
            q_pdone=q_pdone, qlen=self.qlen.astype(np.int32),
            w_ms=ff(rl.w_ms), h0_ms=ff(rl.h0_ms), l_calib=ff(rl.l_calib),
            p_idle=ff(pm.p_idle_w), p_range=ff(pm.p_range_w),
            k=ff(pm.k), x0=ff(pm.x0), p_nom=ff(pm.p_nom_w),
            pf_num=ff(2.0 * self._streamed_params),
            pf_den=ff(prof.tp * prof.chip.peak_bf16_flops
                      * self.prefill_mfu),
            dispatch_s=ff(self.bank.dispatch_s),
            t0=ff(self.bank.measure_t0), t1=ff(self.bank.measure_t1),
            chunk=fi(self.prefill_chunk or 0),
            window=fi(self.window), n_slots=fi(self.n_slots),
            evict=np.full(I, self.evict_on_overflow, bool),
            respect=np.full(I, self.respect_arrival, bool),
            max_iters=np.int32(min(max_iters, np.iinfo(np.int32).max)))

    # --- drive ----------------------------------------------------------

    def run_until_drained(self, max_iters: int = 100_000) -> None:
        res = self._staged
        self._staged = None
        if res is None:
            drain_engines([self], max_iters=max_iters)
            res, self._staged = self._staged, None
        self._finalize(res, max_iters)

    # --- reconstruct ----------------------------------------------------

    def _finalize(self, res: Dict[str, np.ndarray],
                  max_iters: int) -> None:
        alive = bool(res["active"].any()) \
            or bool((res["qpos"] < self.qlen).any())
        if alive:
            qleft = int((self.qlen - res["qpos"]).sum())
            raise DrainTruncatedError(
                self.name, max_iters,
                f"{qleft} queued, {int(res['active'].sum())} in flight")
        b = self.bank
        for k in _METER_KEYS:
            getattr(b, k)[:] = res[k]
        b.sim_time_s[:] = res["sim_time"]
        self.slot_seconds[:] = res["slot_seconds"]
        self.m_slot_seconds[:] = res["m_slot_seconds"]
        self.preempted[:] = res["preempted"]
        self.n_escalated[:] = res["n_escalated"]
        self.qpos[:] = self.qlen
        self._refresh_heads(np.arange(self.instances))
        kinds, times = res["out_kind"], res["out_time"]
        firsts, ngens = res["out_first"], res["out_ngen"]
        tr = self.trace
        for i in range(self.instances):
            n = int(self.qlen[i])
            if not n:
                continue
            # numpy append order: step, then within a step the per-slot
            # event sweeps (slot-ascending) / the FIFO handoff charges
            # (time-ascending — identical within a decode step)
            order = np.lexsort((res["out_slot"][i, :n], times[i, :n],
                                res["out_step"][i, :n]))
            q = self.queues[i]
            for j in order:
                j = int(j)
                kind = int(kinds[i, j])
                assert kind != _EV_NONE, (self.name, i, j)
                req = q[j]
                t = float(times[i, j])
                if firsts[i, j] >= 0:
                    # the request's prompt drained here (chunk interleave):
                    # first token emitted at that instant
                    req.first_token_time = float(firsts[i, j])
                    req.n_generated = 1
                    if tr is not None:
                        tr.event(EV_FIRST_TOKEN, req.rid, self._trace_pool,
                                 i, req.first_token_time)
                if kind == _EV_DONE:
                    req.n_generated = int(ngens[i, j])
                    req.generated = None
                    req.finish_time = t
                    self.completed[i].append(req)
                    if tr is not None:
                        tr.event(EV_COMPLETE, req.rid, self._trace_pool,
                                 i, t)
                elif kind == _EV_HANDOFF:
                    req.n_generated = 1
                    req.generated = [int(
                        (np.int64(req.rid) * _LCG_A + self.seeds[i]
                         + _LCG_C) % self.vocab)]
                    req.prefill_done = True
                    req.ready_time = t
                    self.handoff[i].append(req)
                    self.relayed[i].append(req)
                    if tr is not None:
                        tr.event(EV_HANDOFF, req.rid, self._trace_pool, i, t)
                else:                       # overflow / escalation eviction
                    req.generated = None
                    req.prefill_done = False
                    req.preemptions += 1
                    req.ready_time = t
                    req.escalate_at = None
                    if kind == _EV_ESCALATE:
                        req.escalations += 1
                        self.escalated[i].append(req)
                        if tr is not None:
                            tr.event(EV_ESCALATE, req.rid, self._trace_pool,
                                     i, t)
                    else:
                        self.overflowed[i].append(req)
                        if tr is not None:
                            tr.event(EV_OVERFLOW, req.rid, self._trace_pool,
                                     i, t)
