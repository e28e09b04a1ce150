"""Request abstraction for the serving runtime, trace sampling and latency
percentiles (one source of the clipping rules and metric definitions)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int token ids
    max_new_tokens: int
    arrival_time: float = 0.0
    # runtime state
    generated: Optional[List[int]] = None
    pool: str = ""
    finish_time: float = -1.0
    first_token_time: float = -1.0
    preemptions: int = 0
    n_generated: int = 0
    # admission gate after an overflow migration or escalation; latency
    # metrics keep counting from the original arrival_time
    ready_time: Optional[float] = None
    # router-visible output-length prediction (e.g. E[output] from the
    # workload trace).  None = oracle routing on the actual length.
    predicted_output: Optional[int] = None
    # disaggregated serving: a dedicated prefill pool already drained the
    # prompt (its KV arrives over the interconnect), so the decode pool
    # must not re-charge or re-run prefill; `prefill_role` names the
    # router role that drained it
    prefill_done: bool = False
    prefill_role: str = ""
    # semantic routing: set by the router when the classifier misroutes a
    # true-large request into the small-model pool; the engine evicts it
    # after `escalate_at` decode tokens (the quality monitor's detection
    # latency) and it is re-served from scratch in the large pool.
    # `escalations` counts those hops; `misrouted` marks every flipped
    # decision (short-into-large too, which never escalates).
    misrouted: bool = False
    escalate_at: Optional[int] = None
    escalations: int = 0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def predicted_total(self) -> int:
        o = self.predicted_output if self.predicted_output is not None \
            else self.max_new_tokens
        return self.prompt_len + o

    @property
    def done(self) -> bool:
        """Finished generating: n_generated is authoritative (the engine
        keeps in-flight counts in its slot arrays and flushes at finish;
        analytical-mode requests never materialise `generated`)."""
        n = max(self.n_generated, len(self.generated or ()))
        return n >= self.max_new_tokens


def _clip(lens, ts, max_total: int) -> List[Tuple[int, int, float]]:
    out = []
    for i, (p, o) in enumerate(lens):
        p = int(min(p, max_total - 1))
        o = int(min(o, max_total - p))
        out.append((max(p, 1), max(o, 1), float(ts[i])))
    return out


def sample_trace(workload, n: int, *, seed: int = 0, max_total: int = 4096,
                 arrival_rate: Optional[float] = None,
                 ) -> List[Tuple[int, int, float]]:
    """(prompt_len, output_len, arrival_time) triples: workload lengths
    clipped to max_total and Poisson arrivals."""
    lens = workload.sample_requests(n, seed=seed)
    rng = np.random.default_rng(seed + 7)
    lam = arrival_rate if arrival_rate is not None else workload.arrival_rate
    ts = np.cumsum(rng.exponential(1.0 / lam, size=n))
    return _clip(lens, ts, max_total)


def sample_diurnal_trace(workload, profile, t_end: float, *, seed: int = 0,
                         max_total: int = 4096,
                         ) -> List[Tuple[int, int, float]]:
    """(prompt_len, output_len, arrival_time) triples under a
    `core.workloads.DiurnalProfile` envelope on [0, t_end): arrival times
    from the profile's exact time-rescaled sampler, lengths and clipping
    as `sample_trace`'s."""
    ts = profile.sample_arrivals(t_end, seed=seed)
    lens = workload.sample_requests(len(ts), seed=seed)
    return _clip(lens, ts, max_total)


def synthetic_requests(workload, n: int, vocab: int, *, seed: int = 0,
                       max_total: int = 4096) -> List[Request]:
    """`sample_trace` lengths and arrivals with synthetic token ids."""
    rng = np.random.default_rng(seed + 7)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=p),
                    max_new_tokens=o, arrival_time=t)
            for i, (p, o, t) in enumerate(
                sample_trace(workload, n, seed=seed, max_total=max_total))]


def latency_percentiles(reqs: Sequence[Request]) -> Dict[str, float]:
    """TTFT / TPOT / end-to-end percentiles over completed requests (sim
    time; arrival_time is submission into the fleet)."""
    if not reqs:
        return {}
    return latency_percentiles_arrays(
        np.array([r.arrival_time for r in reqs]),
        np.array([r.first_token_time for r in reqs]),
        np.array([r.finish_time for r in reqs]),
        np.array([r.n_generated for r in reqs], np.int64))


def latency_percentiles_arrays(arrival: np.ndarray, first_token: np.ndarray,
                               finish: np.ndarray, n_generated: np.ndarray,
                               *, strict_keys: bool = False,
                               ) -> Dict[str, float]:
    """Column-oriented `latency_percentiles`.  TTFT needs a first token,
    e2e a finish, TPOT both plus >1 generated token.  By default the keys
    of empty populations are left out; `strict_keys=True` returns all five
    keys, NaN marking "no observations"."""
    out: Dict[str, float] = {}
    if strict_keys:
        out = {k: float("nan") for k in ("ttft_p50_s", "ttft_p99_s",
                                         "e2e_p99_s", "tpot_p50_ms",
                                         "tpot_p99_ms")}
    if not len(arrival):
        return out
    ttft = (first_token - arrival)[first_token >= 0]
    e2e = (finish - arrival)[finish >= 0]
    tmask = (finish >= 0) & (first_token >= 0) & (n_generated > 1)
    tpot = (finish[tmask] - first_token[tmask]) \
        / (n_generated[tmask] - 1)
    if len(ttft):
        out["ttft_p50_s"] = round(float(np.quantile(ttft, 0.5)), 4)
        out["ttft_p99_s"] = round(float(np.quantile(ttft, 0.99)), 4)
    if len(e2e):
        out["e2e_p99_s"] = round(float(np.quantile(e2e, 0.99)), 4)
    if len(tpot):
        out["tpot_p50_ms"] = round(float(np.quantile(tpot, 0.5)) * 1e3, 3)
        out["tpot_p99_ms"] = round(float(np.quantile(tpot, 0.99)) * 1e3, 3)
    return out
