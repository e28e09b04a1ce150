"""Request abstraction for the serving runtime + latency percentiles."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

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
    n_generated: int = 0
    # router-visible output-length prediction (e.g. E[output] from the
    # workload trace).  None = oracle routing on the actual length.
    predicted_output: Optional[int] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def predicted_total(self) -> int:
        o = self.predicted_output if self.predicted_output is not None \
            else self.max_new_tokens
        return self.prompt_len + o


def latency_percentiles(reqs: Sequence[Request]) -> Dict[str, float]:
    """TTFT / TPOT / end-to-end percentiles over completed requests (sim
    time; arrival_time is submission into the fleet).  TTFT needs a first
    token, e2e a finish, TPOT both plus >1 generated token; the keys of
    empty populations are left out."""
    out: Dict[str, float] = {}
    if not reqs:
        return out
    arrival = np.array([r.arrival_time for r in reqs])
    first_token = np.array([r.first_token_time for r in reqs])
    finish = np.array([r.finish_time for r in reqs])
    n_generated = np.array([r.n_generated for r in reqs], np.int64)
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
