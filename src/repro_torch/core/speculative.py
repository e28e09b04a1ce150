"""Beyond-paper: speculative decoding inside the P(b) framework
(paper §10.3: "whether this improves or degrades tok/W depends on the
draft model's power footprint and the verification hit rate — an open
problem within the P(b) framework").

Model: a draft model proposes L tokens per round; the target model
verifies them in ONE forward pass over L positions (compute-heavier but
still one weight stream).  With acceptance rate a, expected tokens per
round E = (1 - a^(L+1)) / (1 - a).  Per-round target latency is the
decode iteration with an L-fold wider token batch (weight stream W
unchanged, KV-scan term H * n * L'ish — decode stays bandwidth-bound, so
verification is nearly free until compute binds), plus the draft's L
sequential steps.  Power: the draft instance draws its own P(b).
"""
from __future__ import annotations

import dataclasses
from typing import List

from .modelspec import ModelSpec
from .profiles import BaseProfile


@dataclasses.dataclass(frozen=True)
class SpecPoint:
    accept_rate: float
    speculation_len: int
    tokens_per_round: float
    tok_per_watt: float
    speedup_vs_plain: float


def speculative_tok_per_watt(target: BaseProfile, draft: BaseProfile,
                             *, window: int = 8192,
                             accept_rate: float = 0.7,
                             speculation_len: int = 4,
                             utilization: float = 0.85,
                             draft_power_overhead: float = 0.08,
                             ) -> SpecPoint:
    """Co-located draft (sharded across the same TP group, the production
    design — a single-GPU draft's own KV scan at fleet concurrency costs
    as much per token as the TP-sharded target's, killing speculation).
    """
    n = max(target.n_max(window) * utilization, 1.0)
    L = speculation_len
    a = accept_rate
    exp_tokens = (1 - a ** (L + 1)) / (1 - a) if a < 1 else L + 1
    # target verify round: weight stream once + KV scan once per position
    tau_t = (target.roofline.w_ms
             + target.roofline.h_ms(window) * n) * 1e-3
    # draft co-located on the target's TP group: its per-step W and H
    # shrink by the TP factor relative to a standalone single-chip draft
    tp_scale = target.tp / max(draft.tp, 1)
    tau_d = L * (draft.roofline.w_ms / tp_scale
                 + draft.roofline.h_ms(window) / tp_scale * n) * 1e-3
    round_s = tau_t + tau_d
    tok_s = n * exp_tokens / round_s
    power = target.power_w(n) * (1.0 + draft_power_overhead)
    tpw = tok_s / power
    plain = target.tok_per_watt(n, window)
    return SpecPoint(accept_rate=a, speculation_len=L,
                     tokens_per_round=exp_tokens, tok_per_watt=tpw,
                     speedup_vs_plain=tpw / plain)


def sweep(target: BaseProfile, draft: BaseProfile, *, window: int = 8192,
          ) -> List[SpecPoint]:
    out = []
    for a in (0.5, 0.7, 0.8, 0.9):
        for L in (2, 4, 8):
            out.append(speculative_tok_per_watt(
                target, draft, window=window, accept_rate=a,
                speculation_len=L))
    return out
