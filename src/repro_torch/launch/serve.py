"""Serving launcher: context-length-routed pools over a real model.

Requests drawn from a reconstructed trace are routed (homo / two_pool /
fleetopt) into continuous-batching PoolEngines on the card; every decode
iteration is charged P(b) * tau, and the fleet report compares measured
tok/W across topologies — the Table-3 experiment as an executing system.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --requests 24

The CLI serves the `.reduced()` config, as the reference launcher does;
`run_policies` takes any config and weights (`chip_smoke.py` passes the
full-width one).  All pools of all policies share one set of weights.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..core.profiles import H100_LLAMA70B
from ..core.workloads import WORKLOADS
from ..models import model as M
from ..serving import ContextRouter, PoolEngine, Request, RouterPolicy

POLICIES = ("homo", "two_pool", "fleetopt")


def build_router(cfg, params, policy: str, *, b_short: int, window_long: int,
                 profile, p99_output: int = 8) -> ContextRouter:
    if policy == "homo":
        pools = {"long": PoolEngine(cfg, params, window=window_long,
                                    profile=profile, n_slots=4, name="long")}
        return ContextRouter(pools, RouterPolicy(
            kind="homo", ladder=[("long", math.inf)]))
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; known: {POLICIES}")
    pools = {
        "short": PoolEngine(cfg, params, window=2 * b_short, profile=profile,
                            n_slots=16, name="short"),
        "long": PoolEngine(cfg, params, window=window_long, profile=profile,
                           n_slots=4, name="long"),
    }
    # explicit admission ladders: two_pool admits at b_short on the
    # conservative prompt + p99 metric; fleetopt at gamma * b_short on
    # predicted total
    boundary = float(b_short) if policy == "two_pool" \
        else float(int(2.0 * b_short))
    return ContextRouter(pools, RouterPolicy(
        kind=policy, b_short=b_short, gamma=2.0, p99_output=p99_output,
        metric_kind="prompt_plus_p99" if policy == "two_pool"
        else "predicted_total",
        ladder=[("short", boundary), ("long", math.inf)]))


def demo_requests(vocab: int, workload: str, n: int,
                  window_long: int) -> List[Request]:
    """Draw raw trace lengths, then scale the whole distribution into the
    demo windows (scaling preserves the short/long mix; clipping doesn't)."""
    lens = WORKLOADS[workload].sample_requests(n, seed=0).astype(float)
    scale = (window_long - 8) / float(np.quantile(lens.sum(1), 0.99))
    rng = np.random.default_rng(7)
    reqs = []
    for i, (p, o) in enumerate(lens * scale):
        p = int(np.clip(p, 1, window_long - 9))
        o = int(np.clip(o, 1, window_long - 8 - p))
        reqs.append(Request(rid=i, prompt=rng.integers(0, vocab, size=p),
                            max_new_tokens=o))
    return reqs


def run_policies(cfg, params, *, workload: str = "azure-conv",
                 requests: int = 24, b_short: int = 24,
                 window_long: int = 192, policies: Sequence[str] = POLICIES,
                 max_iters: int = 20000) -> Dict[str, dict]:
    """Serve one request stream under each policy; returns
    {policy: {"report": per-pool + fleet report, "engines": {name: engine}}}.
    """
    base = demo_requests(cfg.vocab, workload, requests, window_long)
    p99_out = int(np.quantile([r.max_new_tokens for r in base], 0.99)) + 1
    results = {}
    for policy in policies:
        router = build_router(cfg, params, policy, b_short=b_short,
                              window_long=window_long,
                              profile=H100_LLAMA70B, p99_output=p99_out)
        report = router.run(copy.deepcopy(base), max_iters=max_iters)
        results[policy] = {"report": report, "engines": router.pools}
    return results


def fleetopt_gain(results: Dict[str, dict]) -> float:
    """FleetOpt / homo fleet tok/W (metered P(b) * tau)."""
    return (results["fleetopt"]["report"]["fleet"]["tok_per_watt"]
            / results["homo"]["report"]["fleet"]["tok_per_watt"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--workload", default="azure-conv",
                    choices=list(WORKLOADS))
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--b-short", type=int, default=24)
    ap.add_argument("--window-long", type=int, default=192)
    ap.add_argument("--policies", default="homo,two_pool,fleetopt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    results = run_policies(cfg, params, workload=args.workload,
                           requests=args.requests, b_short=args.b_short,
                           window_long=args.window_long,
                           policies=args.policies.split(","))
    for policy, res in results.items():
        print(f"\n== {policy} ==")
        for name, stats in res["report"].items():
            print(" ", name, json.dumps(stats))
    if {"homo", "fleetopt"} <= results.keys():
        print(f"\nFleetOpt vs Homo tok/W gain: {fleetopt_gain(results):.2f}x"
              " (paper fleet-scale: ~2.5x)")


if __name__ == "__main__":
    main()
