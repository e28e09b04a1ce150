"""Autoscaling policy knobs (declarative config only).

The *mechanics* — planning per-instance online windows from a routed
trace and rebuilding the pool engines — live in `serving.autoscale`;
this module holds only the frozen policy dataclass so the topology IR
(`core.topospec.TopologySpec.autoscale`) can carry the knob without the
core layer importing serving.

The controller this configures is deliberately the boring production
one: reactive rate tracking.  Each pool watches its own per-epoch
arrival rate (the RPS signal every serving autoscaler exports), targets
`target_utilization` of the per-instance service rate the *peak* sizing
plan established, reacts one control epoch behind the signal, pays
`scaleup_lag_s` of control-plane actuation plus a weight-load time
derived from the model's byte size before new capacity serves, and only
sheds capacity after the demand signal has been low for
`scaledown_delay_s` (hysteresis).  No oracle knowledge of the diurnal
envelope enters the loop — the measured whole-day tok/W therefore pays
every reaction lag and every warm spare the real policy would.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Per-pool reactive autoscaling configuration.

    `weight_load_Bps` is the bandwidth new capacity streams model bytes
    at before it can serve (PCIe gen5 x16 host -> HBM ~ 60 GB/s); the
    load *duration* is derived per pool from its `ModelProfileRegistry`
    binding's weight bytes, so a 70B pool pays a longer cold start than
    an 8B one.  `min_frac` floors the pool at a fraction of its peak
    instance count (>= 1 instance always stays online).
    `spare_instances` is N+1-style redundancy: held on top of the
    rate-derived target so a small pool (where one instance is a big
    fraction of capacity) is not quantized straight to the critical
    point — its idle draw is exactly the warm-spare power the fleet
    report charges."""

    control_interval_s: float = 60.0
    target_utilization: float = 0.85
    scaleup_lag_s: float = 30.0
    scaledown_delay_s: float = 300.0
    min_frac: float = 0.1
    weight_load_Bps: float = 60e9
    spare_instances: int = 1

    def __post_init__(self):
        if self.control_interval_s <= 0:
            raise ValueError("control_interval_s must be positive")
        if not 0.0 < self.target_utilization <= 1.0:
            raise ValueError("target_utilization must be in (0, 1]")
        if self.scaleup_lag_s < 0 or self.scaledown_delay_s < 0:
            raise ValueError("lag/delay must be non-negative")
        if not 0.0 <= self.min_frac <= 1.0:
            raise ValueError("min_frac must be in [0, 1]")
        if self.weight_load_Bps <= 0:
            raise ValueError("weight_load_Bps must be positive")
        if self.spare_instances < 0:
            raise ValueError("spare_instances must be non-negative")

    def canon(self) -> tuple:
        """Canonical tuple for `TopologySpec.spec_hash` embedding."""
        return ("autoscale", self.control_interval_s,
                self.target_utilization, self.scaleup_lag_s,
                self.scaledown_delay_s, self.min_frac, self.weight_load_Bps,
                self.spare_instances)
