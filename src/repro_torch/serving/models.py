"""Model-heterogeneity registry: which model each pool role serves.

`ModelProfileRegistry` binds each router role to its own `ModelBinding`:
the analytical `ModelSpec` (streamed params for prefill/decode charging,
KV geometry for handoff sizing), the `BaseProfile` the pool's engines run
on, and the MoE dispatch floor used for per-iteration energy attribution
(the dispatch latency itself lives inside the profile's roofline, see
`core.moe.with_dispatch_floor`, so time and energy cannot disagree; the
binding's `dispatch_ms` only labels the share).  This is what lets two
pools serve different models: semantic routing (§5.1, a small model behind
the short window, the large model behind the long one) and MoE
active-parameter streaming (§3.2).  Homogeneous topologies get a registry
with only a default binding.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..core.modelspec import ModelSpec
from ..core.profiles import BaseProfile


@dataclasses.dataclass(frozen=True)
class ModelBinding:
    """One pool role's serving identity."""

    model: ModelSpec
    profile: BaseProfile
    # MoE expert-dispatch floor folded into profile.roofline.w_ms (ms).
    # Kept on the binding so meters can attribute the dispatch share of
    # each decode iteration's energy (EnergyMeter.dispatch_joules).
    dispatch_ms: float = 0.0

    @property
    def streamed_params(self) -> float:
        return self.model.streamed_params

    def kv_bytes_per_instance_token(self,
                                    profile: Optional[BaseProfile] = None,
                                    ) -> float:
        """Whole-instance KV bytes per prompt token — what a prefill ->
        decode handoff moves over the interconnect per token (the
        per-GPU KV share times the TP degree of the pool the prefill ran
        on; pass `profile` when the pool runs on a different deployment
        than the binding's default)."""
        prof = profile if profile is not None else self.profile
        return self.model.kv_bytes_per_token(tp=prof.tp) * prof.tp


@dataclasses.dataclass
class ModelProfileRegistry:
    """role -> ModelBinding, with a default for unbound roles."""

    default: ModelBinding
    bindings: Dict[str, ModelBinding] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def homogeneous(cls, model: ModelSpec, profile: BaseProfile, *,
                    dispatch_ms: float = 0.0) -> "ModelProfileRegistry":
        return cls(default=ModelBinding(model=model, profile=profile,
                                        dispatch_ms=dispatch_ms))

    def bind(self, role: str, binding: ModelBinding) -> "ModelProfileRegistry":
        self.bindings[role] = binding
        return self

    def for_role(self, role: str) -> ModelBinding:
        return self.bindings.get(role, self.default)

    def streamed_params_by_role(self, roles) -> Dict[str, float]:
        """Per-role streamed params in `core.fleet.apply_overrides` form."""
        return {r: self.for_role(r).streamed_params for r in roles}

    @property
    def heterogeneous(self) -> bool:
        return any(b.model is not self.default.model
                   or b.profile is not self.default.profile
                   for b in self.bindings.values())
