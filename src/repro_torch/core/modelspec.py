"""Analytical model description (the paper's Table 2 / Table 5 inputs).

`ModelSpec` is the *analytical* view of a model: just enough geometry for
the serving meter to price a prefill (`streamed_params`).  The executable
architectures live in `repro_torch.models`; `ArchConfig.analytical_spec()`
bridges each of them into this form.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    n_params: float                 # total parameters
    n_layers: int
    n_kv_heads: int                 # GQA KV heads (0 for attention-free)
    head_dim: int
    dtype_bytes: float = 2.0        # fp16/bf16 by default; 1.0 for fp8
    n_active_params: Optional[float] = None   # MoE: active params / token
    # Attention-free / hybrid geometry: recurrent state bytes per sequence
    # per layer (replaces KV growth; O(1) in context length).
    state_bytes_per_layer: float = 0.0
    attn_layer_fraction: float = 1.0  # hybrid: fraction of layers with KV

    @property
    def is_moe(self) -> bool:
        return (self.n_active_params is not None
                and self.n_active_params < self.n_params)

    @property
    def streamed_params(self) -> float:
        """Parameters touched per decode iteration (§3.2 MoE override)."""
        return self.n_active_params if self.is_moe else self.n_params


# The paper's reference model (Table 2 / §4).
LLAMA31_70B = ModelSpec("Llama-3.1-70B", n_params=70.6e9, n_layers=80,
                        n_kv_heads=8, head_dim=128)
