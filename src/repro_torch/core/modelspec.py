"""Analytical model description (the paper's Table 2 / Table 5 inputs).

`ModelSpec` is the *analytical* view of a model: just enough geometry for
the serving meter to price a prefill (`streamed_params`) and for a
computed profile to size weight streaming and KV bytes per token (the MoE
lever of `core.moe`, Table 2).  The executable
architectures live in `repro_torch.models`; `ArchConfig.analytical_spec()`
bridges each of them into this form.
"""
from __future__ import annotations

import dataclasses
import math
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

    def weight_bytes(self, *, active_only: bool = True) -> float:
        p = self.streamed_params if active_only else self.n_params
        return p * self.dtype_bytes

    def kv_bytes_per_token(self, *, tp: int = 1, kv_sharded: bool = True,
                           overhead: float = 1.0) -> float:
        """kappa: KV bytes per token per GPU.

        kv_sharded=True  -> TP-sharded GQA storage (paper Table 1 / fleet
                            results): each GPU stores n_kv/TP heads (>=1).
        kv_sharded=False -> full replication per GPU (paper Table 2
                            ComputedProfile behaviour).
        """
        if self.n_kv_heads == 0:
            return 0.0  # attention-free: no per-token KV growth
        if kv_sharded:
            # Each GPU stores ceil(n_kv / TP) heads, floor 1 (a head cannot
            # be split; TP > n_kv replicates single heads across ranks).
            heads = float(max(math.ceil(self.n_kv_heads / tp), 1))
        else:
            heads = float(self.n_kv_heads)
        per_layer = 2.0 * heads * self.head_dim * self.dtype_bytes
        return per_layer * self.n_layers * self.attn_layer_fraction * overhead


# The paper's own models (Table 2 / §4): the dense Llama-3.1 family and the
# two MoEs of the §3.2 lever.
LLAMA31_8B = ModelSpec("Llama-3.1-8B", n_params=8.03e9, n_layers=32,
                       n_kv_heads=8, head_dim=128)
LLAMA31_70B = ModelSpec("Llama-3.1-70B", n_params=70.6e9, n_layers=80,
                        n_kv_heads=8, head_dim=128)
LLAMA31_405B = ModelSpec("Llama-3.1-405B", n_params=405e9, n_layers=126,
                         n_kv_heads=8, head_dim=128)
QWEN3_235B_A22B = ModelSpec("Qwen3-235B-A22B", n_params=235e9, n_layers=94,
                            n_kv_heads=4, head_dim=128, n_active_params=22e9)
DEEPSEEK_V3 = ModelSpec("DeepSeek-V3", n_params=671e9, n_layers=61,
                        n_kv_heads=1, head_dim=576,  # MLA compressed KV
                        dtype_bytes=1.0, n_active_params=37e9)

PAPER_MODELS = {m.name: m for m in
                (LLAMA31_8B, LLAMA31_70B, LLAMA31_405B, QWEN3_235B_A22B,
                 DEEPSEEK_V3)}
