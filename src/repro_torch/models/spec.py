"""Architecture specification for the unified model zoo.

A model is a repeating `unit` of blocks scanned `n_repeat` times (plus
embeddings, final norm, LM head, and optionally an encoder stack for
enc-dec models).  Mixed architectures (Zamba2's Mamba-with-shared-attention)
express their interleave inside the unit; blocks marked `shared=True` reuse
one parameter set across all repeats (Zamba2's shared attention block).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.modelspec import ModelSpec


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str              # attn | cross_attn | mlp | moe | mamba2 | rwkv6
    shared: bool = False   # share parameters across unit repeats


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """Encoder stack for enc-dec (Whisper): bidirectional attn + mlp."""

    n_layers: int
    n_frames: int          # stub frontend emits this many frame embeddings


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str         # dense | moe | hybrid | ssm | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    unit: Tuple[BlockSpec, ...]
    n_repeat: int
    head_dim: int = 0      # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0      # per-expert hidden dim
    capacity_factor: float = 1.25
    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    d_conv: int = 4
    expand: int = 2        # d_inner = expand * d_model
    # RWKV6
    rwkv_head_dim: int = 64
    # Attention details
    swa_window: int = 0    # 0 = full causal attention
    rope_theta: float = 5e5
    attn_bias: bool = False
    mlp_act: str = "swiglu"   # swiglu | gelu
    # Modality
    encoder: Optional[EncoderSpec] = None
    n_patches: int = 0     # VLM: image patch embeddings prepended
    # Misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""       # citation bracket from the assignment

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_layers(self) -> int:
        return len(self.unit) * self.n_repeat

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def attn_block_count(self) -> int:
        per_unit = sum(1 for b in self.unit if b.kind == "attn")
        return per_unit * self.n_repeat

    # --- parameter accounting (used by analytical profiles & FSDP plan) --
    def param_count(self) -> float:
        d, ff, v = self.d_model, self.d_ff, self.vocab
        total = float(v * d)                      # embed
        if not self.tie_embeddings:
            total += v * d                        # lm head
        total += d                                # final norm
        shared_done = set()
        for i, b in enumerate(self.unit):
            mult = 1 if b.shared else self.n_repeat
            if b.shared:
                if (b.kind, i) in shared_done:
                    continue
                shared_done.add((b.kind, i))
            total += self._block_params(b) * mult
        if self.encoder is not None:
            # encoder layer = bidirectional attn + mlp
            attn_p = d * (self.n_heads * self.hd) * 2 \
                + d * (self.n_kv_heads * self.hd) * 2 + 2 * d
            mlp_p = 2 * d * ff + d if self.mlp_act == "gelu" \
                else 3 * d * ff + d
            total += self.encoder.n_layers * (attn_p + mlp_p)
        return total

    def _block_params(self, b: BlockSpec) -> float:
        d, ff = self.d_model, self.d_ff
        H, K, hd = self.n_heads, self.n_kv_heads, self.hd
        if b.kind in ("attn", "cross_attn"):
            return d * H * hd + 2 * d * K * hd + H * hd * d + d
        if b.kind == "mlp":
            n_mat = 3 if self.mlp_act == "swiglu" else 2
            return n_mat * d * ff + d
        if b.kind == "moe":
            fe = self.moe_d_ff or ff
            return d * self.n_experts + self.n_experts * 3 * d * fe + d
        if b.kind == "mamba2":
            di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
            in_p = d * (2 * di + 2 * ds + nh)
            conv = self.d_conv * (di + 2 * ds)
            extra = 2 * nh + nh + di  # A_log, dt_bias, D, norm-ish
            return in_p + conv + extra + di * d + d
        if b.kind == "rwkv6":
            # time-mix (5 proj + decay lora) + channel-mix
            tm = (5 * d * d + 2 * d * 64 + 6 * d
                  + self.rwkv_heads * self.rwkv_head_dim)
            cm = 2 * d * ff + d * d + 2 * d
            return tm + cm + 2 * d
        raise ValueError(b.kind)

    def moe_active_params(self) -> Optional[float]:
        if not any(b.kind == "moe" for b in self.unit):
            return None
        dense = self.param_count()
        fe = self.moe_d_ff or self.d_ff
        per_moe_total = self.n_experts * 3 * self.d_model * fe
        per_moe_active = self.top_k * 3 * self.d_model * fe
        n_moe = sum(1 for b in self.unit if b.kind == "moe") * self.n_repeat
        return dense - n_moe * (per_moe_total - per_moe_active)

    # --- bridge into the analytical 1/W-law stack ------------------------
    def analytical_spec(self, dtype_bytes: float = 2.0) -> ModelSpec:
        attn_frac = (self.attn_block_count / self.n_layers
                     if self.n_layers else 0.0)
        n_kv = self.n_kv_heads if self.attn_block_count > 0 else 0
        state_bytes = 0.0
        if any(b.kind == "mamba2" for b in self.unit):
            state_bytes = (self.ssm_heads * self.ssm_head_dim * self.ssm_state
                           * 4.0)
        if any(b.kind == "rwkv6" for b in self.unit):
            state_bytes = (self.rwkv_heads * self.rwkv_head_dim ** 2 * 4.0)
        return ModelSpec(
            name=self.name, n_params=self.param_count(),
            n_layers=max(self.attn_block_count, 1),
            n_kv_heads=n_kv, head_dim=self.hd, dtype_bytes=dtype_bytes,
            n_active_params=self.moe_active_params(),
            state_bytes_per_layer=state_bytes,
            attn_layer_fraction=1.0)  # n_layers above == attn layers already

    def reduced(self, *, n_repeat: int = 2, d_model: int = 256,
                vocab: int = 512) -> "ArchConfig":
        """Smoke-test variant: same family, tiny dims (CPU-runnable)."""
        scale = d_model / self.d_model
        return dataclasses.replace(
            self, name=self.name + "-smoke", d_model=d_model,
            n_heads=max(2, min(4, self.n_heads)),
            n_kv_heads=max(1, min(2, self.n_kv_heads)),
            head_dim=d_model // max(2, min(4, self.n_heads)),
            d_ff=max(64, int(self.d_ff * scale) // 16 * 16),
            moe_d_ff=max(32, int((self.moe_d_ff or 64) * scale) // 16 * 16)
            if self.n_experts else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            # drop-free capacity (C >= T) so smoke tests are deterministic
            capacity_factor=float(min(self.n_experts, 4)
                                  / min(self.top_k, 2))
            if self.n_experts else 1.25,
            vocab=vocab, n_repeat=n_repeat,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            rwkv_head_dim=32,
            swa_window=min(self.swa_window, 64) if self.swa_window else 0,
            encoder=EncoderSpec(n_layers=2, n_frames=16)
            if self.encoder else None,
            n_patches=8 if self.n_patches else 0,
            dtype="float32")
