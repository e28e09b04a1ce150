"""grok-1-314b [moe]: 64L d6144 48H (GQA kv=8) expert d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1]

8 experts < 16-way model axis, so expert-parallelism alone cannot fill the
mesh: each expert's ffn dim is TP-sharded across the model axis instead
(see repro.models.moe and the sharding rules in repro.launch.sharding).
"""
from repro_torch.models.spec import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="grok-1-314b", arch_type="moe",
    d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab=131072,
    unit=(BlockSpec("attn"), BlockSpec("moe")), n_repeat=64,
    n_experts=8, top_k=2, moe_d_ff=32768,
    source="hf:xai-org/grok-1")
