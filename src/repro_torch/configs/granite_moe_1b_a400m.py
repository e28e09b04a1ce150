"""granite-moe-1b-a400m [moe]: 24L d1024 16H (GQA kv=8) expert d_ff=512,
vocab 49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.models.spec import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", arch_type="moe",
    d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    unit=(BlockSpec("attn"), BlockSpec("moe")), n_repeat=24,
    n_experts=32, top_k=8, moe_d_ff=512,
    rope_theta=1e4,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base")
