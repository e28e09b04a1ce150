"""command-r-plus-104b [dense]: 64L d12288 96H (GQA kv=8) d_ff=33792
vocab=256000, GQA, no bias.  [hf:CohereForAI/c4ai-command-r-v01]
"""
from repro_torch.models.spec import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="command-r-plus-104b", arch_type="dense",
    d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab=256000,
    unit=(BlockSpec("attn"), BlockSpec("mlp")), n_repeat=64,
    attn_bias=False, rope_theta=7.5e4,
    source="hf:CohereForAI/c4ai-command-r-v01")
