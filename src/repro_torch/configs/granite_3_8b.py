"""granite-3-8b [dense]: 40L d4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base]
"""
from repro_torch.models.spec import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="granite-3-8b", arch_type="dense",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab=49155,
    unit=(BlockSpec("attn"), BlockSpec("mlp")), n_repeat=40,
    rope_theta=1e4,
    source="hf:ibm-granite/granite-3.0-2b-base")
