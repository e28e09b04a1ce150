"""yi-6b [dense]: 32L d4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-arch GQA.  [arXiv:2403.04652]
"""
from repro_torch.models.spec import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="yi-6b", arch_type="dense",
    d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000,
    unit=(BlockSpec("attn"), BlockSpec("mlp")), n_repeat=32,
    rope_theta=5e6,
    source="arXiv:2403.04652")
