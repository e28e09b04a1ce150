"""Llama-3.1-8B — the paper's semantic-routing small model (§5.1).
[arXiv:2407.21783]
"""
from repro_torch.models.spec import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="llama31-8b", arch_type="dense",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256,
    unit=(BlockSpec("attn"), BlockSpec("mlp")), n_repeat=32,
    rope_theta=5e5,
    source="arXiv:2407.21783")
