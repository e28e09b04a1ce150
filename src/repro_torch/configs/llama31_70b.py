"""Llama-3.1-70B — the paper's own fleet model (Tables 1/3/4/5).
[arXiv:2407.21783]
"""
from repro_torch.models.spec import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="llama31-70b", arch_type="dense",
    d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256,
    unit=(BlockSpec("attn"), BlockSpec("mlp")), n_repeat=80,
    rope_theta=5e5,
    source="arXiv:2407.21783")
