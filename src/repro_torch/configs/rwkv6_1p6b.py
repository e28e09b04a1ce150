"""rwkv6-1.6b [ssm]: 24L d2048 (attention-free) d_ff=7168 vocab=65536,
Finch — data-dependent decay.  [arXiv:2404.05892]

Attention-free: O(1) recurrent state per layer, no KV growth — the
architecture for which the paper's 1/W law *vanishes* (n_max is set by
weights/activations, not context; see DESIGN.md §5 and the beyond-paper
analysis in EXPERIMENTS.md).
"""
from repro_torch.models.spec import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="rwkv6-1.6b", arch_type="ssm",
    d_model=2048, n_heads=32, n_kv_heads=0, head_dim=64,
    d_ff=7168, vocab=65536,
    unit=(BlockSpec("rwkv6"),), n_repeat=24,
    rwkv_head_dim=64,
    source="arXiv:2404.05892")
