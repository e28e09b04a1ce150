"""zamba2-2.7b [hybrid]: 54L d2560 32H (GQA kv=32) d_ff=10240 vocab=32000,
Mamba2 (state 64) + shared attention blocks.  [arXiv:2411.15242]

Unit = 5 Mamba2 blocks followed by the *shared* attention + MLP pair
(one parameter set reused at every repeat — Zamba2's shared-block design);
9 repeats -> 45 Mamba2 + 9 shared-attn applications ~ 54 layers.
"""
from repro_torch.models.spec import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="zamba2-2.7b", arch_type="hybrid",
    d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000,
    unit=(BlockSpec("mamba2"), BlockSpec("mamba2"), BlockSpec("mamba2"),
          BlockSpec("mamba2"), BlockSpec("mamba2"),
          BlockSpec("attn", shared=True), BlockSpec("mlp", shared=True)),
    n_repeat=9,
    ssm_state=64, ssm_head_dim=64, expand=2,
    source="arXiv:2411.15242")
