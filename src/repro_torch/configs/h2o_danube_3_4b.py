"""h2o-danube-3-4b [dense]: 24L d3840 32H (GQA kv=8) d_ff=10240 vocab=32000,
llama+mistral mix with sliding-window attention.  [arXiv:2401.16818]

The native SWA (window 4096) gives this dense model a bounded KV cache, so
long_500k decode is feasible with a ring-buffer cache — the one dense arch
that runs the long-context shape without a variant config.
"""
from repro_torch.models.spec import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", arch_type="dense",
    d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10240, vocab=32000,
    unit=(BlockSpec("attn"), BlockSpec("mlp")), n_repeat=24,
    swa_window=4096, rope_theta=1e4,
    source="arXiv:2401.16818")
