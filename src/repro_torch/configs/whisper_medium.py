"""whisper-medium [audio]: 24L d1024 16H (kv=16) d_ff=4096 vocab=51865,
enc-dec with conv frontend STUB.  [arXiv:2212.04356]

The mel-spectrogram + conv feature extractor is the allowed modality stub:
`input_specs` supplies (B, n_frames, d_model) frame embeddings.  The 24-layer
bidirectional encoder and the 24-layer decoder (self-attn + cross-attn + GELU
MLP) are fully implemented.  Decode shapes cache decoder self-attention KV;
long_500k is skipped (full attention, 448-token trained decode horizon).
"""
from repro_torch.models.spec import ArchConfig, BlockSpec, EncoderSpec

CONFIG = ArchConfig(
    name="whisper-medium", arch_type="audio",
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=51865,
    unit=(BlockSpec("attn"), BlockSpec("cross_attn"), BlockSpec("mlp")),
    n_repeat=24,
    mlp_act="gelu", attn_bias=True,
    encoder=EncoderSpec(n_layers=24, n_frames=1500),
    source="arXiv:2212.04356")
