"""llava-next-34b [vlm]: 60L d7168 56H (GQA kv=8) d_ff=20480 vocab=64000,
anyres tiling.  [hf:llava-hf/llava-v1.6-mistral-7b-hf]

The ViT/SigLIP vision tower + projector is the allowed modality stub:
`input_specs` supplies (B, n_patches, d_model) projected patch embeddings
(anyres tiling: base 576 + 4 tiles x 576 = 2880 patches) which the language
decoder consumes as a prefix.  Patch tokens inflate the effective context —
exactly the 1/W-law pressure the paper predicts for VLM serving.
"""
from repro_torch.models.spec import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="llava-next-34b", arch_type="vlm",
    d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000,
    unit=(BlockSpec("attn"), BlockSpec("mlp")), n_repeat=60,
    n_patches=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf")
