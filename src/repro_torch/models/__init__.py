"""Model zoo in PyTorch: plain functions over parameter dicts.

`model.py` runs every block kind of `spec.ArchConfig` (attention,
cross-attention, MLP, MoE, Mamba2, RWKV6), whisper's encoder and llava's
patch prefix, in train, prefill and decode modes, and `loss_fn`;
`convert.py` moves weights between the reference's layout and the port's.
"""
