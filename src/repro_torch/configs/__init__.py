"""Architecture config registry.

`get_config(name)` resolves an assigned architecture id (plus the paper's own
llama models).  A `-swa` suffix returns a sliding-window *variant* (window
4096) of a full-attention arch — the explicit opt-in that makes the
long_500k decode shape feasible for dense/MoE/VLM models (DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.models.spec import ArchConfig

from . import (command_r_plus_104b, granite_3_8b, granite_moe_1b_a400m,
               grok_1_314b, h2o_danube_3_4b, llama31_8b, llama31_70b,
               llava_next_34b, rwkv6_1p6b, whisper_medium, yi_6b, zamba2_2p7b)

ASSIGNED: Dict[str, ArchConfig] = {
    "granite-moe-1b-a400m": granite_moe_1b_a400m.CONFIG,
    "zamba2-2.7b": zamba2_2p7b.CONFIG,
    "whisper-medium": whisper_medium.CONFIG,
    "h2o-danube-3-4b": h2o_danube_3_4b.CONFIG,
    "llava-next-34b": llava_next_34b.CONFIG,
    "granite-3-8b": granite_3_8b.CONFIG,
    "yi-6b": yi_6b.CONFIG,
    "rwkv6-1.6b": rwkv6_1p6b.CONFIG,
    "command-r-plus-104b": command_r_plus_104b.CONFIG,
    "grok-1-314b": grok_1_314b.CONFIG,
}

PAPER_ARCHS: Dict[str, ArchConfig] = {
    "llama31-70b": llama31_70b.CONFIG,
    "llama31-8b": llama31_8b.CONFIG,
}

ARCHS: Dict[str, ArchConfig] = {**ASSIGNED, **PAPER_ARCHS}

SWA_VARIANT_WINDOW = 4096


def get_config(name: str) -> ArchConfig:
    if name.endswith("-swa"):
        base = get_config(name[: -len("-swa")])
        if base.swa_window or not base.attn_block_count:
            raise ValueError(f"{base.name} has no full-attention to window")
        return dataclasses.replace(base, name=name,
                                   swa_window=SWA_VARIANT_WINDOW)
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


def list_archs() -> List[str]:
    return sorted(ASSIGNED)
