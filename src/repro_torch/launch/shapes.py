"""The four assigned input shapes + per-arch input_specs (meta-device
tensors: shapes and dtypes, zero allocation).

  train_4k     seq 4,096   global_batch 256   -> train step
  prefill_32k  seq 32,768  global_batch 32    -> prefill step
  decode_32k   seq 32,768  global_batch 128   -> serve step (1 new token,
                                                 KV cache of seq_len)
  long_500k    seq 524,288 global_batch 1     -> serve step; sub-quadratic
                                                 attention only

Applicability: long_500k runs for SSM / hybrid / native-SWA archs; dense /
MoE / VLM full-attention archs run it only as their explicit `-swa` variant;
whisper (enc-dec, 448-token decode horizon) skips it entirely.

Dtypes are the reference's: int32 token ids, bfloat16 patches and frames.
The port's model indexes with them as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..models import model as M
from ..models.spec import ArchConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def applicability(cfg: ArchConfig, shape: InputShape) -> Optional[str]:
    """None if the (arch, shape) pair runs; else the skip reason."""
    if shape.name != "long_500k":
        return None
    if cfg.encoder is not None:
        return "enc-dec full attention; whisper decode horizon is 448 tokens"
    sub_quadratic = (cfg.attn_block_count == 0          # pure SSM
                     or cfg.arch_type == "hybrid"        # Zamba2
                     or cfg.swa_window > 0)              # native / -swa SWA
    if not sub_quadratic:
        return ("full-attention KV at 524288 tokens; run the '-swa' variant "
                "config instead")
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, object]:
    """Abstract model inputs for one shape (meta tensors, no allocation).

    train:   {tokens, labels [, patches, frames]}
    prefill: {tokens [, patches, frames]}
    decode:  {tokens (B,1), cache, pos}
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        n_text = S - (cfg.n_patches or 0)
        out = {"tokens": _meta((B, n_text), torch.int32)}
        if shape.kind == "train":
            out["labels"] = _meta((B, n_text), torch.int32)
        if cfg.n_patches:
            out["patches"] = _meta((B, cfg.n_patches, cfg.d_model),
                                   torch.bfloat16)
        if cfg.encoder is not None:
            out["frames"] = _meta((B, min(cfg.encoder.n_frames, S // 4),
                                   cfg.d_model), torch.bfloat16)
        return out
    # decode: one token against a seq_len cache
    enc_frames = min(cfg.encoder.n_frames, S // 4) if cfg.encoder else 0
    cache = M.init_cache(cfg, B, S, enc_frames=enc_frames, device="meta")
    return {"tokens": _meta((B, 1), torch.int32),
            "cache": cache,
            "pos": _meta((B,), torch.int32)}
