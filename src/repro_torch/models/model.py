"""Decoder-stack model: init / forward / prefill / decode_step.

Parameters are a plain dict: `embed`, `final_norm`, `lm_head` (unless the
embeddings are tied) and `layers`, a list of `n_repeat` unit dicts keyed
`b{i}_{kind}` as in the reference.  Weights are stored (in, out) and used
as `x @ W`, the reference's layout, so `convert.py` copies them as they are.

This slice ports the dense attention + MLP unit.  Mixture-of-experts,
Mamba2, RWKV6, cross-attention, shared blocks, the encoder and patch
prefixes raise NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .. import resolve_device
from .attention import (attention_decode, attention_full, decode_index,
                        init_attention)
from .common import dense_init, dtype_of, rms_norm
from .mlp import apply_mlp, init_mlp
from .spec import ArchConfig

Params = Dict[str, Any]
Cache = Dict[str, Dict[str, torch.Tensor]]

_INIT = {"attn": init_attention, "mlp": init_mlp}


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for what this slice has not ported."""
    for b in cfg.unit:
        if b.kind not in _INIT:
            raise NotImplementedError(
                f"{cfg.name}: block kind {b.kind!r} is not ported yet"
                f" (ported: {sorted(_INIT)})")
        if b.shared:
            raise NotImplementedError(
                f"{cfg.name}: shared blocks are not ported yet")
    if cfg.encoder is not None:
        raise NotImplementedError(f"{cfg.name}: the encoder is not ported"
                                  " yet")
    if cfg.n_patches:
        raise NotImplementedError(f"{cfg.name}: patch prefixes are not"
                                  " ported yet")


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random weights drawn from `generator`, which must live on `device`."""
    device = resolve_device(device)
    check_supported(cfg)
    dt = dtype_of(cfg)
    params: Params = {
        "embed": dense_init(generator, (cfg.vocab, cfg.d_model), scale=0.02,
                            dtype=dt, device=device),
        "final_norm": torch.ones(cfg.d_model, dtype=torch.float32,
                                 device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab),
                                       dtype=dt, device=device)
    params["layers"] = [
        {f"b{i}_{b.kind}": _INIT[b.kind](generator, cfg, device)
         for i, b in enumerate(cfg.unit)}
        for _ in range(cfg.n_repeat)]
    return params


def _head(params: Params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            mode: str = "train"):
    """Full-sequence pass over tokens (B, S).

    mode="train":   returns logits (B, S, V)
    mode="prefill": returns (last_logits (B, 1, V), cache), the cache keyed
                    like `init_cache` with (n_repeat, B, S', K, hd) K/V,
                    S' = S or, under SWA, the ring-aligned last window.
    """
    check_supported(cfg)
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown forward mode {mode!r}")
    x = params["embed"][tokens]
    per_block: Dict[str, list] = {}
    for layer in params["layers"]:
        for i, b in enumerate(cfg.unit):
            name = f"b{i}_{b.kind}"
            if b.kind == "attn":
                x, c = attention_full(layer[name], cfg, x, mode=mode)
                if c is not None:
                    per_block.setdefault(name, []).append(c)
            else:
                x = apply_mlp(layer[name], cfg, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if mode == "prefill":
        cache = {name: {key: torch.stack([c[key] for c in cs])
                        for key in ("k", "v")}
                 for name, cs in per_block.items()}
        return x[:, -1:] @ _head(params, cfg), cache
    return x @ _head(params, cfg)


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                cache: Cache, pos, *, impl: Optional[str] = None,
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode iteration: tokens (B, 1), cache from prefill/init_cache.

    `pos` (host int or (B,) numpy array) is the absolute position of each
    new token.  The cache is updated in place and returned.  `impl` is
    passed to `ops.decode_attention` ("plain" runs the plain attention).
    This is the paper's tau(n, L) iteration: weight streaming + the KV scan
    over `pos` cached tokens.
    """
    check_supported(cfg)
    x = params["embed"][tokens]
    cache_len = next(iter(cache.values()))["k"].shape[2]
    idx = decode_index(cfg, pos, tokens.shape[0], cache_len, x.device)
    for r, layer in enumerate(params["layers"]):
        for i, b in enumerate(cfg.unit):
            name = f"b{i}_{b.kind}"
            if b.kind == "attn":
                x = attention_decode(
                    layer[name], cfg, x,
                    {"k": cache[name]["k"][r], "v": cache[name]["v"][r]},
                    idx, impl=impl)
            else:
                x = apply_mlp(layer[name], cfg, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), cache


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               device="cuda", dtype: Optional[torch.dtype] = None) -> Cache:
    """Zero decode cache: one (n_repeat, batch, slots, K, hd) K and V slab
    per attention block, slots = max_seq (or the SWA window if smaller)."""
    device = resolve_device(device)
    check_supported(cfg)
    dt = dtype or dtype_of(cfg)
    R, K, hd = cfg.n_repeat, cfg.n_kv_heads, cfg.hd
    slots = min(cfg.swa_window, max_seq) if cfg.swa_window else max_seq
    return {f"b{i}_attn": {key: torch.zeros((R, batch, slots, K, hd),
                                            dtype=dt, device=device)
                           for key in ("k", "v")}
            for i, b in enumerate(cfg.unit) if b.kind == "attn"}
