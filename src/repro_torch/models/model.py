"""Decoder-stack model: init / forward / prefill / decode_step.

Parameters are a plain dict: `embed`, `final_norm`, `lm_head` (unless the
embeddings are tied), `layers`, a list of `n_repeat` unit dicts keyed
`b{i}_{kind}` as in the reference, and `shared`, one dict of the blocks
marked `shared` (Zamba2's attention + MLP pair), used at every repeat.
Weights are stored (in, out) and used as `x @ W`, the reference's layout,
so `convert.py` copies them as they are.

Ported block kinds: attention, MLP, mixture-of-experts, Mamba2 and RWKV6.
Cross-attention, the encoder and patch prefixes raise NotImplementedError.
The MoE block's aux loss is not returned: it waits for training.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .. import resolve_device
from .attention import (attention_decode, attention_full, decode_index,
                        init_attention)
from .common import dense_init, dtype_of, rms_norm
from .mlp import apply_mlp, init_mlp
from .moe import apply_moe, init_moe
from .spec import ArchConfig
from .ssm import (init_mamba2, init_rwkv6, mamba2_decode, mamba2_full,
                  rwkv6_decode, rwkv6_full)

Params = Dict[str, Any]
Cache = Dict[str, Dict[str, torch.Tensor]]

_INIT = {"attn": init_attention, "mlp": init_mlp, "moe": init_moe,
         "mamba2": init_mamba2, "rwkv6": init_rwkv6}
_FULL = {"mamba2": mamba2_full, "rwkv6": rwkv6_full}
_DECODE = {"mamba2": mamba2_decode, "rwkv6": rwkv6_decode}


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for what the port has not ported yet."""
    for b in cfg.unit:
        if b.kind not in _INIT:
            raise NotImplementedError(
                f"{cfg.name}: block kind {b.kind!r} is not ported yet"
                f" (ported: {sorted(_INIT)})")
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
         for i, b in enumerate(cfg.unit) if not b.shared}
        for _ in range(cfg.n_repeat)]
    shared = {f"b{i}_{b.kind}": _INIT[b.kind](generator, cfg, device)
              for i, b in enumerate(cfg.unit) if b.shared}
    if shared:
        params["shared"] = shared
    return params


def _head(params: Params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _blocks(params: Params, cfg: ArchConfig, r: int):
    """(name, spec, parameters) of repeat r's blocks, in unit order; a
    shared block gets the one parameter set of `params["shared"]`."""
    for i, b in enumerate(cfg.unit):
        name = f"b{i}_{b.kind}"
        p = params["shared"][name] if b.shared else params["layers"][r][name]
        yield name, b, p


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            mode: str = "train", impl: Optional[str] = None):
    """Full-sequence pass over tokens (B, S).

    mode="train":   returns logits (B, S, V)
    mode="prefill": returns (last_logits (B, 1, V), cache), the cache keyed
                    like `init_cache`, each leaf stacked over n_repeat:
                    attention K/V (n_repeat, B, S', K, hd) with S' = S or,
                    under SWA, the ring-aligned last window; the recurrent
                    blocks' O(1) state in `init_cache`'s shapes.
    `impl` is passed to the scans of `kernels.ops` ("plain" runs their
    plain versions).
    """
    check_supported(cfg)
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown forward mode {mode!r}")
    x = params["embed"][tokens]
    per_block: Dict[str, list] = {}
    for r in range(cfg.n_repeat):
        for name, b, p in _blocks(params, cfg, r):
            c = None
            if b.kind == "attn":
                x, c = attention_full(p, cfg, x, mode=mode)
            elif b.kind == "mlp":
                x = apply_mlp(p, cfg, x)
            elif b.kind == "moe":
                x = apply_moe(p, cfg, x)
            else:
                x, c = _FULL[b.kind](p, cfg, x, mode=mode, impl=impl)
            if c is not None:
                per_block.setdefault(name, []).append(c)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if mode == "prefill":
        cache = {name: {key: torch.stack([c[key] for c in cs])
                        for key in cs[0]}
                 for name, cs in per_block.items()}
        return x[:, -1:] @ _head(params, cfg), cache
    return x @ _head(params, cfg)


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                cache: Cache, pos, *, impl: Optional[str] = None,
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode iteration: tokens (B, 1), cache from prefill/init_cache.

    `pos` (host int or (B,) numpy array) is the absolute position of each
    new token.  The cache is updated in place and returned.  `impl` is
    passed to `ops.decode_attention` ("plain" runs the plain attention);
    the recurrent blocks take one plain step, as in the reference.
    This is the paper's tau(n, L) iteration: weight streaming + the KV scan
    over `pos` cached tokens (+ the O(1) state of recurrent blocks).
    """
    check_supported(cfg)
    x = params["embed"][tokens]
    idx = None
    attn = [f"b{i}_{b.kind}" for i, b in enumerate(cfg.unit)
            if b.kind == "attn"]
    if attn:
        idx = decode_index(cfg, pos, tokens.shape[0],
                           cache[attn[0]]["k"].shape[2], x.device)
    for r in range(cfg.n_repeat):
        for name, b, p in _blocks(params, cfg, r):
            c = cache.get(name)
            if b.kind == "attn":
                x = attention_decode(p, cfg, x, {"k": c["k"][r],
                                                 "v": c["v"][r]},
                                     idx, impl=impl)
            elif b.kind == "mlp":
                x = apply_mlp(p, cfg, x)
            elif b.kind == "moe":
                x = apply_moe(p, cfg, x)
            else:
                x, new = _DECODE[b.kind](p, cfg, x,
                                         {key: t[r] for key, t in c.items()})
                for key, t in new.items():
                    c[key][r] = t
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), cache


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               device="cuda", dtype: Optional[torch.dtype] = None) -> Cache:
    """Zero decode cache keyed by block name, in the reference's shapes
    and dtypes, one entry per repeat (of a shared block too): attention
    K/V hold `max_seq` slots (or the SWA window if smaller); Mamba2 and
    RWKV6 blocks hold O(1) state."""
    device = resolve_device(device)
    check_supported(cfg)
    dt = dtype or dtype_of(cfg)

    def zeros(*shape, dtype=dt):
        return torch.zeros((cfg.n_repeat, batch) + shape, dtype=dtype,
                           device=device)

    f32 = torch.float32
    cache: Cache = {}
    for i, b in enumerate(cfg.unit):
        name = f"b{i}_{b.kind}"
        if b.kind == "attn":
            slots = min(cfg.swa_window, max_seq) if cfg.swa_window \
                else max_seq
            cache[name] = {key: zeros(slots, cfg.n_kv_heads, cfg.hd)
                           for key in ("k", "v")}
        elif b.kind == "mamba2":
            cache[name] = {
                "conv": zeros(cfg.d_conv - 1,
                              cfg.d_inner + 2 * cfg.ssm_state, dtype=f32),
                "ssm": zeros(cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                             dtype=f32)}
        elif b.kind == "rwkv6":
            hd = cfg.rwkv_head_dim
            cache[name] = {"wkv": zeros(cfg.rwkv_heads, hd, hd, dtype=f32),
                           "shift_tm": zeros(cfg.d_model),
                           "shift_cm": zeros(cfg.d_model)}
    return cache
