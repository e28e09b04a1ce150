"""Decoder-stack model: init / forward / prefill / decode_step / loss.

Parameters are a plain dict: `embed`, `final_norm`, `lm_head` (unless the
embeddings are tied), `layers`, a list of `n_repeat` unit dicts keyed
`b{i}_{kind}` as in the reference, `shared`, one dict of the blocks
marked `shared` (Zamba2's attention + MLP pair), used at every repeat,
and, for an encoder-decoder (whisper), `encoder`: {"layers": a list of
`encoder.n_layers` dicts {"b0_attn", "b1_mlp"}, "final_norm"}.  Weights
are stored (in, out) and used as `x @ W`, the reference's layout, so
`convert.py` copies them as they are.

Under an ambient mesh (`common.set_mesh`) parameters, cache and batch
may be DTensors placed by `launch.sharding`: the reference's `constrain`
sites pin the residual stream to batch sharding (sequence-sharded over
`model` under `seq_shard_residual`) and the logits to vocab-parallel, and
further sites place what DTensor's propagation cannot (PERF.md lists
them).  On plain tensors every site is a no-op.

Block kinds: attention, cross-attention, MLP, mixture-of-experts, Mamba2
and RWKV6.  whisper's conv frontend and llava's vision tower are the
reference's modality stubs: batches carry `frames` (B, F, d) for the
encoder and `patches` (B, n_patches, d), put in front of the tokens.
"""
from __future__ import annotations

import functools
import types
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from .. import resolve_device
from .attention import (attention_decode, attention_full,
                        cross_attention_full, decode_index, encode_cross_kv,
                        encoder_attention, init_attention)
from .common import (_is_dtensor, all_reduce, constrain, dense_init,
                     dtype_of, on_shards, replicated_like, rms_norm,
                     seq_shard_residual, shard_kinds, shard_range,
                     spec_placements)
from .mlp import apply_mlp, init_mlp
from .moe import apply_moe, init_moe
from .spec import ArchConfig
from .ssm import (init_mamba2, init_rwkv6, mamba2_decode, mamba2_full,
                  rwkv6_decode, rwkv6_full)

Params = Dict[str, Any]
Cache = Dict[str, Dict[str, torch.Tensor]]

_INIT = {"attn": init_attention,
         "cross_attn": lambda g, c, d: init_attention(g, c, d, cross=True),
         "mlp": init_mlp, "moe": init_moe, "mamba2": init_mamba2,
         "rwkv6": init_rwkv6}
_FULL = {"mamba2": mamba2_full, "rwkv6": rwkv6_full}
_DECODE = {"mamba2": mamba2_decode, "rwkv6": rwkv6_decode}


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for a block kind the port has not
    ported."""
    for b in cfg.unit:
        if b.kind not in _INIT:
            raise NotImplementedError(
                f"{cfg.name}: block kind {b.kind!r} is not ported yet"
                f" (ported: {sorted(_INIT)})")


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
    if cfg.encoder is not None:
        params["encoder"] = {
            "layers": [{"b0_attn": init_attention(generator, cfg, device),
                        "b1_mlp": init_mlp(generator, cfg, device)}
                       for _ in range(cfg.encoder.n_layers)],
            "final_norm": torch.ones(cfg.d_model, dtype=torch.float32,
                                     device=device)}
    return params


def _head(params: Params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _last_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """The prefill's logits, x[:, -1:] (B, 1, d) @ head (d, V).  On
    DTensors each rank multiplies its own rows by its own vocab columns as
    plain tensors (`on_shards`), the op plain tensors take: the slice's
    strides keep `matmul` from folding it into a 2-D product, and
    DTensor's batched path copies the head expanded over the rank's rows
    (ROADMAP C18)."""
    x = x[:, -1:]
    if not _is_dtensor(x):
        return x @ head
    return on_shards("head", torch.matmul, (x, head),
                     ({"batch": 0}, {"vocab": 1}), ({"batch": 0, "vocab": 2},))


def _blocks(params: Params, cfg: ArchConfig, r: int):
    """(name, spec, parameters) of repeat r's blocks, in unit order; a
    shared block gets the one parameter set of `params["shared"]`."""
    for i, b in enumerate(cfg.unit):
        name = f"b{i}_{b.kind}"
        p = params["shared"][name] if b.shared else params["layers"][r][name]
        yield name, b, p


def encoder_apply(params: Params, cfg: ArchConfig,
                  frames: torch.Tensor) -> torch.Tensor:
    """frames (B, F, d), the stub frontend's output -> the encoder's
    hidden states, in the frames' dtype (float32 in the reference's
    batches, whatever the weights' dtype)."""
    x = constrain(frames, "BATCH")   # as `embed_inputs` places tokens
    for layer in params["encoder"]["layers"]:
        x = constrain(encoder_attention(layer["b0_attn"], cfg, x), "BATCH")
        x = constrain(apply_mlp(layer["b1_mlp"], cfg, x), "BATCH")
    return rms_norm(x, params["encoder"]["final_norm"], cfg.norm_eps)


def embed_inputs(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                 patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings, with the patches (cast to the embedding dtype) in
    front where the config takes them.  The tokens take the batch
    placement first: the lookup's output would move B x S x d where the
    tokens move B x S (a batch on other axes than the input's, as under
    pure data parallelism on the 2 x 16 x 16 mesh, is gathered whole
    before it is cut)."""
    x = _lookup(params["embed"], constrain(tokens, "BATCH"))
    if cfg.n_patches and patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    return constrain(x, "BATCH")


def _lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """embed[tokens].  DTensors look up on each rank's shards where the
    tokens are sharded by batch and the table by width (its vocabulary is
    whole under every rule): the gather is local, and DTensor's own
    strategy refuses a batch sharded over two mesh axes."""
    if _is_dtensor(tokens) and _is_dtensor(embed):
        dims = ({"width": 1}, {"batch": 0})
        if shard_kinds((embed, tokens), dims)[1] is None:
            return on_shards("embedding", lambda e, t: e[t],
                             (embed, tokens), dims,
                             ({"batch": 0, "width": 2},))
    return embed[tokens]


def _repeat_full(params: Params, cfg: ArchConfig, r: int, x, aux, *,
                 mode: str, enc_out, impl, with_aux: bool,
                 chunk_scans: bool = False, sink=None):
    """One repeat of the unit over the full sequence: (x, aux); the MoE
    blocks' aux loss is added to `aux` only `with_aux` (a serving prefill
    leaves it out, and with it its launches).  A prefill hands each
    block's cache to `sink(name, cache)` as the block returns it."""
    # keep the residual stream batch-sharded (+ sequence-sharded over the
    # TP axis under sequence parallelism)
    seq = "model" if seq_shard_residual() else None
    x = constrain(x, "BATCH", seq)
    for name, b, p in _blocks(params, cfg, r):
        c = None
        # a block reads the whole sequence of its shard of the batch
        x = constrain(x, "BATCH")
        if b.kind == "attn":
            x, c = attention_full(p, cfg, x, mode=mode)
        elif b.kind == "cross_attn":
            c = encode_cross_kv(p, cfg, enc_out)
            x = cross_attention_full(p, cfg, x, c)
            if mode != "prefill":
                c = None
        elif b.kind == "mlp":
            x = apply_mlp(p, cfg, x)
        elif b.kind == "moe" and with_aux:
            x, a = apply_moe(p, cfg, x, return_aux=True)
            aux = aux + a
        elif b.kind == "moe":
            x = apply_moe(p, cfg, x)
        else:
            x, c = _FULL[b.kind](p, cfg, x, mode=mode, impl=impl,
                                 chunk_scans=chunk_scans)
        # the residual out of a row-parallel product is a partial sum
        # under a mesh: reduce it here (scatter it over the sequence
        # under sequence parallelism).  Its gradient stays in the block
        # output's placements: a sequence-sharded one would reach the
        # block's products flattened over batch and sequence sharded at
        # once, which DTensor cannot propagate
        x = constrain(x, "BATCH", seq, bind_grad=False)
        if c is not None:
            sink(name, c)
        del c                   # the sink holds what it keeps
    return x, aux


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            mode: str = "train", impl: Optional[str] = None,
            frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None,
            return_aux: bool = False, remat: bool = False,
            chunk_scans: bool = False, cache_specs=None):
    """Full-sequence pass over tokens (B, S), after `patches` (B, P, d)
    where the config takes them (the logits then cover P + S positions),
    with the encoder run over `frames` (B, F, d) where it has one.

    mode="train":   returns logits (B, P + S, V)
    mode="prefill": returns (last_logits (B, 1, V), cache), the cache keyed
                    like `init_cache`, each leaf stacked over n_repeat:
                    attention K/V (n_repeat, B, S', K, hd) with S' = P + S
                    or, under SWA, the ring-aligned last window;
                    cross-attention K/V (n_repeat, B, F, K, hd) of the
                    encoder output; the recurrent blocks' O(1) state in
                    `init_cache`'s shapes.
    `return_aux` appends the summed MoE load-balance loss (an f32 scalar,
    0 without MoE blocks) to either return.  `remat` recomputes each
    repeat's activations in the backward pass (`torch.utils.checkpoint`,
    the reference's `jax.checkpoint` of its scan body).  The recurrent
    blocks' scan follows `mode`: "train" takes the chunk scans of
    `models/ssm.py` on every device (differentiable, as the reference
    trains), "prefill" the scans of `kernels.ops`, whose version `impl`
    picks ("plain" runs the plain version on the card too); `impl` selects
    nothing in mode "train".  `chunk_scans` makes a prefill take the chunk
    scans too (the dry run's prefill, as the reference's prefill scans in
    chunks: the plain sequential scan would step S times a block).

    A prefill writes each block's cache into the stacked leaves as the
    block returns it (`_stacked_like`, `_write_cache`), so no layer's
    cache outlives its block.  Under a mesh `cache_specs`, a callable
    from a tree of the stacked leaves' shapes (objects with `.shape`) to a
    spec per leaf (`launch.sharding.cache_specs`' form, the reference's
    `out_shardings`), places them; each layer's cache is cut to that
    placement as it is written.  Without it a stacked leaf is placed as
    its repeats' caches are.
    """
    check_supported(cfg)
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown forward mode {mode!r}")
    enc_out = None
    if cfg.encoder is not None:
        if frames is None:
            raise ValueError(f"{cfg.name} has an encoder: pass frames=")
        enc_out = encoder_apply(params, cfg, frames)
    x = embed_inputs(params, cfg, tokens, patches)
    aux = replicated_like(torch.zeros((), dtype=torch.float32,
                                      device=x.device), x)
    cache: Cache = {}

    def write(r, name, c):
        # block `name`'s cache of repeat r into row r of its stacked
        # leaves, made when the block of repeat 0 returns it
        if name not in cache:
            cache[name] = _stacked_like(name, c, cfg.n_repeat, cache_specs)
        _write_cache(cache[name], r, c)

    for r in range(cfg.n_repeat):
        step = functools.partial(_repeat_full, params, cfg, r, mode=mode,
                                 enc_out=enc_out, impl=impl,
                                 with_aux=return_aux,
                                 chunk_scans=chunk_scans,
                                 sink=functools.partial(write, r))
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                step, x, aux, use_reentrant=False)
        else:
            x, aux = step(x, aux)
    x = constrain(x, "BATCH")        # the head reads whole sequences
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if mode == "prefill":
        logits = constrain(_last_logits(x, _head(params, cfg)), "BATCH",
                           None, "model")
        return (logits, cache, aux) if return_aux else (logits, cache)
    logits = constrain(x @ _head(params, cfg), "BATCH", None, "model")
    return (logits, aux) if return_aux else logits


def _stacked_like(name: str, c: Dict[str, torch.Tensor], n: int,
                  cache_specs=None) -> Dict[str, torch.Tensor]:
    """An empty (n, ...) leaf for each leaf of block `name`'s cache `c`,
    in its dtype on its device.  A DTensor leaf's is a DTensor on its
    mesh, placed by `cache_specs` (see `forward`) where given, else as
    the leaf is, one dimension on."""
    specs = {}
    if cache_specs is not None and any(map(_is_dtensor, c.values())):
        specs = cache_specs({name: {key: types.SimpleNamespace(
            shape=torch.Size((n, *t.shape))) for key, t in c.items()}})[name]
    return {key: _buffer(t, n, specs.get(key)) for key, t in c.items()}


def _buffer(t: torch.Tensor, n: int, spec=None) -> torch.Tensor:
    if not _is_dtensor(t):
        return t.new_empty((n, *t.shape))
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = t.device_mesh
    placements = spec_placements(spec, mesh) if spec is not None else tuple(
        Shard(p.dim + 1) if p.is_shard() else Replicate()
        for p in t.placements)
    local = [n, *t.shape]
    for i, p in enumerate(placements):
        if p.is_shard():
            if local[p.dim] % mesh.size(i):
                raise ValueError(f"dimension {p.dim} of {(n, *t.shape)} does"
                                 f" not divide by mesh dimension {i}")
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(t.to_local().new_empty(local), mesh,
                              placements, run_check=False)


def _write_cache(stacked: Dict[str, torch.Tensor], r: int,
                 c: Dict[str, torch.Tensor]) -> None:
    """A block's cache `c` of repeat r into row r of its stacked leaves; a
    DTensor leaf first takes the stacked leaf's placements (a local slice
    where it is replicated there, as a K/V whose heads do not divide
    `model` is, and its cache's sequence is sharded on it)."""
    for key, t in c.items():
        buf = stacked[key]
        if not _is_dtensor(buf):
            buf[r].copy_(t)
            continue
        from torch.distributed.tensor import Shard
        t = t.redistribute(buf.device_mesh, tuple(
            Shard(p.dim - 1) if p.is_shard() else p
            for p in buf.placements))
        buf.to_local()[r].copy_(t.to_local())


class _VocabParallelCE(torch.autograd.Function):
    """The cross-entropy rows of one rank's logits z (B, S, V_local), a
    shard of the vocabulary starting at `offset`, against targets t
    (B, S), in chunks of `cs` positions: one (B, cs) f32 tensor a chunk,
    lse - z[target] where t >= 0, else 0.  A chunk's row max, sum of exp
    and target logit (0 on the shards that do not hold it) are
    all-reduced over the vocab `groups`, so every exchange is
    (B, cs)-sized; the backward sends z's gradient, softmax - onehot,
    back on the same shard, with no exchange at all.

    Op for op a chunk's f32 log-sum-exp less its gathered target logit
    and the gradient autograd takes through them, so the bits are those
    of the plain chunk loop; it saves only z and each chunk's max and
    sum of exp, recomputes exp in the backward, and holds one f32 chunk
    at a time in place."""

    @staticmethod
    def forward(ctx, z, t, offset, cs, groups):
        rows, maxes, sums = [], [], []
        for i in range(0, z.shape[1], cs):
            zc, tc = z[:, i:i + cs], t[:, i:i + cs]
            m = all_reduce(zc.amax(dim=-1, keepdim=True).float(), "max",
                           groups)
            zs = zc - m                                  # f32
            idx, held = _local_target(tc, offset, z.shape[-1])
            tl = all_reduce(torch.where(held, zs.gather(-1, idx)[..., 0],
                                        0.0), "sum", groups)
            se = all_reduce(zs.exp_().sum(dim=-1), "sum", groups)
            rows.append(torch.where(tc >= 0, torch.log(se) - tl, 0.0))
            maxes.append(m)
            sums.append(se)
        ctx.save_for_backward(z, t, *maxes, *sums)
        ctx.offset, ctx.cs = offset, cs
        return tuple(rows)

    @staticmethod
    def backward(ctx, *grads):
        z, t, *saved = ctx.saved_tensors
        n = len(grads)
        maxes, sums = saved[:n], saved[n:]
        cs = ctx.cs
        dz = torch.empty_like(z)
        for c, i in enumerate(range(0, z.shape[1], cs)):
            tc = t[:, i:i + cs]
            dl = torch.where(tc >= 0, grads[c], 0.0)     # d lse, -d tl
            d = (z[:, i:i + cs] - maxes[c]).exp_()       # f32
            d.mul_((dl / sums[c])[..., None])
            idx, held = _local_target(tc, ctx.offset, z.shape[-1])
            d.scatter_(-1, idx, d.gather(-1, idx)
                       - torch.where(held, dl, 0.0)[..., None])
            dz[:, i:i + cs] = d
        return dz, None, None, None, None


def _local_target(t, offset: int, V: int):
    """The index into a vocab shard [offset, offset + V) of targets t
    (B, cs) as (B, cs, 1), clamped into the shard, and whether the shard
    holds each target (t < 0 reads index 0)."""
    local = t.clamp(min=0) - offset
    return local.clamp(0, V - 1)[..., None], (local >= 0) & (local < V)


def _vocab_parallel_rows(txt, targets, cs: int):
    """`_VocabParallelCE` on each rank's shard of DTensor logits txt
    (B, S, V) and DTensor targets (B, S): the rows as (B, cs) DTensors
    placed as txt with the vocab replicated, and txt's gradient placed as
    txt (vocab-parallel: the head's constraint then moves nothing).  The
    sequence must be whole."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = txt.device_mesh
    if any(p.is_shard(1) or p.is_partial() for p in txt.placements):
        raise NotImplementedError(
            f"the cross-entropy needs whole sequences and no partial"
            f" logits, not {txt.placements}")
    row_pl = tuple(Replicate() if p.is_shard(2) else p
                   for p in txt.placements)
    groups = [(mesh, m) for m, p in enumerate(txt.placements)
              if p.is_shard(2) and mesh.size(m) > 1]
    rows = _VocabParallelCE.apply(
        txt.to_local(grad_placements=txt.placements),
        targets.redistribute(mesh, row_pl).to_local(),
        shard_range(txt, 2)[0], cs, groups)
    return [DTensor.from_local(r, mesh, row_pl, run_check=False)
            for r in rows]


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, aux_weight: float = 0.01, remat: bool = False
            ) -> torch.Tensor:
    """Next-token cross-entropy over the text positions (+ aux_weight x
    the MoE load-balance loss), the reference's `loss_fn`.

    batch: "tokens", "labels" (B, S) and, where the config takes them,
    "patches" / "frames".  The targets are labels[:, 1:] with -1 (ignored)
    after the last; the modality prefix is unlabeled.  The cross-entropy is
    taken in f32, in chunks of min(512, S) positions halved until they
    divide S, and averaged over the valid targets, in the reference's
    vocab-parallel form (`_VocabParallelCE`; plain logits are one vocab
    shard): every cross-shard exchange of DTensor logits is (B, cs)-sized,
    and the gradient stays on each rank's vocab shard.
    """
    logits, aux = forward(params, cfg, batch["tokens"], mode="train",
                          frames=batch.get("frames"),
                          patches=batch.get("patches"), return_aux=True,
                          remat=remat)
    labels = batch["labels"]
    txt = logits[:, -labels.shape[1]:]
    B, S, _ = txt.shape
    targets = torch.cat([labels[:, 1:], labels.new_full((B, 1), -1)], dim=1)
    cs = min(512, S)
    while S % cs:
        cs //= 2
    nll_sum = replicated_like(torch.zeros((), dtype=torch.float32,
                                          device=txt.device), txt)
    count = 0
    rows = _vocab_parallel_rows(txt, targets, cs) if _is_dtensor(txt) \
        else _VocabParallelCE.apply(txt, targets, 0, cs, ())
    for c, i in enumerate(range(0, S, cs)):
        nll_sum = nll_sum + rows[c].sum()
        count = count + (targets[:, i:i + cs] >= 0).sum()
    return nll_sum / torch.clamp(count, min=1) + aux_weight * aux


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                cache: Cache, pos, *, impl: Optional[str] = None,
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode iteration: tokens (B, 1), cache from prefill/init_cache.

    `pos` (host int or (B,) numpy array) is the absolute position of each
    new token.  The cache is updated in place and returned.  `impl` is
    passed to `ops.decode_attention` ("plain" runs the plain attention);
    the recurrent blocks take one plain step, as in the reference, and
    cross-attention reads the cache's encoder K/V with the plain attention
    (the reference computes it in jnp, outside its kernel).
    This is the paper's tau(n, L) iteration: weight streaming + the KV scan
    over `pos` cached tokens (+ the O(1) state of recurrent blocks).
    """
    check_supported(cfg)
    x = embed_inputs(params, cfg, tokens)
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
            elif b.kind == "cross_attn":
                x = cross_attention_full(p, cfg, x, {"k": c["k"][r],
                                                     "v": c["v"][r]})
            elif b.kind == "mlp":
                x = apply_mlp(p, cfg, x)
            elif b.kind == "moe":
                x = apply_moe(p, cfg, x)
            else:
                x, new = _DECODE[b.kind](p, cfg, x,
                                         {key: t[r] for key, t in c.items()})
                for key, t in new.items():
                    c[key][r] = _placed_as(t, c[key][r])
            x = constrain(x, "BATCH")       # reduce a row-parallel partial
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return constrain(x @ _head(params, cfg), "BATCH", None, "model"), cache


def _placed_as(t, like):
    """t placed as the cache slice `like` it is written into (a DTensor
    copy_ into a slice placed otherwise would change the slice's
    placements, which DTensor refuses)."""
    if _is_dtensor(t) and tuple(t.placements) != tuple(like.placements):
        return t.redistribute(like.device_mesh, like.placements)
    return t


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               enc_frames: int = 0, device="cuda",
               dtype: Optional[torch.dtype] = None) -> Cache:
    """Zero decode cache keyed by block name, in the reference's shapes
    and dtypes, one entry per repeat (of a shared block too): attention
    K/V hold `max_seq` slots (or the SWA window if smaller);
    cross-attention K/V `enc_frames` encoder positions; Mamba2 and RWKV6
    blocks hold O(1) state."""
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
        elif b.kind == "cross_attn":
            cache[name] = {key: zeros(enc_frames, cfg.n_kv_heads, cfg.hd)
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
