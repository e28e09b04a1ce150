"""Top-k MoE block with sort-based capacity dispatch.

The reference's scheme (`repro.models.moe`, MaxText-style), not a dense
one-hot einsum: each token's k assignments are stably sorted by expert id,
gathered into a fixed (E, C, d) buffer, run through batched expert
products, and combined back with the router gates.  An expert takes at most
C assignments, earliest tokens first; the rest are dropped (their share of
the output is 0).  Decode (S == 1) uses C = tokens, so nothing is dropped.

The expert products stay plain `torch.einsum`s over the (E, C, d) buffer,
as the reference leaves them to XLA outside any Pallas kernel: they read
every expert's weights whatever the routing.

Training takes autograd's gradients of the dispatch's gathers (a
scatter-add), as the reference's path does: its gather-only custom-VJP
primitives `_permute`, `_slot_gather` and `_pick` were tried there and
refuted, and no code of it calls them.  They are ported below as
`torch.autograd.Function`s, with the index maps only their backward
passes read (`backward_maps`: `token_slot`, `slot_s`), and stay off
`apply_moe`'s path as they do in the reference; the grouped dispatch below
does not take them up either.  `apply_moe(..., return_aux=True)` also
returns the Switch load-balance loss.

Dispatch groups, the reference's: under a mesh (`common.set_mesh`) the
tokens are routed in one group per data shard (`_n_dispatch_groups`), each
with its own capacity, placed on the mesh axes that shard the batch
(`_rows_spec`), and each rank dispatches and combines its own groups on
its shards (`local_map`, as GSPMD partitions the reference's vmap over
groups); the groups meet only where the (G, E, C, d) buffer is
placed onto the experts (`constrain`, expert-parallel when E divides the
model axis).  Without a mesh there is one group.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .common import (_is_dtensor, axis_size, batch_axes, constrain,
                     dense_init, dtype_of, on_shards, onto_rows, rms_norm,
                     shard_kinds, silu)

# --- gather-only autodiff primitives (off the path; see above) ---------
# Every index map here is a (partial) permutation, so each backward pass
# is a gather by the inverse map instead of a scatter-add.

class Permute(torch.autograd.Function):
    """y[i] = x[perm[i]]; backward g[inv_perm] (inv_perm = perm^-1)."""

    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return x[perm]

    @staticmethod
    def backward(ctx, g):
        (inv_perm,) = ctx.saved_tensors
        return g[inv_perm], None, None


class SlotGather(torch.autograd.Function):
    """buf[slot] = hf_pad[slot_token[slot]] (the sentinel row Tg of hf_pad
    is zeros).  Backward: each token feeds at most k slots, which
    token_slot lists (assignment-major, sentinel E*C for dropped ones), so
    d_hf is a sum over k of a gather; the sentinel row gets zeros."""

    @staticmethod
    def forward(ctx, hf_pad, slot_token, token_slot, k):
        ctx.save_for_backward(token_slot)
        ctx.k, ctx.n_rows = k, hf_pad.shape[0]
        return hf_pad[slot_token]

    @staticmethod
    def backward(ctx, g):
        (token_slot,) = ctx.saved_tensors
        d = g.shape[1]
        g_pad = torch.cat([g, g.new_zeros(1, d)])
        d_hf = g_pad[token_slot].reshape(-1, ctx.k, d).sum(1)
        d_hf = torch.cat([d_hf, g.new_zeros(ctx.n_rows - d_hf.shape[0], d)])
        return d_hf, None, None, None


class Pick(torch.autograd.Function):
    """picked[s] = keep[s] ? out_flat[dest[s]] : 0.  Backward: a gather by
    the inverse map slot_s (slot -> sorted assignment, sentinel Tk ->
    zero)."""

    @staticmethod
    def forward(ctx, out_flat, dest, keep, slot_s):
        ctx.save_for_backward(keep, slot_s)
        return torch.where(keep[:, None], out_flat[dest], 0)

    @staticmethod
    def backward(ctx, g):
        keep, slot_s = ctx.saved_tensors
        gm = torch.where(keep[:, None], g, 0)
        gm_pad = torch.cat([gm, gm.new_zeros(1, g.shape[1])])
        return gm_pad[slot_s], None, None, None


def init_moe(generator: torch.Generator, cfg, device: torch.device) -> dict:
    d, E = cfg.d_model, cfg.n_experts
    fe = cfg.moe_d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    return {"norm": torch.ones(d, dtype=torch.float32, device=device),
            "router": dense_init(generator, (d, E), scale=0.02,
                                 dtype=torch.float32, device=device),
            "w_gate": dense_init(generator, (E, d, fe), dtype=dt,
                                 device=device),
            "w_up": dense_init(generator, (E, d, fe), dtype=dt, device=device),
            "w_down": dense_init(generator, (E, fe, d), dtype=dt,
                                 device=device)}


def router_topk(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax-then-topk router (granite/grok convention): gates renormed."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return gates, idx


def load_balance_loss(logits: torch.Tensor, idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.reshape(-1, n_experts).mean(0)
    frac = torch.nn.functional.one_hot(idx.reshape(-1), n_experts) \
        .float().mean(0)
    return n_experts * torch.sum(me * frac)


def _dispatch_group(hf: torch.Tensor, idx: torch.Tensor, E: int, k: int,
                    C: int):
    """Sort-based dispatch of one group: hf (Tg, d) -> (E, C, d) and the
    combine metadata (dest, keep, inv_order), all over the Tg·k assignments
    in expert-sorted order.

    The sort is stable, as `jnp.argsort` is: within an expert, assignments
    keep token order, so the ones past C that are dropped are the latest
    tokens'.  Dropped assignments are scattered to a sentinel row E·C of an
    index map one row longer, which is then cut off.  Everything stays on
    the tensors' device: the expert counts are a scatter-add of fixed
    length E (`torch.bincount` would first read the largest id back to the
    host to size its output).
    """
    Tg, d = hf.shape
    Tk = Tg * k
    dev = hf.device
    flat_e = idx.reshape(-1)                                    # (Tk,)
    order = torch.argsort(flat_e, stable=True)
    arange = torch.arange(Tk, device=dev)
    inv_order = torch.empty_like(order)
    inv_order[order] = arange                   # = argsort(order), cheaper
    sorted_e = flat_e[order]
    token_of = order // k
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, sorted_e, torch.ones_like(sorted_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = arange - starts[sorted_e]
    keep = pos_in_e < C
    dest = sorted_e * C + torch.where(keep, pos_in_e, 0)
    safe_dest = torch.where(keep, dest, E * C)       # dropped: off the end
    slot_token = torch.full((E * C + 1,), Tg, dtype=torch.long, device=dev)
    slot_token[safe_dest] = token_of
    hf_pad = torch.cat([hf, hf.new_zeros(1, d)])    # row Tg: empty slots
    buf = hf_pad[slot_token[:E * C]]
    return buf.reshape(E, C, d), (dest, keep, inv_order)


def backward_maps(dest: torch.Tensor, keep: torch.Tensor,
                  inv_order: torch.Tensor, E: int, C: int):
    """The index maps only the gather-only backward passes read, from
    `_dispatch_group`'s metadata: token_slot (Tk,), the slot of each
    assignment in token-major order (E*C where dropped), and slot_s (E*C,),
    the sorted assignment each slot holds (Tk where empty)."""
    Tk = dest.shape[0]
    token_slot = torch.where(keep[inv_order], dest[inv_order], E * C)
    safe_dest = torch.where(keep, dest, E * C)
    slot_s = torch.full((E * C + 1,), Tk, dtype=torch.long,
                        device=dest.device)
    slot_s[safe_dest] = torch.arange(Tk, device=dest.device)
    return token_slot, slot_s[:E * C]


# tokens the combine takes at a time; a group of up to this many tokens
# is one block, the whole-group form
COMBINE_ROWS = 1024


def _combine_group(out_e: torch.Tensor, meta, gates: torch.Tensor,
                   k: int) -> torch.Tensor:
    """(Tg, d) f32: each token's k expert rows (0 where dropped) weighted
    by its gates and summed, the reference's form: the rows gathered in
    token order, taken to f32 and reduced over k.  COMBINE_ROWS tokens at
    a time into the one output, so that the (Tg·k, d) copies are a
    block's, each gathered straight from `out_e`: the same ops on every
    token's rows."""
    dest, keep, inv_order = meta
    Tg = gates.shape[0]
    d = out_e.shape[-1]
    out_flat = out_e.reshape(-1, d)
    y = out_e.new_empty((Tg, d), dtype=torch.float32)
    for a in range(0, Tg, COMBINE_ROWS):
        e = min(a + COMBINE_ROWS, Tg)
        s = inv_order[a * k:e * k]      # the block's assignments, sorted
        rows = torch.where(keep[s, None], out_flat[dest[s]], 0)
        y[a:e] = torch.einsum("tkd,tk->td",
                              rows.reshape(e - a, k, d).float(), gates[a:e])
    return y


def _n_dispatch_groups(T: int) -> int:
    """Group-local dispatch: one routing group per data shard of the
    ambient mesh (the product of its batch axes' sizes, halved until it
    divides T), so the argsort and gathers stay on each shard and the
    groups meet only in the resharding of the (G, E, C, d) buffer; 1
    without a mesh."""
    g = 1
    for a in batch_axes():      # includes `model` under pure-DP mappings
        g *= axis_size(a)
    while T % g:
        g //= 2
    return max(g, 1)


def _model_axis_size() -> int:
    return axis_size("model")


def capacity(cfg, T: int, S: int, G: int = 1) -> int:
    """Slots per expert and group of T // G tokens: C = Tg at decode (an
    expert's load is at most Tg, so decode never drops a token), else
    Tg·k/E·capacity_factor."""
    Tg = T // G
    if S == 1:
        return Tg
    return max(int(Tg * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)


def _stack(ts):
    return ts[0][None] if len(ts) == 1 else torch.stack(ts)


def _dispatch(hf, idx, E: int, k: int, C: int):
    """`_dispatch_group` over each of G groups: hf (G, Tg, d), idx
    (G, Tg, k) -> buf (G, E, C, d) and the (G, Tg·k) maps dest, keep,
    inv_order."""
    outs = [_dispatch_group(hf[g], idx[g], E, k, C)
            for g in range(hf.shape[0])]
    return (_stack([o[0] for o in outs]),
            *(_stack([o[1][i] for o in outs]) for i in range(3)))


def _combine(out_e, dest, keep, inv_order, gates, k: int):
    """`_combine_group` over each group: (G, E, C, d) -> (G, Tg, d) f32."""
    return _stack([_combine_group(out_e[g], (dest[g], keep[g], inv_order[g]),
                                  gates[g], k)
                   for g in range(out_e.shape[0])])


def _route(logits, k: int):
    """`router_topk`; a DTensor routes on each rank's tokens (the choice
    is per token, and some DTensor releases lack a sharding strategy for
    the top-k's backward)."""
    if _is_dtensor(logits):
        dims = ({"batch": 0},)
        if shard_kinds((logits,), dims)[1] is None:
            return on_shards("router_topk", lambda z: router_topk(z, k),
                             (logits,), dims, dims * 2)
    return router_topk(logits, k)


def _per_group(fn, n_out: int, *args):
    """fn over DTensor arguments sharded by group (dim 0) only: each rank
    runs it on its own groups (the reference vmaps the dispatch over the
    group axis, which GSPMD keeps on each shard); plain tensors pass
    through."""
    if not _is_dtensor(args[0]):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(args[0].placements)
    in_pl = tuple(pl if _is_dtensor(a) else None for a in args)
    # local_map reads a tuple as one placement list per output
    return local_map(fn, out_placements=(pl,) * n_out if n_out > 1
                     else list(pl),
                     in_placements=in_pl, device_mesh=args[0].device_mesh
                     )(*args)


def _rows_spec(x):
    """The mesh axes that shard x's batch (dimension 0), in mesh order, as
    a spec entry (None for none), where x is a DTensor; else "BATCH".
    The groups and tokens are placed on those axes, as the rows they come
    from: a batch of 256 lies on data x model of the 2 x 16 x 16 mesh
    under pure data parallelism, where "BATCH" would fit 512 groups to
    pod x data x model, an order of groups no rank holds, and moving them
    there gathers them whole."""
    if not _is_dtensor(x):
        return "BATCH"
    names = x.device_mesh.mesh_dim_names
    return tuple(names[m] for m, p in enumerate(x.placements)
                 if p.is_shard(0)) or None


def _combine_columns(out_e, dest, keep, inv_order, gates, k: int):
    """`_combine` of every group on each rank's columns of out_e
    (G, E, C, d), its d sharded (`onto_rows`) and its sum maybe partial
    over `model`: the combine is linear in out_e, column by column, so
    y (G, Tg, d) f32 is placed as out_e, d for d, and (in x's dtype, as
    out_e's partial sums would) moves (G, Tg, d) to the groups' shards
    where out_e would move (G, E, C, d).  The
    groups' metadata are gathered over the mesh dimensions that shard
    d."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = out_e.device_mesh
    pl = tuple(out_e.placements)
    meta_pl = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pl)
    metas = [a.redistribute(mesh, meta_pl)
             for a in (dest, keep, inv_order, gates)]
    y_pl = [Shard(2) if p.is_shard(3) else p for p in pl]
    return local_map(lambda o, de, ke, io, gg: _combine(o, de, ke, io, gg,
                                                        k),
                     out_placements=y_pl, in_placements=(pl,) + (meta_pl,)
                     * 4, device_mesh=mesh)(out_e, *metas)


def _as_rows(y, x):
    """y (G, Tg, d) placed over the groups as x (B, S, d) is over its
    batch, so that y reshapes to x's shape shard by shard (G may exceed
    the batch shards: then one row spans several groups)."""
    if not _is_dtensor(y):
        return y
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Shard(0) if p.is_shard(0) else Replicate()
               for p in x.placements)
    return y if tuple(y.placements) == pl \
        else y.redistribute(y.device_mesh, pl)


def apply_moe(params: dict, cfg, x: torch.Tensor, *,
              return_aux: bool = False):
    """x (B, S, d) -> x + the routed experts' SwiGLU output, and with
    `return_aux` also the block's `load_balance_loss` (f32 scalar).

    The B·S tokens are routed in G groups (`_n_dispatch_groups`: one per
    data shard under a mesh, 1 without), each with its own capacity."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = _n_dispatch_groups(T)
    Tg = T // G
    C = capacity(cfg, T, S, G)
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    # (the gradient is left in the reshape's placement: G may shard more
    # ways than the batch, and a gradient placed so cannot be viewed back)
    rows = _rows_spec(x)
    hf = constrain(h.reshape(G, Tg, d), rows, bind_grad=False)
    logits = constrain(onto_rows(hf.reshape(T, d), params["router"])
                       .float() @ params["router"], rows)       # (T, E)
    gates, idx = _route(logits, k)
    gates, idx = (constrain(a.reshape(G, Tg, k), rows)
                  for a in (gates, idx))
    buf, dest, keep, inv_order = _per_group(
        lambda hh, ii: _dispatch(hh, ii, E, k, C), 4, hf, idx)
    # data -> expert boundary: the resharding below is the all-to-all
    ep = "model" if E % _model_axis_size() == 0 else None
    buf = constrain(buf, rows, ep)                             # (G, E, C, d)
    if not ep:
        # a decode step's buffer onto the experts' shards of d, once for
        # both products; the combine then runs there
        buf = onto_rows(buf, params["w_up"], 1)
    cols = _is_dtensor(buf) and any(p.is_shard(3) for p in buf.placements)
    up = torch.einsum("gecd,edf->gecf", buf, params["w_up"])
    gate = torch.einsum("gecd,edf->gecf", buf, params["w_gate"])
    if cols:
        # the products' partial sums over d reduce onto the groups' shards
        # (a reduce-scatter each; one DTensor release all-reduces them)
        up, gate = (constrain(a, rows, None, None, "model")
                    for a in (up, gate))
    out_e = torch.einsum("gecf,efd->gecd", silu(gate) * up, params["w_down"])
    if cols:
        y = _combine_columns(out_e, dest, keep, inv_order, gates,
                             k).to(x.dtype)
    else:
        out_e = constrain(out_e, rows, ep)
        out_e = constrain(out_e, rows)    # back on the groups' shards
        y = _per_group(lambda oo, de, ke, io, gg: _combine(
            oo, de, ke, io, gg, k), 1, out_e, dest, keep, inv_order, gates)
    # y: (G, Tg, d)
    out = x + _as_rows(y, x).reshape(B, S, d).to(x.dtype)
    if return_aux:
        return out, load_balance_loss(logits, idx, E)
    return out
