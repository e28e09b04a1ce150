"""Shared numerics for the model zoo: norms, RoPE, init helpers, and the
ambient mesh of the distribution layer (`set_mesh`, `constrain`)."""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import sys
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the dtype the two promote to, as JAX computes `f32 @ bf16`
    in f32 (torch raises on mixed dtypes): float32 encoder frames meet
    bfloat16 weights in whisper's encoder and cross-attention K/V."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def dense_init(generator: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None, *, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """Normal(0, scale) weights, drawn in f32 and cast (scale defaults to
    1/sqrt(fan_in) with fan_in = shape[0]: weights are (in, out))."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with positions (..., S) or (S,); split-halves
    rotation with f32 angles."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(d, theta), dtype=torch.float32,
                            device=x.device)
    angles = positions.float()[..., None] * freqs        # (..., S, D/2)
    angles = angles[..., None, :]                        # head axis
    cos, sin = (replicated_like(a, x)
                for a in (torch.cos(angles), torch.sin(angles)))
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ----------------------------------------------------------------------
# The ambient mesh (the reference's `compat.get_abstract_mesh` and its
# module globals BATCH_AXES_OVERRIDE / SEQ_SHARD_RESIDUAL, as one context)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshContext:
    mesh: Any
    batch_axes_override: Optional[Tuple[str, ...]] = None
    seq_shard_residual: bool = False


_MESH_STACK: list = []


@contextlib.contextmanager
def set_mesh(mesh, *, batch_axes_override: Optional[Sequence[str]] = None,
             seq_shard_residual: bool = False):
    """Install `mesh` as the ambient mesh of `constrain` and `batch_axes`
    for the body of the `with`.

    `batch_axes_override` maps the batch over other axes (the launch
    layer's pure-data-parallel mapping: ("pod", "data", "model"));
    `seq_shard_residual` shards the residual stream's sequence dimension
    over `model` between repeats (sequence parallelism for large-model
    training).  The mesh is read only through `.shape` (a name -> size
    mapping) and `.axis_names`, so a stub namespace serves for the rules
    alone; `constrain` redistributes a DTensor over its own mesh.
    """
    override = tuple(batch_axes_override) \
        if batch_axes_override is not None else None
    _MESH_STACK.append(MeshContext(mesh, override, seq_shard_residual))
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def _context() -> Optional[MeshContext]:
    return _MESH_STACK[-1] if _MESH_STACK else None


def get_mesh():
    """The ambient mesh, or None outside `set_mesh`."""
    ctx = _context()
    return ctx.mesh if ctx is not None else None


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or of a stub with a `.shape`
    mapping."""
    names = tuple(mesh.axis_names) if hasattr(mesh, "axis_names") \
        else tuple(mesh.mesh_dim_names)
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(s) for s in shape)))


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names) if hasattr(mesh, "axis_names") \
        else tuple(mesh.mesh_dim_names)


def axis_size(name: str) -> int:
    """Size of the ambient mesh's axis `name` (1 without a mesh or axis)."""
    ctx = _context()
    if ctx is None:
        return 1
    return mesh_shape(ctx.mesh).get(name, 1)


def heads_spec(n_heads: int):
    """The spec entry of a heads dimension: "model" where the heads divide
    the model axis, else None (replicated heads)."""
    return "model" if n_heads % axis_size("model") == 0 else None


def seq_shard_residual() -> bool:
    ctx = _context()
    return bool(ctx and ctx.seq_shard_residual)


def batch_axes() -> tuple:
    """Data-parallel axes of the ambient mesh (empty tuple if no mesh)."""
    ctx = _context()
    if ctx is None:
        return ()
    names = axis_names(ctx.mesh)
    if ctx.batch_axes_override is not None:
        return tuple(a for a in ctx.batch_axes_override if a in names)
    return tuple(a for a in ("pod", "data") if a in names)


def expand_spec(spec: Sequence, ndim: int, mesh) -> Tuple:
    """The reference's `constrain` rules on a spec: axis names absent from
    the mesh are dropped, "BATCH" expands to `batch_axes()`, an axis
    appears in at most one dimension (the first that names it), and the
    spec is padded with None to `ndim` dimensions."""
    names = set(axis_names(mesh))

    def clean(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            kept = tuple(s for s in a if s in names)
            return kept or None
        return a if a in names else None

    expanded, used = [], set()
    for a in spec:
        e = (tuple(batch_axes()) or None) if a == "BATCH" else clean(a)
        if isinstance(e, tuple):
            e = tuple(s for s in e if s not in used) or None
        elif e in used:
            e = None
        for s in (e if isinstance(e, tuple) else (e,) if e else ()):
            used.add(s)
        expanded.append(e)
    return tuple(expanded) + (None,) * (ndim - len(expanded))


def spec_placements(spec: Sequence, mesh) -> tuple:
    """One DTensor placement per mesh dimension for a spec (a tuple over
    tensor dimensions of an axis name, a tuple of names, or None):
    Shard(dim) on every mesh dimension a tensor dimension names, else
    Replicate().  A dimension on several axes is sharded over them in mesh
    order, which is the reference's major-to-minor order when the names
    are listed in mesh order, as every rule lists them."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    placements = [Replicate()] * len(names)
    for dim, a in enumerate(spec):
        axes = a if isinstance(a, tuple) else (a,) if a else ()
        idx = [names.index(s) for s in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)}: axes {axes} of dim {dim}"
                             f" are not in the mesh's order {names}")
        for i in idx:
            placements[i] = Shard(dim)
    return tuple(placements)


def _is_dtensor(x) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")   # none made without
    return mod is not None and isinstance(x, mod.DTensor)


def constrain(x, *spec, bind_grad: bool = True):
    """Redistribute a DTensor to `spec` against the ambient mesh: the
    reference's `with_sharding_constraint`; a no-op outside `set_mesh` and
    on a plain tensor.

    The spec follows `expand_spec`'s rules, and, as in JAX, binds the
    gradient that flows back through it too (`bind_grad=False` leaves the
    gradient to DTensor, which returns it in the input's placements).
    Two rules are the port's own:
    a dimension keeps the sub-product of its axes, in mesh order, with the
    most shards that divides it (`_fit_axes`; GSPMD pads an uneven
    constraint, DTensor would too, which the port refuses everywhere,
    `launch.sharding.distribute`), and an axis of size 1, which shards
    nothing, is dropped (DTensor would refuse to reshape a dimension it
    marks sharded).  The canonical use is pinning the residual stream to
    batch sharding (constrain(x, "BATCH")).
    """
    mesh = get_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    dmesh = x.device_mesh
    spec = expand_spec(spec, x.ndim, mesh)
    sizes = mesh_shape(dmesh)
    fitted = [_fit_axes(dim, tuple(s for s in (
        a if isinstance(a, tuple) else (a,) if a else ()) if sizes[s] > 1),
        sizes) for dim, a in zip(x.shape, spec)]
    placements = spec_placements(fitted, dmesh)
    if not (x.requires_grad and torch.is_grad_enabled()):
        moved = exchange_rows(x, placements)
        if moved is not None:
            return moved
    for pl in _stages(tuple(x.placements), placements):
        if bind_grad and x.requires_grad and torch.is_grad_enabled():
            x = _Constrain.apply(x, pl)
        elif tuple(x.placements) != pl:
            x = x.redistribute(dmesh, pl)
    return x


def _stages(now: tuple, target: tuple) -> list:
    """The placements a redistribution from `now` to `target` passes:
    first every mesh dimension that the target shards where `now` holds
    the tensor whole or as a partial sum (a local slice or a
    reduce-scatter, both of which shrink what the rest moves) takes its
    target placement, where no later mesh dimension shards that tensor
    dimension now (a shard of a shard, in mesh order); then the rest.
    DTensor's own plan may gather first: a product's partial sum over
    `data`, its batch whole, reaches the batch placement by an
    all-gather over `model` of the whole batch and then a reduce-scatter
    over `data`, where this reduce-scatters first."""
    def inner(m, t):        # no later mesh dimension shards t.dim now
        return not any(p.is_shard(t.dim) for p in now[m + 1:])

    mid = tuple(t if t.is_shard() and not p.is_shard() and inner(m, t)
                else p for m, (p, t) in enumerate(zip(now, target)))
    return [mid, target] if mid not in (now, target) else [target]


def onto_rows(x, w, dim: int = 0):
    """x (..., d), whose last dimension meets w's dimension `dim` in a
    product, placed with its d on the mesh axes that shard that dimension
    of w (FSDP) and its batch on the rest of its own, where that is the
    cheaper exchange: DTensors that autograd does not record, x's local
    bytes fewer than w's gathered over those axes (moving x is one
    all-to-all of its local bytes; DTensor would move x for each product
    of it, or gather w).
    The products of x with several such weights, each then local and
    partial over those axes, share the one exchange.  A decode step's
    activations are the case; x is returned as it is otherwise."""
    if not (_is_dtensor(x) and _is_dtensor(w)) or torch.is_grad_enabled() \
            and (x.requires_grad or w.requires_grad):
        return x
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    axes = tuple(names[m] for m, p in enumerate(w.placements)
                 if p.is_shard(dim) and mesh.size(m) > 1)
    n = int(np.prod([mesh.size(names.index(a)) for a in axes]))
    lx, lw = x.to_local(), w.to_local()
    if not axes or lx.numel() * lx.element_size() \
            >= n * lw.numel() * lw.element_size():
        return x
    batch = tuple(names[m] for m, p in enumerate(x.placements)
                  if p.is_shard(0) and names[m] not in axes)
    return constrain(x, batch or None, *[None] * (x.ndim - 2), axes)


def _fit_axes(dim: int, axes: tuple, sizes) -> Optional[tuple]:
    """The axes, a subsequence of `axes`, whose sizes' product divides
    `dim` and is the largest that does; on a tie the longest leading run
    that divides.  A batch of 256 over ("pod", "data", "model") = 2 x 16
    x 16 keeps ("data", "model"), one row a rank and `pod` holding the
    batch twice, where the leading run ("pod", "data") would leave 8 rows
    a rank: GSPMD pads it to 512 and leaves one."""
    def shards(sub):
        return int(np.prod([sizes[s] for s in sub]))

    best = axes
    while best and dim % shards(best):
        best = best[:-1]
    for n in range(len(axes), 0, -1):
        for sub in itertools.combinations(axes, n):
            if dim % shards(sub) == 0 and shards(sub) > shards(best):
                best = sub
    return best or None


class _Constrain(torch.autograd.Function):
    """A redistribution whose gradient is placed as its output, as the
    transpose of a JAX sharding constraint constrains the cotangent
    (DTensor's own `redistribute` sends the gradient back to the input's
    placements instead, which leaves a reshape's gradient sharded where
    its forward was not)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def replicated_like(t: torch.Tensor, x) -> torch.Tensor:
    """`t`, a tensor the model makes itself (positions, masks, angles), as
    a Replicate() DTensor on x's mesh where x is a DTensor, else as it is:
    DTensor refuses to mix plain tensors with DTensors in one op."""
    if not _is_dtensor(x) or _is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, x.device_mesh,
                              [Replicate()] * x.device_mesh.ndim,
                              run_check=False)


def shard_range(x, dim: int) -> Tuple[int, int]:
    """(offset, size) along `dim` of this rank's shard of a DTensor x, its
    shards even (`launch.sharding.distribute` makes no other)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    size, offset = x.shape[dim], 0
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            n = mesh.size(i)
            if size % n:
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} is"
                                 f" unevenly sharded")
            size //= n
            offset += coord[i] * size
    return offset, size


def seq_dims(kv) -> list:
    """The mesh dimensions (of more than one rank) that shard a DTensor
    K/V cache's sequence, dimension 1."""
    mesh = kv.device_mesh
    return [m for m, p in enumerate(kv.placements)
            if p.is_shard(1) and mesh.size(m) > 1]


def whole_where_seq(q, kv):
    """q (a DTensor) made whole on the mesh dimensions that shard kv's
    sequence: each rank there attends its piece of the sequence with every
    query head of its batch rows (the reference's rules shard the KV
    sequence where the KV heads do not divide `model`, and q's heads then
    lie whole there already)."""
    from torch.distributed.tensor import Replicate
    dims = seq_dims(kv)
    pl = tuple(Replicate() if m in dims else p
               for m, p in enumerate(q.placements))
    return q if pl == tuple(q.placements) else q.redistribute(
        q.device_mesh, pl)


def gather_states(x: torch.Tensor, mesh, dims: Sequence[int]) -> torch.Tensor:
    """x (a rank's local tensor) all-gathered along a new leading
    dimension over mesh dimensions `dims` (functional collectives on their
    groups): (R, *x.shape), R the ranks of those dimensions, in rank
    order on every rank."""
    import torch.distributed._functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor
    x = x[None]
    for m in dims:
        x = gather(x, 0, (mesh, m))
    return x.wait() if hasattr(x, "wait") else x     # AsyncCollectiveTensor


def all_reduce(x: torch.Tensor, op: str, groups) -> torch.Tensor:
    """x all-reduced by `op` over each (mesh, mesh dimension) of
    `groups` in turn (functional collectives; none for no group)."""
    import torch.distributed._functional_collectives as funcol
    for g in groups:
        x = funcol.all_reduce(x, op, g)
        x = x.wait() if hasattr(x, "wait") else x    # AsyncCollectiveTensor
    return x


def _row_block(placements, coords, sizes) -> Tuple[int, int]:
    """(index, count) of the block of dimension 0 that the rank at
    `coords` holds: the mesh dimensions that shard it split it in mesh
    order, the first outermost (DTensor's default order)."""
    index, count = 0, 1
    for m, p in enumerate(placements):
        if p.is_shard(0):
            index, count = index * sizes[m] + coords[m], count * sizes[m]
    return index, count


def exchange_rows(x, placements):
    """DTensor x re-placed to `placements` by one all-to-all over the
    whole mesh, or None where that does not apply: both placements shard
    dimension 0 alone, evenly, the target shards it, and some rank's
    target rows are not among those it holds (else a slice does it).
    DTensor's own route gathers: from a batch of 256 on ("pod", "data")
    of the 2 x 16 x 16 mesh to one on ("data", "model") it gathers the
    batch over `model`, `data` and `pod` in turn, 400 rows on a rank
    that lacks one (ROADMAP C27).  Here each target row comes from the
    one rank that holds it and shares the target rank's coordinates on
    the mesh dimensions that do not shard it now.  Records no gradient:
    for tensors autograd does not track, such as a step's inputs."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    now, to = tuple(x.placements), tuple(placements)
    if now == to or not all(p.is_replicate() or p.is_shard(0)
                            for p in now + to):
        return None
    mesh = x.device_mesh
    sizes = tuple(mesh.shape)
    with unset_fake_temporarily():     # the mesh's rank map is real
        ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        return None                  # the exchange runs on the world group
    coords = list(np.ndindex(*sizes))
    shards = [_row_block(p, coords[0], sizes)[1] for p in (now, to)]
    if shards[1] == 1 or any(x.shape[0] % n for n in shards):
        return None
    n_now, n_to = (x.shape[0] // n for n in shards)

    def first(pl, c, rows):
        return _row_block(pl, c, sizes)[0] * rows

    if all(first(now, c, n_now) <= first(to, c, n_to)
           and first(to, c, n_to) + n_to <= first(now, c, n_now) + n_now
           for c in coords):
        return None
    src = [m for m, p in enumerate(now) if p.is_shard(0)]
    me = tuple(mesh.get_coordinate())
    rank_of = {c: g for g, c in enumerate(coords)}
    sends, recvs = [], []      # (group rank, first row, end row)
    for g, c in enumerate(coords):
        t0 = first(to, c, n_to)
        for r0 in range(t0 - t0 % n_now, t0 + n_to, n_now):
            holder, block = list(c), r0 // n_now
            for m in reversed(src):
                holder[m], block = block % sizes[m], block // sizes[m]
            span = (max(r0, t0), min(r0 + n_now, t0 + n_to))
            if tuple(holder) == me:
                sends.append((g,) + span)
            if c == me:
                recvs.append((rank_of[tuple(holder)],) + span)
    mine, lo = x.to_local(), first(now, me, n_now)
    out_splits, in_splits = [0] * len(coords), [0] * len(coords)
    for g, a, b in sends:
        in_splits[g] = b - a
    for g, a, b in recvs:
        out_splits[g] = b - a
    buf = torch.cat([mine[a - lo:b - lo] for _, a, b in sends]) \
        if sends else mine[:0]
    y = funcol.all_to_all_single(buf.contiguous(), out_splits, in_splits,
                                 dist.group.WORLD)
    y = y.wait() if hasattr(y, "wait") else y          # AsyncCollectiveTensor
    recvs.sort()                             # pieces come in rank order
    pieces = torch.split(y, [b - a for _, a, b in recvs])
    local = torch.cat([pieces[i] for i in sorted(
        range(len(recvs)), key=lambda i: recvs[i][1])])
    return DTensor.from_local(local, mesh, to, run_check=False,
                              shape=x.shape, stride=x.stride())


def _exchange(x, mesh, dim, out_splits=None, in_splits=None):
    import torch.distributed._functional_collectives as funcol
    y = funcol.all_to_all_single(x, out_splits, in_splits, (mesh, dim))
    return y.wait() if hasattr(y, "wait") else y       # AsyncCollectiveTensor


class _AllToAll(torch.autograd.Function):
    """An even all-to-all over x's leading dimension, one slice a rank
    (`all_to_all`); its gradient is the same exchange back."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _exchange(x.contiguous(), mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.mesh, ctx.dim), None, None


def all_to_all(x: torch.Tensor, mesh, dim: int, out_splits=None,
               in_splits=None) -> torch.Tensor:
    """x (a rank's local tensor) exchanged over mesh dimension `dim`
    (functional collectives): rank i sends the rows of x's leading
    dimension in its i-th piece to rank i and receives the pieces the
    others send it, in rank order.  Without splits the pieces are equal,
    one slice of x's leading dimension (of size the ranks') each, and the
    exchange records its gradient (the same exchange back); with them
    (`in_splits` the rows sent to each rank, `out_splits` received from
    each) it records none."""
    if out_splits is None and in_splits is None:
        return _AllToAll.apply(x, mesh, dim)
    return _exchange(x.contiguous(), mesh, dim, list(out_splits),
                     list(in_splits))


def shard_kinds(args: Sequence, dims: Sequence):
    """How DTensor `args` are sharded, for a computation that is local
    only over some of their dimensions.  dims[i] names argument i's
    shardable dimensions by kind, e.g. {"batch": d, "heads": d} (a kind it
    lacks is absent).  Returns (kinds, None), one kind or None
    (replicated) per mesh dimension, where every mesh dimension shards the
    arguments by one kind at most (an argument replicated there can be cut
    to its shard); else (None, the reason).  A mesh dimension of one rank
    shards nothing."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = args[0].device_mesh
    kinds = []
    for m in range(mesh.ndim):
        seen = set()
        if mesh.size(m) == 1:       # one shard: every dimension is whole
            kinds.append(None)
            continue
        for a, d in zip(args, dims):
            p = a.placements[m]
            if isinstance(p, Replicate):
                continue
            kind = next((k for k, dim in d.items()
                         if isinstance(p, Shard) and p.dim == dim), None)
            if kind is None:
                return None, (f"placement {p} of an argument of shape"
                              f" {tuple(a.shape)} on mesh dimension {m}")
            seen.add(kind)
        if len(seen) > 1:
            return None, (f"mesh dimension {m} shards the arguments by"
                          f" {sorted(seen)} at once")
        kinds.append(seen.pop() if seen else None)
    return kinds, None


class _ContiguousGrad(torch.autograd.Function):
    """The identity, its gradient made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def on_shards(name: str, fn, args: Sequence, dims: Sequence,
              out_dims: Sequence):
    """fn on the local shards of DTensor `args` (`local_map`), its outputs
    DTensors placed by `out_dims` (as dims, per output).  Arguments
    replicated where others are sharded are cut to their shard (a local
    slice).  Raises NotImplementedError where `shard_kinds` finds the
    work not local: a shard of a dimension the computation reduces over
    needs a cross-rank merge, which only attention over a KV sequence
    declares (the sequence as a kind of its own: `kernels.ops.
    decode_attention`, `models.attention.flash_attention`)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    kinds, reason = shard_kinds(args, dims)
    if reason:
        raise NotImplementedError(
            f"{name}: {reason}; it runs on local shards only where batch or"
            f" heads (or width) are sharded and the dimension it reduces over"
            f" is whole (a sharded sequence needs a cross-rank merge, which"
            f" only attention over a KV sequence has)")
    mesh = args[0].device_mesh

    def placements(d, keep=None):
        # a mesh dimension of one rank keeps the argument's own placement
        return tuple(Shard(d[k]) if k in d
                     else keep[m] if keep and mesh.size(m) == 1
                     else Replicate() for m, k in enumerate(kinds))

    in_pl = [placements(d, a.placements) for a, d in zip(args, dims)]
    args = [a if tuple(a.placements) == pl else a.redistribute(mesh, pl)
            for a, pl in zip(args, in_pl)]
    # an argument whole where others are sharded gets a gradient from each
    # rank's shard: a partial sum
    grad_pl = tuple(tuple(Partial() if k is not None and isinstance(
        p, Replicate) else p for k, p in zip(kinds, pl)) for pl in in_pl)
    out_pl = tuple(placements(d) for d in out_dims)

    def local(*a):
        # a local gradient leaves fn in whatever layout its ops give it
        # (a transpose of the kernel's layouts), which DTensor's views of
        # it downstream cannot take: make it contiguous
        return fn(*(_ContiguousGrad.apply(t) if isinstance(t, torch.Tensor)
                    and t.requires_grad and torch.is_grad_enabled() else t
                    for t in a))

    # local_map reads a tuple as one placement list per output
    mapped = local_map(local, out_placements=out_pl if len(out_pl) > 1
                       else list(out_pl[0]), in_placements=tuple(in_pl),
                       in_grad_placements=grad_pl, device_mesh=mesh)
    return mapped(*args)


def _along(name: str, fn, x, dims_used: Sequence[int]):
    """fn(x) on each rank's shard of a DTensor x, which is first made
    whole along `dims_used` (the dimensions fn moves data along); the
    output is placed as x.  DTensor has no strategy for these ops in every
    release (or a broken one over a 2-D mesh), and the work is local."""
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_shard() and p.dim in dims_used else p
               for p in x.placements)
    if pl != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    dims = {f"d{i}": i for i in range(x.ndim) if i not in dims_used}
    return on_shards(name, fn, (x,), (dims,), (dims,))


def pad(x: torch.Tensor, widths: Sequence[int],
        value: float = 0.0) -> torch.Tensor:
    """F.pad(x, widths, value=value); a DTensor is padded on its shards
    (`_along`)."""
    import torch.nn.functional as F
    if not _is_dtensor(x):
        return F.pad(x, widths, value=value)
    padded = [x.ndim - 1 - i for i in range(len(widths) // 2)
              if widths[2 * i] or widths[2 * i + 1]]
    return _along("pad", lambda t: F.pad(t, widths, value=value), x, padded)


def roll(x: torch.Tensor, shift: int, dim: int) -> torch.Tensor:
    """torch.roll(x, shift, dims=dim); a DTensor is rolled on its shards
    (`_along`)."""
    if not _is_dtensor(x):
        return torch.roll(x, shift, dims=dim)
    dim %= x.ndim
    return _along("roll", lambda t: torch.roll(t, shift, dims=dim), x, [dim])
