"""A traced step's collectives, costs and memory, and its roofline terms.

The twin of the reference's compiled-HLO analysis.  There is no HLO here:
the dry run runs its step once, eagerly, on DTensors whose local shards
are fake tensors, under `StepRecorder`, a TorchDispatchMode below
DTensor that sees every local op of one rank (rank 0 of the fake group)
and every collective DTensor issues for it.  It records:

  * each `_c10d_functional` collective with its *result* bytes (the
    reference's convention): all_gather_into_tensor -> "all-gather",
    all_reduce -> "all-reduce", reduce_scatter_tensor -> "reduce-scatter",
    all_to_all_single -> "all-to-all";
  * flops of each local op (torch.utils.flop_counter's formulas: matmuls,
    convolutions, attention), so a fully sharded matmul counts 1/256 of
    its global flops and a replicated one all of them;
  * bytes accessed: the input and output bytes of every local op that is
    not a view.  Nothing is fused, so this is an upper bound on what
    XLA's cost analysis reports for the same program;
  * live bytes: every local tensor an op makes counts until the last
    tensor on its storage dies (a storage autograd saves for backward
    counts until the graph lets it go), so `peak` is the most held at
    once beside the step's arguments, and `peak_at` names the op, shape
    and dtype of the tensor whose allocation set it.

DTensor's own shape propagation and strategy search run ops on
global-shape placeholders; those are not the rank's work and are left
out.

`StepRecorder.memoized(fn)` traces a function of local tensors once per
signature (shapes, strides, dtypes and other arguments) under no_grad: a
later call with the same signature is not run again, and its flops,
bytes, collectives and rise in live bytes are credited from the first,
its outputs fresh tensors of the first's layouts.  The dry run memoizes
the chunked attention this way (identical in every layer, its chunk loop
of thousands of pairs a layer would otherwise dominate a 32K-token
prefill's trace), and a no-grad chunk scan's group of chunks.

Roofline terms (H100 constants, `core.hardware.H100`):
  compute    = flops / peak bf16 FLOP/s     (989e12)
  memory     = bytes accessed / HBM bytes/s (3.35e12)
  collective = collective bytes * ring factor / NVLink bytes/s (450e9)
NVLink joins the 8 GPUs of one node; 256 GPUs span 32 nodes, whose links
(InfiniBand, ~50 GB/s a GPU) are slower, so the collective term of a
16 x 16 mesh is a lower bound.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..core.hardware import H100

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_KIND = {"all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all"}

# ops that move no bytes of their own
_NO_BYTES = {"wait_tensor", "empty", "empty_strided", "new_empty",
             "new_empty_strided", "empty_like"}

_shadow = threading.local()


# ShardingPropagator's methods whose ops run on placeholders of the global
# shape: the output metadata, and the strategy search, which for an op
# without a strategy of its own runs the op's decomposition on tensors of
# the global shape
_PROPAGATION = ("_propagate_tensor_meta_non_cached",
                "propagate_op_sharding_non_cached")


@contextlib.contextmanager
def _mark_shape_propagation():
    """Flag DTensor's shape propagation while it runs (its ops run on fake
    global-shape placeholders, not on this rank's shards)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    origs = {name: getattr(ShardingPropagator, name) for name in _PROPAGATION}

    def flagging(orig):
        def flagged(self, *args, **kwargs):
            depth = getattr(_shadow, "depth", 0)
            _shadow.depth = depth + 1
            try:
                return orig(self, *args, **kwargs)
            finally:
                _shadow.depth = depth
        return flagged

    for name, orig in origs.items():
        setattr(ShardingPropagator, name, flagging(orig))
    try:
        yield
    finally:
        for name, orig in origs.items():
            setattr(ShardingPropagator, name, orig)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepRecorder(TorchDispatchMode):
    """Records one rank's local ops (see the module docstring).  Use as a
    context manager around the step; `exclude(tree)` first registers the
    step's arguments, whose storages (and views of them) are not counted
    as live."""

    def __init__(self):
        super().__init__()
        self.records: List[Tuple[str, int]] = []
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self.peak_at = ""       # the op, shape and dtype that set the peak
        self._refs: Dict[int, int] = {}
        self._size: Dict[int, int] = {}
        self._excluded: set = set()
        self._stack = contextlib.ExitStack()

    def exclude(self, tree) -> None:
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                local = getattr(t, "_local_tensor", t)
                self._excluded.add(local.untyped_storage()._cdata)

    def __enter__(self):
        self._stack.enter_context(_mark_shape_propagation())
        # a tensor autograd saves is held through a detached alias, whose
        # storage then counts until the graph frees it
        self._stack.enter_context(torch.autograd.graph.saved_tensors_hooks(
            lambda t: t.detach(), lambda t: t))
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._stack.close()
        return out

    def _release(self, key: int) -> None:
        self._refs[key] -= 1
        if self._refs[key] == 0:
            del self._refs[key]
            self.live -= self._size.pop(key)

    def _track(self, t: torch.Tensor, op: str) -> None:
        key = t.untyped_storage()._cdata
        if key in self._excluded:
            return
        if key not in self._refs:
            self._refs[key] = 0
            self._size[key] = t.untyped_storage().nbytes()
            self.live += self._size[key]
            if self.live > self.peak:
                self.peak = self.live
                self.peak_at = f"{op} -> {tuple(t.shape)} {t.dtype}"
        self._refs[key] += 1
        weakref.finalize(t, self._release, key)

    def memoized(self, fn):
        """fn, traced once per signature of its arguments while grad is off
        (see the module docstring); fn returns a tensor or a tuple of
        them."""
        seen = {}

        def sig(a):
            if isinstance(a, torch.Tensor):
                return (tuple(a.shape), tuple(a.stride()), a.dtype,
                        str(a.device))
            return a

        def layout(t):
            return (t.untyped_storage().nbytes(), t.dtype, t.shape,
                    t.stride(), t.storage_offset(), t.device)

        def like(size, dtype, shape, stride, offset, device):
            # a storage of the first call's output, allocated and tracked
            return torch.empty(size // dtype.itemsize, dtype=dtype,
                               device=device).as_strided(shape, stride,
                                                         offset)

        def call(*args, **kwargs):
            if torch.is_grad_enabled():
                return fn(*args, **kwargs)
            key = (tuple(map(sig, args)),
                   tuple(sorted((k, sig(v)) for k, v in kwargs.items())))
            hit = seen.get(key)
            if hit is None:
                flops, nbytes, live, peak = (self.flops, self.bytes_accessed,
                                             self.live, self.peak)
                n_rec, self.peak, at = len(self.records), live, self.peak_at
                out = fn(*args, **kwargs)
                outs = out if isinstance(out, tuple) else (out,)
                seen[key] = (self.flops - flops, self.bytes_accessed - nbytes,
                             self.peak - live, self.peak_at,
                             self.records[n_rec:], [layout(t) for t in outs],
                             isinstance(out, tuple))
                if peak >= self.peak:
                    self.peak, self.peak_at = peak, at
                return out
            flops, nbytes, rise, rise_at, recs, layouts, many = hit
            self.flops += flops
            self.bytes_accessed += nbytes
            self.records.extend(recs)
            if self.live + rise > self.peak:
                self.peak, self.peak_at = self.live + rise, rise_at
            outs = tuple(like(*lay) for lay in layouts)
            return outs if many else outs[0]
        return call

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs it on local shards
        out = func(*args, **kwargs)
        if getattr(_shadow, "depth", 0):
            return out
        name = func._overloadpacket.__name__
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if name in _KIND:
            self.records.append((_KIND[name], sum(map(_nbytes, outs))))
        if not outs:
            return out
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not func.is_view and name not in _NO_BYTES:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(map(_nbytes, ins + outs))
        for t in outs:
            self._track(t, name)
        return out


def collective_bytes(records) -> Dict[str, int]:
    """Per-collective-kind result bytes summed over a step's records
    ((kind, bytes) pairs, `StepRecorder.records`)."""
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for kind, nbytes in records:
        out[kind] += int(nbytes)
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


# ring factors: bytes actually moved per chip relative to result bytes
_RING_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

PEAK_FLOPS = H100.peak_bf16_flops
HBM_BW = H100.mem_bw_Bps
LINK_BW = H100.ici_Bps


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per-device flops
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes: float            # per-device link bytes (ring-adjusted)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    per_collective: Dict[str, int]

    def row(self) -> dict:
        return dict(flops=self.flops, hbm_bytes=self.hbm_bytes,
                    coll_bytes=self.coll_bytes,
                    compute_s=self.compute_s, memory_s=self.memory_s,
                    collective_s=self.collective_s, dominant=self.dominant)


def roofline_from_counts(flops: float, hbm_bytes: float,
                         per_collective: Dict[str, int],
                         *, peak_flops: float = PEAK_FLOPS,
                         hbm_bw: float = HBM_BW,
                         ici_bw: float = LINK_BW) -> "RooflineTerms":
    """Roofline terms from per-device counts."""
    adj = sum(per_collective.get(k, 0) * _RING_FACTOR[k]
              for k in _COLLECTIVES)
    terms = dict(compute_s=flops / peak_flops, memory_s=hbm_bytes / hbm_bw,
                 collective_s=adj / ici_bw)
    dominant = max(terms, key=terms.get)
    return RooflineTerms(flops=flops, hbm_bytes=hbm_bytes, coll_bytes=adj,
                         dominant=dominant.replace("_s", ""),
                         per_collective=dict(per_collective), **terms)


def roofline_terms(cost: dict, records,
                   *, peak_flops: float = PEAK_FLOPS,
                   hbm_bw: float = HBM_BW,
                   ici_bw: float = LINK_BW) -> RooflineTerms:
    """Roofline terms from a cost dict ("flops", "bytes accessed") and a
    step's collective records."""
    coll = collective_bytes(records)
    adj = sum(coll[k] * _RING_FACTOR[k] for k in _COLLECTIVES)
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    terms = dict(compute_s=flops / peak_flops, memory_s=hbm / hbm_bw,
                 collective_s=adj / ici_bw)
    dominant = max(terms, key=terms.get)
    return RooflineTerms(flops=flops, hbm_bytes=hbm, coll_bytes=adj,
                         dominant=dominant.replace("_s", ""),
                         per_collective=coll, **terms)
