"""The port's dry run: collective records, per-rank costs, the fake
production meshes, and every arch's reduced config traced on a fake
(2, 4) mesh.

Twins of tests/launch/test_launch.py's `test_collective_parser` and
`test_roofline_terms_dominance` (the latter on the reference's TPU v5e
constants, read from `repro.core.hardware`, and on the port's H100
defaults) and of its subprocess smoke (`python -m
repro_torch.launch.dryrun --arch whisper-medium --shape decode_32k` in a
child process, at the full 16 x 16 mesh).  The fake process group moves
no data: these tests check what the trace records, not numbers.
"""
import dataclasses
import math
import os
import pathlib
import subprocess
import sys
import types

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro.core.hardware import V5E_HBM_BW, V5E_ICI_BW, V5E_PEAK_FLOPS
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import sharding
from repro_torch.launch.hlo_analysis import (StepRecorder, collective_bytes,
                                             roofline_from_counts,
                                             roofline_terms)
from repro_torch.launch.mesh import fake_mesh, make_production_mesh
from repro_torch.launch.shapes import InputShape
from repro_torch.launch.sharding import distribute
from repro_torch.models import model as M
from repro_torch.models.common import on_shards, shard_kinds

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = {"train_4k": InputShape("train_4k", 32, 8, "train"),
         "prefill_32k": InputShape("prefill_32k", 32, 8, "prefill"),
         "decode_32k": InputShape("decode_32k", 32, 8, "decode"),
         "long_500k": InputShape("long_500k", 128, 1, "decode")}
SMALL_MESH = ((2, 4), ("data", "model"))


def _dt(mesh, shape, dtype, placements):
    """A DTensor of global `shape` with an empty local shard."""
    local = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.empty(local, dtype=dtype), mesh,
                              placements, run_check=False)


def test_collective_records():
    """An all-gather of bf16 (128, 128) and an all-reduce of f32 (4, 4)
    on the fake 16 x 16 mesh: result bytes per kind, as the reference
    parses them from HLO."""
    with make_production_mesh() as mesh, FakeTensorMode():
        a = _dt(mesh, (128, 128), torch.bfloat16, [Shard(0), Replicate()])
        b = _dt(mesh, (4, 4), torch.float32, [Replicate(), Partial()])
        rec = StepRecorder()
        with rec:
            a.redistribute(mesh, [Replicate(), Replicate()])
            b.redistribute(mesh, [Replicate(), Replicate()])
    c = collective_bytes(rec.records)
    assert c["all-gather"] == 128 * 128 * 2
    assert c["all-reduce"] == 4 * 4 * 4
    assert c["reduce-scatter"] == c["all-to-all"] == 0
    assert c["total"] == c["all-gather"] + c["all-reduce"]
    assert set(c) == {"all-gather", "all-reduce", "reduce-scatter",
                      "all-to-all", "collective-permute", "total"}


@pytest.mark.parametrize("now,to", [
    ((Shard(0), Shard(1)), (Shard(0), Shard(2))),      # over `model`
    ((Shard(1), Shard(2)), (Shard(0), Shard(2)))])     # over `data`
def test_shard_to_shard_records_one_all_to_all(now, to):
    """DTensor's redistribution from a shard of one dimension to a shard of
    another, on the fake (2, 4) mesh, records one all-to-all of the local
    bytes and no all-gather: what it runs on a GPU mesh, where a CPU
    mesh would all-gather (`hlo_analysis._gpu_alltoall`; its result is
    held to DTensor's own on gloo in tests/test_torch_gloo.py)."""
    shape = (8, 16, 32)
    with fake_mesh(*SMALL_MESH) as mesh, FakeTensorMode():
        a = _dt(mesh, shape, torch.bfloat16, list(now))
        rec = StepRecorder()
        with rec:
            b = a.redistribute(mesh, list(to))
        local = tuple(b.to_local().shape)
    assert [kind for kind, _ in rec.records] == ["all-to-all"]
    assert rec.records[0][1] == math.prod(shape) // 8 * 2
    assert tuple(b.placements) == to and math.prod(local) * 8 == \
        math.prod(shape)


def test_roofline_terms_dominance():
    v5e = dict(peak_flops=V5E_PEAK_FLOPS, hbm_bw=V5E_HBM_BW,
               ici_bw=V5E_ICI_BW)
    t = roofline_terms({"flops": 197e12, "bytes accessed": 10.0}, [], **v5e)
    assert t.compute_s == pytest.approx(1.0)
    assert t.dominant == "compute"
    t2 = roofline_terms({"flops": 1.0, "bytes accessed": 819e9}, [], **v5e)
    assert t2.dominant == "memory"
    # the port's defaults are the H100's
    t3 = roofline_terms({"flops": 989e12, "bytes accessed": 1.0}, [])
    assert t3.compute_s == pytest.approx(1.0)
    t4 = roofline_from_counts(1.0, 1.0, {"all-reduce": 225e9})
    assert t4.collective_s == pytest.approx(1.0) and t4.dominant == \
        "collective"


@pytest.mark.parametrize("sharded", [True, False])
def test_per_rank_flops(sharded):
    """A fully sharded matmul counts 1/256 of its global flops on a rank,
    a replicated one all of them."""
    M, K, N = 512, 256, 1024
    with make_production_mesh() as mesh, FakeTensorMode():
        if sharded:
            x = _dt(mesh, (M, K), torch.bfloat16, [Shard(0), Replicate()])
            w = _dt(mesh, (K, N), torch.bfloat16, [Replicate(), Shard(1)])
        else:
            x = _dt(mesh, (M, K), torch.bfloat16, [Replicate()] * 2)
            w = _dt(mesh, (K, N), torch.bfloat16, [Replicate()] * 2)
        rec = StepRecorder()
        with rec:
            y = x @ w
        assert tuple(y.placements) == ((Shard(0), Shard(1)) if sharded
                                       else (Replicate(), Replicate()))
    assert rec.flops == 2 * M * K * N // (256 if sharded else 1)
    assert rec.records == []
    assert rec.peak == M * N * 2 // (256 if sharded else 1)


class _Hidden(StepRecorder):
    """A StepRecorder that also lists the ops it leaves out as DTensor's
    shape propagation and strategy search."""

    def __init__(self):
        super().__init__()
        self.hidden = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if getattr(H._shadow, "depth", 0):
            self.hidden.append(func._overloadpacket.__name__)
        return super().__torch_dispatch__(func, types, args, kwargs)


def test_strategy_search_is_not_a_ranks_work(monkeypatch):
    """An elementwise op without a sharding strategy of its own (hardswish
    on torch 2.13, softplus on 2.11) makes DTensor's strategy search run
    its decomposition on tensors of the global (256, w) shape.  The
    recorder leaves those ops out and counts what the rank runs: its
    shard's op, and for a Partial input the all-reduce DTensor issues
    first.  With the search not flagged, its global-shape temporaries
    would set the peak.  (Each trace has a width of its own, so that no
    cached strategy spares it the search.)"""
    from torch.nn.functional import hardswish, softplus

    def trace(fn, width, placements):
        with make_production_mesh() as mesh, FakeTensorMode():
            x = _dt(mesh, (256, width), torch.bfloat16, placements)
            rec = _Hidden()
            rec.exclude(x)
            with rec:
                y = fn(x)
            search = set(rec.hidden) - {fn.__name__, "empty", "empty_strided"}
            return rec, tuple(y.to_local().shape), search

    for fn in (hardswish, softplus):
        try:
            rec, local, search = trace(fn, 64, [Shard(0), Shard(1)])
        except NotImplementedError:             # no strategy, no search
            continue
        if search:                              # the decomposition ran
            break
    else:
        pytest.fail("no candidate op takes DTensor's strategy search")
    assert local == (16, 4) and rec.records == []
    assert rec.peak == 16 * 4 * 2, rec.peak_at
    assert rec.peak_at == f"{fn.__name__} -> (16, 4) torch.bfloat16"
    assert rec.bytes_accessed == 2 * 16 * 4 * 2
    rec, local, search = trace(fn, 96, [Partial(), Replicate()])
    assert search and local == (256, 96)
    assert rec.records == [("all-reduce", 256 * 96 * 2)]
    assert rec.peak == 2 * 256 * 96 * 2, rec.peak_at    # reduced, output
    monkeypatch.setattr(H, "_PROPAGATION", H._PROPAGATION[:1])
    rec, _, search = trace(fn, 128, [Shard(0), Shard(1)])
    assert search and rec.peak >= 256 * 128 * 2, rec.peak_at
    assert "(256, 128)" in rec.peak_at


def test_fake_group_destroyed_and_live_group_refused():
    assert not dist.is_initialized()
    with make_production_mesh(multi_pod=True) as mesh:
        assert dist.get_world_size() == 512
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        with pytest.raises(RuntimeError, match="already live"):
            with make_production_mesh():
                pass
        assert dist.get_world_size() == 512
    assert not dist.is_initialized()
    with make_production_mesh() as mesh:
        assert dist.get_world_size() == 256 and tuple(mesh.shape) == (16, 16)
    assert not dist.is_initialized()


def test_distribute_refuses_uneven_shards():
    with fake_mesh(*SMALL_MESH) as mesh, FakeTensorMode():
        t = torch.empty(6, 8, device="meta")
        with pytest.raises(ValueError, match="does not divide"):
            distribute(t, ("model", None), mesh)
        d = distribute(t, ("data", "model"), mesh)
        assert tuple(d.to_local().shape) == (3, 2)


def test_local_work_rule():
    """Kernels and attention run on local shards only where batch or heads
    are sharded; a sharded sequence is refused by name."""
    with fake_mesh(*SMALL_MESH) as mesh, FakeTensorMode():
        q = _dt(mesh, (8, 4, 16), torch.float32, [Shard(0), Shard(1)])
        kv_heads = _dt(mesh, (8, 32, 4, 16), torch.float32,
                       [Shard(0), Shard(2)])
        kv_seq = _dt(mesh, (8, 32, 4, 16), torch.float32,
                     [Shard(0), Shard(1)])
        dims = ({"batch": 0, "heads": 1}, {"batch": 0, "heads": 2},
                {"batch": 0, "heads": 2})
        assert shard_kinds((q, kv_heads, kv_heads), dims) == (
            ["batch", "heads"], None)
        kinds, reason = shard_kinds((q, kv_seq, kv_seq), dims)
        assert kinds is None and "S(1)" in reason
        with pytest.raises(NotImplementedError, match="cross-rank merge"):
            on_shards("flash_decode", lambda *a: a[0], (q, kv_seq, kv_seq),
                      dims, dims[:1])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_pairs_on_a_fake_mesh(arch):
    """Every shape of the reduced config (one repeat) traced on a fake
    (2, 4) mesh: ok or the reference's skip, the traced arguments equal to
    the rules'."""
    cfg = get_config(arch).reduced(n_repeat=1)
    stub = types.SimpleNamespace(shape={"data": 2, "model": 4},
                                 axis_names=("data", "model"))
    for name, shape in SMALL.items():
        r = D.run_pair(arch, name, cfg=cfg, shape=shape,
                       mesh_shape=SMALL_MESH[0], mesh_names=SMALL_MESH[1],
                       save=False)
        if r["status"] == "skip":
            assert name == "long_500k", r
            continue
        assert r["status"] == "ok", r.get("traceback")
        b = r["bytes_per_device"]
        assert b["arguments"] == D.argument_bytes(cfg, shape, stub)
        assert b["arguments"] <= b["peak"] and r["fits_h100"]
        assert r["cost"]["flops"] > 0 and r["cost"]["bytes_accessed"] > 0
        if shape.kind != "prefill":      # updated in place
            assert b["aliased"] > 0
    assert not dist.is_initialized()


def test_failure_is_reported_not_ok(monkeypatch):
    """A rule that puts `model` on a non-dividing dimension fails the
    pair with its error; nothing turns it into ok."""
    from repro_torch.launch import sharding
    real = sharding._spec_for_param

    def bad(path, shape, cfg, mesh, fsdp="data"):
        if path == "embed":                  # (510, d): 510 % 4 != 0
            return ("model", None)
        return real(path, shape, cfg, mesh, fsdp=fsdp)

    monkeypatch.setattr(sharding, "_spec_for_param", bad)
    cfg = get_config("yi-6b").reduced(vocab=510)
    r = D.run_pair("yi-6b", "decode_32k", cfg=cfg, shape=SMALL["decode_32k"],
                   mesh_shape=SMALL_MESH[0], mesh_names=SMALL_MESH[1],
                   save=False)
    assert r["status"] == "fail" and "does not divide" in r["error"]
    assert "traceback" in r and not dist.is_initialized()


def test_dryrun_subprocess_smoke(tmp_path):
    """One full 16 x 16 trace in a child process, its JSON written."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-medium", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert "decode_32k pod16x16: ok" in r.stdout, r.stdout + r.stderr
    assert (tmp_path / "whisper-medium_decode_32k_pod16x16.json").exists()


def test_vocab_parallel_loss_moves_no_logits(monkeypatch):
    """C14: a train step whose logits' vocabulary lies on `model` (the
    tensor-parallel rules, not pure data parallelism) takes the
    vocab-parallel cross-entropy: no collective's result holds the rank's
    (B_local, S, V) logits or more, and their gradient reaches the head's
    constraint on its vocab shard, (Shard(0), Shard(2)), as the
    constraint binds it (nothing to redistribute)."""
    from repro_torch.models import common
    monkeypatch.setattr(D, "pure_dp", lambda cfg, mesh: False)
    cfg = get_config("yi-6b").reduced(n_repeat=1, vocab=16384)
    shape = InputShape("train_4k", 32, 64, "train")
    seen, real = [], common._Constrain.backward

    def bind(ctx, g):
        if g.ndim == 3 and g.shape[-1] == cfg.vocab:
            seen.append((tuple(g.placements), ctx.placements))
        return real(ctx, g)

    monkeypatch.setattr(common._Constrain, "backward", staticmethod(bind))
    recs = []
    real_trace = D.hlo_analysis.collective_bytes

    def keep(records):
        recs.extend(records)
        return real_trace(records)

    monkeypatch.setattr(D.hlo_analysis, "collective_bytes", keep)
    r = D.run_pair("yi-6b", "train_4k", cfg=cfg, shape=shape,
                   mesh_shape=SMALL_MESH[0], mesh_names=SMALL_MESH[1],
                   save=False)
    assert r["status"] == "ok", r.get("traceback")
    b_local = shape.global_batch // SMALL_MESH[0][0]
    logits = b_local * shape.seq_len * cfg.vocab \
        * getattr(torch, cfg.dtype).itemsize         # bytes
    assert recs and max(n for _, n in recs) < logits, max(recs)
    shard = (Shard(0), Shard(2))
    assert seen == [(shard, shard)]


@pytest.mark.parametrize("arch", ["llama31-70b", "whisper-medium"])
def test_cut_depth_shards_as_the_full_config(arch):
    """`tools/dryrun_peak_tensor.py`'s `cut_depth` keeps the full config's
    parameter count, so a cut pair is sharded as the full one: the same
    mesh settings (pure data parallelism, the sequence-parallel residual)
    and the same specs of every parameter of a repeat; whisper's encoder
    is cut alike."""
    from repro_torch.launch.shapes import SHAPES
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "tools"))
    from dryrun_peak_tensor import cut_depth
    cfg = get_config(arch)
    cut = cut_depth(cfg, 2)
    assert cut.n_repeat == 2 and cut.param_count() == cfg.param_count()
    if cfg.encoder is not None:
        assert cut.encoder.n_layers == 2
    stub = types.SimpleNamespace(shape={"data": 16, "model": 16},
                                 axis_names=("data", "model"))
    _, full_specs, full_kw = D.step_inputs(cfg, SHAPES["train_4k"], stub)
    _, cut_specs, cut_kw = D.step_inputs(cut, SHAPES["train_4k"], stub)
    assert cut_kw == full_kw
    assert cut_specs["params"]["layers"][0] == \
        full_specs["params"]["layers"][0]
    assert cut_specs["batch"] == full_specs["batch"]


def test_pure_dp_batch_on_the_multi_pod_mesh_is_one_row_a_rank(monkeypatch):
    """C17: under pure data parallelism on a fake 2 x 16 x 16 mesh,
    `constrain(x, "BATCH")` places a batch of 256 on data x model (pod
    holding it twice), one row a rank; a reduced granite-moe train pair
    of batch 256 traced there takes one row a rank into every repeat."""
    from repro_torch.models import model as M
    from repro_torch.models.common import constrain, set_mesh
    with fake_mesh((2, 16, 16), ("pod", "data", "model")) as mesh, \
            FakeTensorMode():
        x = _dt(mesh, (256, 8), torch.bfloat16,
                [Shard(0), Shard(0), Replicate()])
        with set_mesh(mesh, batch_axes_override=("pod", "data", "model")):
            y = constrain(x, "BATCH")
        assert tuple(y.placements) == (Replicate(), Shard(0), Shard(0))
        assert tuple(y.to_local().shape) == (1, 8)
    rows, real = [], M._repeat_full

    def keep(params, cfg, r, x, aux, **kw):
        rows.append(x.to_local().shape[0])
        return real(params, cfg, r, x, aux, **kw)

    monkeypatch.setattr(M, "_repeat_full", keep)
    cfg = get_config("granite-moe-1b-a400m").reduced(n_repeat=1)
    r = D.run_pair("granite-moe-1b-a400m", "train_4k", cfg=cfg,
                   shape=InputShape("train_4k", 16, 256, "train"),
                   mesh_shape=(2, 16, 16),
                   mesh_names=("pod", "data", "model"), save=False)
    assert r["status"] == "ok", r.get("traceback")
    assert rows and set(rows) == {1}, rows


# reduced GQA configs whose 2 KV heads do not divide `model` = 4 of the
# (2, 4) mesh, q's width (H * hd) unlike d_model's 256: 8 q heads split two
# a rank ("heads"), or 6, three a group, straddling a group's two ranks
# ("rows")
GQA_SPLITS = {"heads": dict(n_heads=8, n_kv_heads=2, head_dim=48),
              "rows": dict(n_heads=6, n_kv_heads=2, head_dim=48)}
GQA_SHAPES = {"prefill_32k": InputShape("prefill_32k", 4096, 8, "prefill"),
              "train_4k": InputShape("train_4k", 256, 8, "train")}


def _traced(monkeypatch, arch, cfg, shape, mesh_shape, block):
    """A pair of `cfg` (one repeat) traced on a fake mesh of mesh_shape
    ("data", "model") under the tensor-parallel rules (pure data
    parallelism off): the flops rank 0 records while the function
    `block` ((module or dict, name)) runs, summed over its calls, and
    every collective's (kind, result shape)."""
    recs = []

    class Rec(StepRecorder):
        def __init__(self):
            super().__init__()
            self.shapes = []
            recs.append(self)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            name = func._overloadpacket.__name__
            if name in H._KIND and not getattr(H._shadow, "depth", 0):
                self.shapes.append((H._KIND[name], tuple(out.shape)))
            return out

    mod, name = block
    put = monkeypatch.setitem if isinstance(mod, dict) else \
        monkeypatch.setattr
    real, flops = (mod[name] if isinstance(mod, dict)
                   else getattr(mod, name)), []

    def counted(*a, **kw):
        f0 = recs[-1].flops
        out = real(*a, **kw)
        flops.append(recs[-1].flops - f0)
        return out

    monkeypatch.setattr(H, "StepRecorder", Rec)
    put(mod, name, counted)
    for m in (D, sharding):
        monkeypatch.setattr(m, "pure_dp", lambda cfg, mesh: False)
    r = D.run_pair(arch, shape.name, cfg=cfg, shape=shape,
                   mesh_shape=mesh_shape, mesh_names=("data", "model"),
                   save=False)
    put(mod, name, real)
    assert r["status"] == "ok", r.get("traceback")
    return sum(flops), recs[-1].shapes


@pytest.mark.parametrize("shape", sorted(GQA_SHAPES))
@pytest.mark.parametrize("split", sorted(GQA_SPLITS))
def test_gqa_attention_split_over_model(monkeypatch, split, shape):
    """C21: GQA attention whose KV heads do not divide `model`, traced on
    a fake (2, 4) mesh (batch on `data`), records on a rank the unsharded
    call's attention flops (a (1, 1) mesh) / (2 x 4) within 1 %, and no
    all-gather of q's columns (a result of q's size for the rank's rows,
    B/2 x S x H hd); with q whole on every `model` rank, the parent's
    placement, the rank computes every head: 4x the flops, q gathered."""
    from repro_torch.models import attention
    cfg = dataclasses.replace(get_config("yi-6b").reduced(n_repeat=1),
                              **GQA_SPLITS[split])
    s = GQA_SHAPES[shape]
    block = (attention, "_flash_attention")
    whole, _ = _traced(monkeypatch, "yi-6b", cfg, s, (1, 1), block)
    split_f, shapes = _traced(monkeypatch, "yi-6b", cfg, s, (2, 4), block)
    assert split_f == pytest.approx(whole / 8, rel=0.01)
    q = s.global_batch // 2 * s.seq_len * cfg.n_heads * cfg.hd
    gathers = [sh for kind, sh in shapes
               if kind == "all-gather" and math.prod(sh) == q]
    assert not gathers
    monkeypatch.setattr(attention, "_q_split", lambda cfg: None)
    fault, shapes = _traced(monkeypatch, "yi-6b", cfg, s, (2, 4), block)
    assert fault == pytest.approx(whole / 2, rel=0.01)
    assert any(kind == "all-gather" and math.prod(sh) == q
               for kind, sh in shapes)


def test_mamba2_heads_split_over_model(monkeypatch):
    """C22: zamba2's Mamba2 blocks at prefill, traced on a fake (2, 4)
    mesh (batch on `data`), record on a rank the unsharded blocks' flops
    (a (1, 1) mesh) / (2 x 4) and the few that every rank repeats: the
    in-projection's B and C columns and the scan's C.B products, which
    the heads share (1.06 / 8 here, d_state 16 against 16 heads of 32);
    with the blocks whole on every `model` rank, the parent's, the rank
    computes every head's in-projection and scan (3.2 / 8: only its
    out-projection is split)."""
    from repro_torch.models import ssm
    cfg = get_config("zamba2-2.7b").reduced(n_repeat=1)
    s = InputShape("prefill_32k", 512, 8, "prefill")
    block = (M._FULL, "mamba2")
    whole, _ = _traced(monkeypatch, "zamba2-2.7b", cfg, s, (1, 1), block)
    split_f, _ = _traced(monkeypatch, "zamba2-2.7b", cfg, s, (2, 4), block)
    assert whole / 8 < split_f < 1.1 * whole / 8
    monkeypatch.setattr(ssm, "_heads_dim", lambda *a: None)
    fault, _ = _traced(monkeypatch, "zamba2-2.7b", cfg, s, (2, 4), block)
    assert fault > 3 * whole / 8


def test_rows_split_refuses_batched_positions():
    """Attention whose q rows `model` splits (`_q_split` "rows") refuses
    batched RoPE positions by name, on a fake (2, 4) mesh: the heads
    branch would attend every head on every rank, the fault C21
    repaired."""
    from repro_torch.models import attention
    from repro_torch.models.common import set_mesh
    cfg = dataclasses.replace(get_config("yi-6b").reduced(n_repeat=1),
                              **GQA_SPLITS["rows"])
    with fake_mesh(*SMALL_MESH) as mesh, FakeTensorMode():
        x = _dt(mesh, (8, 16, cfg.d_model), torch.float32,
                [Shard(0), Replicate()])
        params = {"norm": _dt(mesh, (cfg.d_model,), torch.float32,
                              [Replicate(), Replicate()])}
        pos = torch.zeros(8, 16, dtype=torch.long)
        with set_mesh(mesh):
            assert attention._q_split(cfg) == "rows"
            with pytest.raises(NotImplementedError,
                               match="batched positions"):
                attention.attention_full(params, cfg, x, positions=pos)
