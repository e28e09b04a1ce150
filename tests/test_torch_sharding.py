"""The port's distribution rules against the reference's.

Every case of tests/launch/test_sharding_rules.py and
tests/launch/test_launch.py (the slow 512-device subprocess smoke has its
twin in test_torch_dryrun.py; the collective parser and roofline cases
too), on the same stub meshes (the rules read only `.shape` and
`.axis_names`), then the port held to the reference leaf by leaf: every
spec of `param_specs` (both modes), `cache_specs` and `batch_specs` for
all 12 archs and their -swa variants on both meshes, `SHAPES`,
`applicability` and `input_specs`' shapes and dtypes, and the per-device
bytes of every pair's arguments.

The port's parameter tree keeps one entry per repeat
(`params["layers"][r]`, `params["encoder"]["layers"][r]`) where the
reference stacks `unit/...` leaves over a leading n_repeat axis: such a
leaf's spec is the reference's without its leading None.
"""
import functools
import json
import pathlib
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.launch import shapes as JSH
from repro.launch import sharding as JS
from repro.models import model as JM
from repro_torch.configs import ARCHS, get_config, list_archs
from repro_torch.launch import dryrun as D
from repro_torch.launch.shapes import SHAPES, applicability, input_specs
from repro_torch.launch.sharding import (batch_specs, cache_specs,
                                         local_shape, param_specs, pure_dp,
                                         shard_bytes, to_placements,
                                         tree_map_with_path)
from repro_torch.models import model as M

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = types.SimpleNamespace(shape={"data": 16, "model": 16},
                             axis_names=("data", "model"))
MESH3 = types.SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16},
                              axis_names=("pod", "data", "model"))
MESHES = {"pod16x16": MESH, "pod2x16x16": MESH3}
SWA = sorted(a + "-swa" for a in ARCHS
             if not ARCHS[a].swa_window and ARCHS[a].attn_block_count
             and ARCHS[a].encoder is None)
CONFIGS = sorted(ARCHS) + SWA


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return M.init_params(get_config(arch), torch.Generator(), device="meta")


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = jget_config(arch)
    return jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))


def _flat(tree):
    """{path: leaf} of a port tree (specs or tensors)."""
    out = {}

    def add(path, leaf):
        out[path] = leaf
    tree_map_with_path(add, tree)
    return out


def _spec_flat(specs):
    """{path: spec} of a port spec tree (a spec is a tuple leaf)."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{prefix}{i}/")
        else:
            out[prefix[:-1]] = t
    walk(specs, "")
    return out


def _ref_flat(specs):
    return {("/".join(str(getattr(p, "key", p)) for p in path)): s
            for path, s in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, P))[0]}


def _norm(spec):
    """A spec with one-axis tuples written as the axis (PartitionSpec
    stores P(("data",)) as P("data"), and compares them equal)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _ref_key(port_path):
    """The reference's path of a port leaf and whether it is stacked."""
    parts = port_path.split("/")
    for head in (["layers"], ["encoder", "layers"]):
        n = len(head)
        if parts[:n] == head:
            return "/".join(parts[:n - 1] + ["unit"] + parts[n + 1:]), True
    return port_path, False


def _specs(arch, mode, mesh=MESH):
    cfg = get_config(arch)
    shapes = _port_params(arch)
    return cfg, shapes, param_specs(cfg, shapes, mesh, mode=mode)


def _one(specs, key):
    """The spec of `key` with the repeat index 0 ("unit/" -> "layers/0/")."""
    return _spec_flat(specs)[key.replace("unit/", "layers/0/")]


# --- tests/launch/test_sharding_rules.py ---------------------------------

def test_divisibility_always_respected():
    """No spec may assign an axis to a non-dividing dim."""
    for arch in ("yi-6b", "grok-1-314b", "whisper-medium", "zamba2-2.7b",
                 "command-r-plus-104b"):
        cfg, shapes, specs = _specs(arch, "train")
        spec_map = _spec_flat(specs)
        for key, leaf in _flat(shapes).items():
            spec = spec_map[key]
            for dim, ax in zip(leaf.shape, tuple(spec) + (None,) * 8):
                if ax is None:
                    continue
                axes = ax if isinstance(ax, tuple) else (ax,)
                size = int(np.prod([MESH.shape[a] for a in axes]))
                assert dim % size == 0, (arch, key, leaf.shape, spec)


def test_serve_mode_drops_fsdp_for_small_models():
    _, _, train = _specs("llava-next-34b", "train")   # 34B: FSDP active
    _, _, serve = _specs("llava-next-34b", "serve")   # TP only
    k = "unit/b0_attn/wq"
    assert _one(train, k) == ("data", "model")        # FSDP + TP
    assert _one(serve, k) == (None, "model")          # TP only
    # mid-size train (<8B): TP-only even in training
    _, _, yi_train = _specs("yi-6b", "train")
    assert _one(yi_train, k) == (None, "model")


def test_serve_mode_keeps_fsdp_for_huge_models():
    _, _, serve = _specs("grok-1-314b", "serve")
    assert _one(serve, "unit/b0_attn/wq") == ("data", "model")


def test_pure_dp_for_small_training():
    cfg, shapes, specs = _specs("rwkv6-1.6b", "train")
    assert pure_dp(cfg, MESH)
    assert all(s == () for s in _spec_flat(specs).values())
    assert not pure_dp(get_config("yi-6b"), MESH)


def test_moe_expert_parallel_vs_tp():
    _, _, granite = _specs("granite-moe-1b-a400m", "serve")
    # 32 experts % 16 == 0 -> expert parallel
    assert _one(granite, "unit/b1_moe/w_up") == ("model", None, None)
    _, _, grok = _specs("grok-1-314b", "serve")
    # 8 experts < 16 -> TP inside expert ffn (+FSDP: grok is huge)
    assert _one(grok, "unit/b1_moe/w_up") == (None, "data", "model")


def test_cache_specs_modes():
    for arch, shape_name, expect in [
        # kv=32 divides model -> heads sharded
        ("zamba2-2.7b", "decode_32k", (None, ("data",), None, "model",
                                       None)),
        # kv=4 does not divide 16 -> sequence sharded on model
        ("yi-6b", "decode_32k", (None, ("data",), "model", None, None)),
        # batch=1 -> context parallelism on data(+model)
        ("h2o-danube-3-4b", "long_500k", (None, None, ("data", "model"),
                                          None, None)),
    ]:
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        cache = input_specs(cfg, shape)["cache"]
        flat = _spec_flat(cache_specs(cfg, cache, MESH,
                                      batch=shape.global_batch))
        key = next(k for k in flat if k.endswith("attn/k"))
        assert flat[key] == expect, (arch, flat[key])


def test_batch_specs():
    assert batch_specs(MESH, 256) == (("data",),)
    assert batch_specs(MESH3, 256) == (("pod", "data"),)
    assert batch_specs(MESH, 1) == (None,)
    assert batch_specs(MESH, 256, wide=True) == (("data", "model"),)
    # 256 does not divide pod*data*model=512 -> falls back
    assert batch_specs(MESH3, 256, wide=True) == (("pod", "data"),)


# --- tests/launch/test_launch.py -----------------------------------------

def test_shapes_table():
    s = SHAPES
    assert (s["train_4k"].seq_len, s["train_4k"].global_batch) == (4096, 256)
    assert (s["prefill_32k"].seq_len,
            s["prefill_32k"].global_batch) == (32768, 32)
    assert (s["decode_32k"].seq_len,
            s["decode_32k"].global_batch) == (32768, 128)
    assert (s["long_500k"].seq_len, s["long_500k"].global_batch) == (524288,
                                                                     1)


def test_long_500k_applicability():
    ok = {a: applicability(get_config(a), SHAPES["long_500k"]) is None
          for a in list_archs()}
    assert ok["zamba2-2.7b"] and ok["rwkv6-1.6b"] and ok["h2o-danube-3-4b"]
    assert not ok["whisper-medium"] and not ok["yi-6b"]
    # the -swa variants opt dense/MoE/VLM archs in
    assert applicability(get_config("yi-6b-swa"),
                         SHAPES["long_500k"]) is None


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_abstract(arch):
    """input_specs never allocates: every leaf is a meta tensor."""
    cfg = get_config(arch)
    for shape in SHAPES.values():
        if applicability(cfg, shape):
            continue
        specs = input_specs(cfg, shape)
        for leaf in _flat(specs).values():
            assert isinstance(leaf, torch.Tensor) and leaf.is_meta
        if shape.kind == "decode":
            assert tuple(specs["tokens"].shape) == (shape.global_batch, 1)


def test_dryrun_results_complete_if_present():
    """When the sweep has been run, every (arch x shape x mesh) must be
    ok or an explicitly documented skip."""
    d = D.RESULTS_DIR
    files = list(d.glob("*.json")) if d.exists() else []
    if len(files) < 40:
        pytest.skip("full dry-run sweep not yet executed")
    bad = [(f.name, r.get("error")) for f in files
           for r in [json.loads(f.read_text())] if r["status"] == "fail"]
    assert not bad, bad


# --- the port against the reference --------------------------------------

@pytest.mark.parametrize("arch", CONFIGS)
def test_param_specs_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shapes, jshapes = _port_params(arch), _ref_params(arch)
    for mesh in MESHES.values():
        for mode in ("train", "serve"):
            port = _spec_flat(param_specs(cfg, shapes, mesh, mode=mode))
            ref = _ref_flat(JS.param_specs(jcfg, jshapes, mesh, mode=mode))
            seen = set()
            for key, spec in port.items():
                rkey, stacked = _ref_key(key)
                want = tuple(ref[rkey])
                if stacked and want:
                    assert want[0] is None, (arch, rkey, want)
                    want = want[1:]
                assert _norm(spec) == _norm(want), (arch, mode, key, spec,
                                                    want)
                seen.add(rkey)
            assert seen == set(ref), (arch, set(ref) ^ seen)


@pytest.mark.parametrize("arch", CONFIGS)
def test_cache_and_batch_specs_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape_name, shape in SHAPES.items():
        if applicability(cfg, shape):
            continue
        for mesh in MESHES.values():
            for wide in (False, True):
                assert _norm(batch_specs(mesh, shape.global_batch,
                                         wide=wide)) \
                    == _norm(JS.batch_specs(mesh, shape.global_batch,
                                            wide=wide))
            if shape.kind != "decode":
                continue
            port = _spec_flat(cache_specs(
                cfg, input_specs(cfg, shape)["cache"], mesh,
                batch=shape.global_batch))
            ref = _ref_flat(JS.cache_specs(
                jcfg, JSH.input_specs(jcfg, JSH.SHAPES[shape_name])["cache"],
                mesh, batch=shape.global_batch))
            assert {k: _norm(v) for k, v in port.items()} \
                == {k: _norm(v) for k, v in ref.items()}, arch


_JDTYPE = {"int32": torch.int32, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


@pytest.mark.parametrize("arch", CONFIGS)
def test_shapes_applicability_and_input_specs_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in SHAPES.items():
        assert dataclass_fields(shape) == dataclass_fields(JSH.SHAPES[name])
        assert applicability(cfg, shape) == JSH.applicability(
            jcfg, JSH.SHAPES[name])
        if applicability(cfg, shape):
            continue
        port = _flat(input_specs(cfg, shape))
        ref = {("/".join(str(getattr(p, "key", p)) for p in path)): leaf
               for path, leaf in jax.tree_util.tree_flatten_with_path(
                   JSH.input_specs(jcfg, JSH.SHAPES[name]))[0]}
        assert set(port) == set(ref), (arch, name)
        for key, leaf in port.items():
            assert tuple(leaf.shape) == tuple(ref[key].shape), (arch, key)
            assert leaf.dtype == _JDTYPE[str(ref[key].dtype)], (arch, key)


def dataclass_fields(shape):
    return (shape.name, shape.seq_len, shape.global_batch, shape.kind)


def _ref_argument_bytes(arch, shape_name, mesh):
    """The per-device bytes of the reference dry run's arguments, summed
    from its specs and jax.eval_shape shapes."""
    jcfg, shape = jget_config(arch), JSH.SHAPES[shape_name]
    train = shape.kind == "train"
    params = _ref_params(arch)
    pspecs = JS.param_specs(jcfg, params, mesh,
                            mode="train" if train else "serve")
    specs = JSH.input_specs(jcfg, shape)
    wide = train and JS.pure_dp(jcfg, mesh)
    bspec = JS.batch_specs(mesh, shape.global_batch, wide=wide)

    def size(leaf, spec):
        n = int(np.prod(leaf.shape, dtype=np.int64)) * leaf.dtype.itemsize
        for ax in tuple(spec):
            for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                n //= mesh.shape[a]
        return n

    def tree_bytes(tree, spec_tree):
        return sum(size(leaf, spec) for leaf, spec in zip(
            jax.tree.leaves(tree),
            jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(x, P))))

    tok = lambda leaf: P(*([bspec[0]] + [None] * (len(leaf.shape) - 1)))
    total = tree_bytes(params, pspecs)
    if train:
        total += 2 * tree_bytes(jax.tree.map(
            lambda p: jax.ShapeDtypeStruct(p.shape, np.float32), params),
            pspecs) + 4                      # mu, nu and the int32 step
    if shape.kind in ("train", "prefill"):
        total += sum(size(v, tok(v)) for v in specs.values())
    else:
        cspecs = JS.cache_specs(jcfg, specs["cache"], mesh,
                                batch=shape.global_batch)
        total += tree_bytes(specs["cache"], cspecs) \
            + size(specs["tokens"], tok(specs["tokens"])) \
            + size(specs["pos"], tok(specs["pos"]))
    return total


@pytest.mark.parametrize("arch", CONFIGS)
def test_argument_bytes_equal_reference(arch):
    """Exactly the reference's per-device argument bytes, pair by pair, on
    both meshes.  A train step's reference arguments hold AdamW's int32
    step counter (4 bytes), which the port keeps on the host."""
    cfg = get_config(arch)
    for shape_name, shape in SHAPES.items():
        if applicability(cfg, shape):
            continue
        for mesh in MESHES.values():
            port = D.argument_bytes(cfg, shape, mesh, _port_params(arch))
            ref = _ref_argument_bytes(arch, shape_name, mesh)
            extra = 4 if shape.kind == "train" else 0
            assert port + extra == ref, (arch, shape_name, port, ref)


def test_whisper_decode_argument_bytes():
    """The sum the rules give for whisper-medium decode_32k on 16 x 16
    (the committed reference artifact, 1,841,685,696, predates them)."""
    assert D.argument_bytes(get_config("whisper-medium"),
                            SHAPES["decode_32k"], MESH) == 1_886_319_808


def test_placements_and_local_shapes():
    from torch.distributed.tensor import Replicate, Shard
    assert to_placements((None, ("data", "model")), MESH) == (Shard(1),
                                                              Shard(1))
    assert to_placements((("data",), None, "model"), MESH) == (Shard(0),
                                                               Shard(2))
    assert to_placements((), MESH3) == (Replicate(),) * 3
    assert local_shape((256, 4096), (("data", "model"), None), MESH) \
        == (1, 4096)
    assert shard_bytes((128, 1), torch.int32, (("data",), None), MESH) == 32
    with pytest.raises(ValueError, match="does not divide"):
        local_shape((8, 4096), ("model",), MESH)
    with pytest.raises(ValueError, match="mesh's order"):
        to_placements((("model", "data"),), MESH)


def test_launch_exports_equal_reference():
    import repro.launch
    import repro_torch.launch
    assert repro_torch.launch.__all__ == repro.launch.__all__


def test_ambient_mesh_and_constrain_rules():
    """`set_mesh` / `get_mesh` / `batch_axes` and the reference's
    `constrain` rules on the stub meshes; outside a mesh, and on a plain
    tensor, `constrain` changes nothing."""
    from repro_torch.models.common import (batch_axes, constrain,
                                           expand_spec, get_mesh,
                                           seq_shard_residual, set_mesh)
    x = torch.ones(4, 4)
    assert get_mesh() is None and batch_axes() == ()
    assert constrain(x, "BATCH") is x and not seq_shard_residual()
    with set_mesh(MESH3):
        assert get_mesh() is MESH3 and batch_axes() == ("pod", "data")
        assert constrain(x, "BATCH", "model") is x
        # "BATCH" expands, padded to rank
        assert expand_spec(("BATCH", None, "model"), 4, MESH3) == (
            ("pod", "data"), None, "model", None)
    with set_mesh(MESH, batch_axes_override=("pod", "data", "model"),
                  seq_shard_residual=True):
        assert batch_axes() == ("data", "model") and seq_shard_residual()
        # names missing from the mesh are dropped; an axis is used once
        assert expand_spec(("BATCH", "model"), 2, MESH) == (
            ("data", "model"), None)
        assert expand_spec(("pod", ("pod", "model"), "model"), 3, MESH) == (
            None, ("model",), None)
    assert get_mesh() is None and not seq_shard_residual()


SIZES3 = {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("dim,axes,sizes,kept", [
    # C17: pure data parallelism's batch of 256 on 2 x 16 x 16 keeps
    # data x model, one row a rank, not the leading run pod x data
    (256, ("pod", "data", "model"), SIZES3, ("data", "model")),
    (512, ("pod", "data", "model"), SIZES3, ("pod", "data", "model")),
    # a tie keeps the leading run: pod x data, not pod x model
    (32, ("pod", "data", "model"), SIZES3, ("pod", "data")),
    (16, ("pod", "data"), SIZES3, ("data",)),
    (2, ("pod", "data"), SIZES3, ("pod",)),
    (1, ("pod", "data", "model"), SIZES3, None),
    (8, ("data", "model"), SIZES3, None),
    (256, ("data", "model"), SIZES3, ("data", "model")),
    (6, ("data", "model"), {"data": 2, "model": 4}, ("data",)),
    (4, ("data", "model"), {"data": 2, "model": 4}, ("model",)),
    (8, (), SIZES3, None),
])
def test_constrain_keeps_the_largest_dividing_sub_product(dim, axes, sizes,
                                                          kept):
    """`constrain`'s fit of a dimension to its axes (`_fit_axes`): the
    sub-product in mesh order with the most shards that divides it, the
    leading run on a tie."""
    from repro_torch.models.common import _fit_axes
    assert _fit_axes(dim, axes, sizes) == kept
