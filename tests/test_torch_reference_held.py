"""tools/reference_dryrun_held.py: the reference's dry-run cost compiles
held to the full model's sharding plan (ROADMAP C24).

The reference's dry run extrapolates flops and collectives from 1- and
2-repeat cuts of a config (`repro.launch.dryrun._corrected_cost`), and
each cut picks its plan from its own `param_count()`.  Under the tool's
`held_param_count` every cut must shard as the full model: the same
`param_specs` on every leaf path, the same pure data parallelism and the
same sequence-parallel residual, for every arch in both modes on both
production meshes.  Without the hold a cut granite-3-8b trains as pure
data parallelism (C24, asserted in the reference).

Stub meshes as tests/launch/test_sharding_rules.py's: the rules read only
`mesh.shape` and `mesh.axis_names`, so no device and no compile.
"""
import functools
import importlib.util
import pathlib
import types

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import get_config, list_archs
from repro.launch.sharding import param_specs
from repro.models import model as M
from repro.models.spec import ArchConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {
    "pod16x16": types.SimpleNamespace(shape={"data": 16, "model": 16},
                                      axis_names=("data", "model")),
    "pod2x16x16": types.SimpleNamespace(
        shape={"pod": 2, "data": 16, "model": 16},
        axis_names=("pod", "data", "model")),
}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "reference_dryrun_held", ROOT / "tools" / "reference_dryrun_held.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


@functools.lru_cache(maxsize=None)
def _config(arch, k):
    cfg = get_config(arch)
    return cfg if k is None else TOOL.cut(cfg, k)


@functools.lru_cache(maxsize=None)
def _shapes(arch, k):
    cfg = _config(arch, k)
    return jax.eval_shape(lambda: M.init_params(jax.random.PRNGKey(0), cfg))


def _flat(specs):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): s
            for path, s in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, P))[0]}


def _specs(arch, k, mesh, mode):
    return _flat(param_specs(_config(arch, k), _shapes(arch, k), mesh,
                             mode=mode))


def _plan(arch, k, mesh, kind):
    return TOOL.plan(_config(arch, k), mesh, kind, _shapes(arch, k))


@pytest.mark.parametrize("arch", list_archs())
def test_held_cuts_shard_as_the_full_model(arch):
    """Under the hold both cuts give the full config's spec on every leaf
    path and its three decisions, in train and serve, on both meshes."""
    full_count = _config(arch, None).param_count()
    for mesh_name, mesh in MESHES.items():
        for kind, mode in (("train", "train"), ("decode", "serve")):
            full = _specs(arch, None, mesh, mode)
            full_plan = _plan(arch, None, mesh, kind)
            with TOOL.held_param_count(full_count):
                for k in (1, 2):
                    assert _specs(arch, k, mesh, mode) == full, \
                        (arch, mesh_name, mode, k)
                    assert _plan(arch, k, mesh, kind) == full_plan, \
                        (arch, mesh_name, mode, k)
    assert ArchConfig.param_count(_config(arch, 1)) != full_count, \
        "the hold must end with its block"


def test_unheld_cut_trains_granite_as_pure_data_parallelism():
    """C24 in the reference: without the hold granite-3-8b's cuts (6.0e8 /
    8.0e8 parameters against 8.37e9) train as pure data parallelism,
    every parameter replicated, where the full model keeps FSDP and TP."""
    mesh = MESHES["pod16x16"]
    full = _specs("granite-3-8b", None, mesh, "train")
    assert _plan("granite-3-8b", None, mesh, "train") == dict(
        pure_dp=False, fsdp=True, seq_shard_residual=False)
    for k in (1, 2):
        assert _config("granite-3-8b", k).param_count() < 3e9
        cut = _specs("granite-3-8b", k, mesh, "train")
        assert set(cut) == set(full)
        assert all(s == P() for s in cut.values())
        assert cut != full
        assert _plan("granite-3-8b", k, mesh, "train") == dict(
            pure_dp=True, fsdp=False, seq_shard_residual=False)
