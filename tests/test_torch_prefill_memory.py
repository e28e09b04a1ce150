"""What a prefill keeps alive (ROADMAP C15, C16a), on the CPU.

  * C15a: the recurrent blocks' prefill caches own their rows.  Mamba2's
    conv state (the last d_conv - 1 conv inputs) and RWKV6's two shift
    states (the last normed inputs of the time and channel mix) are copies
    whose storage is their own size, not views that keep a layer's whole
    (B, S, C) input alive as long as the cache; their values are the
    rows they copy (zeros in front of a prompt shorter than the conv);
  * C15b: the dry run's prefill (no autograd, the chunk scans) takes a
    scan's chunks a group at a time: the recorder's peak of a reduced
    zamba2 and rwkv6 prefill falls below the all-at-once form's, with the
    same collectives and a cache of the same bytes;
  * C16a: a prefill writes each block's cache into the stacked leaves
    as the block returns it: on plain tensors the bits of `torch.stack`
    of the repeats' caches; under a mesh each leaf in
    `cache_specs`' placements, and the traced peak grows a repeat by one
    layer's cache as those placements shard it, not as the layer's
    attention left it (replicated over `model` where the KV heads do
    not divide it).
"""
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_mesh
from repro_torch.launch.shapes import InputShape
from repro_torch.launch.sharding import cache_specs, to_placements
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models.common import rms_norm, set_mesh


def _own(t):
    return t.untyped_storage().nbytes() == t.numel() * t.element_size()


def _layer_input(cfg, B, S, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, S, cfg.d_model, generator=g).to(
        getattr(torch, cfg.dtype))


@pytest.mark.parametrize("S", [2, 37])
def test_mamba2_conv_state_owns_its_rows(S):
    """At S = 37 the last 3 conv inputs; at S = 2 (shorter than the conv)
    a zero row in front of the two."""
    cfg = get_config("zamba2-2.7b").reduced()
    p = M.init_params(cfg, torch.Generator().manual_seed(0),
                      "cpu")["layers"][0]["b0_mamba2"]
    x = _layer_input(cfg, 2, S, seed=S)
    _, cache = ssm.mamba2_full(p, cfg, x, mode="prefill", impl="plain")
    K1, di, ds = cfg.d_conv - 1, cfg.d_inner, cfg.ssm_state
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    xbc = (h @ p["w_in"])[..., di:2 * di + 2 * ds].float()
    want = F.pad(xbc, (0, 0, max(K1 - S, 0), 0))[:, -K1:]
    conv = cache["conv"]
    assert conv.shape == (2, K1, di + 2 * ds) and _own(conv)
    assert torch.equal(conv, want)
    assert _own(cache["ssm"])


def test_rwkv6_shift_states_own_their_rows(monkeypatch):
    cfg = get_config("rwkv6-1.6b").reduced()
    p = M.init_params(cfg, torch.Generator().manual_seed(0),
                      "cpu")["layers"][0]["b0_rwkv6"]
    x = _layer_input(cfg, 2, 37, seed=1)
    seen, real = [], ssm._channel_mix
    monkeypatch.setattr(ssm, "_channel_mix",
                        lambda *a, **kw: seen.append(real(*a, **kw))
                        or seen[-1])
    _, cache = ssm.rwkv6_full(p, cfg, x, mode="prefill", impl="plain")
    h2 = seen[-1][1]
    h = rms_norm(x, p["norm_tm"], cfg.norm_eps)
    for key, want in (("shift_tm", h[:, -1]), ("shift_cm", h2[:, -1])):
        assert cache[key].shape == (2, cfg.d_model) and _own(cache[key])
        assert torch.equal(cache[key], want)
    assert _own(cache["wkv"])


def test_model_prefill_caches_own_their_rows():
    """Every leaf of a reduced zamba2's and rwkv6's per-layer prefill
    caches owns its storage (the blocks' caches before the stack)."""
    for arch in ("zamba2-2.7b", "rwkv6-1.6b"):
        cfg = get_config(arch).reduced(n_repeat=1)
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        tokens = torch.randint(0, cfg.vocab, (2, 40),
                               generator=torch.Generator().manual_seed(2))
        x = M.embed_inputs(params, cfg, tokens)
        caches = {}
        M._repeat_full(params, cfg, 0, x, 0.0, mode="prefill", enc_out=None,
                       impl="plain", with_aux=False,
                       sink=caches.__setitem__)
        leaves = [t for c in caches.values() for t in c.values()]
        assert leaves and all(_own(t) for t in leaves), arch


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_grouped_scans_lower_the_traced_prefill_peak(monkeypatch, arch):
    """A reduced prefill of 8192 tokens traced on a fake (2, 4) mesh (the
    dry run's `chunk_scans`): grouped, its peak is below the all-at-once
    form's (forced by a group longer than the prompt), every other number
    but the trace wall equal."""
    cfg = get_config(arch).reduced(n_repeat=1)
    shape = InputShape("prefill_8k", 8192, 8, "prefill")
    kw = dict(cfg=cfg, shape=shape, mesh_shape=(2, 4),
              mesh_names=("data", "model"), save=False)
    grouped = D.run_pair(arch, "prefill_8k", **kw)
    monkeypatch.setattr(ssm, "MAMBA_GROUP", 8192)
    monkeypatch.setattr(ssm, "WKV_GROUP", 8192)
    whole = D.run_pair(arch, "prefill_8k", **kw)
    assert grouped["status"] == whole["status"] == "ok"
    gb, wb = grouped["bytes_per_device"], whole["bytes_per_device"]
    assert gb["arguments"] == wb["arguments"]
    assert gb["outputs"] == wb["outputs"]
    assert grouped["collectives"] == whole["collectives"]
    assert gb["peak"] < wb["peak"], (gb, wb)


@pytest.mark.parametrize("arch", ["yi-6b", "zamba2-2.7b", "whisper-medium"])
def test_prefill_cache_is_the_stack_of_the_repeats_caches(arch,
                                                          monkeypatch):
    """A reduced prefill of 3 repeats (attention K/V, Mamba2 conv and SSM
    states, whisper's cross-attention K/V): each stacked leaf is bit for
    bit `torch.stack` of the caches its blocks returned repeat by repeat,
    in their dtype, and owns its storage."""
    cfg = get_config(arch).reduced(n_repeat=3)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=g)
    kw = {}
    if cfg.encoder is not None:
        kw["frames"] = torch.randn(2, cfg.encoder.n_frames, cfg.d_model,
                                   generator=g)
    seen, real = [{}, {}, {}], M._repeat_full

    def keep(params, cfg, r, x, aux, *, sink, **kw):
        def clone_then_sink(name, c):
            seen[r][name] = {key: t.clone() for key, t in c.items()}
            sink(name, c)
        return real(params, cfg, r, x, aux, sink=clone_then_sink, **kw)

    monkeypatch.setattr(M, "_repeat_full", keep)
    _, cache = M.forward(params, cfg, tokens, mode="prefill", impl="plain",
                         **kw)
    assert set(cache) == set(seen[0]) == set(seen[1]) == set(seen[2])
    for name, c in cache.items():
        assert set(c) == set(seen[0][name])
        for key, t in c.items():
            want = torch.stack([s[name][key] for s in seen])
            assert t.dtype == want.dtype and _own(t)
            assert torch.equal(t, want), (name, key)


def test_prefill_cache_placed_as_cache_specs_as_it_is_written():
    """A reduced yi-6b (2 KV heads, which do not divide `model` = 4)
    prefill traced on a fake (2, 4) mesh: every cache leaf comes out in
    `cache_specs`' placements (batch on `data`, sequence on `model`), and
    from 2 to 4 repeats the peak over the arguments grows a repeat by one
    layer's K and V as sharded so, a quarter of the K and V the layer's
    attention holds replicated over `model`."""
    shape = InputShape("prefill_32k", 64, 8, "prefill")
    rise = []
    for k in (2, 3, 4):
        cfg = get_config("yi-6b").reduced(n_repeat=k)
        r = D.run_pair("yi-6b", "prefill_32k", cfg=cfg, shape=shape,
                       mesh_shape=(2, 4), mesh_names=("data", "model"),
                       save=False)
        assert r["status"] == "ok", r.get("traceback")
        b = r["bytes_per_device"]
        rise.append(b["peak"] - b["arguments"])
    sharded = 2 * (8 // 2) * (64 // 4) * cfg.n_kv_heads * cfg.hd * 4
    assert [b - a for a, b in zip(rise, rise[1:])] == [sharded] * 2, rise
    with fake_mesh((2, 4), ("data", "model")) as mesh, FakeTensorMode():
        step = D.build_step("yi-6b", "prefill_32k", mesh, cfg=cfg,
                            shape=shape)
        with set_mesh(mesh, **step.mesh_kwargs):
            _, cache = step.fn(*step.args)
        specs = cache_specs(cfg, cache, mesh, batch=8)
        for name, c in cache.items():
            for key, t in c.items():
                assert specs[name][key] == (None, ("data",), "model", None,
                                            None)
                assert tuple(t.placements) == to_placements(
                    specs[name][key], mesh)
                assert tuple(t.to_local().shape) == (4, 4, 16, 2, 64)
