"""Port MoE (model, serving, analytical lever) vs the JAX reference, on the CPU.

granite-moe-1b-a400m and grok-1-314b at `.reduced()` size in float32 on
the reference's converted weights:

  * `router_topk` and `load_balance_loss` within 1e-6;
  * `apply_moe` (the sort-based capacity dispatch) within 1e-5 of max|out|
    at decode and prefill shapes, drop-free (the reduced configs' default
    capacity factor) and with capacity_factor 0.5, where the dropped
    assignments must be the reference's exactly.  The bound is relative:
    the reference draws expert weights with fan_in = E, so the outputs
    reach 10^3, where one float32 ulp is already above an absolute 1e-5;
  * a property: the dispatch equals a dense per-token formulation in numpy
    (each token's top-k experts, gate-weighted, an assignment kept when
    fewer than C earlier tokens chose its expert);
  * prefill logits and caches and greedy decode within ATOL = 1e-4 with
    equal tokens (the rule of tests/test_torch_model.py);
  * `PoolEngine` and `run_policies`: the same token streams and exactly
    equal meters and stats (the rule of tests/test_torch_serving.py), also
    with an expert-dispatch floor (`dispatch_ms`);
  * `core.moe` and `computed_profile`: the reference's numbers exactly.
"""
import dataclasses
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jax_get_config
from repro.core import hardware as JH
from repro.core import modelspec as JMS
from repro.core import moe as JCM
from repro.core import power as JPW
from repro.core import profiles as JP
from repro.core import workloads as JW
from repro.launch import serve as jax_serve
from repro.models import model as JM
from repro.models import moe as JMoE
from repro import serving as JS
from repro_torch.configs import get_config
from repro_torch.core import hardware as H
from repro_torch.core import modelspec as MS
from repro_torch.core import moe as CM
from repro_torch.core import power as PW
from repro_torch.core import profiles as P
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.convert import convert_params
from repro_torch.serving import PoolEngine
from test_torch_model import ATOL, _slab, _tokens
from test_torch_serving import (ENGINE_SCENARIOS, _assert_same_engine,
                                _port_request)

ARCH_IDS = ["granite-moe-1b-a400m", "grok-1-314b"]
MOE_REL = 1e-5


def _configs(arch, capacity_factor=None):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's weights for `arch` reduced, and the port's copy
    (the capacity factor changes no weight)."""
    jparams = JM.init_params(jax.random.PRNGKey(0), _configs(arch)[0])
    return jparams, convert_params(jax.tree.map(np.asarray, jparams),
                                   device="cpu")


@pytest.fixture(scope="module", params=ARCH_IDS)
def pair(request):
    jcfg, cfg = _configs(request.param)
    return (jcfg, _weights(request.param)[0], cfg,
            _weights(request.param)[1])


def _moe_layer(jparams, params, r=0):
    """Repeat r's MoE block: the reference's leaves and the port's."""
    jp = jax.tree.map(lambda a: a[r], jparams["unit"]["b1_moe"])
    return jp, params["layers"][r]["b1_moe"]


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


# ---- router, aux loss, dispatch ------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 8])
def test_router_topk_and_load_balance_loss(k):
    E = 32
    logits = np.random.default_rng(k).standard_normal((3, 7, E)) \
        .astype(np.float32)
    jg, ji = JMoE.router_topk(jnp.asarray(logits), k)
    g, i = moe.router_topk(torch.as_tensor(logits), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    jl = JMoE.load_balance_loss(jnp.asarray(logits), ji, E)
    tl = moe.load_balance_loss(torch.as_tensor(logits), i, E)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-6, rtol=0)


def _reference_keep(jp, jcfg, x):
    """The reference's kept assignments, (T, k) in token order, and C."""
    B, S, d = x.shape
    C = S * B if S == 1 else max(int(B * S * jcfg.top_k / jcfg.n_experts
                                     * jcfg.capacity_factor), 1)
    h = JMoE.rms_norm(jnp.asarray(x), jp["norm"], jcfg.norm_eps) \
        .reshape(B * S, d)
    gates, idx = JMoE.router_topk(h @ jp["router"], jcfg.top_k)
    _, (_, keep, _, _, inv_order) = JMoE._dispatch_group(
        h, gates, idx, jcfg.n_experts, jcfg.top_k, C)
    return np.asarray(keep[inv_order]).reshape(B * S, jcfg.top_k), C


def _port_keep(p, cfg, x):
    B, S, d = x.shape
    C = moe.capacity(cfg, B * S, S)
    h = moe.rms_norm(torch.as_tensor(x), p["norm"], cfg.norm_eps) \
        .reshape(B * S, d)
    _, idx = moe.router_topk(h @ p["router"], cfg.top_k)
    _, (_, keep, inv_order) = moe._dispatch_group(h, idx, cfg.n_experts,
                                                  cfg.top_k, C)
    return keep[inv_order].reshape(B * S, cfg.top_k).numpy(), C


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("capacity_factor", [None, 0.5])
@pytest.mark.parametrize("B,S", [(2, 1), (4, 1), (2, 16), (3, 40)])
def test_apply_moe_matches_reference(arch, capacity_factor, B, S):
    jcfg, cfg = _configs(arch, capacity_factor)
    jparams, params = _weights(arch)
    for r in range(cfg.n_repeat):
        jp, p = _moe_layer(jparams, params, r)
        x = _x(cfg, B, S, seed=10 * r + S)
        want = np.asarray(JMoE.apply_moe(jp, jcfg, jnp.asarray(x)))
        got = moe.apply_moe(p, cfg, torch.as_tensor(x)).numpy()
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= MOE_REL, (r, err)
        jkeep, C = _reference_keep(jp, jcfg, x)
        keep, C2 = _port_keep(p, cfg, x)
        assert C == C2
        np.testing.assert_array_equal(keep, jkeep)
        if S == 1 or capacity_factor is None:
            assert keep.all()           # decode, and the reduced default
        else:
            assert not keep.all()       # 0.5 drops some assignments


def _dense_moe(p, cfg, x):
    """numpy: per token, the gate-weighted sum of its top-k experts' SwiGLU
    output, an assignment counted when fewer than C earlier tokens chose
    the same expert."""
    f = {k: v.double().numpy() for k, v in p.items()}
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(-1, d).astype(np.float64)
    h = xt / np.sqrt((xt * xt).mean(-1, keepdims=True) + cfg.norm_eps) \
        * f["norm"]
    logits = h @ f["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    gates = np.take_along_axis(probs, idx, -1)
    gates /= np.maximum(gates.sum(-1, keepdims=True), 1e-9)
    chose = np.zeros((len(h), E), np.int64)
    np.put_along_axis(chose, idx, 1, -1)
    earlier = np.cumsum(chose, 0) - chose           # tokens before t, per e
    C = moe.capacity(cfg, B * S, S)
    keep = np.take_along_axis(earlier, idx, -1) < C
    y = np.zeros_like(h)
    for t in range(len(h)):
        for j in range(k):
            if keep[t, j]:
                e = idx[t, j]
                g = h[t] @ f["w_gate"][e]
                u = h[t] @ f["w_up"][e]
                y[t] += gates[t, j] * ((g / (1 + np.exp(-g)) * u)
                                       @ f["w_down"][e])
    return x + y.reshape(B, S, d), keep


@settings(max_examples=40, deadline=None)
@given(T=st.integers(1, 24), E=st.integers(2, 6), k=st.integers(1, 3),
       S_is_one=st.booleans(), cf=st.sampled_from([0.25, 0.5, 1.0, None]),
       seed=st.integers(0, 2 ** 16))
def test_property_dispatch_equals_dense_formulation(T, E, k, S_is_one, cf,
                                                    seed):
    """Drop-free (cf None: E, so C = T·k; and every decode) and dropping
    capacity factors alike: the sort-based dispatch equals the dense
    per-token formulation with the counting keep mask."""
    k = min(k, E)
    d, fe = 8, 12
    cfg = types.SimpleNamespace(n_experts=E, top_k=k, norm_eps=1e-5,
                                capacity_factor=cf or float(E), d_model=d)
    B, S = (T, 1) if S_is_one else (1, T)
    g = torch.Generator().manual_seed(seed)
    p = {"norm": 1 + 0.1 * torch.randn(d, generator=g),
         "router": torch.randn(d, E, generator=g),
         "w_gate": torch.randn(E, d, fe, generator=g) / math.sqrt(d),
         "w_up": torch.randn(E, d, fe, generator=g) / math.sqrt(d),
         "w_down": torch.randn(E, fe, d, generator=g) / math.sqrt(fe)}
    x = torch.randn(B, S, d, generator=g).numpy()
    want, keep = _dense_moe(p, cfg, x)
    got = moe.apply_moe(p, cfg, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if S == 1 or cf is None:
        assert keep.all()
    port_keep, _ = _port_keep(p, cfg, x)
    np.testing.assert_array_equal(port_keep, keep)


# ---- model ---------------------------------------------------------------

def test_convert_unstacks_expert_leaves(pair):
    """The stacked (n_repeat, E, d, fe) expert leaves become one (E, d, fe)
    tensor per layer, repeat r's slice r."""
    jcfg, jparams, cfg, params = pair
    fe = cfg.moe_d_ff
    shapes = {"norm": (cfg.d_model,), "router": (cfg.d_model, cfg.n_experts),
              "w_gate": (cfg.n_experts, cfg.d_model, fe),
              "w_up": (cfg.n_experts, cfg.d_model, fe),
              "w_down": (cfg.n_experts, fe, cfg.d_model)}
    ref = jax.tree.map(np.asarray, jparams["unit"]["b1_moe"])
    assert len(params["layers"]) == cfg.n_repeat
    for r, layer in enumerate(params["layers"]):
        blk = layer["b1_moe"]
        assert {k: tuple(v.shape) for k, v in blk.items()} == shapes
        for leaf, t in blk.items():
            np.testing.assert_array_equal(t.numpy(), ref[leaf][r])
    init = M.init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    assert {k: (tuple(v.shape), v.dtype)
            for k, v in init["layers"][0]["b1_moe"].items()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in blk.items()}


def test_train_logits(pair):
    jcfg, jparams, cfg, params = pair
    toks = _tokens(cfg, 2, 24, seed=1)
    jlogits, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    logits = M.forward(params, cfg, torch.as_tensor(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_prefill_then_decode(pair, capacity_factor):
    """Prefill logits and cache (with drops at capacity_factor 0.5), then
    6 greedy decode steps (decode never drops)."""
    jcfg, jparams, cfg, params = pair
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    B, S, max_seq, steps = 2, 30, 40, 6
    toks = _tokens(cfg, B, S, seed=S)
    jlogits, jcache, _ = JM.forward(jparams, jcfg,
                                    {"tokens": jnp.asarray(toks)},
                                    mode="prefill")
    logits, cache = M.forward(params, cfg, torch.as_tensor(toks),
                              mode="prefill")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)
    assert sorted(cache) == sorted(jcache) == ["b0_attn"]
    for key in ("k", "v"):
        np.testing.assert_allclose(cache["b0_attn"][key].numpy(),
                                   np.asarray(jcache["b0_attn"][key]),
                                   atol=ATOL, rtol=0)
    jcache = {n: {k: jnp.asarray(v) for k, v in c.items()} for n, c in
              _slab(jax.tree.map(np.asarray, jcache), max_seq,
                    np.zeros).items()}
    cache = _slab(cache, max_seq, torch.zeros)
    step = jax.jit(lambda p, t, c, pos: JM.decode_step(p, jcfg, t, c, pos))
    nxt = np.array(jnp.argmax(jlogits[:, -1], axis=-1))
    for i in range(steps):
        pos = np.full(B, S + i, np.int32)
        jl, jcache = step(jparams, jnp.asarray(nxt[:, None]), jcache,
                          jnp.asarray(pos))
        tl, cache = M.decode_step(params, cfg, torch.as_tensor(nxt[:, None]),
                                  cache, pos)
        jl = np.asarray(jl[:, 0])
        np.testing.assert_allclose(tl[:, 0].numpy(), jl, atol=ATOL, rtol=0)
        nxt = jl.argmax(-1)
        assert (tl[:, 0].argmax(-1).numpy() == nxt).all(), i


# ---- serving ---------------------------------------------------------------

METER_DISPATCH = ("dispatch_s", "dispatch_joules", "m_dispatch_joules")


@pytest.fixture(scope="module")
def granite():
    jcfg, cfg = _configs("granite-moe-1b-a400m")
    jparams, params = _weights("granite-moe-1b-a400m")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("scenario", sorted(ENGINE_SCENARIOS))
def test_engine_matches_reference_engine(granite, scenario):
    """Immediate and chunked prefill, with an expert-dispatch floor: both
    profiles carry it (core.moe.with_dispatch_floor) and both meters label
    the same dispatch joules (run_policies below serves without one)."""
    jcfg, jparams, cfg, params = granite
    dispatch_ms = 2.5
    make, kw = ENGINE_SCENARIOS[scenario]
    jreqs = make(cfg.vocab)
    reqs = [_port_request(r) for r in jreqs]
    jeng = JS.PoolEngine(
        jcfg, jparams, name="t", dispatch_ms=dispatch_ms,
        profile=JCM.with_dispatch_floor(JP.H100_LLAMA70B, dispatch_ms), **kw)
    eng = PoolEngine(
        cfg, params, name="t", dispatch_ms=dispatch_ms,
        profile=CM.with_dispatch_floor(P.H100_LLAMA70B, dispatch_ms), **kw)
    for je, e in zip(jreqs, reqs):
        jeng.submit(je)
        eng.submit(e)
    jeng.run_until_drained(max_iters=500)
    eng.run_until_drained(max_iters=500)
    assert len(eng.completed) == len(reqs)
    _assert_same_engine(jeng, eng)
    for f in METER_DISPATCH:
        assert getattr(eng.meter, f) == getattr(jeng.meter, f), f
    assert eng.meter.dispatch_joules > 0
    assert eng.decode_steps > 0


def test_run_policies_matches_reference_launcher(granite):
    """Port `run_policies` vs the reference launcher's build_router +
    ContextRouter.run on the stream `serve.main` builds."""
    jcfg, jparams, cfg, params = granite
    n, b_short, window_long = 4, 24, 96
    res = serve.run_policies(cfg, params, requests=n, b_short=b_short,
                             window_long=window_long)
    lens = JW.WORKLOADS["azure-conv"].sample_requests(n, seed=0) \
        .astype(float)
    scale = (window_long - 8) / float(np.quantile(lens.sum(1), 0.99))
    rng = np.random.default_rng(7)
    base = []
    for i, (p, o) in enumerate(lens * scale):
        p = int(np.clip(p, 1, window_long - 9))
        o = int(np.clip(o, 1, window_long - 8 - p))
        base.append(JS.Request(rid=i, prompt=rng.integers(0, jcfg.vocab,
                                                          size=p),
                               max_new_tokens=o))
    p99 = int(np.quantile([r.max_new_tokens for r in base], 0.99)) + 1
    for policy in serve.POLICIES:
        router = jax_serve.build_router(
            jcfg, jparams, policy, b_short=b_short, window_long=window_long,
            profile=JP.H100_LLAMA70B, p99_output=p99)
        assert res[policy]["report"] == router.run(
            [dataclasses.replace(r) for r in base], max_iters=20000)
        for name, eng in res[policy]["engines"].items():
            _assert_same_engine(router.pools[name], eng)
            assert not eng.busy


# ---- the analytical MoE lever --------------------------------------------

SPECS = ["LLAMA31_8B", "LLAMA31_70B", "LLAMA31_405B", "QWEN3_235B_A22B"]


def _spec_pairs():
    pairs = [(getattr(MS, n), getattr(JMS, n)) for n in SPECS]
    for arch in ARCH_IDS:
        pairs.append((get_config(arch).analytical_spec(),
                      jax_get_config(arch).analytical_spec()))
    return pairs


@pytest.mark.parametrize("i", range(len(SPECS) + len(ARCH_IDS)))
@pytest.mark.parametrize("tp", [1, 8])
def test_computed_profile_equals_reference(i, tp):
    spec, jspec = _spec_pairs()[i]
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    for kw in ({}, {"kv_sharded": False}):
        assert spec.kv_bytes_per_token(tp=tp, **kw) \
            == jspec.kv_bytes_per_token(tp=tp, **kw)
    assert spec.weight_bytes() == jspec.weight_bytes()
    assert spec.weight_bytes(active_only=False) \
        == jspec.weight_bytes(active_only=False)
    for pm, jpm in ((None, None), (PW.H100_POWER, JPW.H100_POWER)):
        prof = P.computed_profile(spec, H.H100, pm, tp=tp)
        jprof = JP.computed_profile(jspec, JH.H100, jpm, tp=tp)
        assert dataclasses.asdict(prof) == dataclasses.asdict(jprof)
        for w in (2048, 8192, 32768):
            assert prof.tok_per_watt_at_window(w) \
                == jprof.tok_per_watt_at_window(w)
        for n, L in ((1, 512.0), (8, 8192.0), (64, 4096.0)):
            assert prof.tokens_per_s(n, L) == jprof.tokens_per_s(n, L)
            assert prof.tok_per_watt(n, L) == jprof.tok_per_watt(n, L)


@pytest.mark.parametrize("dispatch_ms", [0.0, 1.0, 10.0])
def test_moe_profile_and_dispatch_floor_equal_reference(dispatch_ms):
    prof = CM.moe_profile(MS.QWEN3_235B_A22B, H.H100, PW.H100_POWER, tp=8,
                          dispatch_ms=dispatch_ms)
    jprof = JCM.moe_profile(JMS.QWEN3_235B_A22B, JH.H100, JPW.H100_POWER,
                            tp=8, dispatch_ms=dispatch_ms)
    assert dataclasses.asdict(prof) == dataclasses.asdict(jprof)
    assert dataclasses.asdict(
        CM.with_dispatch_floor(P.H100_LLAMA70B, dispatch_ms)) \
        == dataclasses.asdict(
            JCM.with_dispatch_floor(JP.H100_LLAMA70B, dispatch_ms))
    with pytest.raises(ValueError):
        CM.with_dispatch_floor(P.H100_LLAMA70B, -dispatch_ms - 1e-3)


def test_dispatch_sensitivity_equals_reference():
    """§3.2 on the H100: Qwen3-235B-A22B against Llama-3.1-70B, the same
    points as the reference, and the reference test's shape of the curve."""
    pts = CM.dispatch_sensitivity(MS.QWEN3_235B_A22B, MS.LLAMA31_70B, H.H100,
                                  PW.H100_POWER)
    jpts = JCM.dispatch_sensitivity(JMS.QWEN3_235B_A22B, JMS.LLAMA31_70B,
                                    JH.H100, JPW.H100_POWER)
    assert [dataclasses.asdict(p) for p in pts] \
        == [dataclasses.asdict(p) for p in jpts]
    advs = {p.dispatch_ms: p.advantage_vs_dense for p in pts}
    assert advs[0.0] == max(advs.values()) and advs[0.0] > 2.0
    assert advs[10.0] < 0.45 * advs[0.0]


def test_moe_active_param_advantage_like_reference():
    """tests/core/test_archs_and_moe.py::test_moe_active_param_advantage's
    quantities on the port's copies equal the reference's."""
    def quantities(pkg_p, pkg_m, ms, h, pw):
        dense = pkg_p.computed_profile(ms.LLAMA31_70B, h.H100, pw.H100_POWER,
                                       tp=8)
        m = pkg_m.moe_profile(ms.QWEN3_235B_A22B, h.H100, pw.H100_POWER,
                              tp=8)
        return (m.roofline.w_ms / dense.roofline.w_ms,
                m.tok_per_watt(8, 8192) / dense.tok_per_watt(8, 8192),
                m.tokens_per_s(1, 8192) / dense.tokens_per_s(1, 8192),
                m.tok_per_watt_at_window(8192)
                / dense.tok_per_watt_at_window(8192))

    got = quantities(P, CM, MS, H, PW)
    assert got == quantities(JP, JCM, JMS, JH, JPW)
    w_ratio, adv8, _, adv_full = got
    assert w_ratio == pytest.approx(22e9 / 70.6e9, rel=0.02)
    assert 2.0 < adv8 < 5.0 and adv_full < adv8


# ---- dispatch groups (the distribution layer's per-shard routing) ------

@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("B,S", [(4, 1), (4, 20)])
def test_apply_moe_dispatch_groups_match_reference(arch, G, B, S,
                                                   monkeypatch):
    """`apply_moe` routed in G groups (as a mesh with G data shards routes
    it) against the reference's, both packages' `_n_dispatch_groups` set to
    G in this test: outputs within MOE_REL of max|out| and, at capacity
    0.5, each group's dropped assignments the reference's exactly."""
    jcfg, cfg = _configs(arch, 0.5)
    jparams, params = _weights(arch)
    monkeypatch.setattr(JMoE, "_n_dispatch_groups", lambda T: G)
    monkeypatch.setattr(moe, "_n_dispatch_groups", lambda T: G)
    jp, p = _moe_layer(jparams, params)
    x = _x(cfg, B, S, seed=G + S)
    want = np.asarray(JMoE.apply_moe(jp, jcfg, jnp.asarray(x)))
    kept = []
    real = moe._dispatch_group

    def spy(hf, idx, E, k, C):
        buf, meta = real(hf, idx, E, k, C)
        kept.append(meta[1][meta[2]].reshape(-1, k).numpy())
        return buf, meta

    monkeypatch.setattr(moe, "_dispatch_group", spy)
    got = moe.apply_moe(p, cfg, torch.as_tensor(x)).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= MOE_REL, err
    T, d, k = B * S, cfg.d_model, cfg.top_k
    C = moe.capacity(cfg, T, S, G)
    h = JMoE.rms_norm(jnp.asarray(x), jp["norm"], jcfg.norm_eps) \
        .reshape(G, T // G, d)
    assert len(kept) == G
    for g in range(G):
        _, idx = JMoE.router_topk(h[g] @ jp["router"], k)
        _, (_, jkeep, _, _, jinv) = JMoE._dispatch_group(
            h[g], None, idx, jcfg.n_experts, k, C)
        np.testing.assert_array_equal(
            kept[g], np.asarray(jkeep[jinv]).reshape(T // G, k))
    every = np.concatenate(kept)
    assert every.all() if S == 1 else not every.all()


def test_dispatch_groups_follow_the_mesh():
    """One group per data shard of the ambient mesh, halved until it
    divides the tokens; 1 without a mesh; `model` too under pure DP."""
    from repro_torch.models.common import set_mesh
    mesh = types.SimpleNamespace(shape={"data": 16, "model": 16},
                                 axis_names=("data", "model"))
    assert moe._n_dispatch_groups(64) == 1
    with set_mesh(mesh):
        assert moe._n_dispatch_groups(4096) == 16
        assert moe._n_dispatch_groups(24) == 8
        assert moe._model_axis_size() == 16
    with set_mesh(mesh, batch_axes_override=("pod", "data", "model")):
        assert moe._n_dispatch_groups(256 * 4096) == 256
