"""The port's analytical core (the 1/W law, Table 1, the power model,
workloads, the §10.3 extensions, the architectures' profiles and the
Appendix B API) vs the JAX package's numpy twins.

Each case mirrors one of tests/core/test_{golden_anchors,law,future_work,
beyond_paper,power,workloads,archs_and_moe}.py or
tests/core/test_fleet.py::test_analyzer_api: it computes the reference
test's quantities in both packages, asserts they are equal exactly (every
dataclass field, floats by their bits: `_plain` of
tests/test_torch_fleet_core.py), and asserts the reference test's own
claim on the port's.  The hypothesis properties keep the reference's
`max_examples` and run derandomized, so every run draws the same
examples.
"""
import dataclasses
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.configs import list_archs
from test_torch_fleet_core import assert_same

_MODULES = ("adaptive", "analyzer", "carbon", "disagg", "fleet", "hardware",
            "kvcache", "law", "modelspec", "moe", "multipool", "power",
            "profiles", "routing", "speculative", "tokenomics", "workloads")


def _pkg(root):
    core = importlib.import_module(f"{root}.core")
    return SimpleNamespace(
        root=root, core=core,
        configs=importlib.import_module(f"{root}.configs"),
        **{m: getattr(core, m) for m in _MODULES})


REF, PORT = _pkg("repro"), _pkg("repro_torch")


def _same(fn):
    """fn(package) on both packages, equal exactly; the port's result."""
    ref, port = fn(REF), fn(PORT)
    assert_same(ref, port)
    return port


def _derandomized(n):
    """The reference property's example count, the same examples every run."""
    return settings(max_examples=n, deadline=None, derandomize=True,
                    database=None)


# --- tests/core/test_golden_anchors.py --------------------------------------

def test_table1_anchor_64k():
    n, tpw = _same(lambda pk: (
        pk.profiles.H100_LLAMA70B.n_max(65536),
        pk.profiles.H100_LLAMA70B.tok_per_watt_at_window(65536)))
    assert n == 16
    assert tpw == pytest.approx(1.50, rel=0.02)


def test_table1_anchor_4k():
    n, tpw = _same(lambda pk: (
        pk.profiles.H100_LLAMA70B.n_max(4096),
        pk.profiles.H100_LLAMA70B.tok_per_watt_at_window(4096)))
    assert n == 256
    assert tpw == pytest.approx(17.6, rel=0.02)


def test_one_over_w_halving_per_context_doubling():
    fit = _same(lambda pk: pk.law.fit_one_over_w(pk.profiles.H100_LLAMA70B))
    assert fit.slope == pytest.approx(-1.0, abs=0.15)
    assert fit.r2 > 0.99
    for ratio in fit.halving_ratios:
        assert 0.42 < ratio < 0.65, fit.halving_ratios


def test_disagg_azure_h100_provisioning_anchor():
    rep = _same(lambda pk: pk.disagg.Disaggregated(
        b_short=4096, gamma=2.0).provision(
        pk.workloads.AZURE, pk.profiles.H100_LLAMA70B,
        pk.modelspec.LLAMA31_70B))
    pools = {p.name: p for p in rep.pools}
    assert {n: p.instances for n, p in pools.items()} == {
        "prefill-8K": 12, "decode-8K": 19,
        "prefill-64K": 26, "decode-64K": 21}
    nom = PORT.profiles.H100_LLAMA70B.power_model.p_nom_w \
        * PORT.fleet.PREFILL_SATURATION
    assert pools["prefill-8K"].power_w_per_instance == pytest.approx(nom)
    assert pools["prefill-64K"].power_w_per_instance == pytest.approx(nom)
    assert pools["decode-8K"].power_w_per_instance == \
        pytest.approx(578.58, rel=1e-3)
    assert pools["decode-64K"].power_w_per_instance == \
        pytest.approx(417.92, rel=1e-3)
    assert rep.instances == 78 and rep.gpus == 624
    assert rep.power_kw == pytest.approx(41.885, rel=1e-3)
    assert rep.tok_per_watt == pytest.approx(7.712, rel=1e-3)
    dec = [p for p in rep.pools if p.phase == "decode"]
    dec_tpw = (sum(p.tokens_per_s for p in dec)
               / sum(p.instances * p.power_w_per_instance for p in dec))
    assert dec_tpw == pytest.approx(16.339, rel=1e-3)


def _small_profile(pk):
    return pk.profiles.computed_profile(
        pk.modelspec.LLAMA31_8B, pk.hardware.H100, pk.power.H100_POWER, tp=1)


def _semantic(pk, **kw):
    return pk.routing.Semantic(
        b_short=4096, small_profile=_small_profile(pk),
        small_model=pk.modelspec.LLAMA31_8B, **kw).provision(
        pk.workloads.AZURE, pk.profiles.H100_LLAMA70B,
        pk.modelspec.LLAMA31_70B)


def test_semantic_azure_h100_provisioning_anchor():
    sem, semf = _same(lambda pk: (_semantic(pk, gamma=1.0),
                                  _semantic(pk, gamma=2.0)))
    assert {p.name: p.instances for p in sem.pools} == {
        "semantic-small-4K": 31, "semantic-large-64K": 26}
    assert sem.tok_per_watt == pytest.approx(11.357, rel=1e-3)
    assert {p.name: p.instances for p in semf.pools} == {
        "semantic-small-8K": 51, "semantic-large-64K": 26}
    assert semf.tok_per_watt == pytest.approx(8.625, rel=1e-3)


def test_semantic_misroute_degrades_analytical_tok_per_watt():
    clean, noisy = _same(lambda pk: (
        _semantic(pk, gamma=2.0),
        _semantic(pk, gamma=2.0, misroute_rate=0.3)))
    assert noisy.tok_per_watt < 0.9 * clean.tok_per_watt


def test_moe_pool_azure_h100_provisioning_anchor():
    def anchor(pk):
        m = pk.modelspec
        mk = pk.moe.moe_profile
        prof = mk(m.QWEN3_235B_A22B, pk.hardware.H100, pk.power.H100_POWER,
                  tp=8)
        dense = pk.routing.Homogeneous().provision(
            pk.workloads.AZURE, pk.profiles.H100_LLAMA70B, m.LLAMA31_70B)
        reps = {d: pk.routing.Homogeneous().provision(
            pk.workloads.AZURE, mk(m.QWEN3_235B_A22B, pk.hardware.H100,
                                   pk.power.H100_POWER, tp=8, dispatch_ms=d),
            m.QWEN3_235B_A22B) for d in (0.0, 2.0, 10.0)}
        return prof.n_max(65536), prof.roofline.w_ms, dense, reps

    n, w_ms, dense, reps = _same(anchor)
    assert n == 5
    assert w_ms == pytest.approx(2.113, rel=1e-3)
    assert dense.tok_per_watt == pytest.approx(5.294, rel=1e-3)
    expect = {0.0: (6.522, 1.232), 2.0: (3.496, 0.660), 10.0: (1.222, 0.231)}
    for d, (tpw, adv) in expect.items():
        assert reps[d].tok_per_watt == pytest.approx(tpw, rel=1e-3), d
        assert reps[d].tok_per_watt / dense.tok_per_watt == \
            pytest.approx(adv, abs=5e-3), d


# --- tests/core/test_law.py --------------------------------------------------

H100_TABLE1 = [(2048, 512, 598, 35.0), (4096, 256, 593, 17.6),
               (8192, 128, 583, 8.97), (16384, 64, 557, 4.69),
               (32768, 32, 507, 2.58), (65536, 16, 435, 1.50),
               (131072, 8, 369, 0.88)]
B200_TABLE1 = [(2048, 1343, 859, 61.4), (4096, 671, 857, 30.8),
               (8192, 335, 852, 15.5), (16384, 167, 838, 7.87),
               (32768, 83, 805, 4.09), (65536, 41, 735, 2.24),
               (131072, 20, 630, 1.30)]


@pytest.mark.parametrize("profile,table", [
    ("H100_LLAMA70B", H100_TABLE1), ("B200_LLAMA70B", B200_TABLE1)],
    ids=["H100", "B200"])
def test_table1_full(profile, table):
    rows = _same(lambda pk: pk.tokenomics.context_sweep(
        getattr(pk.profiles, profile), [r[0] for r in table]))
    for row, (ctx, nm, psat, tpw) in zip(rows, table):
        assert row.n_max == nm, (ctx, row.n_max, nm)
        assert row.p_sat_w == pytest.approx(psat, rel=0.01)
        assert row.tok_per_watt == pytest.approx(tpw, rel=0.02)


def test_nmax_exact_halving():
    rows = _same(lambda pk: pk.tokenomics.context_sweep(
        pk.profiles.H100_LLAMA70B))
    for a, b in zip(rows, rows[1:]):
        assert a.n_max == 2 * b.n_max


def test_tok_per_watt_halves_per_doubling():
    fit = _same(lambda pk: pk.law.fit_one_over_w(pk.profiles.H100_LLAMA70B))
    assert all(0.48 <= r <= 0.60 for r in fit.halving_ratios)
    assert fit.slope < -0.85
    assert fit.r2 > 0.99


def test_b200_shifts_curve_not_slope():
    def curves(pk):
        P, L = pk.profiles, pk.law
        return (L.fit_one_over_w(P.H100_LLAMA70B),
                L.fit_one_over_w(P.B200_LLAMA70B),
                pk.tokenomics.context_sweep(P.H100_LLAMA70B),
                pk.tokenomics.context_sweep(P.B200_LLAMA70B))

    f_h, f_b, h, b = _same(curves)
    assert abs(f_h.slope - f_b.slope) < 0.1
    gains = [rb.tok_per_watt / rh.tok_per_watt for rh, rb in zip(h, b)]
    assert all(1.45 <= g <= 1.85 for g in gains)
    assert gains[-1] < gains[1]


@_derandomized(50)
@given(capacity=st.integers(2 ** 12, 2 ** 24),
       window=st.integers(128, 2 ** 18))
def test_nmax_floor_properties(capacity, window):
    n = _same(lambda pk: pk.kvcache.n_max(capacity, window))
    assert n >= 1
    if n > 1:
        assert n * window <= capacity
        assert (n + 1) * window > capacity


@_derandomized(30)
@given(window=st.sampled_from([2048, 4096, 8192, 16384, 32768]))
def test_law_monotone(window):
    a, b = _same(lambda pk: (
        pk.profiles.H100_LLAMA70B.tok_per_watt_at_window(window),
        pk.profiles.H100_LLAMA70B.tok_per_watt_at_window(window * 2)))
    assert b < a


# --- tests/core/test_power.py ------------------------------------------------

H100_PSAT = [(512, 598), (256, 593), (128, 583), (64, 557), (32, 507),
             (16, 435), (8, 369)]


@pytest.mark.parametrize("b,expected", H100_PSAT)
def test_h100_table1_psat(b, expected):
    p = _same(lambda pk: pk.power.H100_POWER.power_w(b))
    assert p == pytest.approx(expected, rel=0.005)


def test_h100_calibration_points():
    p1, p128 = _same(lambda pk: (pk.power.H100_POWER.power_w(1),
                                 pk.power.H100_POWER.power_w(128)))
    assert p1 == pytest.approx(311, rel=0.03)
    assert p128 == pytest.approx(583, rel=0.03)


def test_half_saturation():
    sat, mid = _same(lambda pk: (
        pk.power.H100_POWER.saturation_b(),
        pk.power.H100_POWER.power_w(pk.power.H100_POWER.saturation_b())))
    assert sat == pytest.approx(18.4, rel=0.01)
    assert mid == pytest.approx((300 + 600) / 2, rel=0.01)


def test_tdp_fractions():
    pairs = _same(lambda pk: [
        (chip, pm) for chip, pm in [
            (pk.hardware.H200, pk.power.H200_POWER),
            (pk.hardware.B200, pk.power.B200_POWER),
            (pk.hardware.GB200, pk.power.GB200_POWER)]])
    for chip, pm in pairs:
        assert pm.p_idle_w == pytest.approx(0.43 * chip.tdp_w, rel=0.01)
        assert pm.p_nom_w == pytest.approx(0.86 * chip.tdp_w, rel=0.01)


def test_idle_floor():
    p0, pneg = _same(lambda pk: (pk.power.H100_POWER.power_w(0),
                                 pk.power.H100_POWER.power_w(-3)))
    assert p0 == 300.0
    assert pneg == 300.0


@_derandomized(50)
@given(b1=st.floats(0.5, 4096), b2=st.floats(0.5, 4096))
def test_monotone_in_concurrency(b1, b2):
    lo, hi = sorted([b1, b2])
    plo, phi = _same(lambda pk: (pk.power.H100_POWER.power_w(lo),
                                 pk.power.H100_POWER.power_w(hi)))
    assert plo <= phi + 1e-9


@_derandomized(50)
@given(b=st.floats(0, 1e6))
def test_bounded(b):
    p = float(_same(lambda pk: pk.power.H100_POWER.power_w(b)))
    assert 300.0 - 1e-6 <= p <= 600.0 + 1e-6


def test_from_tdp_fraction_roundtrip():
    pm = _same(lambda pk: pk.power.PowerModel.from_tdp_fraction(
        pk.hardware.H100))
    assert pm.p_idle_w == pytest.approx(301.0, rel=0.01)
    assert pm.p_nom_w == pytest.approx(602.0, rel=0.01)


def test_x0_from_roofline_ratio():
    """Appendix A's x0 = log2(W / H0) (`DecodeRoofline.x0_from_ratio`, the
    helper Table 7's consistency column computes by hand) for every
    generation's profile."""
    x0 = _same(lambda pk: {n: p.roofline.x0_from_ratio for n, p in
                           pk.profiles.GENERATION_PROFILES.items()})
    assert x0["H100-SXM5"] == pytest.approx(np.log2(6.72 / 0.139), rel=0.01)


# --- tests/core/test_workloads.py -------------------------------------------

def test_azure_stats():
    frac, out = _same(lambda pk: (pk.workloads.AZURE.frac_total_leq(4096),
                                  pk.workloads.AZURE.mean_output))
    assert frac == pytest.approx(0.89, abs=0.015)
    assert out == pytest.approx(325, rel=0.03)


def test_lmsys_stats():
    frac, out = _same(lambda pk: (pk.workloads.LMSYS.frac_total_leq(1536),
                                  pk.workloads.LMSYS.mean_output))
    assert 0.6 < frac < 0.95
    assert out == pytest.approx(136, rel=0.06)


def test_agent_stats():
    frac, q99 = _same(lambda pk: (pk.workloads.AGENT.frac_total_leq(8192),
                                  pk.workloads.AGENT.quantile_total(0.99)))
    assert frac == pytest.approx(0.74, abs=0.04)
    assert q99 == pytest.approx(32768, rel=0.25)


def test_split_consistency():
    splits = _same(lambda pk: {
        wl.name: (wl.split_by_total(4096), wl.mean_output, wl.totals)
        for wl in (pk.workloads.AZURE, pk.workloads.LMSYS,
                   pk.workloads.AGENT)})
    for s, mean_output, _ in splits.values():
        assert s["short"]["frac"] + s["long"]["frac"] == pytest.approx(1.0)
        if s["long"]["frac"]:
            assert s["long"]["mean_context"] > s["short"]["mean_context"]
        total_out = (s["short"]["frac"] * s["short"]["mean_output"]
                     + s["long"]["frac"] * s["long"]["mean_output"])
        assert total_out == pytest.approx(mean_output, rel=0.01)


def test_sampling_deterministic():
    a, b = _same(lambda pk: (pk.workloads.AZURE.sample_requests(100, seed=3),
                             pk.workloads.AZURE.sample_requests(100, seed=3)))
    assert (a == b).all()
    assert (a > 0).all()


def test_workload_registry():
    """`WORKLOADS` and the Appendix B model registry `PAPER_MODELS` (with
    `DEEPSEEK_V3`) name the same entries in both packages."""
    wls, models = _same(lambda pk: (
        {n: (w.prompt_mix, w.output_mu, w.output_sigma)
         for n, w in pk.workloads.WORKLOADS.items()},
        pk.modelspec.PAPER_MODELS))
    assert set(wls) == {"azure-conv", "lmsys-chat", "agent-heavy"}
    assert models["DeepSeek-V3"].n_active_params == 37e9


# --- tests/core/test_future_work.py -----------------------------------------

def _fo_and_disagg(pk):
    args = (pk.workloads.AZURE, pk.profiles.H100_LLAMA70B,
            pk.modelspec.LLAMA31_70B)
    return (pk.routing.FleetOpt(b_short=4096, gamma=2.0).provision(*args),
            pk.disagg.Disaggregated(b_short=4096, gamma=2.0).provision(*args))


def test_disagg_energy_economics():
    fo, dis = _same(_fo_and_disagg)
    assert dis.tokens_per_s == pytest.approx(fo.tokens_per_s, rel=0.05)
    decode_inst = sum(p.instances for p in dis.pools
                      if p.name.startswith("decode"))
    assert decode_inst < fo.instances
    assert dis.tok_per_watt < fo.tok_per_watt
    dec_pools = [p for p in dis.pools if p.name.startswith("decode")]
    dec_tpw = (sum(p.tokens_per_s for p in dec_pools)
               / sum(p.instances * p.power_w_per_instance
                     for p in dec_pools))
    assert dec_tpw > fo.tok_per_watt


def test_disagg_kv_handoff_is_ici_feasible():
    def handoff(pk):
        D, m, P = pk.disagg.Disaggregated, pk.modelspec, pk.profiles
        cp = P.computed_profile
        prof_tp1 = cp(m.LLAMA31_8B, pk.hardware.H100, pk.power.H100_POWER,
                      tp=1)
        prof_tp16 = cp(m.LLAMA31_8B, pk.hardware.H100, pk.power.H100_POWER,
                       tp=16)
        return (D.kv_handoff_bytes_per_s(pk.workloads.AZURE, m.LLAMA31_70B,
                                         P.H100_LLAMA70B),
                D.kv_handoff_bytes_per_request(1000, m.LLAMA31_70B,
                                               P.H100_LLAMA70B),
                D.kv_handoff_bytes_per_request(1000, m.LLAMA31_70B, prof_tp1),
                D.kv_handoff_bytes_per_request(1000, m.LLAMA31_70B,
                                               prof_tp16),
                D().kv_handoff_delay_s(1000, m.LLAMA31_70B, P.H100_LLAMA70B))

    bps, per_req8, per_req1, per_req16, delay = _same(handoff)
    assert 1e11 < bps < 2e12
    assert per_req8 == pytest.approx(per_req1)
    assert per_req16 == pytest.approx(2 * per_req8)
    assert 1e-4 < delay < 1e-2


def test_speculative_decoding_tradeoff():
    def spec(pk):
        S = pk.speculative
        target = pk.profiles.H100_LLAMA70B
        draft = pk.profiles.computed_profile(
            pk.modelspec.LLAMA31_8B, pk.hardware.H100, pk.power.H100_POWER,
            tp=1)
        return (S.speculative_tok_per_watt(target, draft, accept_rate=0.8,
                                           speculation_len=4),
                S.speculative_tok_per_watt(target, draft, accept_rate=0.5,
                                           speculation_len=8),
                S.sweep(target, draft))

    good, bad, pts = _same(spec)
    assert good.tok_per_watt > bad.tok_per_watt
    assert good.tokens_per_round > 2.9
    assert good.speedup_vs_plain > 1.0
    assert bad.speedup_vs_plain < good.speedup_vs_plain
    assert len(pts) == 12
    assert all(p.tok_per_watt > 0 for p in pts)


def test_adaptive_controller_tracks_distribution_shift():
    def control(pk):
        W = pk.workloads
        ctl = pk.adaptive.AdaptiveController(
            pk.profiles.H100_LLAMA70B, pk.modelspec.LLAMA31_70B,
            reoptimize_every=2000, capacity=4000, seed=1)
        rng = np.random.default_rng(0)
        idx = rng.integers(0, 200_000, 3000)
        for p, o in zip(W.AZURE.prompts[idx], W.AZURE.outputs[idx]):
            ctl.observe(int(p), int(o))
        b_chat = ctl.history[-1]["b_short"] if ctl.history else ctl.b_short
        idx = rng.integers(0, 200_000, 6000)
        for p, o in zip(W.AGENT.prompts[idx], W.AGENT.outputs[idx]):
            ctl.observe(int(p), int(o))
        return (b_chat, ctl.history, ctl.buf, ctl.b_short, ctl.gamma,
                ctl.route(100, 325.0), ctl.route(60000, 325.0))

    b_chat, history, _, _, _, short, long_ = _same(control)
    b_agent = history[-1]["b_short"]
    assert b_agent >= b_chat
    assert len(history) >= 2
    assert short == "short"
    assert long_ == "long"


# --- tests/core/test_beyond_paper.py ----------------------------------------

def test_three_pools_beat_two_on_dispersed_traffic():
    two, three = _same(lambda pk: tuple(
        pk.multipool.MultiPool(windows=w).provision(
            pk.workloads.AGENT, pk.profiles.H100_LLAMA70B,
            pk.modelspec.LLAMA31_70B)
        for w in ([8192, 65536], [4096, 16384, 65536])))
    assert three.tok_per_watt > two.tok_per_watt


def test_pool_count_diminishing_returns():
    sweep = _same(lambda pk: pk.multipool.sweep_pool_counts(
        pk.workloads.AZURE, pk.profiles.H100_LLAMA70B,
        pk.modelspec.LLAMA31_70B))
    tpw = dict(sweep)
    assert tpw[2] > tpw[1]
    assert tpw[3] >= tpw[2] * 0.95
    assert tpw[3] / tpw[2] < tpw[2] / tpw[1]


def test_ladder_windows_dedupes_clamped_rungs():
    l3, l5, sweep = _same(lambda pk: (
        pk.multipool.ladder_windows(3), pk.multipool.ladder_windows(5),
        pk.multipool.sweep_pool_counts(pk.workloads.AZURE,
                                       pk.profiles.H100_LLAMA70B,
                                       pk.modelspec.LLAMA31_70B)))
    assert l3 == [4096, 16384, 65536]
    assert l5 == [2048, 4096, 16384, 65536]
    ks = [k for k, _ in sweep]
    assert ks == sorted(set(ks)), ks


@pytest.mark.parametrize("windows,gamma", [
    ([4096, 4096, 65536], 2.0), ([8192, 4096], 2.0), ([], 2.0),
    ([4096, 65536], 0.5)], ids=["duplicate", "descending", "empty",
                                "gamma-below-one"])
def test_multipool_rejects_bad_ladders(windows, gamma):
    def refuse(pk):
        with pytest.raises(ValueError) as exc:
            pk.multipool.MultiPool(windows=windows, gamma=gamma).provision(
                pk.workloads.AGENT, pk.profiles.H100_LLAMA70B,
                pk.modelspec.LLAMA31_70B)
        return str(exc.value)

    _same(refuse)


def _fo_report(pk):
    return pk.routing.FleetOpt(b_short=4096, gamma=2.0).provision(
        pk.workloads.AZURE, pk.profiles.H100_LLAMA70B,
        pk.modelspec.LLAMA31_70B)


def test_carbon_bill():
    b, b2 = _same(lambda pk: (
        pk.carbon.bill(_fo_report(pk), pk.carbon.GRIDS["us-east-mixed"]),
        pk.carbon.bill(_fo_report(pk), pk.carbon.GRIDS["eu-north"])))
    assert b.g_co2_per_mtok > 0
    assert b.usd_rental_per_mtok > b.usd_energy_per_mtok
    assert b2.g_co2_per_mtok < 0.2 * b.g_co2_per_mtok
    assert b2.tok_per_watt == b.tok_per_watt


@pytest.mark.parametrize("objective", ["g_co2_per_mtok", "tok_per_watt",
                                       "usd_total_per_mtok"])
def test_topology_ranking_is_objective_dependent(objective):
    def rank(pk):
        reps = {"homo": pk.routing.Homogeneous().provision(
            pk.workloads.AZURE, pk.profiles.H100_LLAMA70B,
            pk.modelspec.LLAMA31_70B), "fleetopt": _fo_report(pk)}
        return pk.carbon.rank_topologies(
            reps, pk.carbon.GRIDS["us-east-mixed"], objective)

    ranked = _same(rank)
    if objective == "g_co2_per_mtok":
        assert ranked[0]["topology"] == "fleetopt"


def test_tpu_v5e_profile():
    fit, tp = _same(lambda pk: (
        pk.law.fit_one_over_w(pk.profiles.V5E_LLAMA70B,
                              contexts=(2048, 4096, 8192, 16384)),
        pk.profiles.V5E_LLAMA70B.tp))
    assert fit.slope < -0.8
    assert tp == 16


# --- tests/core/test_archs_and_moe.py ---------------------------------------

def _dense_and_moe(pk):
    m, h, p = pk.modelspec, pk.hardware.H100, pk.power.H100_POWER
    return (pk.profiles.computed_profile(m.LLAMA31_70B, h, p, tp=8),
            pk.moe.moe_profile(m.QWEN3_235B_A22B, h, p, tp=8))


def test_moe_active_param_advantage():
    def adv(pk):
        dense, moe = _dense_and_moe(pk)
        return (dense, moe,
                moe.tok_per_watt(8, 8192) / dense.tok_per_watt(8, 8192),
                moe.tokens_per_s(1, 8192) / dense.tokens_per_s(1, 8192),
                moe.tok_per_watt_at_window(8192)
                / dense.tok_per_watt_at_window(8192))

    dense, moe, adv8, adv1, adv_full = _same(adv)
    assert (moe.roofline.w_ms / dense.roofline.w_ms
            == pytest.approx(22e9 / 70.6e9, rel=0.02))
    assert moe.roofline.w_ms * 0.777 == pytest.approx(1.64, rel=0.05)
    assert 2.0 < adv8 < 5.0
    assert adv1 == pytest.approx(dense.roofline.w_ms / moe.roofline.w_ms,
                                 rel=0.15)
    assert adv_full < adv8


def test_dispatch_sensitivity_shrinks_advantage():
    pts = _same(lambda pk: pk.moe.dispatch_sensitivity(
        pk.modelspec.QWEN3_235B_A22B, pk.modelspec.LLAMA31_70B,
        pk.hardware.H100, pk.power.H100_POWER))
    advs = {p.dispatch_ms: p.advantage_vs_dense for p in pts}
    assert advs[0.0] == max(advs.values())
    assert advs[0.0] > 2.0
    assert advs[10.0] < 0.45 * advs[0.0]
    vals = [p.advantage_vs_dense for p in pts]
    assert vals == sorted(vals, reverse=True)


def test_405b_near_zero_regime():
    h, b = _same(lambda pk: tuple(
        pk.profiles.computed_profile(pk.modelspec.LLAMA31_405B, chip, pm,
                                     tp=8)
        for chip, pm in ((pk.hardware.H100, pk.power.H100_POWER),
                         (pk.hardware.B200, pk.power.B200_POWER))))
    assert h.n_max(8192) == 1
    assert b.n_max(8192) >= 10
    assert (b.tok_per_watt_at_window(8192)
            > 10 * h.tok_per_watt_at_window(8192))


def test_table5_generation_ordering():
    def gens(pk):
        P, T = pk.profiles, pk.tokenomics
        return ({n: p.tok_per_watt_at_window(8192)
                 for n, p in [("H100", P.H100_LLAMA70B),
                              ("H200", P.H200_LLAMA70B),
                              ("B200", P.B200_LLAMA70B),
                              ("GB200", P.GB200_LLAMA70B)]},
                [T.tok_per_dollar_m(p, 8192) for p in (
                    P.B200_LLAMA70B, P.H200_LLAMA70B, P.H100_LLAMA70B)])

    tpw, dollars = _same(gens)
    assert tpw["H200"] / tpw["H100"] == pytest.approx(2.1, rel=0.3)
    assert tpw["B200"] > tpw["H200"] > tpw["H100"]
    assert tpw["GB200"] < tpw["B200"]
    assert dollars[0] > dollars[1] > dollars[2]


def test_quantization_halves_w():
    fp16, fp8 = _same(lambda pk: tuple(
        pk.profiles.computed_profile(
            dataclasses.replace(pk.modelspec.LLAMA31_70B, dtype_bytes=b),
            pk.hardware.H100, pk.power.H100_POWER, tp=8)
        for b in (2.0, 1.0)))
    assert fp8.roofline.w_ms == pytest.approx(fp16.roofline.w_ms / 2,
                                              rel=0.01)


@pytest.mark.parametrize("arch", list_archs())
def test_arch_profile_and_law(arch):
    def law(pk):
        cfg = pk.configs.get_config(arch)
        spec = cfg.analytical_spec()
        prof = pk.profiles.computed_profile(
            spec, pk.hardware.H100, pk.power.H100_POWER,
            tp=8 if spec.n_params > 2e10 else 1)
        fit = None if spec.n_kv_heads == 0 else pk.law.fit_one_over_w(
            prof, contexts=(2048, 4096, 8192, 16384, 32768))
        return (cfg.arch_type, spec, spec.kv_bytes_per_token(),
                spec.kv_bytes_per_token(tp=8), prof, fit)

    arch_type, spec, kappa, kappa_tp8, _, fit = _same(law)
    if spec.n_kv_heads == 0:
        assert kappa == 0.0
        return
    if arch_type == "hybrid":
        assert kappa_tp8 < 0.6 * (2 * 1 * 128 * 2 * 80)
    assert fit.slope < -0.5


def test_moe_archs_have_active_override():
    specs = _same(lambda pk: [pk.configs.get_config(a).analytical_spec()
                              for a in ("granite-moe-1b-a400m",
                                        "grok-1-314b")])
    for spec in specs:
        assert spec.is_moe
        assert spec.n_active_params < 0.45 * spec.n_params


def test_assigned_param_counts():
    expect = {"granite-moe-1b-a400m": 1.4e9, "zamba2-2.7b": 2.4e9,
              "whisper-medium": 0.8e9, "h2o-danube-3-4b": 4.0e9,
              "llava-next-34b": 34e9, "granite-3-8b": 8.4e9,
              "yi-6b": 6.1e9, "rwkv6-1.6b": 1.6e9,
              "command-r-plus-104b": 107e9, "grok-1-314b": 316e9}
    got = _same(lambda pk: {a: pk.configs.get_config(a).param_count()
                            for a in expect})
    for arch, target in expect.items():
        assert got[arch] == pytest.approx(target, rel=0.35), \
            (arch, got[arch] / 1e9)


# --- tests/core/test_fleet.py::test_analyzer_api ----------------------------

def test_analyzer_api():
    """Appendix B: fleet_tpw_analysis accepts any GpuProfile (the protocol
    is runtime-checkable in both packages)."""
    def analysis(pk):
        res = pk.analyzer.fleet_tpw_analysis(
            workload="azure-conv", profile=pk.profiles.H100_LLAMA70B,
            b_short=4096)
        return res, res.table(), isinstance(pk.profiles.H100_LLAMA70B,
                                            pk.profiles.GpuProfile)

    res, rows, is_profile = _same(analysis)
    assert is_profile
    assert set(res.reports) == {"homo", "pool", "fleetopt"}
    assert res.gamma_star is not None
    assert rows[0]["vs_baseline"] == "-"
    assert all(r["tok_per_watt"] > 0 for r in rows)


def test_analyzer_named_model_and_fixed_gamma():
    """The API's other arguments: a model named in PAPER_MODELS, a fixed
    gamma (no search), a Workload object, and an unknown topology
    refused with the same message."""
    def analysis(pk):
        res = pk.analyzer.fleet_tpw_analysis(
            workload=pk.workloads.LMSYS, profile=pk.profiles.H100_LLAMA70B,
            model="Llama-3.1-70B", b_short=1536, gamma=2.0,
            topologies=("fleetopt", "homo"))
        with pytest.raises(ValueError) as exc:
            pk.analyzer.fleet_tpw_analysis(
                workload="azure-conv", profile=pk.profiles.H100_LLAMA70B,
                topologies=("mesh",))
        return res, res.table(), str(exc.value)

    res, rows, msg = _same(analysis)
    assert res.gamma_star == 2.0 and "mesh" in msg
    assert [r["topology"] for r in rows] == ["fleetopt", "homo"]
