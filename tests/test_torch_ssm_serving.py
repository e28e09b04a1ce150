"""Port `PoolEngine` vs the JAX reference for the O(1)-state models.

zamba2-2.7b (Mamba2 + shared attention) and rwkv6-1.6b, `.reduced()` in
float32 on the reference's converted weights, on the engine scenarios of
tests/serving/test_serving.py (and tests/test_torch_serving.py), with the
same rule: the same token streams and exactly equal `EnergyMeter`
counters.  Every prompt here is at least d_conv - 1 = 3 tokens long; below
that the two engines differ by design (ROADMAP C7,
tests/test_torch_ssm.py).  Under chunked prefill the reference's decode
pass steps the recurrent state of slots still waiting on their prefill, so
its token streams differ from those of immediate prefill (ROADMAP C8); the
port keeps that state, so its chunked streams equal the immediate ones,
while its meters, stats and times equal the reference's chunked run (the
meters read no token value).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import profiles as JP
from repro.models import model as JM
from repro import serving as JS
from repro_torch.configs import get_config
from repro_torch.core import profiles as P
from repro_torch.models.convert import convert_params
from repro_torch.serving import PoolEngine
from test_torch_serving import (ENGINE_SCENARIOS, _assert_same_engine,
                                _port_request)

ARCH_IDS = ["zamba2-2.7b", "rwkv6-1.6b"]


@pytest.fixture(scope="module", params=ARCH_IDS)
def model(request):
    jcfg = jax_get_config(request.param).reduced()
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config(request.param).reduced(), params


@pytest.mark.parametrize("scenario", sorted(ENGINE_SCENARIOS))
def test_engine_matches_reference_engine(model, scenario):
    jcfg, jparams, cfg, params = model
    make, kw = ENGINE_SCENARIOS[scenario]
    jreqs = make(cfg.vocab)
    assert min(r.prompt_len for r in jreqs) >= cfg.d_conv - 1
    reqs = [_port_request(r) for r in jreqs]
    jeng = JS.PoolEngine(jcfg, jparams, profile=JP.H100_LLAMA70B, name="t",
                         **kw)
    if kw.get("prefill_chunk"):
        _assert_chunked_prefill_parity(model, jeng, jreqs, kw)
        return
    eng = PoolEngine(cfg, params, profile=P.H100_LLAMA70B, name="t", **kw)
    for je, e in zip(jreqs, reqs):
        jeng.submit(je)
        eng.submit(e)
    jeng.run_until_drained(max_iters=500)
    eng.run_until_drained(max_iters=500)
    assert len(eng.completed) == len(reqs)
    _assert_same_engine(jeng, eng)
    assert eng.decode_steps > 0


def _assert_chunked_prefill_parity(model, jeng, jreqs, kw):
    """ROADMAP C8.  The port's chunked-prefill token streams equal its
    immediate-prefill streams and the reference's immediate streams; its
    meters, stats() and first/finish times equal the reference's chunked
    run exactly.  The reference's chunked streams still differ from the
    immediate ones (its decode pass steps the waiting slots' state)."""
    jcfg, jparams, cfg, params = model
    immediate = {k: v for k, v in kw.items() if k != "prefill_chunk"}
    jimm = JS.PoolEngine(jcfg, jparams, profile=JP.H100_LLAMA70B, name="t",
                         **immediate)
    eng = PoolEngine(cfg, params, profile=P.H100_LLAMA70B, name="t", **kw)
    imm = PoolEngine(cfg, params, profile=P.H100_LLAMA70B, name="t",
                     **immediate)
    for e in (jeng, jimm, eng, imm):
        for r in jreqs:
            e.submit(_port_request(r) if isinstance(e, PoolEngine)
                     else dataclasses.replace(r))
        e.run_until_drained(max_iters=500)
        assert len(e.completed) == len(jreqs)
    want = {r.rid: r.generated for r in jimm.completed}
    assert {r.rid: r.generated for r in imm.completed} == want
    assert {r.rid: r.generated for r in eng.completed} == want
    _assert_same_engine(jeng, eng, tokens=False)
    assert eng.decode_steps > 0
    assert any(r.generated != want[r.rid] for r in jeng.completed)
