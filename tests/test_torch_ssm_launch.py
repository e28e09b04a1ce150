"""Port `run_policies` vs the JAX launcher for the O(1)-state models.

zamba2-2.7b and rwkv6-1.6b, `.reduced()` in float32 on the reference's
converted weights, under homo / two_pool / fleetopt: equal reports, the
same token streams and exactly equal meters in every pool (the rule of
tests/test_torch_serving.py).  Every prompt of the stream is at least
d_conv - 1 = 3 tokens long (ROADMAP C7).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import profiles as JP
from repro.core import workloads as JW
from repro.launch import serve as jax_serve
from repro.models import model as JM
from repro import serving as JS
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.convert import convert_params
from test_torch_serving import _assert_same_engine


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_run_policies_matches_reference_launcher(arch):
    """Port `run_policies` vs the reference launcher's build_router +
    ContextRouter.run on the stream `serve.main` builds."""
    jcfg = jax_get_config(arch).reduced()
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert_params(jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = get_config(arch).reduced()
    n, b_short, window_long = 8, 24, 192
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
    assert min(r.prompt_len for r in base) >= cfg.d_conv - 1
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
