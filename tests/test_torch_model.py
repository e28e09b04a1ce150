"""Port model vs the JAX model on the same weights, on the CPU.

Weights come from `repro.models.model.init_params` and reach the port
through `repro_torch.models.convert`.  Configs are `.reduced()` and in
float32, so the comparison is of the algorithm: logits within ATOL = 1e-4
(float32 sums taken in other orders over a few hundred terms), greedy
tokens equal.  h2o-danube-3-4b exercises sliding-window attention: its
reduced window is 64, and decode runs past the wrap point.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import model as M
from repro_torch.models.convert import convert_params

ATOL = 1e-4
ARCH_IDS = ["yi-6b", "llama31-8b", "h2o-danube-3-4b"]


@pytest.fixture(scope="module", params=ARCH_IDS)
def pair(request):
    jcfg = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S))


def test_configs_copied_whole():
    from repro.configs import ARCHS as JARCHS
    assert sorted(ARCHS) == sorted(JARCHS)
    for name in JARCHS:
        assert dataclasses.asdict(get_config(name)) \
            == dataclasses.asdict(jax_get_config(name))
    assert get_config("llama31-8b-swa").swa_window \
        == jax_get_config("llama31-8b-swa").swa_window


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-34b"])
def test_unported_blocks_raise(arch):
    """The encoder, cross-attention and patch prefixes are ported since
    (parity in tests/test_torch_encoder.py): these archs initialise, and a
    block kind the port lacks still raises."""
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert ("encoder" in params) == (cfg.encoder is not None)
    bad = dataclasses.replace(cfg, unit=cfg.unit + (
        dataclasses.replace(cfg.unit[0], kind="conv"),))
    with pytest.raises(NotImplementedError, match="conv"):
        M.init_params(bad, torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_ssm_archs_initialise_on_cpu(arch):
    """The O(1)-state models, ported since: weights, a decode cache and a
    prefill over a few tokens on the CPU (parity with the reference is in
    tests/test_torch_ssm.py)."""
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert len(params["layers"]) == cfg.n_repeat
    assert ("shared" in params) == any(b.shared for b in cfg.unit)
    assert M.init_cache(cfg, 2, 8, device="cpu")
    logits, _ = M.forward(params, cfg, torch.zeros(1, 4, dtype=torch.long),
                          mode="prefill")
    assert logits.shape == (1, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


def test_train_logits(pair):
    jcfg, jparams, cfg, params = pair
    toks = _tokens(cfg, 2, 24, seed=1)
    jlogits, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    logits = M.forward(params, cfg, torch.as_tensor(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)


def _slab(cache, max_seq, zeros):
    """Prefill cache (R, B, S', K, hd) written into a max_seq slab."""
    out = {}
    for name, c in cache.items():
        out[name] = {}
        for key, a in c.items():
            slab = zeros(a.shape[:2] + (max_seq,) + a.shape[3:])
            slab[:, :, :a.shape[2]] = a
            out[name][key] = slab
    return out


@pytest.mark.parametrize("S", [60, 80])
def test_prefill_then_decode(pair, S):
    """Prefill logits and cache, then 8 greedy decode steps on a cache of
    96 slots (the SWA ring holds 64: S=60 wraps during decode, S=80 is
    rolled at prefill)."""
    jcfg, jparams, cfg, params = pair
    B, max_seq, steps = 2, 96, 8
    toks = _tokens(cfg, B, S, seed=S)
    jlogits, jcache, _ = JM.forward(jparams, jcfg,
                                    {"tokens": jnp.asarray(toks)},
                                    mode="prefill")
    logits, cache = M.forward(params, cfg, torch.as_tensor(toks),
                              mode="prefill")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)
    for name in jcache:
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[name][key].numpy(),
                                       np.asarray(jcache[name][key]),
                                       atol=ATOL, rtol=0)

    T = min(cfg.swa_window, max_seq) if cfg.swa_window else max_seq
    jcache = {n: {k: jnp.asarray(v) for k, v in c.items()} for n, c in
              _slab(jax.tree.map(np.asarray, jcache), T, np.zeros).items()}
    cache = _slab(cache, T, torch.zeros)
    step = jax.jit(lambda p, t, c, pos: JM.decode_step(p, jcfg, t, c, pos))
    nxt = np.array(jnp.argmax(jlogits[:, -1], axis=-1))
    gaps = []
    for i in range(steps):
        pos = np.full(B, S + i, np.int32)
        jl, jcache = step(jparams, jnp.asarray(nxt[:, None]), jcache,
                          jnp.asarray(pos))
        tl, cache = M.decode_step(params, cfg, torch.as_tensor(nxt[:, None]),
                                  cache, pos)
        jl = np.asarray(jl[:, 0])
        np.testing.assert_allclose(tl[:, 0].numpy(), jl, atol=ATOL, rtol=0)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
        nxt = jl.argmax(-1)
        assert (tl[:, 0].argmax(-1).numpy() == nxt).all(), (i, gaps[-1])
    # the smallest top-1 / top-2 logit gap over the greedy steps (shown
    # with -s): a token mismatch at a gap near ATOL would be a near-tie,
    # at a larger one a fault
    print(f"{cfg.name} S={S}: min top-1/top-2 gap {min(gaps):.3e}")
    for name in jcache:
        np.testing.assert_allclose(cache[name]["k"].numpy(),
                                   np.asarray(jcache[name]["k"]),
                                   atol=ATOL, rtol=0)


def test_decode_write_past_cache_is_dropped(pair):
    """A position at or past a non-ring cache's end is read as a full cache
    and its write is dropped, as JAX drops an out-of-bounds `.at[].set`."""
    jcfg, jparams, cfg, params = pair
    B, T = 3, 16
    rng = np.random.default_rng(5)
    shape = (cfg.n_repeat, B, T, cfg.n_kv_heads, cfg.hd)
    kv = {n: {k: rng.standard_normal(shape).astype(np.float32)
              for k in ("k", "v")}
          for n in M.init_cache(cfg, B, T, device="cpu")}
    pos = np.array([3, T - 1, T + 4], np.int32)
    toks = _tokens(cfg, B, 1, seed=6)
    jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(toks),
                            jax.tree.map(jnp.asarray, kv), jnp.asarray(pos))
    cache = jax.tree.map(torch.from_numpy, kv)
    tl, cache = M.decode_step(params, cfg, torch.as_tensor(toks), cache, pos)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for name in jc:
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[name][key].numpy(),
                                       np.asarray(jc[name][key]),
                                       atol=ATOL, rtol=0)


def test_decode_plain_impl_matches_default_on_cpu(pair):
    """On CPU tensors the kernel path is the plain version: both impls give
    the same logits."""
    _, _, cfg, params = pair
    B, T = 2, 32
    toks = torch.as_tensor(_tokens(cfg, B, 1, seed=7))
    pos = np.array([4, 20], np.int32)
    a, _ = M.decode_step(params, cfg, toks,
                         M.init_cache(cfg, B, T, device="cpu"), pos)
    b, _ = M.decode_step(params, cfg, toks,
                         M.init_cache(cfg, B, T, device="cpu"), pos,
                         impl="plain")
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
