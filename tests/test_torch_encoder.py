"""Port encoder, cross-attention and patch prefix vs the JAX package, on
the CPU: whisper-medium's bidirectional encoder and decoder
cross-attention, llava-next-34b's patch-prefixed decoder.

Weights come from the reference's `init_params` through `convert_params`;
inputs are numpy, seeded.  Tolerances:

  * ATTN_ATOL = 2e-5: the port's `flash_attention` against the
    reference's chunked `flash_attention` in float32, the reference's own
    bound (tests/models/test_attention.py); bfloat16 q/k/v at BF16_ATOL =
    3e-2 against float32 attention, its bfloat16 test's bound;
  * ATOL = 1e-4 on logits, caches and encoder states of the float32
    configs (the rule of tests/test_torch_model.py);
  * DECODE_ATOL = 5e-4: prefill plus stepwise decode against the full
    sequence's logits, tests/models/test_smoke.py's bound;
  * the encoder of a bfloat16 config: both packages promote the bfloat16
    weights to the float32 frames' dtype (JAX promotes `f32 @ bf16`; the
    port casts, as torch would raise), so the encoder and the
    cross-attention K/V run in float32 on the same bfloat16 values:
    ATOL again.  The bfloat16 decoder's logits: BF16_LOGIT_REL = 2e-2 of
    max|logits| (bfloat16 activations rounded in other places).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models.convert import (convert_params, flatten_paths,
                                        to_reference_layout)
from repro_torch.models.spec import BlockSpec
from repro_torch.training.train import loss_and_grads
from test_torch_training import _configs

ATTN_ATOL = 2e-5
BF16_ATOL = 3e-2
ATOL = 1e-4
DECODE_ATOL = 5e-4
BF16_LOGIT_REL = 2e-2
ENC_ARCHS = ["whisper-medium", "llava-next-34b"]


@functools.lru_cache(maxsize=None)
def _weights(arch, dtype="float32", seed=1):
    jcfg, _ = _configs(arch, dtype=dtype)
    jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, convert_params(jax.tree.map(np.asarray, jparams),
                                   device="cpu")


def _batch(cfg, B=2, S=16, seed=1):
    """tests/models/test_smoke.py's batch, in numpy (no labels)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S))}
    rng.integers(0, cfg.vocab, (B, S))          # the labels' draw
    if cfg.n_patches:
        out["patches"] = (rng.standard_normal((B, cfg.n_patches, cfg.d_model))
                          * 0.02).astype(np.float32)
    if cfg.encoder is not None:
        out["frames"] = (rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _kw(batch):
    """The port's forward keywords for a numpy batch."""
    return {key: torch.as_tensor(batch[key]) for key in ("frames", "patches")
            if key in batch}


def _jb(batch):
    return {key: jnp.asarray(a) for key, a in batch.items()}


def _np(t):
    return t.detach().float().numpy()


# ---- attention ----------------------------------------------------------------

def test_non_causal_cross():
    """tests/models/test_attention.py::test_non_causal_cross's shapes."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 33, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 50, 4, 16)).astype(np.float32)
    v = rng.standard_normal((1, 50, 4, 16)).astype(np.float32)
    ref = JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=False)
    out = A.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATTN_ATOL,
                               rtol=0)


@pytest.mark.parametrize("B,S,T,K,G,D", [(2, 7, 7, 2, 3, 8),
                                         (1, 130, 130, 1, 1, 32),
                                         (2, 5, 40, 2, 2, 16),
                                         (1, 600, 70, 4, 1, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_flash_attention(B, S, T, K, G, D, causal):
    """Causal or not, T apart from S (causal keeps key t <= query i, both
    counted from 0, as the reference's q_offset=0), GQA, chunked past the
    reference's 512-row chunks."""
    rng = np.random.default_rng(S * T)
    q = rng.standard_normal((B, S, K * G, D)).astype(np.float32)
    k = rng.standard_normal((B, T, K, D)).astype(np.float32)
    v = rng.standard_normal((B, T, K, D)).astype(np.float32)
    ref = JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal)
    out = A.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATTN_ATOL,
                               rtol=0)


def test_bfloat16_non_causal():
    rng = np.random.default_rng(2)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
               for shape in ((2, 24, 8, 32), (2, 96, 4, 32), (2, 96, 4, 32)))
    out = A.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                             causal=False)
    ref = JA.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                             causal=False)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=BF16_ATOL,
                               rtol=0)


def test_init_attention_cross_has_q_norm():
    _, cfg = _configs("whisper-medium")
    g = torch.Generator().manual_seed(0)
    p = A.init_attention(g, cfg, torch.device("cpu"), cross=True)
    jp = JA.init_attention(jax.random.PRNGKey(0), cfg, cross=True)
    assert p.keys() == jp.keys()
    for key in jp:
        assert tuple(p[key].shape) == jp[key].shape
        assert str(p[key].dtype).split(".")[1] == str(jp[key].dtype)
    assert "q_norm" not in A.init_attention(g, cfg, torch.device("cpu"))


# ---- the encoder, in float32 and under the bfloat16 promotion ------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_reference(dtype):
    jcfg, cfg = _configs("whisper-medium", dtype=dtype)
    jparams, params = _weights("whisper-medium", dtype)
    frames = _batch(cfg)["frames"]
    ref = JM._encoder_apply(jparams, jcfg, jnp.asarray(frames))
    out = M.encoder_apply(params, cfg, torch.as_tensor(frames))
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype):
    """encode_cross_kv on the encoder output (float32 K/V), then
    cross_attention_full on a decoder residual of the config's dtype,
    cast back to it."""
    jcfg, cfg = _configs("whisper-medium", dtype=dtype)
    jparams, params = _weights("whisper-medium", dtype)
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((2, cfg.encoder.n_frames, cfg.d_model)) \
        .astype(np.float32)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["unit"]["b1_cross_attn"])
    p = params["layers"][1]["b1_cross_attn"]
    jkv = JA.encode_cross_kv(jp, jcfg, jnp.asarray(enc))
    kv = A.encode_cross_kv(p, cfg, torch.as_tensor(enc))
    for key in ("k", "v"):
        assert jkv[key].dtype == jnp.float32 and kv[key].dtype == torch.float32
        np.testing.assert_allclose(kv[key].numpy(), np.asarray(jkv[key]),
                                   atol=ATOL, rtol=0)
    dt = getattr(torch, dtype)
    jy = JA.cross_attention_full(jp, jcfg, jnp.asarray(x).astype(dtype), jkv)
    y = A.cross_attention_full(p, cfg, torch.as_tensor(x).to(dt), kv)
    assert y.dtype == dt and str(jy.dtype) == dtype
    tol = ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(_np(y), np.asarray(jy).astype(np.float32),
                               atol=tol, rtol=0)


# ---- whole models --------------------------------------------------------------

@pytest.mark.parametrize("arch", ENC_ARCHS)
def test_train_logits_match_reference(arch):
    jcfg, cfg = _configs(arch)
    jparams, params = _weights(arch)
    batch = _batch(cfg)
    jlogits, _ = JM.forward(jparams, jcfg, _jb(batch))
    logits = M.forward(params, cfg, torch.as_tensor(batch["tokens"]),
                       **_kw(batch))
    assert logits.shape == jlogits.shape == (
        2, 16 + (cfg.n_patches or 0), cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ENC_ARCHS)
def test_bfloat16_logits_match_reference(arch):
    jcfg, cfg = _configs(arch, dtype="bfloat16")
    jparams, params = _weights(arch, "bfloat16")
    batch = _batch(cfg)
    jlogits, _ = JM.forward(jparams, jcfg, _jb(batch))
    logits = M.forward(params, cfg, torch.as_tensor(batch["tokens"]),
                       **_kw(batch))
    assert logits.dtype == torch.bfloat16
    ref = np.asarray(jlogits).astype(np.float32)
    err = np.abs(_np(logits) - ref).max()
    assert err <= BF16_LOGIT_REL * np.abs(ref).max(), err


def _pad_attn(cache, slab):
    """Self-attention K/V (R, B, S', K, hd) zero-padded to `slab` slots."""
    return {name: ({key: torch.nn.functional.pad(
        t, (0, 0, 0, 0, 0, slab - t.shape[2])) for key, t in c.items()}
        if name.endswith("_attn") and "cross" not in name else c)
        for name, c in cache.items()}


@pytest.mark.parametrize("arch", ENC_ARCHS)
def test_decode_matches_forward(arch):
    """tests/models/test_smoke.py::test_decode_matches_forward for the
    port: prefill 12 tokens (after the patches, or with the encoder's
    frames), decode 4, each step's logits within DECODE_ATOL of the full
    sequence's; and each step within ATOL of the reference's own decode
    on its own prefill cache."""
    jcfg, cfg = _configs(arch)
    jparams, params = _weights(arch)
    B, S = 2, 16
    batch = _batch(cfg, B=B, S=S)
    toks = torch.as_tensor(batch["tokens"])
    full = M.forward(params, cfg, toks, **_kw(batch))
    t0 = S - 4
    off = cfg.n_patches or 0
    lg, cache = M.forward(params, cfg, toks[:, :t0], mode="prefill",
                          **_kw(batch))
    pf = dict(batch, tokens=batch["tokens"][:, :t0])
    jlg, jcache, _ = JM.forward(jparams, jcfg, _jb(pf), mode="prefill")
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL,
                               rtol=0)
    assert cache.keys() == jcache.keys()
    for name in jcache:
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[name][key].numpy(),
                                       np.asarray(jcache[name][key]),
                                       atol=ATOL, rtol=0)
    slab = S + off
    cache = _pad_attn(cache, slab)
    jcache = {name: {key: jnp.asarray(t.numpy()) for key, t in c.items()}
              for name, c in cache.items()}
    errs = [float((lg[:, -1] - full[:, t0 - 1 + off]).abs().max())]
    for i in range(4):
        pos = t0 + i
        lg, cache = M.decode_step(params, cfg, toks[:, pos:pos + 1], cache,
                                  pos + off)
        jlg, jcache = JM.decode_step(jparams, jcfg,
                                     jnp.asarray(batch["tokens"][:, pos:pos
                                                                 + 1]),
                                     jcache, jnp.asarray(pos + off))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL,
                                   rtol=0)
        if pos + 1 < S:
            errs.append(float((lg[:, 0] - full[:, pos + off]).abs().max()))
    assert max(errs) < DECODE_ATOL, errs


def test_cross_cache_is_the_encoder_kv():
    """The prefill's cross-attention cache equals encode_cross_kv of the
    encoder output, repeat by repeat, and decode leaves it unchanged."""
    _, cfg = _configs("whisper-medium")
    _, params = _weights("whisper-medium")
    batch = _batch(cfg)
    kw = _kw(batch)
    _, cache = M.forward(params, cfg, torch.as_tensor(batch["tokens"]),
                         mode="prefill", **kw)
    enc = M.encoder_apply(params, cfg, kw["frames"])
    before = {key: t.clone() for key, t in cache["b1_cross_attn"].items()}
    for r in range(cfg.n_repeat):
        kv = A.encode_cross_kv(params["layers"][r]["b1_cross_attn"], cfg, enc)
        for key in ("k", "v"):
            torch.testing.assert_close(cache["b1_cross_attn"][key][r],
                                       kv[key], atol=0, rtol=0)
    cache = _pad_attn(cache, 20)
    M.decode_step(params, cfg, torch.as_tensor(batch["tokens"][:, :1]),
                  cache, 16)
    for key in ("k", "v"):
        torch.testing.assert_close(cache["b1_cross_attn"][key], before[key],
                                   atol=0, rtol=0)


@pytest.mark.parametrize("arch", ENC_ARCHS)
def test_init_cache_matches_reference(arch):
    jcfg, cfg = _configs(arch, dtype="bfloat16")
    jc = JM.init_cache(jcfg, 3, 40, enc_frames=7)
    c = M.init_cache(cfg, 3, 40, enc_frames=7, device="cpu")
    assert c.keys() == jc.keys()
    for name in jc:
        for key in jc[name]:
            assert tuple(c[name][key].shape) == jc[name][key].shape
            assert str(c[name][key].dtype).split(".")[1] \
                == str(jc[name][key].dtype)


# ---- parameters ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ENC_ARCHS + ["zamba2-2.7b",
                                              "granite-moe-1b-a400m"])
def test_init_params_layout_matches_reference(arch, dtype):
    """The port's own draw has the reference's leaves, shapes and dtypes
    (read through to_reference_layout, which writes bfloat16 as float32)."""
    jcfg, cfg = _configs(arch, dtype=dtype)
    jflat = flatten_paths(jax.eval_shape(
        lambda: JM.init_params(jax.random.PRNGKey(0), jcfg)))
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    flat = flatten_paths(to_reference_layout(params))
    assert flat.keys() == jflat.keys()
    for key, s in jflat.items():
        assert flat[key].shape == s.shape, key
    for t in _leaves(params):
        assert t.dtype in (torch.float32, getattr(torch, dtype))


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ENC_ARCHS + ["zamba2-2.7b"])
def test_convert_round_trips_bit_for_bit(arch, dtype):
    jparams, params = _weights(arch, dtype)
    ref = flatten_paths(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), jparams))
    back = flatten_paths(to_reference_layout(params))
    assert back.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(back[key], ref[key], err_msg=key)


def test_encoder_gets_gradients_only_through_cross_attention():
    """whisper: every encoder weight the loss reads gets a finite, nonzero
    gradient; with the cross-attention outputs cut (wo zeroed), zero."""
    _, cfg = _configs("whisper-medium")
    _, params = _weights("whisper-medium")
    batch = _batch(cfg)
    b = {"tokens": torch.as_tensor(batch["tokens"]),
         "labels": torch.as_tensor(batch["tokens"]),
         "frames": torch.as_tensor(batch["frames"])}

    def encoder_grads(params):
        grads = loss_and_grads(params, cfg, b)[1]["encoder"]
        return [g for layer in grads["layers"] for blk in layer.values()
                for g in blk.values() if g is not None] \
            + [grads["final_norm"]]

    grads = encoder_grads(params)
    assert len(grads) == cfg.encoder.n_layers * 8 + 1
    assert all(bool(torch.isfinite(g).all()) and float(g.norm()) > 0
               for g in grads)
    cut = dict(params, layers=[dict(layer, b1_cross_attn=dict(
        layer["b1_cross_attn"],
        wo=torch.zeros_like(layer["b1_cross_attn"]["wo"])))
        for layer in params["layers"]])
    assert all(float(g.norm()) == 0 for g in encoder_grads(cut))


def test_check_supported_raises_only_for_unported_kinds():
    for arch in ENC_ARCHS:
        M.check_supported(get_config(arch))
    cfg = dataclasses.replace(get_config("yi-6b").reduced(),
                              unit=(BlockSpec("attn"), BlockSpec("conv")))
    with pytest.raises(NotImplementedError, match="conv"):
        M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        _, params = _weights("whisper-medium")
        M.forward(params, get_config("whisper-medium").reduced(),
                  torch.zeros(1, 3, dtype=torch.long))
