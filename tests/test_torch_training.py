"""Port training (loss, gradients, AdamW, train step, checkpoints, data,
launcher) vs the JAX package, on the CPU.

Weights come from the reference's `init_params(PRNGKey(0))` and reach the
port through `convert_params`; batches are numpy, seeded, the same arrays
for both.  Configs are `.reduced()` and in float32.  Tolerances:

  * LOSS_ATOL = 1e-5 on the loss and the MoE aux loss (f32 sums over a few
    thousand logits taken in other orders: the observed gap is <= 1.5e-6);
  * GRAD_REL = 1e-4: every gradient leaf within 1e-4 x that leaf's
    max|g_ref| (observed: <= 4e-6 for the attention, MoE and RWKV6 archs,
    3.2e-5 for zamba2's A_log; it was 3.4e-5 when the port trained
    through its sequential plain scan: the gap is the reference's own
    rounding, whose chunk scan takes each pair's log-decay as a difference
    of the chunk's cumulative sum (ROADMAP C12), where the port's segment
    sum keeps the scan's gradients within ~1e-6 of float64);
  * the AdamW update on identical gradients: OPT_RTOL = 1e-6 relative and
    OPT_ATOL = 1e-7 absolute on parameters and moments (float32, one
    rounding order);
  * the whole train step: updated parameters within STEP_ATOL = 1e-6,
    except where the reference's gradient is within NOISE_REL = 1e-3 of
    its leaf's max|g|: Adam's first step moves an element by
    lr x g / (|g| + eps), so a gradient at rounding-noise level may take
    either sign, 2 lr = 1e-4 apart at most (seen: 2 of 352256 elements of
    yi-6b's w_down, 1.2e-6 apart);
  * batches, checkpoints and converted leaves: bit for bit.

SSM archs train through the chunk scans of `models/ssm.py` (the
reference's algorithm) on every device; the scan kernels serve prefill
only and refuse to record a backward they do not have, which
`test_kernel_wrappers_refuse_grad` holds here on CPU tensors.  The chunk
scans themselves are held in tests/test_torch_chunk_scan.py.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as JD
from repro import training as JT
from repro.configs import get_config as jax_get_config, list_archs
from repro.launch import train as jax_launch_train
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch import data as D
from repro_torch import training as T
from repro_torch.configs import get_config
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import flash_decode_int8 as FD8
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mamba_scan_ref
from repro_torch.kernels import wkv6 as WK
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.convert import (convert_params, flatten_paths,
                                        to_reference_layout, unflatten_paths)
from repro_torch.training.optimizer import tree_leaves, tree_map
from repro_torch.training.train import batch_to, loss_and_grads

LOSS_ATOL = 1e-5
GRAD_REL = 1e-4
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
STEP_ATOL = 1e-6
NOISE_REL = 10 * GRAD_REL


def _configs(arch, **changes):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **changes)
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _batch(cfg, B=2, S=24, seed=0):
    """tests/models/test_smoke.py's batch, in numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)),
           "labels": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.n_patches:
        out["patches"] = (rng.standard_normal((B, cfg.n_patches, cfg.d_model))
                          * 0.02).astype(np.float32)
    if cfg.encoder is not None:
        out["frames"] = (rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)) * 0.02).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jparams = JM.init_params(jax.random.PRNGKey(0), _configs(arch)[0])
    return jparams, jax.tree.map(np.asarray, jparams)


def _port_params(arch):
    return convert_params(_weights(arch)[1], device="cpu")


@functools.lru_cache(maxsize=None)
def _reference(arch, **changes):
    """The reference's loss, aux and gradients (flat numpy) on `_batch`."""
    jcfg, _ = _configs(arch, **changes)
    jb = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}

    def f(p, b):
        loss, grads = jax.value_and_grad(lambda q: JM.loss_fn(q, jcfg, b))(p)
        return loss, JM.forward(p, jcfg, b)[1], grads

    loss, aux, grads = jax.jit(f)(_weights(arch)[0], jb)
    return float(loss), float(aux), flatten_paths(
        jax.tree.map(np.asarray, grads))


def _flat_grads(grads, params):
    """The port's gradient tree keyed like the reference's, None as 0."""
    filled = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g,
                      grads, params)
    return flatten_paths(to_reference_layout(filled))


def _assert_grads(got, ref, rel=GRAD_REL):
    assert got.keys() == ref.keys(), set(got) ^ set(ref)
    for key, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(got[key] - r).max())
        assert err <= rel * scale, (key, err, scale)


# ---- loss, aux and gradients of every arch ---------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_aux_match_reference(arch):
    """tests/models/test_smoke.py::test_forward_and_train_step's model
    side: forward(return_aux=True) and loss_fn against the reference's."""
    _, cfg = _configs(arch)
    jloss, jaux, _ = _reference(arch)
    params = _port_params(arch)
    b = batch_to(_batch(cfg), "cpu")
    logits, aux = M.forward(params, cfg, b["tokens"], frames=b.get("frames"),
                            patches=b.get("patches"), return_aux=True)
    B, S = b["tokens"].shape
    assert logits.shape == (B, S + (cfg.n_patches or 0), cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert abs(float(aux) - jaux) <= LOSS_ATOL
    assert (float(aux) > 0) == bool(cfg.n_experts)
    loss = M.loss_fn(params, cfg, b)
    assert abs(float(loss) - jloss) <= LOSS_ATOL, (float(loss), jloss)


@pytest.mark.parametrize("arch", list_archs())
def test_every_grad_leaf_matches_reference(arch):
    _, cfg = _configs(arch)
    _, _, jgrads = _reference(arch)
    params = _port_params(arch)
    _, grads = loss_and_grads(params, cfg, batch_to(_batch(cfg), "cpu"))
    _assert_grads(_flat_grads(grads, params), jgrads)


def test_unread_leaves_get_none_and_zero_reference_grads():
    """whisper's unread leaves (the encoder's and cross-attention's biases,
    cross-attention's q_norm): torch gives None, JAX zeros."""
    _, cfg = _configs("whisper-medium")
    params = _port_params("whisper-medium")
    _, grads = loss_and_grads(params, cfg, batch_to(_batch(cfg), "cpu"))
    is_none = flatten_paths(to_reference_layout(tree_map(
        lambda g, p: torch.full_like(p, float(g is None)), grads, params)))
    none = {key for key, v in is_none.items() if v.all()}
    assert none == {f"{blk}/{leaf}" for blk in (
        "encoder/unit/b0_attn", "unit/b1_cross_attn")
        for leaf in ("bq", "bk", "bv")} | {"unit/b1_cross_attn/q_norm"}
    assert not any(v.any() for key, v in is_none.items() if key not in none)
    _, _, jgrads = _reference("whisper-medium")
    for key in none:
        assert not jgrads[key].any()


def test_remat_gives_the_same_grads():
    for arch in ("yi-6b", "granite-moe-1b-a400m", "whisper-medium"):
        _, cfg = _configs(arch)
        params = _port_params(arch)
        b = batch_to(_batch(cfg), "cpu")
        loss, grads = loss_and_grads(params, cfg, b)
        rloss, rgrads = loss_and_grads(params, cfg, b, remat=True)
        assert float(rloss) == float(loss)
        for g, r in zip(tree_leaves(grads), tree_leaves(rgrads)):
            assert (g is None) == (r is None)
            if g is not None:
                torch.testing.assert_close(r, g, atol=0, rtol=0)


def _inline_chunk_ce(z, t, cs):
    """Each chunk's f32 log-sum-exp less its gathered target logit, with
    autograd's own gradient: the rows `_VocabParallelCE` must equal."""
    rows = []
    for i in range(0, z.shape[1], cs):
        zf = z[:, i:i + cs].float()
        zs = zf - zf.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(zs).sum(dim=-1))
        tc = t[:, i:i + cs]
        tl = zs.gather(-1, tc.clamp(min=0)[..., None])[..., 0]
        rows.append(torch.where(tc >= 0, lse - tl, 0.0))
    return rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_cross_entropy_is_the_inline_chunk_bit_for_bit(dtype):
    """On plain logits (one vocab shard, no group) the loss's
    `_VocabParallelCE` gives the rows and the logits' gradient of the
    inline chunk loop bit for bit: the masked target sum is the gather
    exactly, and the backward is autograd's softmax - onehot."""
    g = torch.Generator().manual_seed(7)
    B, S, V, cs = 3, 64, 1000, 16
    z = (torch.randn(B, S, V, generator=g) * 4).to(dtype)
    t = torch.randint(0, V, (B, S), generator=g)
    t[0, :9] = -1
    t[:, -1] = -1
    w = torch.rand(S // cs, B, cs, generator=g)     # per-row cotangents
    out = []
    for fn in (lambda x: _inline_chunk_ce(x, t, cs),
               lambda x: M._VocabParallelCE.apply(x, t, 0, cs, ())):
        x = z.clone().requires_grad_()
        rows = fn(x)
        sum((r * wc).sum() for r, wc in zip(rows, w)).backward()
        out.append((torch.stack([r.detach() for r in rows]), x.grad))
    assert torch.equal(out[1][0], out[0][0])
    assert torch.equal(out[1][1], out[0][1])


# ---- MoE: the aux loss, drops, and the gather-only primitives --------------

def test_capacity_half_drops_match_reference():
    """granite-moe at capacity_factor 0.5: in every MoE block of the loss's
    forward the port routes and drops as the reference's router and
    dispatch do on the same router logits, assignments are dropped, and
    the gradients equal the reference's (whose own forward routed alike:
    a different drop would move them far past GRAD_REL)."""
    arch = "granite-moe-1b-a400m"
    _, cfg = _configs(arch, capacity_factor=0.5)
    params = _port_params(arch)
    b = _batch(cfg)
    seen = []
    real_topk, real_dispatch = moe.router_topk, moe._dispatch_group

    def topk_spy(logits, k):
        seen.append({"logits": logits.detach().numpy().copy()})
        return real_topk(logits, k)

    def dispatch_spy(hf, idx, E, k, C):
        buf, meta = real_dispatch(hf, idx, E, k, C)
        seen[-1].update(idx=idx.numpy().copy(), C=C,
                        keep=meta[1][meta[2]].reshape(-1, k).numpy().copy())
        return buf, meta

    moe.router_topk, moe._dispatch_group = topk_spy, dispatch_spy
    try:
        _, grads = loss_and_grads(params, cfg, batch_to(b, "cpu"))
    finally:
        moe.router_topk, moe._dispatch_group = real_topk, real_dispatch
    assert len(seen) == cfg.n_repeat
    dropped = 0
    for blk in seen:
        _, jidx = JMoE.router_topk(jnp.asarray(blk["logits"]), cfg.top_k)
        np.testing.assert_array_equal(blk["idx"], np.asarray(jidx))
        T = jidx.shape[0]
        _, (_, jkeep, _, _, jinv) = JMoE._dispatch_group(
            jnp.zeros((T, 1)), None, jidx, cfg.n_experts, cfg.top_k,
            blk["C"])
        jkeep = np.asarray(jkeep[jinv]).reshape(T, cfg.top_k)
        np.testing.assert_array_equal(blk["keep"], jkeep)
        dropped += int((~jkeep).sum())
    assert dropped > 0
    _, _, jgrads = _reference(arch, capacity_factor=0.5)
    _assert_grads(_flat_grads(grads, params), jgrads)


def _dispatch_maps(T, E, k, C, seed):
    """A routing and the index maps of both packages' dispatch."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    hf = rng.standard_normal((T, 6)).astype(np.float32)
    _, (dest, keep, inv_order) = moe._dispatch_group(
        torch.as_tensor(hf), torch.as_tensor(idx), E, k, C)
    token_slot, slot_s = moe.backward_maps(dest, keep, inv_order, E, C)
    _, (jdest, jkeep, jslot_s, jorder, jinv) = JMoE._dispatch_group(
        jnp.asarray(hf), None, jnp.asarray(idx), E, k, C)
    np.testing.assert_array_equal(slot_s.numpy(), np.asarray(jslot_s))
    order = np.asarray(jorder)
    slot_token = np.full(E * C, T)
    kept = np.asarray(jkeep)
    slot_token[np.asarray(jdest)[kept]] = (order // k)[kept]
    return (hf, idx, dest, keep, inv_order, token_slot, slot_s,
            torch.as_tensor(slot_token), torch.as_tensor(order.copy()))


@pytest.mark.parametrize("T,E,k,C", [(12, 4, 2, 3), (9, 8, 3, 2),
                                     (16, 4, 1, 6)])
def test_gather_only_primitives_match_autograd(T, E, k, C):
    (hf, idx, dest, keep, inv_order, token_slot, slot_s, slot_token,
     order) = _dispatch_maps(T, E, k, C, seed=T + E)
    rng = np.random.default_rng(0)
    # _slot_gather vs the plain gather's scatter-add backward
    x = torch.as_tensor(hf).requires_grad_()
    pad = torch.cat([x, x.new_zeros(1, x.shape[1])])
    g = torch.as_tensor(rng.standard_normal((E * C, hf.shape[1])),
                        dtype=torch.float32)
    (a,) = torch.autograd.grad(moe.SlotGather.apply(pad, slot_token,
                                                    token_slot, k), x, g)
    (b,) = torch.autograd.grad(pad[slot_token], x, g)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    # _pick, also against the reference's custom VJP on the same maps
    out = torch.as_tensor(rng.standard_normal((E * C, 5)),
                          dtype=torch.float32).requires_grad_()
    g = torch.as_tensor(rng.standard_normal((T * k, 5)), dtype=torch.float32)
    (a,) = torch.autograd.grad(moe.Pick.apply(out, dest, keep, slot_s), out, g)
    (b,) = torch.autograd.grad(torch.where(keep[:, None], out[dest], 0),
                               out, g)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    jg = jax.grad(lambda o: jnp.sum(
        JMoE._pick(o, jnp.asarray(dest.numpy()), jnp.asarray(keep.numpy()),
                   jnp.asarray(slot_s.numpy())) * jnp.asarray(g.numpy())))(
        jnp.asarray(out.detach().numpy()))
    np.testing.assert_allclose(a.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    # _permute
    y = torch.as_tensor(rng.standard_normal((T * k, 5)),
                        dtype=torch.float32).requires_grad_()
    (a,) = torch.autograd.grad(moe.Permute.apply(y, order, inv_order), y, g)
    (b,) = torch.autograd.grad(y[order], y, g)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


# ---- AdamW -----------------------------------------------------------------

def test_schedule_matches_reference():
    for opt_kw in (dict(lr=1e-3, warmup_steps=20, total_steps=1000),
                   dict(lr=2e-3, warmup_steps=20, total_steps=100),
                   dict(lr=0.5, warmup_steps=0, total_steps=7)):
        opt, jopt = T.AdamW(**opt_kw), JT.AdamW(**opt_kw)
        for step in range(0, opt.total_steps + 3):
            ref = float(jopt.schedule(jnp.asarray(step, jnp.int32)))
            assert opt.schedule(step) == pytest.approx(ref, rel=1e-6, abs=0)


def test_adamw_update_matches_reference_with_unread_leaves():
    """Three steps on identical gradients; on the port side whisper's unread
    leaves get None, on the reference's zeros.  Clip active (norm > 1)."""
    arch = "whisper-medium"
    jcfg, cfg = _configs(arch)
    jparams = _weights(arch)[0]
    params = _port_params(arch)
    none = {"encoder/unit/b0_attn/bq", "unit/b1_cross_attn/q_norm"}
    opt_kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.1)
    opt, jopt = T.AdamW(**opt_kw), JT.AdamW(**opt_kw)
    state, jstate = opt.init(params), jopt.init(jparams)
    rng = np.random.default_rng(3)
    for _ in range(3):
        jgrads = jax.tree.map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape)
                                  .astype(np.float32)), jparams)
        flat = flatten_paths(jax.tree.map(np.asarray, jgrads))
        for key in none:
            flat[key] = np.zeros_like(flat[key])
        jgrads = jax.tree.map(jnp.asarray, unflatten_paths(flat))
        grads = convert_params(unflatten_paths(flat), device="cpu")
        for path in none:           # the leaves torch leaves at None
            _set_path(grads, path, None)
        params, state = opt.update(grads, state, params)
        jparams, jstate = jax.jit(jopt.update)(jgrads, jstate, jparams)
    assert state.step == int(jstate.step) == 3
    for mine, ref in ((params, jparams), (state.mu, jstate.mu),
                      (state.nu, jstate.nu)):
        got = flatten_paths(to_reference_layout(mine))
        want = flatten_paths(jax.tree.map(np.asarray, ref))
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=OPT_RTOL,
                                       atol=OPT_ATOL, err_msg=key)
    # weight decay still moved q_norm (ones), which None spared the moments
    key = "unit/b1_cross_attn/q_norm"
    assert not np.array_equal(flatten_paths(to_reference_layout(params))[key],
                              flatten_paths(_weights(arch)[1])[key])


def _set_path(params, ref_path, value):
    """Set every repeat's leaf of a reference key path in the port's tree."""
    parts = ref_path.split("/")
    if parts[0] == "encoder":
        layers, (name, leaf) = params["encoder"]["layers"], parts[2:]
    else:
        layers, (name, leaf) = params["layers"], parts[1:]
    for layer in layers:
        layer[name][leaf] = value


@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-1b-a400m",
                                  "whisper-medium", "zamba2-2.7b",
                                  "rwkv6-1.6b"])
def test_train_step_matches_reference(arch):
    jcfg, cfg = _configs(arch)
    opt_kw = dict(lr=1e-3, total_steps=10)
    jparams = _weights(arch)[0]
    b = _batch(cfg)
    jnew, jstate, jm = jax.jit(JT.make_train_step(jcfg, JT.AdamW(**opt_kw)))(
        jparams, JT.AdamW(**opt_kw).init(jparams),
        {k: jnp.asarray(v) for k, v in b.items()})
    opt = T.AdamW(**opt_kw)
    params = _port_params(arch)
    step = T.make_train_step(cfg, opt)
    new, state, m = step(params, opt.init(params), batch_to(b, "cpu"))
    assert new is params                     # updated in place
    assert state.step == 1
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-5)
    assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    # Adam's first step moves an element by lr x g / (|g| + eps): where
    # the reference's gradient is within NOISE_REL of its leaf's max, the
    # two packages' roundings may give it either sign (up to 2 lr apart)
    lr = float(jm["lr"])
    _, _, jgrads = _reference(arch)
    got = flatten_paths(to_reference_layout(new))
    want = flatten_paths(jax.tree.map(np.asarray, jnew))
    for key in want:
        g = np.abs(jgrads[key])
        atol = np.where(g > NOISE_REL * g.max(), STEP_ATOL, 2 * lr)
        err = np.abs(got[key] - want[key])
        assert (err <= atol).all(), (key, float(err.max()),
                                     int((err > STEP_ATOL).sum()))


# ---- twins of tests/training/test_training.py --------------------------------

def test_adamw_quadratic():
    opt = T.AdamW(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=100)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(100):
        grads = {"w": 2 * params["w"]}
        params, state = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 0.3


def test_grad_clip():
    opt = T.AdamW(lr=1e-3, grad_clip=1.0, warmup_steps=0)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    new, _ = opt.update({"w": torch.full((3,), 1e6)}, state, params)
    assert float(new["w"].abs().max()) < 1.0


def test_lr_schedule():
    opt = T.AdamW(lr=1.0, warmup_steps=10, total_steps=100)
    assert opt.schedule(0) == 0.0
    assert opt.schedule(10) == pytest.approx(1.0)
    assert opt.schedule(100) == pytest.approx(0.1, rel=0.01)


def test_loss_decreases_100_steps():
    """The reference's criterion: more than 1 nat in 100 steps on
    granite-3-8b reduced, batch 4 x 32, lr 2e-3.  On one intra-op thread:
    the reduced model's ops are too small to share, and where other
    processes hold the cores, each op's thread barrier waits on the
    scheduler (100x slower when the whole suite runs on 6 workers)."""
    cfg = get_config("granite-3-8b").reduced()
    it = D.batch_iterator(cfg, batch=4, seq=32)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, _, hist = T.train_loop(cfg, steps=100, batch_iter=it,
                                  opt=T.AdamW(lr=2e-3, total_steps=100),
                                  device="cpu", log_every=25)
    finally:
        torch.set_num_threads(threads)
    assert [h["step"] for h in hist] == [0, 25, 50, 75, 99]
    assert set(hist[0]) == {"step", "loss", "grad_norm", "lr"}
    assert hist[-1]["loss"] < hist[0]["loss"] - 1.0, hist


def test_checkpoint_roundtrip(tmp_path):
    cfg = get_config("yi-6b").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    path = str(tmp_path / "ckpt.npz")
    T.save_checkpoint(path, params, step=17)
    template = tree_map(torch.zeros_like, params)
    restored, step = T.load_checkpoint(path, template)
    assert step == 17
    for a, b in zip(tree_leaves(params), tree_leaves(restored)):
        torch.testing.assert_close(b, a, atol=0, rtol=0)


# ---- checkpoints across the packages -----------------------------------------

@pytest.mark.parametrize("arch,dtype", [("yi-6b", "float32"),
                                        ("granite-moe-1b-a400m", "bfloat16"),
                                        ("whisper-medium", "bfloat16"),
                                        ("zamba2-2.7b", "bfloat16"),
                                        ("rwkv6-1.6b", "float32")])
def test_checkpoints_cross_both_ways(tmp_path, arch, dtype):
    jcfg, cfg = _configs(arch, dtype=dtype)
    jparams = JM.init_params(jax.random.PRNGKey(4), jcfg)
    params = convert_params(jax.tree.map(np.asarray, jparams), device="cpu")
    ref_bits = flatten_paths(jax.tree.map(
        lambda a: np.asarray(a).view(np.uint16 if a.dtype == jnp.bfloat16
                                     else np.uint32), jparams))
    # reference -> port
    JT.save_checkpoint(str(tmp_path / "ref.npz"), jparams, step=5)
    template = M.init_params(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    loaded, step = T.load_checkpoint(str(tmp_path / "ref.npz"), template)
    assert step == 5
    for a, b in zip(tree_leaves(params), tree_leaves(loaded)):
        assert b.dtype == a.dtype
        torch.testing.assert_close(b, a, atol=0, rtol=0)
    # port -> reference
    T.save_checkpoint(str(tmp_path / "port.npz"), params, step=9)
    with np.load(str(tmp_path / "port.npz")) as data:
        assert set(data.files) == set(flatten_paths(
            to_reference_layout(params))) | {"__step__"}
    jtemplate = jax.tree.map(jnp.zeros_like, jparams)
    jloaded, jstep = JT.load_checkpoint(str(tmp_path / "port.npz"), jtemplate)
    assert jstep == 9
    got = flatten_paths(jax.tree.map(
        lambda a: np.asarray(a).view(np.uint16 if a.dtype == jnp.bfloat16
                                     else np.uint32), jloaded))
    assert got.keys() == ref_bits.keys()
    for key in ref_bits:
        np.testing.assert_array_equal(got[key], ref_bits[key], err_msg=key)


# ---- data ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "whisper-medium",
                                  "llava-next-34b"])
def test_batch_iterator_bit_equal(arch):
    jcfg, cfg = _configs(arch)
    ours = D.batch_iterator(cfg, batch=3, seq=20, seed=5)
    ref = JD.batch_iterator(jcfg, batch=3, seq=20, seed=5)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys()
        for key in b:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_synthetic_lm_tables_equal():
    src, ref = D.SyntheticLM(1000, seed=2), JD.SyntheticLM(1000, seed=2)
    np.testing.assert_array_equal(src.unigram, ref.unigram)
    np.testing.assert_array_equal(src.succ, ref.succ)
    np.testing.assert_array_equal(src.sample_tokens(2, 9),
                                  ref.sample_tokens(2, 9))


# ---- the launcher ------------------------------------------------------------

@pytest.mark.parametrize("preset", list(launch_train.PRESETS))
@pytest.mark.parametrize("arch", list_archs())
def test_scaled_config_equals_reference(arch, preset):
    assert dataclasses.asdict(launch_train.scaled_config(arch, preset)) \
        == dataclasses.asdict(jax_launch_train.scaled_config(arch, preset))


def test_launcher_trains_and_checkpoints_on_cpu(tmp_path, capsys):
    path = str(tmp_path / "c.npz")
    cfg, params, hist = launch_train.main(
        ["--arch", "yi-6b", "--preset", "smoke", "--steps", "3", "--batch",
         "2", "--seq", "16", "--device", "cpu", "--ckpt", path])
    out = capsys.readouterr().out
    assert out.startswith(f"config {cfg.name}:")
    assert "final loss" in out and "checkpoint:" in out
    assert [h["step"] for h in hist] == [0, 2]
    restored, step = T.load_checkpoint(path, params)
    assert step == 3
    for a, b in zip(tree_leaves(params), tree_leaves(restored)):
        torch.testing.assert_close(b, a, atol=0, rtol=0)


# ---- the kernels' guard: no silent detach ------------------------------------

def _kernel_inputs(grad):
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(*shape, generator=g).requires_grad_(grad)

    lengths = torch.tensor([3, 5], dtype=torch.int32)
    q, k, v = t(2, 4, 16), t(2, 5, 2, 16), t(2, 5, 2, 16)
    kq = torch.randint(-127, 128, (2, 5, 2, 16), generator=g,
                       dtype=torch.int8)
    scales = t(2, 5, 2).detach().abs().requires_grad_(grad)
    xt, Bm, Cm, lA = t(1, 6, 2, 4), t(1, 6, 4), t(1, 6, 4), \
        (-t(1, 6, 2).detach().abs()).requires_grad_(grad)
    r, kk, vv = t(1, 6, 2, 4), t(1, 6, 2, 4), t(1, 6, 2, 4)
    w = torch.rand(1, 6, 2, 4, generator=g).requires_grad_(grad)
    u = t(2, 4)
    return {"decode_attention": (ops.decode_attention, FD.flash_decode,
                                 (q, k, v, lengths)),
            "decode_attention_int8": (ops.decode_attention_int8,
                                      FD8.flash_decode_int8,
                                      (q, kq, kq, scales, scales, lengths)),
            "ssd_scan": (ops.ssd_scan, MS.mamba_scan, (xt, Bm, Cm, lA)),
            "wkv_scan": (ops.wkv_scan, WK.wkv6, (r, kk, vv, w, u))}


@pytest.mark.parametrize("name", ["decode_attention", "decode_attention_int8",
                                  "ssd_scan", "wkv_scan"])
def test_ops_backpropagate_through_plain_versions_on_cpu(name):
    """ops.*(impl=None) on CPU tensors that require grad: the plain version
    runs, and its output carries a gradient back to every float input."""
    op, _, args = _kernel_inputs(grad=True)[name]
    out = op(*args)
    out = out if isinstance(out, torch.Tensor) else out[0]
    assert out.grad_fn is not None
    float_args = [a for a in args if a.requires_grad]
    grads = torch.autograd.grad(out.square().sum(), float_args)
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)
    assert any(bool(g.abs().sum() > 0) for g in grads)


@pytest.mark.parametrize("name", ["decode_attention", "decode_attention_int8",
                                  "ssd_scan", "wkv_scan"])
def test_kernel_wrappers_refuse_grad(name):
    """The wrapper itself raises before it would launch: with grad enabled
    and an input that requires grad, RuntimeError pointing at the training
    path, `forward(mode="train")`; under no_grad it goes on to its device
    check (ValueError off the card)."""
    _, wrapper, args = _kernel_inputs(grad=True)[name]
    with pytest.raises(RuntimeError, match="chunk scans in models/ssm.py"):
        wrapper(*args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        wrapper(*args)
    with torch.inference_mode(), pytest.raises(ValueError, match="CUDA"):
        wrapper(*args)
    _, wrapper, args = _kernel_inputs(grad=False)[name]
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*args)


def test_ssm_trains_on_cpu_through_plain_scans():
    """zamba2 reduced: the gradients of a train step through the sequential
    plain scans (`kernels.ref`, swapped in for the chunk scans) equal those
    through the chunk scans within GRAD_REL of each leaf's max|g|, and the
    scan's inputs get finite, nonzero gradients."""
    _, cfg = _configs("zamba2-2.7b")
    params = _port_params("zamba2-2.7b")
    b = batch_to(_batch(cfg), "cpu")
    _, grads = loss_and_grads(params, cfg, b)

    def plain(xh, Bm, Cm, dt, A, D):
        y, state = mamba_scan_ref(xh * dt[..., None], Bm, Cm, dt * A)
        return y + xh * D[None, None, :, None], state

    real = ssm.mamba2_chunk_scan
    ssm.mamba2_chunk_scan = plain
    try:
        _, pgrads = loss_and_grads(params, cfg, b)
    finally:
        ssm.mamba2_chunk_scan = real
    g = pgrads["layers"][0]["b0_mamba2"]
    for leaf in ("A_log", "w_in", "dt_bias"):
        assert bool(torch.isfinite(g[leaf]).all())
        assert float(g[leaf].abs().max()) > 0
    _assert_grads(_flat_grads(grads, params), _flat_grads(pgrads, params))


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_ssm_trains_on_cpu_through_chunk_scans(arch):
    """Both SSMs reduced: a train step on the CPU goes through the chunk
    scans (each called once per block, never the ops scans) and gives the
    scans' inputs finite, nonzero gradients."""
    _, cfg = _configs(arch)
    params = _port_params(arch)
    kind, scan = {"zamba2-2.7b": ("mamba2", "mamba2_chunk_scan"),
                  "rwkv6-1.6b": ("rwkv6", "wkv6_chunk_scan")}[arch]
    calls = []
    real = getattr(ssm, scan)

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    def refused(*args, **kw):
        raise AssertionError("a train step reached kernels.ops")

    saved = {n: getattr(ops, n) for n in ("ssd_scan", "wkv_scan")}
    setattr(ssm, scan, counted)
    for n in saved:
        setattr(ops, n, refused)
    try:
        _, grads = loss_and_grads(params, cfg, batch_to(_batch(cfg), "cpu"))
    finally:
        setattr(ssm, scan, real)
        for n, fn in saved.items():
            setattr(ops, n, fn)
    assert len(calls) == sum(blk.kind == kind for blk in cfg.unit) \
        * cfg.n_repeat
    g = grads["layers"][0][f"b0_{kind}"]
    leaves = ("A_log", "w_in", "dt_bias") if kind == "mamba2" else \
        ("w0", "wA", "wB", "u", "Wk", "Wr")
    for leaf in leaves:
        assert bool(torch.isfinite(g[leaf]).all())
        assert float(g[leaf].abs().max()) > 0
    assert not math.isnan(float(sum(t.sum() for t in tree_leaves(grads)
                                    if t is not None)))
