"""The 32K prefill's memory against the reference's (ROADMAP C18-C20), on
the CPU at reduced size.

  * C18: the last position's logits on DTensors multiply each rank's rows
    by its own vocab columns (`models.model._last_logits`).  A reduced
    granite-3-8b and whisper-medium, their vocabulary made odd so that
    the head stays whole on every rank (as granite's 49155 does on
    `model` = 16), traced on a fake (pod, data, model) mesh with four
    rows a rank: no tensor of the head expanded over the rows, (rows, d,
    V), is made, where `matmul`'s batched path on DTensors copied it.  On
    plain tensors the product is `x[:, -1:] @ head`, bit for bit.
  * C19: Mamba2's conv, skip term and gated norm take MAMBA_ROWS rows at
    a time where autograd does not record them.  A reduced zamba2's
    prefill with blocks of 16 rows and a prompt that is not a multiple of
    them equals the reference's `forward(mode="prefill")` at the model
    tolerance, caches included, under both scans; a block traced over 16
    blocks of rows peaks below the whole-sequence form's (the expressions
    autograd still takes).
  * C20: the MoE combine takes COMBINE_ROWS tokens at a time: equal to
    the reference's `_combine_group` within MOE_REL of max|out| with
    assignments dropped, no (Tg·k, d) f32 tensor made and the traced peak
    below the whole-group form's by that copy; under autograd one block is
    the whole-group form bit for bit, value and gradients, and smaller
    blocks are within MOE_REL of it.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo_analysis import StepRecorder
from repro_torch.launch.shapes import InputShape
from repro_torch.models import model as M
from repro_torch.models import moe, ssm
from repro_torch.models.common import rms_norm, silu
from repro_torch.models.convert import to_reference_layout

ATOL = 1e-4                               # tests/test_torch_ssm.py's
STATE_TOL = dict(atol=1e-4, rtol=1e-4)
MOE_REL = 1e-5                            # tests/test_torch_moe.py's


class _Shapes(TorchDispatchMode):
    """Every (shape, dtype) an op returns."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.made.append((tuple(t.shape), t.dtype))
        return out


# --- C18 ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-3-8b", "whisper-medium"])
def test_head_not_expanded_over_the_rows(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(n_repeat=1),
                              vocab=4099)
    shape = InputShape("prefill_32k", 32, 16, "prefill")
    r = D.run_pair(arch, "prefill_32k", cfg=cfg, shape=shape,
                   mesh_shape=(2, 2, 4), mesh_names=("pod", "data", "model"),
                   save=False)
    assert r["status"] == "ok", r.get("traceback")
    expanded = rf"\(4, {cfg.d_model}, {cfg.vocab}\)"
    assert not re.search(expanded, r["peak_set_by"]), r["peak_set_by"]
    assert r["bytes_per_device"]["peak"] - r["bytes_per_device"][
        "arguments"] < 4 * cfg.d_model * cfg.vocab * 4, r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_last_logits_bits_on_plain_tensors(dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 37, 64, generator=g).to(dtype)
    head = torch.randn(64, 1000, generator=g).to(dtype)
    got = M._last_logits(x, head)
    assert got.shape == (3, 1, 1000)
    assert torch.equal(got, x[:, -1:] @ head)


# --- C19 ---------------------------------------------------------------

@pytest.fixture(scope="module")
def zamba():
    """A reduced zamba2 of one repeat (the port's weights, the reference's
    the same in its layout), a 70-token prompt and the reference's
    prefill of it."""
    jcfg = jax_get_config("zamba2-2.7b").reduced(n_repeat=1)
    cfg = get_config("zamba2-2.7b").reduced(n_repeat=1)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jparams = jax.tree.map(jnp.asarray, to_reference_layout(params))
    toks = np.random.default_rng(70).integers(0, cfg.vocab, size=(2, 70))
    jlogits, jcache, _ = JM.forward(jparams, jcfg,
                                    {"tokens": jnp.asarray(toks)},
                                    mode="prefill")
    return cfg, params, toks, np.asarray(jlogits), jax.tree.map(np.asarray,
                                                                jcache)


@pytest.mark.parametrize("chunk_scans", [False, True])
def test_blocked_mamba_prefill_matches_reference(zamba, chunk_scans,
                                                 monkeypatch):
    """Blocks of 16 rows over the 70-token prompt (4 whole blocks and 6
    rows), without autograd: logits, attention K/V and the Mamba2 conv and
    SSM states within the model tolerances of the reference's prefill."""
    cfg, params, toks, jlogits, jcache = zamba
    monkeypatch.setattr(ssm, "MAMBA_ROWS", 16)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # tiny ops: threads only wait
    try:
        with torch.no_grad():
            logits, cache = M.forward(params, cfg, torch.as_tensor(toks),
                                      mode="prefill", chunk_scans=chunk_scans)
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=ATOL, rtol=0)
    assert sorted(cache) == sorted(jcache)
    for name, c in jcache.items():
        for key, a in c.items():
            tol = dict(atol=ATOL, rtol=0) if key in ("k", "v") else STATE_TOL
            np.testing.assert_allclose(cache[name][key].numpy(), a,
                                       err_msg=f"{name}/{key}", **tol)


def _whole_sequence_form(monkeypatch):
    """The block's conv, skip term and gated norm in the form autograd
    takes, each over the whole sequence at once."""
    monkeypatch.setattr(ssm, "_conv_silu_rows", lambda xbc, w, b: silu(
        ssm._causal_conv_full(xbc.float(), w, b)))
    monkeypatch.setattr(ssm, "_plus_Dx_rows", lambda y, xh, D: y + xh * D[
        None, None, :, None])
    monkeypatch.setattr(ssm, "_gated_norm_rows", lambda y, z, scale, *, eps,
                        dtype: rms_norm(y * silu(z.float()), scale,
                                        eps).to(dtype))


def _mamba_block_peak(cfg, S):
    """One Mamba2 block's no-grad prefill (the chunk scan) of S tokens on
    fake tensors: the peak `StepRecorder` traces beside its inputs."""
    with FakeTensorMode():
        p = ssm.init_mamba2(torch.Generator().manual_seed(0), cfg,
                            torch.device("cpu"))
        x = torch.empty(1, S, cfg.d_model, dtype=torch.bfloat16)
        rec = StepRecorder()
        rec.exclude((p, x))
        with torch.no_grad(), rec:
            out = ssm.mamba2_full(p, cfg, x, mode="prefill",
                                  chunk_scans=True)
            del out
    return rec.peak


def test_blocked_mamba_lowers_the_traced_prefill_peak(monkeypatch):
    """A bf16 reduced zamba2 block over 4096 tokens in blocks of 256 rows
    (the scan in groups of one 128-token chunk, so that the conv's
    whole-sequence temporaries would set the peak): the peak is below the
    whole-sequence form's by two (S, C) f32 tensors of the conv."""
    cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(),
                              dtype="bfloat16")
    S = 4096
    monkeypatch.setattr(ssm, "MAMBA_GROUP", 1)
    monkeypatch.setattr(ssm, "MAMBA_ROWS", 256)
    blocked = _mamba_block_peak(cfg, S)
    _whole_sequence_form(monkeypatch)
    whole = _mamba_block_peak(cfg, S)
    conv = S * (cfg.d_inner + 2 * cfg.ssm_state) * 4
    assert whole - blocked >= 2 * conv, (blocked, whole, conv)


# --- C20 ---------------------------------------------------------------

def test_combine_matches_reference_without_the_copy(monkeypatch):
    """32 tokens in blocks of 8, 8 experts, top 3, 6 slots an expert: some
    assignments are dropped.  The port's combine on its own dispatch's
    maps vs the reference's on its own, on the same expert outputs; no f32
    tensor of Tg·k rows is made."""
    Tg, d, E, k, C = 32, 48, 8, 3, 6
    monkeypatch.setattr(moe, "COMBINE_ROWS", 8)
    rng = np.random.default_rng(20)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(Tg)])
    gates = rng.uniform(0.1, 1.0, (Tg, k)).astype(np.float32)
    gates /= gates.sum(-1, keepdims=True)
    hf = rng.standard_normal((Tg, d)).astype(np.float32)
    # the experts' outputs exact in bfloat16 too: one reference for both
    out_e = torch.from_numpy(rng.standard_normal((E, C, d)).astype(
        np.float32)).bfloat16().float().numpy()
    _, jmeta = JMoE._dispatch_group(jnp.asarray(hf), jnp.asarray(gates),
                                    jnp.asarray(idx), E, k, C)
    assert not np.asarray(jmeta[1]).all()          # assignments dropped
    want = np.asarray(JMoE._combine_group(jnp.asarray(out_e), jmeta,
                                          jnp.asarray(gates), k))
    _, meta = moe._dispatch_group(torch.as_tensor(hf), torch.as_tensor(idx),
                                  E, k, C)
    for dtype in (torch.float32, torch.bfloat16):
        o = torch.as_tensor(out_e).to(dtype)
        with torch.no_grad(), _Shapes() as seen:
            got = moe._combine_group(o, meta, torch.as_tensor(gates), k)
        assert got.dtype == torch.float32 and got.shape == (Tg, d)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= MOE_REL, (dtype, err)
        big = [s for s, dt in seen.made
               if dt == torch.float32 and int(np.prod(s)) >= Tg * k * d]
        assert not big, big


def _whole_group(out_e, meta, gates, k):
    """The combine over the whole group at once: the reference's form
    (the rows picked in slot order, then put in token order)."""
    dest, keep, inv_order = meta
    d = out_e.shape[-1]
    picked = torch.where(keep[:, None], out_e.reshape(-1, d)[dest], 0)
    return torch.einsum("tkd,tk->td", picked[inv_order].reshape(
        gates.shape[0], k, d).float(), gates)


def _combine_case(Tg, d, E, k, C, seed):
    g = torch.Generator().manual_seed(seed)
    idx = torch.stack([torch.randperm(E, generator=g)[:k]
                       for _ in range(Tg)])
    gates = torch.rand(Tg, k, generator=g)
    _, meta = moe._dispatch_group(torch.randn(Tg, d, generator=g), idx,
                                  E, k, C)
    out_e = torch.randn(E, C, d, generator=g).to(torch.bfloat16)
    return out_e, meta, gates


@pytest.mark.parametrize("rows", [64, 8])
def test_combine_blocks_against_the_whole_group_form(rows, monkeypatch):
    """44 tokens, top 3, assignments dropped, under autograd: in one block
    (a group of up to COMBINE_ROWS tokens: the serve paths' prefills of
    up to 1024 tokens and their decode steps) the value and the gradients
    of the experts' outputs and of the gates are the whole-group form's
    bit for bit; in blocks of 8 tokens (five and one of 4) within MOE_REL
    of their largest magnitude."""
    k = 3
    out_e, meta, gates = _combine_case(44, 32, 8, k, 12, 5)
    assert not meta[1].all()
    monkeypatch.setattr(moe, "COMBINE_ROWS", rows)
    w = torch.randn(44, 32, generator=torch.Generator().manual_seed(6))
    got, want = [], []
    for fn, into in ((moe._combine_group, got), (_whole_group, want)):
        o = out_e.float().requires_grad_()
        gt = gates.clone().requires_grad_()
        y = fn(o, meta, gt, k)
        (y * w).sum().backward()
        into += [y.detach(), o.grad, gt.grad]
    for a, b in zip(got, want):
        if rows >= 44:
            assert torch.equal(a, b)
        else:
            assert float((a - b).abs().max() / b.abs().max()) <= MOE_REL


def test_combine_traced_peak(monkeypatch):
    """Traced by `StepRecorder` over 16 blocks of 16 tokens, the combine's
    peak is below the whole-group form's (the reference's, one block of
    all 256 tokens) by its (Tg·k, d) f32 copy less a block's."""
    Tg, k = 256, 4
    out_e, meta, gates = _combine_case(Tg, 64, 8, k, 160, 3)
    d = out_e.shape[-1]

    def peak(rows):
        monkeypatch.setattr(moe, "COMBINE_ROWS", rows)
        rec = StepRecorder()
        rec.exclude((out_e, meta, gates))
        with torch.no_grad(), rec:
            y = moe._combine_group(out_e, meta, gates, k)
        del y
        return rec.peak

    blocked, whole = peak(16), peak(Tg)
    copy, block = Tg * k * d * 4, 16 * k * d * 4
    assert whole - blocked >= copy - block, (blocked, whole)
