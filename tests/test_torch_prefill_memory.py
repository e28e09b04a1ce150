"""What a prefill keeps alive (ROADMAP C15), on the CPU.

  * C15a: the recurrent blocks' prefill caches own their rows.  Mamba2's
    conv state (the last d_conv - 1 conv inputs) and RWKV6's two shift
    states (the last normed inputs of the time and channel mix) are copies
    whose storage is their own size, not views that keep a layer's whole
    (B, S, C) input alive as long as the cache; their values are the
    rows they copy (zeros in front of a prompt shorter than the conv);
  * C15b: the dry run's prefill (no autograd, the chunk scans) takes a
    scan's chunks a group at a time: the recorder's peak of a reduced
    zamba2 and rwkv6 prefill falls below the all-at-once form's, with the
    same collectives and a cache of the same bytes.
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.shapes import InputShape
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models.common import rms_norm


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
        _, _, caches = M._repeat_full(params, cfg, 0, x, 0.0,
                                      mode="prefill", enc_out=None,
                                      impl="plain", with_aux=False)
        leaves = [t for c in caches.values() for t in c.values()]
        assert leaves and all(_own(t) for t in leaves), arch


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_grouped_scans_lower_the_traced_prefill_peak(monkeypatch, arch):
    """A reduced prefill of 8192 tokens traced on a fake (2, 4) mesh (the
    dry run's `chunk_scans`): grouped, its peak is below the all-at-once
    form's (forced by letting `_records` say autograd records), every
    other number but the trace wall equal."""
    cfg = get_config(arch).reduced(n_repeat=1)
    shape = InputShape("prefill_8k", 8192, 8, "prefill")
    kw = dict(cfg=cfg, shape=shape, mesh_shape=(2, 4),
              mesh_names=("data", "model"), save=False)
    grouped = D.run_pair(arch, "prefill_8k", **kw)
    monkeypatch.setattr(ssm, "_records", lambda *a: True)
    whole = D.run_pair(arch, "prefill_8k", **kw)
    assert grouped["status"] == whole["status"] == "ok"
    gb, wb = grouped["bytes_per_device"], whole["bytes_per_device"]
    assert gb["arguments"] == wb["arguments"]
    assert gb["outputs"] == wb["outputs"]
    assert grouped["collectives"] == whole["collectives"]
    assert gb["peak"] < wb["peak"], (gb, wb)
