"""The port's `flash_attention` (models/attention.py) against the
reference's chunked online softmax, on the CPU.

The same numpy inputs, made from a seed, go through
`repro.models.attention.flash_attention` and its twin at the same chunk
sizes.  Tolerances are tests/models/test_attention.py's: atol 2e-5 in
float32; bfloat16 q/k/v at atol 3e-2 against float32 direct softmax.
Gradients of q, k and v against one `jax.vjp` of the reference within
GRAD_REL of each gradient's max|g|.  Also held: the chunk pairs the masks
leave empty are skipped, bit for bit as if they were not; each q chunk is
checkpointed where autograd records the call and nowhere else, and the
dry run's recorder counts the recompute; a DTensor sharded by batch or
heads is attended on each rank's shards; K and V stay chunk-major in
their own dtype and a chunk pair takes its kv chunk to f32 (C16b), bit
for bit the form that took them to f32 whole.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models.attention import flash_attention as jax_flash_attention
from repro_torch.models import attention as A

ATOL = 2e-5
BF16_ATOL = 3e-2
GRAD_REL = 1e-4

# (B, S, T, K, G, D, causal, window, q_offset, chunk): the reference test's
# cases (causal, with and without a window, chunks 16 and 64, GQA; the
# non-causal cross shapes with S != T), the default 512 with S, T > 512, a
# query offset, and windows wider than a chunk
CASES = [
    (2, 130, 130, 2, 3, 32, True, 16, 0, 16),
    (1, 130, 130, 1, 1, 8, True, 0, 0, 64),
    (1, 7, 7, 2, 1, 32, True, 0, 0, 16),
    (2, 1, 1, 1, 3, 8, True, 16, 0, 16),
    (1, 33, 50, 4, 1, 16, False, 0, 0, 512),
    (1, 600, 600, 2, 2, 16, True, 0, 0, 512),
    (1, 520, 700, 2, 1, 8, False, 0, 0, 512),
    (1, 40, 100, 2, 2, 16, True, 0, 60, 16),
    (1, 200, 200, 2, 2, 16, True, 70, 0, 16),
]


def _jit(**kw):
    """The reference's flash_attention at `kw`, jitted (one compile, a
    third of its eager time here)."""
    return jax.jit(functools.partial(jax_flash_attention, **kw))


def _inputs(B, S, T, K, G, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, K * G, D), (B, T, K, D), (B, T, K, D))]


def _direct(q, k, v, *, causal=True):
    """tests/models/test_attention.py's direct softmax, in numpy f64."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    qh = q.reshape(B, S, K, H // K, D).astype(np.float64)
    s = np.einsum("bskgd,btkd->bkgst", qh, k.astype(np.float64)) / np.sqrt(D)
    if causal:
        s = np.where(np.arange(T)[None, :] <= np.arange(S)[:, None], s,
                     -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("bkgst,btkd->bskgd", p, v.astype(np.float64))
    return out.reshape(B, S, H, D)


@pytest.mark.parametrize("B,S,T,K,G,D,causal,window,q_offset,chunk", CASES)
def test_matches_reference(B, S, T, K, G, D, causal, window, q_offset,
                           chunk):
    q, k, v = _inputs(B, S, T, K, G, D, seed=S * T + window)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              q_chunk=chunk, kv_chunk=chunk)
    ref = _jit(**kw)(*map(jnp.asarray, (q, k, v)))
    out = A.flash_attention(*map(torch.as_tensor, (q, k, v)), **kw)
    assert out.dtype == torch.float32 and out.shape == (B, S, K * G, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_bfloat16_path():
    """tests/models/test_attention.py::test_bfloat16_path's shapes and
    chunks: bfloat16 out, within BF16_ATOL of float32 direct softmax and of
    the reference's bfloat16 output."""
    q, k, v = _inputs(2, 96, 96, 4, 2, 32, seed=0)
    q16, k16, v16 = (torch.as_tensor(t).bfloat16() for t in (q, k, v))
    out = A.flash_attention(q16, k16, v16, q_chunk=32, kv_chunk=32)
    assert out.dtype == torch.bfloat16
    exact = [t.float().numpy() for t in (q16, k16, v16)]
    np.testing.assert_allclose(out.float().numpy(), _direct(*exact),
                               atol=BF16_ATOL, rtol=0)
    ref = _jit(q_chunk=32, kv_chunk=32)(
        *(jnp.asarray(t, jnp.bfloat16) for t in exact))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("causal,window,chunk", [(True, 20, 16),
                                                 (False, 0, 32)])
def test_gradients_match_jax_vjp(causal, window, chunk):
    """d(q, k, v) of sum(out * cot) against one jax.vjp of the reference,
    within GRAD_REL of each max|g|; each q chunk checkpointed."""
    q, k, v = _inputs(2, 48, 48, 2, 2, 16, seed=7 + window)
    cot = np.random.default_rng(8).standard_normal(q.shape).astype(
        np.float32)
    kw = dict(causal=causal, window=window, q_chunk=chunk, kv_chunk=chunk)
    want = jax.jit(lambda q, k, v, c: jax.vjp(functools.partial(
        jax_flash_attention, **kw), q, k, v)[1](c))(
            *map(jnp.asarray, (q, k, v, cot)))
    ts = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    (A.flash_attention(*ts, **kw) * torch.as_tensor(cot)).sum().backward()
    for t, w in zip(ts, want):
        w = np.asarray(w)
        err = np.abs(t.grad.numpy() - w).max() / np.abs(w).max()
        assert err <= GRAD_REL, err


@pytest.mark.parametrize("window,chunk", [(0, 16), (40, 16), (9, 4)])
def test_skipped_chunk_pairs_are_exact(window, chunk, monkeypatch):
    """Skipping the pairs the masks leave empty (above the causal diagonal,
    wholly before the window, which here spans several chunks) gives the
    bits of the unskipped loop, forward and backward."""
    q, k, v = _inputs(1, 100, 100, 2, 2, 8, seed=window)
    kw = dict(window=window, q_chunk=chunk, kv_chunk=chunk)

    def run():
        ts = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
        out = A.flash_attention(*ts, **kw)
        out.square().sum().backward()
        return [out.detach()] + [t.grad for t in ts]

    skipped = run()
    monkeypatch.setattr(A, "_kv_chunks",
                        lambda a, b, *, nk, **_: range(nk))
    full = run()
    for a, b in zip(skipped, full):
        assert torch.equal(a, b)


def test_chunk_pairs_visited():
    """prefill_32k's causal 64 x 64 chunk pairs fall to 2080; a 4096-token
    window at 512 keeps 9 a q chunk past the first 8; a query with no key
    at all keeps every pair of its chunk."""
    n = 32768 // 512

    def pairs(window, S=32768, T=32768, q_offset=0):
        return sum(len(A._kv_chunks(q_offset + i * 512,
                                    q_offset + min(S, (i + 1) * 512) - 1,
                                    kc=512, nk=-(-T // 512), T=T,
                                    causal=True, window=window))
                   for i in range(-(-S // 512)))

    assert pairs(0) == n * (n + 1) // 2 == 2080
    assert pairs(4096) == sum(min(i + 1, 9) for i in range(n))
    assert len(A._kv_chunks(-4, 10, kc=8, nk=3, T=20, causal=True,
                            window=0)) == 3


def test_checkpointed_only_where_autograd_records(monkeypatch):
    """One checkpoint a q chunk under grad, none under no_grad or for
    inputs that need no gradient."""
    calls = []
    real = A.checkpoint

    def counted(*a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(*a, **kw)

    monkeypatch.setattr(A, "checkpoint", counted)
    q, k, v = (torch.as_tensor(t) for t in _inputs(1, 50, 50, 1, 2, 8, 3))
    A.flash_attention(q, k, v, q_chunk=16, kv_chunk=16)
    with torch.no_grad():
        A.flash_attention(q.requires_grad_(), k, v, q_chunk=16, kv_chunk=16)
    assert calls == []
    A.flash_attention(q, k, v, q_chunk=16, kv_chunk=16).sum().backward()
    assert calls == [False] * 4


def test_dry_run_recorder_counts_the_recompute():
    """Under FakeTensorMode and the dry run's StepRecorder, a step with
    gradients counts the checkpointed forward twice: the einsums' flops are
    forward 2 x F, recompute 2 x F and backward 4 x F, i.e. 4x the
    forward's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.hlo_analysis import StepRecorder
    flops = []
    for grad in (False, True):
        with FakeTensorMode():
            q, k, v = (torch.empty(s, requires_grad=grad)
                       for s in ((2, 64, 4, 16), (2, 64, 2, 16),
                                 (2, 64, 2, 16)))
            rec = StepRecorder()
            with rec:
                out = A.flash_attention(q, k, v, causal=False, q_chunk=32,
                                        kv_chunk=32)
                if grad:
                    out.sum().backward()
        flops.append(rec.flops)
    assert flops[0] > 0 and flops[1] == 4 * flops[0], flops


def test_dtensor_batch_sharded_runs_on_local_shards():
    """On a fake 2-rank mesh, q, k, v sharded by batch (or heads): each
    rank attends its shard, the output placed as q and equal to the plain
    call on the shard; a sharded sequence is refused."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    q, k, v = (torch.as_tensor(t) for t in _inputs(2, 40, 40, 2, 2, 8, 5))
    dist.init_process_group("fake", store=FakeStore(), world_size=2, rank=0)
    try:
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
        for dim_q, dim_kv, cut in ((0, 0, slice(0, 1)),
                                   (2, 2, (slice(None), slice(None),
                                           slice(0, 1)))):
            qs = q[:, :, :2] if dim_q == 2 else q[cut]
            ks, vs = (t[cut] for t in (k, v))
            dq, dk, dv = (DTensor.from_local(t, mesh, [Shard(d)],
                                             run_check=False)
                          for t, d in ((qs, dim_q), (ks, dim_kv),
                                       (vs, dim_kv)))
            out = A.flash_attention(dq, dk, dv, window=12, q_chunk=16,
                                    kv_chunk=16)
            assert tuple(out.placements) == (Shard(dim_q),)
            assert torch.equal(out.to_local(), A.flash_attention(
                qs, ks, vs, window=12, q_chunk=16, kv_chunk=16))
        dseq = [DTensor.from_local(t[:, :20], mesh, [Shard(1)],
                                   run_check=False) for t in (q, k, v)]
        with pytest.raises(NotImplementedError, match="flash_attention"):
            A.flash_attention(*dseq)
    finally:
        dist.destroy_process_group()


def test_dtensor_key_sequence_sharded_merges():
    """Non-causal attention over K/V whose sequence is sharded over a fake
    2-rank mesh (decode's cross-attention over a cached encoder K/V): each
    rank attends its piece of the keys and the gathered softmax states
    are merged.  The fake group's all-gather copies rank 0's state to
    every slot, so the keys it stands for are rank 0's piece twice; the
    result, replicated, equals the plain call on them."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    q, k, v = (torch.as_tensor(t) for t in _inputs(2, 3, 40, 2, 2, 8, 6))
    dist.init_process_group("fake", store=FakeStore(), world_size=2, rank=0)
    try:
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
        dq = DTensor.from_local(q, mesh, [Replicate()], run_check=False)
        dk, dv = (DTensor.from_local(t[:, :20], mesh, [Shard(1)],
                                     run_check=False) for t in (k, v))
        out = A.flash_attention(dq, dk, dv, causal=False, kv_chunk=8)
        assert tuple(out.placements) == (Replicate(),)
        whole = [torch.cat([t[:, :20]] * 2, 1) for t in (k, v)]
        torch.testing.assert_close(out.to_local(), A.flash_attention(
            q, *whole, causal=False, kv_chunk=8), atol=1e-6, rtol=0)
    finally:
        dist.destroy_process_group()


def test_dry_run_memoizes_the_chunked_attention(monkeypatch):
    """The dry run traces the chunked attention of a prefill once per
    signature (`StepRecorder.memoized`) and credits it to the other
    layers: bytes, peak, cost and collectives equal to the full trace, in
    a third of the q-chunk calls over three layers."""
    import contextlib
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.launch.shapes import InputShape
    cfg = get_config("yi-6b").reduced(n_repeat=3)
    shape = InputShape("prefill_1k", 1024, 8, "prefill")
    calls = []
    real = A._q_chunk
    monkeypatch.setattr(A, "_q_chunk", lambda *a, **kw: calls.append(1)
                        or real(*a, **kw))
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        memo = D.trace_pair("yi-6b", "prefill_1k", mesh, cfg=cfg,
                            shape=shape)
        n_memo = len(calls)
        monkeypatch.setattr(D, "_memoized",
                            lambda rec: contextlib.nullcontext())
        full = D.trace_pair("yi-6b", "prefill_1k", mesh, cfg=cfg,
                            shape=shape)
    assert memo == full
    assert 3 * n_memo == len(calls) - n_memo == 3 * 2


class _Allocations(TorchDispatchMode):
    """The (shape, dtype) of every tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.made.append((tuple(t.shape), t.dtype))
        return out


@pytest.fixture
def one_thread():
    """One intra-op thread: the many small ops of a chunk loop otherwise
    wait on the scheduler while the suite's workers hold the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,K,G,D,causal,window,q_offset,chunk", CASES)
def test_kv_chunks_taken_to_f32_one_pair_at_a_time(
        B, S, T, K, G, D, causal, window, q_offset, chunk, dtype):
    """C16b: the output, the lse and (under autograd) the gradients of q, k
    and v equal, bit for bit, the call on K and V taken to f32 whole
    beforehand (the form that kept f32 K^T and V of the whole call); in
    bfloat16 and without autograd no f32 tensor of the chunk-major K^T or
    V's shape, (nk, B K, D, kc) or (nk, B K, kc, D), is made."""
    q, k, v = (torch.as_tensor(t).to(dtype)
               for t in _inputs(B, S, T, K, G, D, seed=S + T + window))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              q_chunk=chunk, kv_chunk=chunk)
    with torch.no_grad(), _Allocations() as rec:
        out, lse = A._flash_attention(q, k, v, **kw, state=True)
    for a, b in zip((out, lse), A._flash_attention(
            q, k.float(), v.float(), **kw, state=True)):
        assert torch.equal(a, b)
    assert torch.equal(A.flash_attention(q, k, v, **kw),
                       A.flash_attention(q, k.float(), v.float(), **kw))
    kc, BK = min(chunk, T), B * K
    nk = -(-T // kc)
    whole = {((nk, BK, D, kc), torch.float32),
             ((nk, BK, kc, D), torch.float32)}
    if dtype == torch.bfloat16:
        assert not whole & set(rec.made)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(
        S), dtype=torch.float32).to(dtype)
    grads = []
    for up in (lambda t: t, lambda t: t.float()):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        (A.flash_attention(ts[0], up(ts[1]), up(ts[2]), **kw)
         .float() * cot.float()).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        assert a.dtype == dtype and torch.equal(a, b)
