"""The CUDA kernels, the fabric, the model and the server on the card,
against their plain versions and the CPU.

Every case needs an NVIDIA card: it carries the ``cuda`` marker and skips
without one.  The file imports neither jax nor ``repro``, so it runs on a
machine that has the card and no JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Inputs come from numpy with a seed and hold what the fabric feeds the
kernels: gathered set rows with the trash way sliced off (strided views),
duplicate tags, empty ways and rows, full and partly-full TSU rows, and
clocks within a lease of ``TS_MAX``.  Every coherence comparison is
exact; the float kernels' tolerances are stated with ``FLOAT_TOL``.
"""
import numpy as np
import pytest
import torch

from repro_torch.coherence.fabric import ArrayFabric, FabricConfig, Op
from repro_torch.core.protocol import TS_MAX
from repro_torch.kernels import ref
from repro_torch.kernels.lease_probe import lease_probe
from repro_torch.kernels.tier_pass import miss_round, write_grant


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rows(dev, a):
    """A ``[N, W+1]`` host matrix as the strided ``[N, W]`` view the
    fabric passes (the trailing trash way sliced off)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)[:, :-1]


def _vec(dev, a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _assert_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert torch.equal(g, w), f"output {i} differs"


def _probe_inputs(N, W, seed):
    rng = np.random.default_rng(seed)
    tag = rng.integers(-1, 12, (N, W + 1)).astype(np.int32)
    tag[::3, min(1, W - 1)] = tag[::3, 0]              # duplicate tags
    tag[1::5] = -1                                     # empty set rows
    rts = rng.integers(TS_MAX - 35, TS_MAX, (N, W + 1)).astype(np.int32)
    cts = rng.integers(TS_MAX - 35, TS_MAX, N).astype(np.int32)
    addr = rng.integers(0, 12, N).astype(np.int32)
    mwts = rng.integers(TS_MAX - 15, TS_MAX, N).astype(np.int32)
    mrts = (mwts + rng.integers(1, 9, N)).astype(np.int32)
    return tag, rts, cts, addr, mwts, mrts


def _miss_inputs(N, W1, W2, C, seed):
    rng = np.random.default_rng(seed)
    r = lambda lo, hi, shp: rng.integers(lo, hi, shp).astype(np.int32)
    rp_tag, sh_tag = r(-1, 40, (N, W1 + 1)), r(-1, 40, (N, W2 + 1))
    ts_tag = r(-1, 4000, (N, C + 1))
    rp_tag[::4, min(1, W1 - 1)] = rp_tag[::4, 0]       # duplicate tags
    addr = r(0, 40, N)
    ts_tag[::2, C // 2] = addr[::2]                    # TSU hits on half
    ts_tag[1::6] = -1                                  # empty TSU rows
    ts_mem = r(TS_MAX - 15, TS_MAX, (N, C + 1))        # within rd of TS_MAX
    rows = [rp_tag, r(0, 40, (N, W1 + 1)), sh_tag, r(0, 40, (N, W2 + 1)),
            r(0, 40, (N, W2 + 1)), ts_tag, ts_mem]
    vecs = [r(0, 40, N), r(0, 40, N), addr, r(0, 2, N),
            np.full(N, 8, np.int32)]
    return rows, vecs


def _grant_inputs(N, C, seed):
    rng = np.random.default_rng(seed)
    tag = rng.integers(0, 6000, (N, C + 1)).astype(np.int32)   # full rows
    tag[1::4, 5::3] = -1                               # partly full rows
    tag[2::8] = -1                                     # empty rows
    addr = rng.integers(0, 6000, N).astype(np.int32)
    tag[::3, min(11, C - 1)] = addr[::3]               # hits on a third
    mem = rng.integers(TS_MAX - 7, TS_MAX, (N, C + 1)).astype(np.int32)
    seq = rng.integers(0, 64, (N, C + 1)).astype(np.int32)
    wl = rng.integers(1, 9, N).astype(np.int32)
    return [tag, mem, seq], [addr, wl]


@pytest.mark.cuda
@pytest.mark.parametrize("N,W", [(1, 2), (64, 8), (4096, 8), (100, 3)])
def test_cuda_lease_probe_equals_plain(cuda_device, N, W):
    tag, rts, *vecs = _probe_inputs(N, W, seed=N + W)
    args = (_rows(cuda_device, tag), _rows(cuda_device, rts),
            *(_vec(cuda_device, v) for v in vecs))
    before = lease_probe.launches
    _assert_equal(lease_probe(*args), ref.lease_probe_ref(*args))
    assert lease_probe.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("N,W1,W2,C,seed", [(256, 8, 8, 1024, 0),
                                            (37, 2, 4, 64, 1)])
def test_cuda_miss_round_equals_plain(cuda_device, N, W1, W2, C, seed):
    rows, vecs = _miss_inputs(N, W1, W2, C, seed)
    args = [_rows(cuda_device, a) for a in rows] + \
        [_vec(cuda_device, v) for v in vecs]
    got = miss_round(*args)
    _assert_equal(got, ref.miss_round_ref(*args))
    assert got[11].any()                               # a reinit fired


@pytest.mark.cuda
@pytest.mark.parametrize("N,C,seed", [(256, 1024, 0), (40, 8, 2)])
def test_cuda_write_grant_equals_plain(cuda_device, N, C, seed):
    rows, vecs = _grant_inputs(N, C, seed)
    args = [_rows(cuda_device, a) for a in rows] + \
        [_vec(cuda_device, v) for v in vecs]
    got = write_grant(*args)
    _assert_equal(got, ref.write_grant_ref(*args))
    assert got[2].any() and not got[2].all()           # full and not full


@pytest.mark.cuda
def test_cuda_wrappers_check_their_inputs(cuda_device):
    tag, rts, *vecs = _probe_inputs(8, 4, seed=0)
    vecs = [_vec(cuda_device, v) for v in vecs]
    full = _vec(cuda_device, tag)
    with pytest.raises(ValueError, match="contiguous"):
        lease_probe(full[:, ::2], _rows(cuda_device, rts)[:, ::2], *vecs)
    with pytest.raises(TypeError, match="int32"):
        lease_probe(full.long(), _rows(cuda_device, rts), *vecs)
    with pytest.raises(ValueError, match="shape"):
        lease_probe(full[:4], _rows(cuda_device, rts), *vecs)


@pytest.mark.cuda
def test_cuda_fabric_equals_cpu_fabric(cuda_device):
    """The same mixed stream through the fabric on the card and on the
    CPU: identical results, grant log, counters and state."""
    cfg = FabricConfig(n_shards=2, rd_lease=8, wr_lease=4, tsu_capacity=8,
                       shared_sets=8, shared_ways=2, replica_sets=4,
                       replica_ways=2, max_in_flight=2)
    fabs = [ArrayFabric(cfg, n_nodes=2, replicas_per_node=2, device=d)
            for d in (cuda_device, "cpu")]
    rng = np.random.default_rng(5)
    keys = [f"k{i}" for i in range(24)]
    outs = [[], []]
    for step in range(30):
        batch = [keys[int(i)] for i in rng.integers(0, len(keys), 24)]
        rep = int(rng.integers(4))
        for fab, out in zip(fabs, outs):
            fab.write_batch([(k, f"{k}@{step}") for k in batch[:6]],
                            replica=rep)
            out.append(fab.read_batch(batch, replica=(rep + 1) % 4))
            out.append(fab.read_batch_async(batch[::2], replica=rep).result())
            out.append([r for _, r in fab.apply(
                [Op("read", batch[0], replica=rep),
                 Op("mm_write", batch[1], f"m{step}"),
                 Op("publish", batch[2], f"p{step}", node=step % 2),
                 Op("mm_read", batch[3])])])
            if step % 4 == 3:
                out.append(fab.fence())
    assert outs[0] == outs[1]
    a, b = fabs
    assert list(a.grant_log) == list(b.grant_log)
    assert a.stats() == b.stats()
    assert a.stats()["tsu_evictions"] > 0
    xa, ha = a.export_state()
    xb, hb = b.export_state()
    assert all(np.array_equal(xa[k], xb[k]) for k in xa)


# ------------------------------------------------------------ float kernels
# Kernel vs plain version on the card.  f32: rtol = atol = 1e-5 (the same
# f32 math, summed in another order: online vs full softmax, warp vs
# torch reductions).  bf16: rtol = atol = 2e-2 (both sides compute in f32
# and round the result to bf16 once; an input rounding difference of one
# bf16 step, 2^-8 relative, stays inside).
FLOAT_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def exact_f32(cuda_device):
    """Full-precision f32 matmuls on the card (no TF32)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda_device
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _randn(dev, shape, dtype, seed):
    g = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(g).to(dev, dtype)


def _close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **FLOAT_TOL[want.dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("R,D", [(4096, 960), (7, 80), (5, 100), (3, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rmsnorm_equals_plain(exact_f32, R, D, dtype):
    from repro_torch.kernels.rmsnorm import rmsnorm
    x = _randn(exact_f32, (R, D), dtype, R + D)
    w = _randn(exact_f32, (D,), torch.float32, D) * 0.1
    before = rmsnorm.launches
    _close(rmsnorm(x, w), ref.rmsnorm_ref(x, w))
    assert rmsnorm.launches == before + 1
    x3 = x.reshape(1, R, D)
    _close(rmsnorm(x3, w), ref.rmsnorm_ref(x3, w))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", [
    (2, 512, 512, 15, 5, 64, True, 0),        # the serving path's prefill
    (1, 100, 100, 15, 5, 64, True, 0),        # ragged tail
    (2, 77, 77, 4, 2, 16, False, 0),
    (1, 130, 130, 4, 1, 128, True, 32),       # MQA, windowed
    (1, 50, 130, 4, 2, 32, False, 0),         # rectangular
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_equals_plain(exact_f32, B, Sq, Sk, Hq, Hkv, D,
                                           causal, window, dtype):
    from repro_torch.kernels.flash_attention import flash_attention
    dev = exact_f32
    q = _randn(dev, (B, Sq, Hq, D), dtype, 1)
    # k and v as strided views of one [B, S, 2, Hkv, D] block, as a fused
    # projection would give them
    kv = _randn(dev, (B, Sk, 2, Hkv, D), dtype, 2)
    k, v = kv[:, :, 0], kv[:, :, 1]
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    _close(got, ref.attention_ref(q, k, v, causal=causal, window=window))
    assert flash_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sk,Hq,Hkv,D,kv_len", [
    (8, 584, 15, 5, 64, 1), (8, 584, 15, 5, 64, 513),
    (8, 584, 15, 5, 64, 584), (2, 300, 8, 2, 128, 257),
    (1, 64, 16, 1, 16, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_equals_plain(exact_f32, B, Sk, Hq, Hkv, D,
                                            kv_len, dtype):
    from repro_torch.kernels.decode_attention import decode_attention
    dev = exact_f32
    q = _randn(dev, (B, 1, Hq, D), dtype, 3)
    # the model's cache layout: [B, max_len, Hkv*D] viewed as heads
    k = _randn(dev, (B, Sk, Hkv * D), dtype, 4).view(B, Sk, Hkv, D)
    v = _randn(dev, (B, Sk, Hkv * D), dtype, 5).view(B, Sk, Hkv, D)
    k[:, kv_len:] = float("nan")       # the masked tail is never read
    v[:, kv_len:] = float("nan")
    before = decode_attention.launches
    got = decode_attention(q, k, v, kv_len)
    want = ref.attention_ref(q, torch.nan_to_num(k), torch.nan_to_num(v),
                             causal=False, kv_len=kv_len)
    _close(got, want)
    assert decode_attention.launches == before + 1


@pytest.mark.cuda
def test_cuda_float_wrappers_check_their_inputs(cuda_device):
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    dev = cuda_device
    x = torch.ones(4, 32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(x.t(), torch.zeros(4, device=dev))
    with pytest.raises(TypeError, match="float32"):
        rmsnorm(x, torch.zeros(32, device=dev, dtype=torch.bfloat16))
    q = torch.ones(1, 4, 4, 80, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.ones(1, 1, 4, 64, device=dev)
    k = torch.ones(1, 8, 2, 64, device=dev)
    with pytest.raises(ValueError, match="kv_len"):
        decode_attention(q, k, k, 9)
    with pytest.raises(TypeError, match="host int"):
        decode_attention(q, k, k, torch.tensor(3, device=dev))
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q, k.bfloat16(), k)


@pytest.mark.cuda
def test_cuda_model_and_server_equal_cpu(exact_f32):
    """The smoke model under the f32 policy on the card and on the CPU:
    hidden states within rtol = atol = 1e-4 (f32 in another summation
    order), equal greedy tokens, equal lease-cache and fabric counters;
    the three float kernels launch."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.models import forward, init_model
    from repro_torch.models.config import Policy
    from repro_torch.models.model import tree_map
    from repro_torch.runtime.server import Request, Server

    cfg = dataclasses.replace(configs.SMOKE["smollm-360m"], policy=Policy(
        compute_dtype=torch.float32, cache_dtype=torch.float32))
    params = init_model(cfg, torch.Generator(exact_f32).manual_seed(0))
    cpu = tree_map(lambda t: t.cpu(), params)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab, (2, 40)).astype(np.int32))
    h_card, _ = forward(cfg, params, tok.to(exact_f32))
    h_cpu, _ = forward(cfg, cpu, tok)
    torch.testing.assert_close(h_card.cpu(), h_cpu, rtol=1e-4, atol=1e-4)

    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, cfg.vocab, 16).astype(np.int32)
               for _ in range(3)]
    waves = [[Request(rid=w * 3 + i, prompt=prompts[i], max_new=4)
              for i in range(3)] for w in range(3)]
    counters = (rmsnorm, flash_attention, decode_attention)
    before = [fn.launches for fn in counters]
    outs, srvs = [], []
    for dev in (exact_f32, "cpu"):
        srv = Server(cfg, params, batch_size=2, max_len=32, device=dev)
        outs.append({k: v for w in waves for k, v in srv.serve(w).items()})
        srvs.append(srv)
    assert all(fn.launches > b for fn, b in zip(counters, before))
    assert outs[0].keys() == outs[1].keys()
    for rid in outs[0]:
        np.testing.assert_array_equal(outs[0][rid], outs[1][rid])
    assert srvs[0].cache_stats == srvs[1].cache_stats
    assert srvs[0].fabric_stats == srvs[1].fabric_stats
    assert list(srvs[0].fabric.grant_log) == list(srvs[1].fabric.grant_log)
    assert srvs[0].cache_stats["hits"] >= 1


@pytest.mark.cuda
def test_cuda_server_bf16_equals_cpu_counters(cuda_device):
    """The default bf16 policy on the card (bf16 matrices, f32 norm
    weights into the rmsnorm kernel): the fabric sees only keys, so the
    counters and grant log equal the CPU's; the final hidden states agree
    within a relative L2 of 2e-2."""
    from repro_torch import configs
    from repro_torch.models import cast_params, forward, init_model
    from repro_torch.models.model import tree_map
    from repro_torch.runtime.server import Request, Server

    cfg = configs.SMOKE["smollm-360m"]
    params = init_model(cfg, torch.Generator(cuda_device).manual_seed(2))
    cast = cast_params(cfg, params)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        2, cfg.vocab, (2, 48)).astype(np.int32))
    h_card, _ = forward(cfg, cast, tok.to(cuda_device))
    h_cpu, _ = forward(cfg, tree_map(lambda t: t.cpu(), cast), tok)
    err = (h_card.float().cpu() - h_cpu.float()).norm() / h_cpu.float().norm()
    assert float(err) <= 2e-2
    prompt = tok[0].numpy()
    waves = [[Request(rid=w * 2 + i, prompt=prompt, max_new=3)
              for i in range(2)] for w in range(2)]
    srvs = [Server(cfg, params, batch_size=2, max_len=64, device=d)
            for d in (cuda_device, "cpu")]
    for srv in srvs:
        for w in waves:
            out = srv.serve(w)
            assert all(v.shape == (3,) for v in out.values())
    assert srvs[0].cache_stats == srvs[1].cache_stats
    assert srvs[0].fabric_stats == srvs[1].fabric_stats
    assert list(srvs[0].fabric.grant_log) == list(srvs[1].fabric.grant_log)
