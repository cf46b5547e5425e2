"""The CUDA kernels and the fabric on the card, against their plain
versions and the CPU.

Every case needs an NVIDIA card: it carries the ``cuda`` marker and skips
without one.  The file imports neither jax nor ``repro``, so it runs on a
machine that has the card and no JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Inputs come from numpy with a seed and hold what the fabric feeds the
kernels: gathered set rows with the trash way sliced off (strided views),
duplicate tags, empty ways and rows, full and partly-full TSU rows, and
clocks within a lease of ``TS_MAX``.  Every comparison is exact.
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
