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
from tier_inputs import gathered, miss_tables, probe_tables


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
@pytest.mark.parametrize("N", [1, 64, 4096])
@pytest.mark.parametrize("W", [2, 4, 8, 16])
def test_cuda_lease_probe_indexed_equals_plain(cuda_device, N, W):
    """The indexed form at the fast read's shape: a replica tier's 1024
    sets read in place at ``row``, one clock, no grant (read as 0), and
    with a clock and a grant per lane; exact, one launch each.  W = 4 and
    16 are the figure engine's L1 and L2 ways."""
    for one_clock, grant in ((True, False), (False, True)):
        (tag, rts), row, cts, addr, mwts, mrts = probe_tables(
            1024, N, W, N + W, one_clock)
        args = (_vec(cuda_device, tag)[:, :-1], _vec(cuda_device, rts)[:, :-1],
                _vec(cuda_device, cts), _vec(cuda_device, addr))
        more = (_vec(cuda_device, mwts), _vec(cuda_device, mrts)) if grant \
            else ()
        rowt = _vec(cuda_device, row)
        before = lease_probe.launches
        got = lease_probe(*args, *more, row=rowt)
        assert lease_probe.launches == before + 1
        _assert_equal(got, ref.lease_probe_ref(*args, *more, row=rowt))
        assert got[0][0] and got[2][0] == 0     # lane 0: the first duplicate


def _miss_args(dev, tables, rows, vecs):
    views = [_vec(dev, t)[:, :-1] for t in tables[:5]] + \
        [_vec(dev, t)[:, 0, :-1] for t in tables[5:]]
    return views + [_vec(dev, v) for v in vecs], \
        tuple(_vec(dev, r) for r in rows)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [32, 64, 256])
def test_cuda_miss_round_indexed_equals_plain(cuda_device, M):
    """The indexed form at the miss pass's shape: 8 TSU rows of 1024 ways,
    a replica's 1024 and a node's 2048 sets of 8 ways read in place, M
    lanes naming them (padded lanes on shard 0), one clock a tier, act
    bool, rd an int; exact in one launch, and equal to the gathered
    form."""
    tables, rows, vecs, rd = miss_tables(1024, 2048, 8, M, 8, 8, 1024, M)
    args, rowt = _miss_args(cuda_device, tables, rows, vecs)
    before = miss_round.launches
    got = miss_round(*args, rd, rows=rowt)
    assert miss_round.launches == before + 1
    _assert_equal(got, ref.miss_round_ref(*args, rd, rows=rowt))
    _assert_equal(got, miss_round(*(_vec(cuda_device, a) for a in gathered(
        tables, rows, vecs, rd))))
    assert got[6].any() and got[11].any()           # grants, and a reinit


@pytest.mark.cuda
def test_cuda_miss_round_indexed_past_one_tile(cuda_device):
    """TSU rows of 20000 ways, walked in tiles: every hit lies in the last
    tile."""
    C = 20000
    tables, rows, vecs, rd = miss_tables(1024, 2048, 8, 64, 8, 8, C, 7,
                                         match_at=C - 3)
    args, rowt = _miss_args(cuda_device, tables, rows, vecs)
    got = miss_round(*args, rd, rows=rowt)
    _assert_equal(got, ref.miss_round_ref(*args, rd, rows=rowt))
    tway = got[7].cpu().numpy()
    assert (tway[got[6].cpu().numpy()] == C - 3).all() and got[6].any()


@pytest.mark.cuda
def test_cuda_indexed_wrappers_check_their_inputs(cuda_device):
    """The indexed wrappers refuse ways that are not contiguous, a CPU
    tensor and a wrong clock shape."""
    (tag, rts), row, cts, addr, _, _ = probe_tables(16, 8, 4, 0, True)
    t, r = _vec(cuda_device, tag), _vec(cuda_device, rts)
    a, c, rowt = (_vec(cuda_device, v) for v in (addr, cts, row))
    with pytest.raises(ValueError, match="contiguous"):
        lease_probe(t[:, ::2], r[:, ::2], c, a, row=rowt)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lease_probe(t[:, :-1], r[:, :-1], c, a, row=rowt.cpu())
    with pytest.raises(ValueError, match="shape"):
        lease_probe(t[:, :-1], r[:, :-1], c.expand(2).contiguous(), a,
                    row=rowt)
    tables, rows, vecs, rd = miss_tables(16, 16, 4, 8, 2, 2, 64, 0)
    args, rowm = _miss_args(cuda_device, tables, rows, vecs)
    with pytest.raises(ValueError, match="contiguous"):
        miss_round(*args[:5], args[5][:, ::2], args[6][:, ::2], *args[7:],
                   rd, rows=rowm)
    with pytest.raises(ValueError, match="CUDA tensor"):
        miss_round(*args[:5], args[5].cpu(), *args[6:], rd, rows=rowm)
    with pytest.raises(ValueError, match="lane i reads row i"):
        miss_round(*args, rd)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["lease_probe", "miss_round"])
def test_cuda_indexed_kernels_trap_on_a_row_out_of_range(cuda_device,
                                                         kernel):
    """A lane naming a row outside its table stops the kernel with a
    device error: never a silent wrong answer."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    call = {"lease_probe": "lease_probe(t, t, v[:1], v, row=row)",
            "miss_round": "miss_round(t, t, t, t, t, t[:2], t[:2], v[:1], "
                          "v[:1], v, v, 8, rows=(v, v, row))"}[kernel]
    code = (
        "import torch\n"
        "from repro_torch.kernels.lease_probe import lease_probe\n"
        "from repro_torch.kernels.tier_pass import miss_round\n"
        "d = torch.device('cuda')\n"
        "t = torch.zeros((8, 64), dtype=torch.int32, device=d)\n"
        "v = torch.zeros(4, dtype=torch.int32, device=d)\n"
        "row = torch.tensor([0, 1, 8, 1], dtype=torch.int32, device=d)\n"
        f"{call}\n"
        "torch.cuda.synchronize()\n"
        "print('no error')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode != 0 and "no error" not in out.stdout
    assert "CUDA" in out.stderr or "cuda" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("N,C,seed", [(256, 1024, 0), (40, 8, 2),
                                      (16, 3000, 3), (16, 5000, 4)])
def test_cuda_write_grant_equals_plain(cuda_device, N, C, seed):
    rows, vecs = _grant_inputs(N, C, seed)
    args = [_rows(cuda_device, a) for a in rows] + \
        [_vec(cuda_device, v) for v in vecs]
    got = write_grant(*args)
    _assert_equal(got, ref.write_grant_ref(*args))
    assert got[2].any() and not got[2].all()           # full and not full


def _wide_grant_inputs(N, C, seed):
    """Rows past 16384 ways, which the kernel walks in tiles of 16384, with
    every lane's answer in the last tile.  A row's tags are distinct.
    Lanes 0::4 hit a tag at ways C - 3 and C - 1 (the first wins); lanes
    1::4 miss a full row whose least memts is at way C - 2; lanes 2::4
    miss a row whose one empty way is C - 5; lanes 3::4 miss a full row
    whose least memts ties on ways 7 and C - 4, with seq 9 and 3."""
    rng = np.random.default_rng(seed)
    tag = np.stack([rng.permutation(4 * C)[:C] for _ in range(N)]).astype(
        np.int32)
    mem = rng.integers(TS_MAX - 20, TS_MAX, (N, C)).astype(np.int32)
    seq = rng.integers(0, 64, (N, C)).astype(np.int32)
    addr = np.full(N, 4 * C + 1, np.int32)
    tag[0::4, C - 1] = addr[0::4] = tag[0::4, C - 3]
    mem[1::4, C - 2] = TS_MAX - 100
    tag[2::4, C - 5] = -1
    mem[3::4, 7] = mem[3::4, C - 4] = TS_MAX - 100
    seq[3::4, 7], seq[3::4, C - 4] = 9, 3
    return [tag, mem, seq], [addr, rng.integers(1, 9, N).astype(np.int32)]


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16385, 20000, 65536])
def test_cuda_write_grant_past_16384_ways_equals_plain(cuda_device, C):
    """A row of more ways than the kernel holds in registers is walked in
    tiles, each reduction carried over: the first matching way, `full`
    and the victim (empty first, then least memts, least seq, first
    index) all lie in the last tile here."""
    rows, vecs = _wide_grant_inputs(16, C, seed=C)
    args = [_vec(cuda_device, a) for a in rows] + \
        [_vec(cuda_device, v) for v in vecs]
    got = write_grant(*args)
    _assert_equal(got, ref.write_grant_ref(*args))
    th, way, full = (g.cpu().numpy() for g in got[:3])
    assert th[0::4].all() and not th[1::4].any()
    assert (way[0::4] == C - 3).all() and (way[1::4] == C - 2).all()
    assert (way[2::4] == C - 5).all() and (way[3::4] == C - 4).all()
    assert full[1::4].all() and not full[2::4].any()


def _indexed_grant_inputs(K, N, C, seed):
    """A write round's TSU side: ``[K, 1, C+1]`` tag, memts and seq tables
    (set 0 with the trash way, as the fabric holds them) and the ``[N]``
    shard of each lane.  Inactive lanes (a third) name shard 0; shard 1 is
    all empty, shard 2 holds duplicate tags, shard 3 is full with its
    minimum memts tied on a third of the ways, whose seq is 2^30 and
    above; clocks sit within a lease of TS_MAX; half the lanes hit."""
    rng = np.random.default_rng(seed)
    tag = rng.integers(0, 4 * C, (K, 1, C + 1)).astype(np.int32)
    tag[:, 0, 1::5] = -1
    tag[1] = -1
    tag[2, 0, 1:C:2] = tag[2, 0, 0:C - 1:2]
    tag[3, 0] = np.arange(C + 1) + 8 * C
    mem = rng.integers(TS_MAX - 7, TS_MAX + 1, (K, 1, C + 1)).astype(np.int32)
    seq = rng.integers(0, 64, (K, 1, C + 1)).astype(np.int32)
    mem[3, 0] = 100
    mem[3, 0, 2::3] = 50
    seq[3, 0, 2::3] = 2 ** 30 + rng.integers(0, 3, len(seq[3, 0, 2::3]))
    row = rng.integers(0, K, N).astype(np.int32)
    row[::3] = 0
    row[1:5] = [3, 1, 0, 2][:max(0, min(N, 5) - 1)]
    addr = rng.integers(0, 4 * C, N).astype(np.int32)
    hit = rng.random(N) < 0.5
    addr[hit] = tag[row[hit], 0, rng.integers(0, C, N)[hit]]
    addr[addr == -1] = 4 * C
    wl = rng.integers(1, 9, N).astype(np.int32)
    return (tag, mem, seq), row, addr, wl


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 16, 64, 256])
def test_cuda_write_grant_indexed_equals_plain(cuda_device, N):
    """The indexed form at the write pass's shape (K = 8 shard rows of
    C = 1024 ways read in place, lanes naming them) equals its plain
    version exactly, in one launch."""
    tables, row, addr, wl = _indexed_grant_inputs(8, N, 1024, N)
    full = [_vec(cuda_device, a) for a in tables]
    args = [t[:, 0, :-1] for t in full] + \
        [_vec(cuda_device, v) for v in (addr, wl)]
    rowt = _vec(cuda_device, row)
    before = write_grant.launches
    got = write_grant(*args, rowt)
    assert write_grant.launches == before + 1
    _assert_equal(got, ref.write_grant_ref(*args, rowt))
    _assert_equal(got, ref.write_grant_ref(*(t[rowt] for t in args[:3]),
                                           *args[3:]))


@pytest.mark.cuda
def test_cuda_write_grant_checks_its_inputs(cuda_device):
    tables, row, addr, wl = _indexed_grant_inputs(8, 16, 64, 0)
    t = [_vec(cuda_device, a)[:, 0, :-1] for a in tables]
    a, w, r = (_vec(cuda_device, v) for v in (addr, wl, row))
    with pytest.raises(TypeError, match="int32"):
        write_grant(*t, a, w, r.long())
    with pytest.raises(ValueError, match="shape"):
        write_grant(*t, a, w, r[:8])
    with pytest.raises(ValueError, match="lane i reads row i"):
        write_grant(*t, a, w)
    with pytest.raises(ValueError, match="ways"):
        write_grant(t[0], t[1][:, :32], t[2], a, w, r)
    with pytest.raises(ValueError, match="contiguous"):
        write_grant(t[0][:, ::2], *t[1:], a, w, r)


@pytest.mark.cuda
def test_cuda_write_grant_traps_on_a_row_out_of_range(cuda_device):
    """A lane naming a row outside [0, K) stops the kernel with a device
    error, as torch's gather does: never a silent wrong answer."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    code = (
        "import torch\n"
        "from repro_torch.kernels.tier_pass import write_grant\n"
        "d = torch.device('cuda')\n"
        "t = torch.zeros((8, 64), dtype=torch.int32, device=d)\n"
        "v = torch.zeros(4, dtype=torch.int32, device=d)\n"
        "row = torch.tensor([0, 1, 8, 2], dtype=torch.int32, device=d)\n"
        "write_grant(t, t, t, v, v, row)\n"
        "torch.cuda.synchronize()\n"
        "print('no error')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode != 0 and "no error" not in out.stdout
    assert "CUDA" in out.stderr or "cuda" in out.stderr


@pytest.mark.cuda
def test_cuda_tsu_commit_write_batch_equals_cpu(cuda_device):
    """A write storm through ``tsu_commit_write_batch`` (the write grant
    over the TSU tables in place, allocation, eviction, commit) on the
    card and on the CPU: equal outputs and state after every round."""
    from repro_torch.core import state as S
    rng = np.random.default_rng(9)
    KS, C, M = 8, 1024, 64
    tables, _, _, _ = _indexed_grant_inputs(KS, 1, C, 9)
    side = [rng.integers(0, 9, (KS, 1, C + 1)).astype(np.int32)
            for _ in range(2)]
    nseq = rng.integers(2 ** 30 - 2, 2 ** 30 + 2, KS).astype(np.int32)
    host = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (*tables, *side, nseq)]
    dev = [h.to(cuda_device, copy=True) for h in host]
    gseq = [torch.tensor(5, dtype=torch.int32, device=d)
            for d in ("cpu", cuda_device)]
    for rnd in range(12):
        shard = rng.integers(0, KS, M).astype(np.int32)
        active = np.zeros(M, bool)
        _, first = np.unique(shard, return_index=True)
        active[first[rng.random(len(first)) < 0.8]] = True
        shard[~active] = 0                       # as the write pass pads
        keys = rng.integers(0, 4 * C, M).astype(np.int32)
        hit = rng.random(M) < 0.4
        keys[hit] = host[0].numpy()[shard[hit], 0,
                                    rng.integers(0, C, M)[hit]]
        keys[keys == -1] = 4 * C
        wl = rng.integers(1, 9, M).astype(np.int32)
        outs = []
        for arrs, g, d in ((host, gseq[0], "cpu"), (dev, gseq[1],
                                                    cuda_device)):
            T = lambda a: torch.from_numpy(a).to(d)
            out = S.tsu_commit_write_batch(
                S.TSUState(arrs[0], arrs[1]), arrs[3], arrs[4], arrs[2],
                arrs[5], g, T(shard), T(keys), T(wl), 8, T(active))
            g.copy_(out[-1])
            outs.append([o.cpu() for i, o in enumerate(out)
                         if i not in (6, 7, 8, 9, 10)])
        for a, b in zip(*outs):
            assert torch.equal(a, b), f"round {rnd}"
        for a, b in zip(host, dev):
            assert torch.equal(a, b.cpu()), f"state after round {rnd}"
    assert host[0][1].ne(-1).any()               # the empty shard filled


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


def _sharded_script(seed=9, n_keys=24, steps=12):
    """A mixed stream as ``tests/torch_sharded_worker.py`` script steps:
    write storms, read batches (sync and all-hit), op-scan batches with
    every op kind, fences, and the views."""
    rng = np.random.default_rng(seed)
    keys = [f"k{i}" for i in range(n_keys)]
    script = []
    for step in range(steps):
        batch = [keys[int(i)] for i in rng.integers(0, n_keys, 24)]
        rep = int(rng.integers(4))
        script.append(("write_batch", [(k, f"{k}@{step}")
                                       for k in batch[:6]], rep))
        script.append(("read_batch", batch, (rep + 1) % 4))
        script.append(("apply", [("read", batch[0], None, rep, 0, None),
                                 ("mm_write", batch[1], f"m{step}", 0, 0,
                                  None),
                                 ("publish", batch[2], f"p{step}", 0,
                                  step % 2, None),
                                 ("mm_read", batch[3], None, 0, 0, None)]))
        if step % 4 == 3:
            script += [("fence",), ("read_batch", batch[:4], 0),
                       ("read_batch", batch[:4], 0)]
    return script + [("memts", keys), ("stats",)]


@pytest.mark.cuda
@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_cuda_sharded_fabric_equals_cpu_fabric(cuda_device, tmp_path, world,
                                               backend):
    """The sharded fabric on the card — a world of one over NCCL, and two
    ranks sharing the one card over gloo with CUDA tensors — equals the
    single-device fabric on the CPU: results, grant log, counters, state;
    one collective per TSU-touching pass, each rank's own TSU rows."""
    import os
    import pathlib
    import pickle
    import subprocess
    import sys
    if world > torch.cuda.device_count() and backend == "nccl":
        pytest.skip("NCCL needs a card per rank")
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from torch_sharded_worker import run_script
    cfg_kw = dict(n_shards=8, rd_lease=8, wr_lease=4, tsu_capacity=8,
                  shared_sets=8, shared_ways=2, replica_sets=4,
                  replica_ways=2, max_in_flight=2)
    sc = {"name": "card", "cfg": cfg_kw, "n_nodes": 2, "rpn": 2,
          "script": _sharded_script()}
    (tmp_path / "job.pkl").write_bytes(pickle.dumps(
        {"scenarios": [sc], "backend": backend, "device": None}))
    root = pathlib.Path(__file__).resolve().parent.parent
    worker = root / "tests" / "torch_sharded_worker.py"
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(world),
         str(tmp_path / "rdzv"), str(tmp_path / "job.pkl"),
         str(tmp_path / f"out{r}.pkl")], env=env, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    errs = []
    for p in procs:
        try:
            errs.append(p.communicate(timeout=600)[1])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a rank did not finish in 600 s")
    assert all(p.returncode == 0 for p in procs), "\n".join(
        e[-3000:] for e in errs)
    arr = ArrayFabric(FabricConfig(**cfg_kw), 2, 2, device="cpu")
    want = run_script(arr, sc["script"], Op)
    xw, hw = arr.export_state()
    for r in range(world):
        res = pickle.loads((tmp_path / f"out{r}.pkl").read_bytes())
        for pipe in ("batched", "scan"):
            got = res["scenarios"]["card"][pipe]
            assert got["device"] == "cuda:0"
            assert got["outs"] == want, (r, pipe)
            assert got["grant_log"] == list(arr.grant_log), (r, pipe)
            xg, hg = got["export"]
            assert all(np.array_equal(xg[k], xw[k]) for k in xw), (r, pipe)
            assert all(s["tsu.tag"] == (8 // world, 1, 9)
                       for s in got["shapes"])
        counts = res["scenarios"]["card"]["batched"]["counts"]
        for step, c in zip(sc["script"], counts):
            if step[0] in ("write_batch", "apply", "fence"):
                assert c["total"] == 1, (step[0], c)
            elif step[0] in ("memts", "stats"):
                assert c["total"] == 0, (step[0], c)


@pytest.mark.cuda
def test_cuda_engine_equals_cpu_engine(cuda_device):
    """The figure engine on the card (``device=None``) against the port on
    the CPU: all five systems at 2 GPUs x 4 CUs over two benchmarks of 96
    rounds (one cut to 79, so NOP padding shows) with equal counters and
    cycles within rtol 1e-6 (a per-GPU mean summed in another order);
    ``lease_probe`` launched twice a round per static group, three times
    under HMG; the litmus trace's whole state, read log and result log
    bit-equal."""
    from repro_torch.core import engine, sysconfig, traces

    kw = dict(n_gpus=2, cus_per_gpu=4)
    base = sysconfig.sm_wt_halcone(**kw)
    tl = [traces.standard_trace(base, traces.STANDARD[b], 96)
          for b in ("aes", "bs")]
    tl[0] = (tl[0][0][:, :79], tl[0][1][:, :79])
    ops, addrs = traces.pack_batch(tl)
    cfgs = [make(**kw) for make in sysconfig.ALL_CONFIGS]
    for cfg in cfgs:
        before = lease_probe.launches
        engine.sweep([cfg], ops, addrs, device=cuda_device)
        assert lease_probe.launches - before == \
            (3 if cfg.protocol == "hmg" else 2) * 96, cfg.name
    got = engine.sweep(cfgs, ops, addrs)
    want = engine.sweep(cfgs, ops, addrs, device="cpu")
    np.testing.assert_allclose(got["cycles"], want["cycles"], rtol=1e-6)
    for k in engine.COUNTERS:
        np.testing.assert_array_equal(got["counters"][k], want["counters"][k],
                                      err_msg=k)
    lit = traces.litmus_intra(base)
    a, b = engine.simulate(base, *lit), engine.simulate(base, *lit,
                                                        device="cpu")
    assert a["state"].l1.tag.device.type == "cuda"
    np.testing.assert_array_equal(a["read_log"], b["read_log"])
    for k in a["res_log"]:
        np.testing.assert_array_equal(a["res_log"][k], b["res_log"][k])
    for name in ("l1", "l2", "tsu"):
        for x, y in zip(getattr(a["state"], name), getattr(b["state"], name)):
            assert torch.equal(x.cpu(), y), name
    for name in ("l2_dirty", "mm_ver", "dir_sharers", "time"):
        assert torch.equal(getattr(a["state"], name).cpu(),
                           getattr(b["state"], name)), name


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
@pytest.mark.parametrize("R,D", [(4096, 960), (7, 80), (5, 100), (3, 8)] + [
    (R, D) for R in (8, 4096) for D in (768, 960, 1536, 2048, 4096)
    if (R, D) != (4096, 960)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rmsnorm_equals_plain(exact_f32, R, D, dtype):
    """The serving path's rows (decode R = 8, prefill R = 4096, at every
    width of smollm, mamba2 and zamba2 and their d_inner) and odd ones
    (element path, masked vector slots)."""
    from repro_torch.kernels.rmsnorm import rmsnorm
    x = _randn(exact_f32, (R, D), dtype, R + D)
    w = _randn(exact_f32, (D,), torch.float32, D) * 0.1
    before = rmsnorm.launches
    _close(rmsnorm(x, w), ref.rmsnorm_ref(x, w))
    assert rmsnorm.launches == before + 1
    x3 = x.reshape(1, R, D)
    _close(rmsnorm(x3, w), ref.rmsnorm_ref(x3, w))


@pytest.mark.cuda
@pytest.mark.parametrize("grad", [False, True])
def test_cuda_kernels_launch_under_the_analyser(exact_f32, grad):
    """Under ``launch.opanalysis`` a real CUDA tensor still launches each
    float kernel (its count moves, its output equals the plain version's
    within ``FLOAT_TOL``); the analyser charges each call its rule, and
    under grad the backward kernels launch and are charged too."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.launch import opanalysis
    dev, bf = exact_f32, torch.bfloat16
    x = _randn(dev, (64, 960), bf, 1).requires_grad_(grad)
    w = (_randn(dev, (960,), torch.float32, 2) * 0.1).requires_grad_(grad)
    q, k, v = (_randn(dev, (2, 128, 4, 64), bf, 3 + i).requires_grad_(grad)
               for i in range(3))
    kq = _randn(dev, (2, 1, 4, 64), bf, 6)
    kc = _randn(dev, (2, 100, 2, 64), bf, 7)
    wrappers = (rmsnorm, flash_attention, decode_attention, rmsnorm_bwd,
                flash_attention_bwd)
    before = [f.launches for f in wrappers]

    def step():
        y = ops.rmsnorm(x, w)
        o = ops.flash_attention(q, k, v, causal=True)
        d = ops.decode_attention(kq, kc, kc, 77)
        if grad:
            torch.autograd.grad((y.float().sum() + o.float().sum()),
                                (x, w, q, k, v))
        return y.detach(), o.detach(), d

    cost = opanalysis.analyze(step)
    launched = [f.launches - b for f, b in zip(wrappers, before)]
    assert launched == [1, 1, 1, int(grad), int(grad)]
    want = {"rmsnorm": 1, "flash_attention": 1, "decode_attention": 1}
    if grad:
        want.update(rmsnorm_bwd=1, flash_attention_bwd=1)
    assert {n: c["calls"] for n, c in cost.kernels.items()} == want
    y, o, d = cost.result
    _close(y, ref.rmsnorm_ref(x.detach(), w.detach()))
    _close(o, ref.attention_ref(q.detach(), k.detach(), v.detach(),
                                causal=True))
    _close(d, ref.attention_ref(kq, kc, kc, causal=False, kv_len=77))


@pytest.mark.cuda
@pytest.mark.parametrize("R,D", [(8, 960), (4096, 960), (8, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rmsnorm_weight_off_16_bytes(exact_f32, R, D, dtype):
    """A weight that does not start on a 16-byte boundary (a row of a
    stacked [L, D] table whose 4 D is not a multiple of 16, here a slice
    one element in) takes the element path and gives the same answer."""
    from repro_torch.kernels.rmsnorm import rmsnorm
    x = _randn(exact_f32, (R, D), dtype, R + D)
    buf = _randn(exact_f32, (D + 1,), torch.float32, D) * 0.1
    w = buf[1:]
    assert w.data_ptr() % 16
    _close(rmsnorm(x, w), ref.rmsnorm_ref(x, w))
    _close(rmsnorm(x, w), rmsnorm(x, w.clone()))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", [
    (2, 512, 512, 15, 5, 64, True, 0),        # the serving path's prefill
    (8, 512, 512, 15, 5, 64, True, 0),        # smollm-360m prefill, B=8
    (8, 512, 512, 32, 32, 64, True, 0),       # zamba2-1.2b prefill, qpk=1
    (1, 100, 100, 15, 5, 64, True, 0),        # ragged tail
    (2, 77, 77, 4, 2, 16, False, 0),
    (1, 130, 130, 4, 1, 128, True, 32),       # MQA, windowed
    (1, 50, 130, 4, 2, 32, False, 0),         # rectangular
    # windowed at D = 64: rows whose first key tile lies wholly outside
    # the window see a tile of equal masked scores
    (1, 200, 200, 4, 2, 64, True, 32),
    (1, 200, 200, 4, 2, 64, False, 32),
    (1, 50, 130, 4, 2, 64, False, 0),         # rectangular, tensor cores
    (1, 130, 50, 4, 2, 64, True, 0),          # more queries than keys
    # D = 256 (gemma3-4b; bf16 on the tensor cores with 32-key tiles, f32
    # split over four threads a row): its prefill, windowed and global,
    # then windows that skip whole key tiles, odd and rectangular shapes
    (4, 1536, 1536, 8, 4, 256, True, 1024),
    (4, 1536, 1536, 8, 4, 256, True, 0),
    (1, 333, 333, 8, 4, 256, True, 128),
    (1, 200, 200, 4, 2, 256, False, 32),
    (1, 77, 130, 4, 2, 256, False, 0),
    (1, 130, 50, 4, 2, 256, True, 0),
    # D = 80 (hubert-xlarge, non-causal; bf16 on the tensor cores over
    # zero-filled 64-column boxes, f32 split over four threads a row): its
    # encoder shape, then windowed, odd and rectangular ones
    (8, 512, 512, 16, 16, 80, False, 0),
    (1, 130, 130, 4, 2, 80, True, 32),
    (1, 50, 77, 4, 1, 80, False, 16),
    (1, 333, 333, 4, 4, 80, False, 0),
    (1, 130, 50, 4, 2, 80, True, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_equals_plain(exact_f32, B, Sq, Sk, Hq, Hkv, D,
                                           causal, window, dtype):
    from repro_torch.kernels.flash_attention import flash_attention, route
    dev = exact_f32
    q = _randn(dev, (B, Sq, Hq, D), dtype, 1)
    # k and v as strided views of one [B, S, 2, Hkv, D] block, as a fused
    # projection would give them
    kv = _randn(dev, (B, Sk, 2, Hkv, D), dtype, 2)
    k, v = kv[:, :, 0], kv[:, :, 1]
    before = flash_attention.launches
    path = route(dtype, D)
    before_route = flash_attention.route_launches[path]
    got = flash_attention(q, k, v, causal=causal, window=window)
    _close(got, ref.attention_ref(q, k, v, causal=causal, window=window))
    assert flash_attention.launches == before + 1
    assert flash_attention.route_launches[path] == before_route + 1
    assert path == ("wgmma" if dtype == torch.bfloat16
                    and D in (64, 80, 128, 256) else "simt")


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,Dv,causal,window", [
    (2, 256, 256, 4, 2, 64, 64, True, 0),
    (1, 200, 200, 4, 2, 64, 64, False, 32),
    (1, 50, 130, 4, 2, 64, 64, False, 0),
    (1, 128, 128, 2, 1, 128, 128, True, 0),
    (1, 256, 256, 4, 2, 256, 256, True, 64),  # D = 256: 32-key tiles
    (1, 100, 150, 2, 1, 256, 256, False, 0),
    # MLA's (192, 128): 12 k-steps of S, O at D = 128's width
    (1, 256, 256, 4, 4, 192, 128, True, 0),
    (1, 200, 200, 4, 2, 192, 128, True, 64),
    (1, 100, 150, 2, 1, 192, 128, False, 0),
    # D = 80: two 64-column boxes, columns 80-127 TMA's zeros
    (2, 256, 256, 4, 4, 80, 80, False, 0),
    (1, 200, 200, 4, 2, 80, 80, True, 64),
])
def test_cuda_flash_wgmma_keeps_split_p(cuda_device, B, Sq, Sk, Hq, Hkv, D,
                                        Dv, causal, window):
    """The tensor-core kernel against the CPU emulation of its arithmetic
    (``attention_emulation.py``) on the same bf16 inputs.  With P split
    into bf16 hi and lo halves the kernel's bf16 output is the split
    emulation's rounded output on nearly all elements (at most 1% differ:
    ex2's approximation and the tensor cores' order of summation may move
    a value across a rounding boundary); a single bf16 rounding of P
    changes about a third of them at these shapes (measured on the CPU:
    35-37%), so at least 20% must differ from that emulation.  Against an
    f64 softmax its mean error must also be at least 1.2x below the single
    rounding's (1.37-1.43x on the CPU), and within 2% of the split's."""
    from attention_emulation import emulate_kernel, exact_attention
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(Sq + Sk + D)
    q, k, v = (torch.from_numpy(
        rng.standard_normal(shp).astype(np.float32)).to(torch.bfloat16)
        for shp in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, Dv)))
    before = flash_attention.route_launches["wgmma"]
    got = flash_attention(*(t.to(cuda_device) for t in (q, k, v)),
                          causal=causal, window=window).cpu()
    assert flash_attention.route_launches["wgmma"] == before + 1
    kw = dict(causal=causal, window=window, zero_fill=D % 64 != 0)
    split = emulate_kernel(q, k, v, **kw)
    one = emulate_kernel(q, k, v, split=False, **kw)
    miss_split = float((got != split.to(torch.bfloat16)).float().mean())
    miss_one = float((got != one.to(torch.bfloat16)).float().mean())
    assert miss_split <= 0.01, (miss_split, miss_one)
    assert miss_one >= 0.2, (miss_split, miss_one)
    exact = exact_attention(q, k, v, causal=causal, window=window)

    def err(t):
        return float((t.to(torch.bfloat16).double() - exact).abs().mean())
    assert err(got) * 1.2 <= err(one), (err(got), err(split), err(one))
    assert err(got) <= err(split) * 1.02, (err(got), err(split))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", [
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 200, 200, 4, 2, 64, False, 32),
    (1, 50, 130, 4, 2, 64, False, 0),
    (1, 128, 128, 2, 1, 128, True, 0),
    (1, 130, 50, 4, 2, 64, True, 16),         # rows with no visible key
    # D = 80 over zero-filled boxes, D = 256 in two column halves
    (2, 128, 128, 4, 4, 80, False, 0),
    (1, 130, 130, 4, 2, 80, True, 32),
    (1, 160, 160, 4, 2, 256, True, 64),
    (1, 100, 70, 2, 1, 256, False, 0),
    # D = 192: MLA's (192, 128), v, o and dO 128 wide
    (1, 256, 256, 4, 4, 192, True, 0),
    (1, 130, 130, 4, 2, 192, True, 32),
    (1, 100, 150, 2, 1, 192, False, 0),
])
def test_cuda_flash_bwd_wgmma_keeps_split(cuda_device, B, Sq, Sk, Hq, Hkv,
                                          D, causal, window):
    """The tensor-core backward against the CPU emulation of its
    arithmetic (``attention_bwd_emulation.py``) on the same bf16 inputs,
    the card forward's output and row statistics.  With P and dS split
    into bf16 hi and lo halves the kernel's bf16 dq, dk, dv are the split
    emulation's rounded outputs on nearly all elements (at most 1% differ:
    ex2's approximation and the tensor cores' order of summation may move
    a value across a rounding boundary); a single bf16 rounding of P and
    dS changes about 40% of them at these shapes (measured on the CPU:
    40-43%), so at least 20% must differ from that emulation.  Against an
    f64 gradient each output's mean error must also be at least 1.2x
    below the single rounding's (1.36-1.62x on the CPU), and within 2% of
    the split's.  At D = 192 v is 128 wide (MLA's pair)."""
    from attention_bwd_emulation import emulate_bwd, exact_attention_bwd
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    Dv = 128 if D == 192 else D
    rng = np.random.default_rng(Sq + Sk + D)
    q, k, v, dout = (torch.from_numpy(
        rng.standard_normal(shp).astype(np.float32)).to(torch.bfloat16)
        for shp in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, Dv),
                    (B, Sq, Hq, Dv)))
    dev = [t.to(cuda_device) for t in (q, k, v, dout)]
    stats = torch.empty((2, B, Hq, Sq), dtype=torch.float32,
                        device=cuda_device)
    out = flash_attention(*dev[:3], causal=causal, window=window,
                          stats=stats)
    before = flash_attention_bwd.route_launches["wgmma"]
    got = [g.cpu() for g in flash_attention_bwd(
        *dev[:3], out, dev[3], causal=causal, window=window, stats=stats)]
    assert flash_attention_bwd.route_launches["wgmma"] == before + 1
    kw = dict(stats=stats.cpu(), causal=causal, window=window,
              layout=D in (80, 192, 256))
    split = emulate_bwd(q, k, v, out.cpu(), dout, **kw)
    one = emulate_bwd(q, k, v, out.cpu(), dout, split=False, **kw)
    exact = exact_attention_bwd(q, k, v, dout, causal=causal, window=window)

    def err(t, e):
        return float((t.to(torch.bfloat16).double() - e).abs().mean())
    for name, g, s, o, e in zip("qkv", got, split, one, exact):
        miss_split = float((g != s.to(torch.bfloat16)).float().mean())
        miss_one = float((g != o.to(torch.bfloat16)).float().mean())
        found = (name, miss_split, miss_one, err(g, e), err(s, e), err(o, e))
        assert miss_split <= 0.01 and miss_one >= 0.2, found
        assert err(g, e) * 1.2 <= err(o, e), found
        assert err(g, e) <= err(s, e) * 1.02, found


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sk,Hq,Hkv,D,kv_len", [
    (8, 584, 15, 5, 64, 1), (8, 584, 15, 5, 64, 513),
    (8, 584, 15, 5, 64, 584), (2, 300, 8, 2, 128, 257),
    (1, 64, 16, 1, 16, 40),
    # one tile short of, at, and one row past a 64-row tile
    (8, 584, 15, 5, 64, 63), (8, 584, 15, 5, 64, 64),
    (8, 584, 15, 5, 64, 65),
    (8, 536, 32, 32, 64, 513),                # zamba2-1.2b decode, qpk=1
    (2, 4096, 15, 5, 64, 4000),               # several tiles per block
    (2, 200, 4, 2, 32, 150), (1, 100, 8, 1, 64, 77),    # qpk 2 and 8
    # D = 256 (32-row tiles, block 0's slots in the stages' region):
    # gemma3-4b's decode past its window (G = 4), then G = 1 and 16
    (4, 1576, 8, 4, 256, 1568), (2, 300, 4, 4, 256, 33),
    (1, 100, 16, 1, 256, 77), (2, 200, 14, 2, 256, 150),
    (2, 64, 8, 4, 256, 31), (2, 64, 8, 4, 256, 64),
    (2, 700, 56, 8, 128, 641)])              # llava-next-34b, qpk 7
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
    q = torch.ones(1, 4, 4, 96, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.ones(1, 1, 4, 80, device=dev)
    with pytest.raises(ValueError, match="head dim 80 .* item 23"):
        decode_attention(q, q, q, 1)          # no decode kernel at D = 80
    q = torch.ones(1, 1, 4, 64, device=dev)
    k = torch.ones(1, 8, 2, 64, device=dev)
    with pytest.raises(ValueError, match="kv_len"):
        decode_attention(q, k, k, 9)
    with pytest.raises(TypeError, match="host int"):
        decode_attention(q, k, k, torch.tensor(3, device=dev))
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q, k.bfloat16(), k)
    # the tensor-core route loads through TMA: strides of whole 16 bytes
    wide = torch.ones(1, 4, 2, 68, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention(wide[..., :64], wide[..., :64], wide[..., :64])
    with pytest.raises(ValueError, match="16 bytes"):
        decode_attention(wide[:, :1, :, :64], wide[..., :64],
                         wide[..., :64], 2)


@pytest.mark.cuda
@pytest.mark.parametrize("D,causal,window", [(80, False, 0), (256, True, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_trains_at_head_dims_80_and_256(exact_f32, D, causal,
                                                   window, dtype):
    """hubert-xlarge's D = 80 and gemma3-4b's 256 under grad:
    ``ops.flash_attention`` takes ``FlashAttentionFn``, one forward (bf16:
    the tensor-core route, writing row statistics) and one backward on
    the same route, and the gradients agree with autograd of the plain
    version; without grad the forward launches alone."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd,
                                                     route)
    dev = exact_f32
    q, k, v = (_randn(dev, (2, 130, h, D), dtype, s).requires_grad_()
               for s, h in ((1, 4), (2, 2), (3, 2)))
    do = _randn(dev, (2, 130, 4, D), dtype, 4)
    path = route(dtype, D)
    assert path == ("wgmma" if dtype == torch.bfloat16 else "simt")
    before = (dict(flash_attention.route_launches),
              dict(flash_attention_bwd.route_launches),
              flash_attention.stats_writes)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(o, (q, k, v), do)
    assert flash_attention.route_launches[path] == before[0][path] + 1
    assert flash_attention_bwd.route_launches[path] == before[1][path] + 1
    assert flash_attention.stats_writes == before[2] + (path == "wgmma")
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(ref.attention_ref(
        qs, ks, vs, causal=causal, window=window), (qs, ks, vs), do)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _grad_close(g, w)
    fwd, writes = (flash_attention.route_launches[path],
                   flash_attention.stats_writes)
    with torch.no_grad():
        ops.flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.route_launches[path] == fwd + 1
    assert flash_attention.stats_writes == writes
    assert flash_attention_bwd.route_launches[path] == before[1][path] + 1


def _mla_kv(dev, dtype, B, Sk, Hkv, seed):
    """k and v as MLA builds them: k [B, Sk, H, 192] the 128 "nope"
    columns beside the 64 rope columns broadcast over the heads,
    concatenated; v [B, Sk, H, 128] a view of one product's rows."""
    k_nope = _randn(dev, (B, Sk, Hkv, 128), dtype, seed)
    kr = _randn(dev, (B, Sk, 64), dtype, seed + 1)
    k = torch.cat([k_nope, kr[..., None, :].expand(B, Sk, Hkv, 64)], -1)
    v = _randn(dev, (B, Sk, Hkv * 128), dtype, seed + 2).view(B, Sk, Hkv,
                                                              128)
    return k, v


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,causal,window", [
    (2, 512, 512, 128, 128, True, 0),         # deepseek-v2's prefill
    (1, 200, 200, 8, 8, False, 0),
    (1, 333, 333, 8, 2, True, 64),            # GQA, windowed
    (1, 77, 130, 4, 1, False, 0),             # rectangular
    (1, 130, 50, 4, 2, True, 0),              # more queries than keys
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_mla_pair_equals_plain(exact_f32, B, Sq, Sk, Hq, Hkv,
                                          causal, window, dtype):
    """flash at (D, Dv) = (192, 128), k and v as MLA builds them: bf16 on
    the tensor-core kernel, f32 on the CUDA-core one, each against the
    plain version within ``FLOAT_TOL``; the output is v's width."""
    from repro_torch.kernels.flash_attention import flash_attention, route
    dev = exact_f32
    q = _randn(dev, (B, Sq, Hq, 192), dtype, 1)
    k, v = _mla_kv(dev, dtype, B, Sk, Hkv, 2)
    path = route(dtype, 192, 128)
    assert path == ("wgmma" if dtype == torch.bfloat16 else "simt")
    before = flash_attention.launches, flash_attention.route_launches[path]
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert got.shape == (B, Sq, Hq, 128)
    _close(got, ref.attention_ref(q, k, v, causal=causal, window=window))
    assert (flash_attention.launches, flash_attention.route_launches[path]) \
        == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_cuda_flash_mla_pair_refusals(cuda_device):
    """Pairs not built raise; the (192, 128) pair writes row statistics
    on the tensor-core route, and ``ops.flash_attention`` under grad
    there runs ``FlashAttentionFn``: the forward with statistics, the
    backward on the tensor cores, gradients of q's, k's and v's shapes;
    without grad it launches the forward on the tensor-core route."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    dev = cuda_device
    q = _randn(dev, (1, 64, 2, 192), torch.bfloat16, 1)
    k, v = _mla_kv(dev, torch.bfloat16, 1, 64, 2, 2)
    with pytest.raises(ValueError, match="head dim 192 not in"):
        flash_attention(q, k, k)                 # (192, 192)
    with pytest.raises(ValueError, match="head dim 128 with v's 64"):
        flash_attention(v, v, v[..., :64])
    stats = torch.full((2, 1, 2, 64), float("nan"), device=dev)
    writes = flash_attention.stats_writes
    flash_attention(q, k, v, stats=stats)
    assert flash_attention.stats_writes == writes + 1
    assert torch.isfinite(stats).all() and (stats[1] > 0).all()
    before = (flash_attention.launches, flash_attention.stats_writes,
              flash_attention_bwd.route_launches["wgmma"])
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ops.flash_attention(qg, kg, vg).float().sum().backward()
    assert (flash_attention.launches, flash_attention.stats_writes,
            flash_attention_bwd.route_launches["wgmma"]) == \
        (before[0] + 1, before[1] + 1, before[2] + 1)
    assert [t.grad.shape for t in (qg, kg, vg)] == [q.shape, k.shape,
                                                     v.shape]
    assert all(torch.isfinite(t.grad).all() for t in (qg, kg, vg))
    before = flash_attention.launches
    wgmma = flash_attention.route_launches["wgmma"]
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)
    assert out.shape == (1, 64, 2, 128)
    assert flash_attention.launches == before + 1
    assert flash_attention.route_launches["wgmma"] == wgmma + 1


def _mla_cfg(dt, family="moe"):
    """The smoke deepseek-v2 with MLA's real head dims (nope 128, rope 64,
    v 128) over 2 heads: its prefill takes flash at (192, 128) (the smoke
    widths, 24 and 16, have no kernel).  ``family="dense"``: every layer
    a dense MLP, no MoE."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.config import Policy
    pol = Policy(compute_dtype=torch.float32, cache_dtype=torch.float32) \
        if dt == torch.float32 else Policy()
    return dataclasses.replace(
        configs.SMOKE["deepseek-v2-236b"], family=family, n_heads=2,
        n_kv_heads=2, nope_head_dim=128, rope_head_dim=64, v_head_dim=128,
        policy=pol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mla_model_equals_cpu(exact_f32, dtype):
    """A small MLA model at the real head dims (every layer dense, so no
    routing can split on a bf16 near-tie) on the card and the CPU: a
    prefill into a ``ckv`` cache and four absorbed decode steps, both
    sides decoding the card's tokens; hidden states within 1e-4 under the
    f32 policy (tokens equal), within a relative L2 of 2e-2 in bf16; the
    prefill's flash on the route of its dtype at (192, 128)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import forward, init_cache, init_model
    from repro_torch.models.model import tree_map
    cfg = _mla_cfg(dtype, family="dense")
    params = init_model(cfg, torch.Generator(exact_f32).manual_seed(0))
    cpu = tree_map(lambda t: t.cpu(), params)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab, (2, 40)).astype(np.int32))
    path = "wgmma" if dtype == torch.bfloat16 else "simt"
    before = flash_attention.route_launches[path]

    def close(a, b):
        if dtype == torch.float32:
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
        else:
            a = a.float().cpu()
            assert float((a - b.float()).norm() / b.float().norm()) <= 2e-2

    with torch.no_grad():
        h_c, c_c = forward(cfg, params, tok.to(exact_f32),
                           cache=init_cache(cfg, 2, 48, exact_f32))
        h_h, c_h = forward(cfg, cpu, tok, cache=init_cache(cfg, 2, 48,
                                                           "cpu"))
        assert flash_attention.route_launches[path] == \
            before + cfg.n_layers
        close(h_c, h_h)
        for (a, b) in zip(_tree_tensors(c_c), _tree_tensors(c_h)):
            close(a, b)
        for t in range(4):
            ids = torch.argmax((h_c[:, -1] @ params["unembed"].to(
                h_c.dtype)).float(), -1).to(torch.int32)[:, None]
            if dtype == torch.float32:
                assert torch.equal(ids.cpu(), torch.argmax(
                    (h_h[:, -1] @ cpu["unembed"].to(h_h.dtype)).float(),
                    -1).to(torch.int32)[:, None])
            h_c, c_c = forward(cfg, params, ids, cache=c_c, pos=40 + t)
            h_h, c_h = forward(cfg, cpu, ids.cpu(), cache=c_h, pos=40 + t)
            close(h_c, h_h)


def _tree_tensors(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tree_tensors(tree[k])]
    return [tree]


@pytest.mark.cuda
def test_cuda_mla_unabsorbed_decode_raises(cuda_device):
    """MLA decode without weight absorption needs decode_attention at
    (192, 128), which is not built: it raises naming the ROADMAP item."""
    import dataclasses

    from repro_torch.models import forward, init_cache, init_model
    cfg = dataclasses.replace(_mla_cfg(torch.bfloat16), mla_absorb=False)
    params = init_model(cfg, torch.Generator(cuda_device).manual_seed(0))
    tok = torch.ones((1, 8), dtype=torch.int32, device=cuda_device)
    with torch.no_grad():
        _, cache = forward(cfg, params, tok,
                           cache=init_cache(cfg, 1, 16, cuda_device))
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 26"):
            forward(cfg, params, tok[:, :1], cache=cache, pos=8)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_moe_block_equals_cpu(exact_f32, arch, dtype):
    """The MoE block (router, top-k, capacity dispatch with drops, expert
    products, shared expert) on the card and the CPU on the same inputs,
    a prefill and a decode-sized T: the same experts for every token and
    the output within ``FLOAT_TOL``.  The inputs are positive and the
    router's column 3 raised, so every token's first choice is expert 3
    and the prefill overflows its capacity."""
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.params import materialize
    from repro_torch.models.model import tree_map
    cfg = configs.SMOKE[arch]
    p = materialize(moe.moe_spec(cfg), torch.Generator().manual_seed(1))
    p["router"][:, 3] += 0.05
    pc = tree_map(lambda t: t.to(exact_f32), p)
    for B, S in ((2, 24), (3, 1)):
        x = _randn("cpu", (B, S, cfg.d_model), dtype, B + S).abs()
        T = B * S
        _, _, i_c = moe.route(cfg, pc, x.to(exact_f32).reshape(T, -1))
        _, _, i_h = moe.route(cfg, p, x.reshape(T, -1))
        assert torch.equal(i_c.cpu(), i_h) and bool((i_h[:, 0] == 3).all())
        _, keep = moe.dispatch(cfg, i_h, moe.capacity_for(cfg, T))
        assert bool((~keep).any()) == (T > moe.capacity_for(cfg, T))
        out_c, aux_c = moe.moe_apply(cfg, pc, x.to(exact_f32))
        out_h, aux_h = moe.moe_apply(cfg, p, x)
        _close(out_c.cpu(), out_h)
        torch.testing.assert_close(aux_c.cpu(), aux_h, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_moe_models_serve_equal_cpu(exact_f32):
    """The MoE decoders under the f32 policy behind the lease fabric on
    the card and the CPU: deepseek-v2 at MLA's real head dims (flash at
    (192, 128), the absorbed decode) and the smoke llama4-maverick (MoE
    every other layer, GQA): equal tokens, lease-cache and fabric
    counters and grant log."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import init_model
    from repro_torch.models.config import Policy
    from repro_torch.runtime.server import Request, Server
    llama = dataclasses.replace(
        configs.SMOKE["llama4-maverick-400b-a17b"], policy=Policy(
            compute_dtype=torch.float32, cache_dtype=torch.float32))
    rng = np.random.default_rng(1)
    for cfg in (_mla_cfg(torch.float32), llama):
        params = init_model(cfg, torch.Generator(exact_f32).manual_seed(0))
        prompts = [rng.integers(2, cfg.vocab, 16).astype(np.int32)
                   for _ in range(3)]
        waves = [[Request(rid=w * 3 + i, prompt=prompts[i], max_new=4)
                  for i in range(3)] for w in range(3)]
        outs, srvs = [], []
        for dev in (exact_f32, "cpu"):
            srv = Server(cfg, params, batch_size=2, max_len=32, device=dev)
            outs.append({k: v for w in waves
                         for k, v in srv.serve(w).items()})
            srvs.append(srv)
        assert outs[0].keys() == outs[1].keys()
        for rid in outs[0]:
            np.testing.assert_array_equal(outs[0][rid], outs[1][rid])
        assert srvs[0].cache_stats == srvs[1].cache_stats
        assert srvs[0].fabric_stats == srvs[1].fabric_stats
        assert srvs[0].cache_stats["hits"] >= 1


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


def _ssd_inputs(dev, B, nc, Q, H, P, N, dtype, stride0, dt_scale, seed):
    """x, dt, A, B and C for ``ssd_chunk`` on the card: dt is
    softplus(normal) * ``dt_scale``, A = -exp(U(0, 1.5)); B and C are a
    group's ``[..., 1, N]`` broadcast to the heads as a stride-0 view
    (``stride0``, as the model passes them) or a copy per head."""
    rng = np.random.default_rng(seed)
    x = _randn(dev, (B, nc, Q, H, P), dtype, seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, nc, Q, H)))) * dt_scale
    dt = torch.from_numpy(dt.astype(np.float32)).to(dev)
    A = torch.from_numpy((-np.exp(rng.uniform(0.0, 1.5, H))).astype(
        np.float32)).to(dev)
    bc = []
    for s in (seed + 1, seed + 2):
        g = _randn(dev, (B, nc, Q, 1, N), dtype, s)
        g = g.expand(B, nc, Q, H, N)
        bc.append(g if stride0 else g.contiguous())
    return x, dt, A, bc[0], bc[1]


@pytest.mark.cuda
@pytest.mark.parametrize("B,nc,Q,H,P,N,stride0", [
    (8, 2, 256, 24, 64, 128, True),     # mamba2-130m prefill, B = 8, S = 512
    (8, 2, 256, 64, 64, 64, True),      # zamba2-1.2b prefill
    (2, 1, 16, 4, 16, 16, False),       # one chunk of 16 (the smoke configs)
    (2, 3, 64, 4, 32, 16, False),
    (1, 2, 100, 3, 128, 48, True),      # ragged query and key tiles
    # the tensor-core route in bf16: B/C copied per head, a ragged chunk,
    # one chunk, P = 128 and N = 128
    (8, 2, 256, 24, 64, 128, False),
    (2, 2, 200, 4, 64, 64, True),
    (8, 1, 16, 24, 64, 128, False),
    (2, 2, 256, 4, 128, 128, True),
    (2, 1, 130, 4, 128, 64, False),
    (1, 1, 512, 2, 64, 64, True),       # four query blocks, eight key tiles
    (1, 1, 1024, 2, 64, 128, False),    # the longest chunk the kernels take
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_chunk_equals_plain(exact_f32, B, nc, Q, H, P, N, stride0,
                                     dtype):
    """dt of 0.1 softplus(normal) makes cum span about -50 over a chunk
    of 256; y and state within ``FLOAT_TOL``, cum within 1e-5; each call
    takes the kernel ``route`` names."""
    from repro_torch.kernels.ssd_chunk import route, ssd_chunk
    args = _ssd_inputs(exact_f32, B, nc, Q, H, P, N, dtype, stride0, 0.1,
                       Q + N)
    path = route(dtype, P, N)
    before = ssd_chunk.launches, ssd_chunk.route_launches[path]
    y, st, cum = ssd_chunk(*args)
    yr, sr, cr = ref.ssd_chunk_ref(*args)
    assert (ssd_chunk.launches, ssd_chunk.route_launches[path]) == \
        (before[0] + 1, before[1] + 1)
    assert path == ("wgmma" if dtype == torch.bfloat16 and P >= 64
                    and N in (64, 128) else "simt")
    for t in (y, st, cum):
        assert torch.isfinite(t).all()
    _close(y, yr)
    torch.testing.assert_close(st, sr, **FLOAT_TOL[dtype])
    torch.testing.assert_close(cum, cr, rtol=1e-5, atol=1e-5)
    assert torch.equal(cum, cr)          # the same sums in the same order


@pytest.mark.cuda
@pytest.mark.parametrize("B,nc,Q,H,P,N,path", [
    (8, 2, 256, 24, 64, 128, "wgmma"), (8, 2, 256, 24, 64, 128, "simt"),
    (8, 2, 256, 64, 64, 64, "wgmma"), (8, 2, 256, 64, 64, 64, "simt"),
    (2, 1, 100, 3, 32, 16, "simt")])
def test_cuda_ssd_chunk_f32_output_equals_plain(exact_f32, B, nc, Q, H, P, N,
                                                path):
    """bf16 inputs with y asked in f32 (the model's call): both kernels
    against the plain version's f32 y within the bf16 inputs' tolerance;
    the default output is that y rounded to bf16."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    args = _ssd_inputs(exact_f32, B, nc, Q, H, P, N, torch.bfloat16, True,
                       0.1, Q + N)
    y, st, cum = ssd_chunk(*args, out_dtype=torch.float32, path=path)
    yr, sr, cr = ref.ssd_chunk_ref(*args, torch.float32)
    assert y.dtype == torch.float32 and torch.isfinite(y).all()
    torch.testing.assert_close(y, yr, **FLOAT_TOL[torch.bfloat16])
    torch.testing.assert_close(st, sr, **FLOAT_TOL[torch.bfloat16])
    assert torch.equal(cum, cr)
    y16, st16, _ = ssd_chunk(*args, path=path)
    assert torch.equal(y16, y.to(torch.bfloat16)) and torch.equal(st16, st)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,P,N", [(torch.float32, 64, 64),
                                       (torch.bfloat16, 64, 64),
                                       (torch.bfloat16, 64, 128)])
def test_cuda_ssd_chunk_never_weighs_masked_pairs(exact_f32, dtype, P, N):
    """dt wide enough that cum spans thousands: exp(cum_i - cum_j) is inf
    for j > i, so masking those pairs with a 0 would give NaN; both
    kernels set them to 0 instead (the CUDA-core one skips them, the
    tensor-core one selects).  Its cum is the plain version's bit for bit
    (the same products summed in the same order), so the tolerances hold
    here too."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    args = _ssd_inputs(exact_f32, 2, 2, 256, 4, P, N, dtype, True, 4.0, 7)
    y, st, cum = ssd_chunk(*args)
    yr, sr, cr = ref.ssd_chunk_ref(*args)
    assert float(cum.min()) < -200
    for t in (y, st, cum):
        assert torch.isfinite(t).all()
    assert torch.equal(cum, cr)
    _close(y, yr)
    torch.testing.assert_close(st, sr, **FLOAT_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,nc,Q,H,P,N", [
    (2, 2, 256, 4, 64, 128), (1, 2, 256, 8, 64, 64), (1, 1, 200, 4, 128, 64),
    (2, 1, 100, 2, 128, 128), (1, 1, 16, 2, 64, 64)])
def test_cuda_ssd_wgmma_keeps_split_w(cuda_device, B, nc, Q, H, P, N):
    """The tensor-core kernel against the CPU emulation of its arithmetic
    (``ssd_emulation.py``) on the same bf16 inputs, y and state in f32.
    With W and w x split into bf16 hi and lo halves the kernel is the
    split emulation within rtol = atol = 5e-4 (ex2's approximation and
    the tensor cores' order of summation; the CPU emulation is within
    8e-5 of the Pallas kernel), and its error against the function in f64
    is at least 16x below that of one bf16 rounding of W and w x (the
    emulation's is 477-741x below on the CPU)."""
    from ssd_emulation import emulate_kernel, exact_ssd

    from repro_torch.kernels.ssd_chunk import ssd_chunk
    args = _ssd_inputs(torch.device("cpu"), B, nc, Q, H, P, N,
                       torch.bfloat16, True, 0.1, Q + P + N)
    before = ssd_chunk.route_launches["wgmma"]
    got = [t.cpu() for t in ssd_chunk(*(t.to(cuda_device) for t in args),
                                      out_dtype=torch.float32)]
    assert ssd_chunk.route_launches["wgmma"] == before + 1
    split = emulate_kernel(*args)
    one = emulate_kernel(*args, split=False)
    exact = exact_ssd(*args)
    # the kernel's cum is torch's cumsum on the card bit for bit (above);
    # on the CPU torch sums an f32 cumsum in f64, so here within 1e-5
    torch.testing.assert_close(got[2], split[2], rtol=1e-5, atol=1e-5)
    for g, s, o, e in zip(got, split, one, exact):
        torch.testing.assert_close(g, s, rtol=5e-4, atol=5e-4)
        err = lambda t: float((t.double() - e).abs().max())
        assert err(g) * 16 < err(o), (err(g), err(s), err(o))


@pytest.mark.cuda
def test_cuda_ssd_chunk_checks_its_inputs(cuda_device):
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    x, dt, A, Bc, Cc = _ssd_inputs(cuda_device, 1, 1, 16, 2, 16, 16,
                                   torch.float32, True, 0.1, 0)
    with pytest.raises(ValueError, match="head dim"):
        ssd_chunk(x[..., :8], dt, A, Bc, Cc)
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk(x, dt.bfloat16(), A, Bc, Cc)
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk(x, dt, A, Bc.bfloat16(), Cc)
    with pytest.raises(ValueError, match="shapes"):
        ssd_chunk(x, dt, A[:1], Bc, Cc)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk(x, dt, A, Bc.transpose(3, 4), Cc)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_chunk(x, dt.cpu(), A, Bc, Cc)
    with pytest.raises(TypeError, match="y in"):
        ssd_chunk(x, dt, A, Bc, Cc, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not take"):
        ssd_chunk(x, dt, A, Bc, Cc, path="wgmma")
    # the tensor-core route raises on a view TMA cannot read; it never
    # falls back to the CUDA-core kernel
    xb, dtb, Ab, Bb, Cb = _ssd_inputs(cuda_device, 1, 1, 16, 2, 64, 64,
                                      torch.bfloat16, True, 0.1, 0)
    wide = torch.zeros(1, 1, 16, 2, 68, dtype=torch.bfloat16,
                       device=cuda_device)
    before = dict(ssd_chunk.route_launches)
    with pytest.raises(ValueError, match="16 bytes"):
        ssd_chunk(wide[..., :64], dtb, Ab, Bb, Cb)
    assert ssd_chunk.route_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_cuda_ssm_model_and_server_equal_cpu(exact_f32, arch):
    """The SSM smoke models under the f32 policy on the card and on the
    CPU: hidden states within rtol = atol = 1e-4, equal greedy tokens,
    equal lease-cache and fabric counters; ``ssd_chunk`` and ``rmsnorm``
    launch."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    from repro_torch.models import forward, init_model
    from repro_torch.models.config import Policy
    from repro_torch.models.model import tree_map
    from repro_torch.runtime.server import Request, Server

    cfg = dataclasses.replace(configs.SMOKE[arch], policy=Policy(
        compute_dtype=torch.float32, cache_dtype=torch.float32))
    params = init_model(cfg, torch.Generator(exact_f32).manual_seed(0))
    cpu = tree_map(lambda t: t.cpu(), params)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab, (2, 48)).astype(np.int32))
    h_card, _ = forward(cfg, params, tok.to(exact_f32))
    h_cpu, _ = forward(cfg, cpu, tok)
    torch.testing.assert_close(h_card.cpu(), h_cpu, rtol=1e-4, atol=1e-4)

    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, cfg.vocab, 32).astype(np.int32)
               for _ in range(3)]
    waves = [[Request(rid=w * 3 + i, prompt=prompts[i], max_new=4)
              for i in range(3)] for w in range(3)]
    before = (ssd_chunk.launches, rmsnorm.launches)
    outs, srvs = [], []
    for dev in (exact_f32, "cpu"):
        srv = Server(cfg, params, batch_size=2, max_len=48, device=dev)
        outs.append({k: v for w in waves for k, v in srv.serve(w).items()})
        srvs.append(srv)
    assert ssd_chunk.launches > before[0] and rmsnorm.launches > before[1]
    assert outs[0].keys() == outs[1].keys()
    for rid in outs[0]:
        np.testing.assert_array_equal(outs[0][rid], outs[1][rid])
    assert srvs[0].cache_stats == srvs[1].cache_stats
    assert srvs[0].fabric_stats == srvs[1].fabric_stats
    assert list(srvs[0].fabric.grant_log) == list(srvs[1].fabric.grant_log)
    assert srvs[0].cache_stats["hits"] >= 1


# ------------------------------------------------------ backward kernels
# Backward kernel vs autograd of the plain forward on the card.  f32:
# rtol = atol = 1e-4 (the same f32 math, but gradients sum over up to
# 4096 rows, or over every query of a key and the group's heads, in
# another order, and attention's Di is dO . O from the forward kernel's
# output where autograd sums P dP).  bf16: rtol = atol = 2e-2 (both sides
# compute in f32 from the same bf16 inputs and round once; Di reads the
# bf16-rounded forward output).
GRAD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _grad_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **GRAD_TOL[want.dtype])


def _ssd_grad_close(name, got, want):
    """``ssd_chunk_bwd``'s outputs: dx, dB and dC within ``GRAD_TOL``;
    ddt and dA (f32 for both input dtypes) within rtol = 1e-4 and 1e-4 of
    their largest magnitude: an element near zero is a difference of
    terms ~1000x larger (a reverse cumsum of cancelling terms), on which
    the f32 plain version itself is more than 1e-4 of 1 + |g| off an f64
    gradient at mamba2's widths
    (``test_torch_ssd_bwd.py::test_f32_ddt_cancels_against_f64``)."""
    if name not in ("ddt", "dA"):
        return _grad_close(got, want)
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("R,D", [(4096, 960), (8, 960), (7, 80), (5, 100),
                                 (3, 8), (33, 4096), (1, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rmsnorm_bwd_equals_plain(exact_f32, R, D, dtype):
    """dx and dw against autograd of ``rmsnorm_ref`` at the training
    shape (R = B S = 4096, D = 960), a few rows, odd widths (element
    loads) and a wide row; dw is the same from run to run."""
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    x = _randn(exact_f32, (R, D), dtype, R + D)
    dy = _randn(exact_f32, (R, D), dtype, R + D + 1)
    w = _randn(exact_f32, (D,), torch.float32, D) * 0.1
    before = rmsnorm_bwd.launches
    dx, dw = rmsnorm_bwd(x, w, dy)
    assert rmsnorm_bwd.launches == before + 1
    want_dx, want_dw = ref.rmsnorm_bwd_ref(x, w, dy)
    _grad_close(dx, want_dx)
    _grad_close(dw, want_dw)
    dx2, dw2 = rmsnorm_bwd(x, w, dy)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", [
    (8, 512, 512, 15, 5, 64, True, 0),        # smollm-360m's training step
    (1, 100, 100, 15, 5, 64, True, 0),        # ragged tail
    (2, 77, 77, 4, 2, 16, False, 0),
    (1, 130, 130, 4, 1, 128, True, 32),       # MQA, windowed
    (1, 50, 130, 4, 2, 32, False, 0),         # rectangular
    (1, 130, 50, 4, 2, 64, True, 0),          # more queries than keys
    # rows 65.. have no visible key (past Sk and the window): the forward
    # and the plain version weigh their keys evenly
    (1, 130, 50, 4, 2, 64, True, 16),
    (1, 200, 200, 4, 2, 64, False, 32),
    # D = 80: hubert-xlarge's training shape (non-causal), odd ones
    (8, 512, 512, 16, 16, 80, False, 0),
    (1, 77, 130, 4, 2, 80, False, 0),
    (1, 100, 100, 4, 2, 80, True, 0),
    (1, 130, 50, 4, 2, 80, True, 16),
    # D = 256: gemma3-4b's training shape past its window, then global,
    # odd and rectangular (32-row tiles on the CUDA cores, two column
    # halves on the tensor cores)
    (4, 1536, 1536, 8, 4, 256, True, 1024),
    (1, 333, 333, 4, 2, 256, False, 0),
    (1, 130, 130, 4, 1, 256, True, 32),
    (1, 70, 100, 4, 2, 256, False, 16),
    # D = 192: MLA's (192, 128), v 128 wide: deepseek-v2's training shape,
    # then odd Sq != Sk, windowed and non-causal
    (2, 512, 512, 128, 128, 192, True, 0),
    (1, 77, 130, 4, 2, 192, False, 0),
    (1, 333, 333, 8, 2, 192, True, 64),
    (1, 130, 50, 4, 2, 192, True, 16),
    (1, 200, 200, 8, 8, 192, False, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_bwd_equals_plain(exact_f32, B, Sq, Sk, Hq, Hkv,
                                               D, causal, window, dtype):
    """dq, dk, dv against autograd of ``attention_ref``, the forward from
    the route's kernel (on the tensor-core route with its row statistics,
    as ``FlashAttentionFn`` passes them); the backward takes the forward's
    route; finite everywhere (a fully masked row included) and the same
    from run to run."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd,
                                                     route)
    dev = exact_f32
    Dv = 128 if D == 192 else D
    q = _randn(dev, (B, Sq, Hq, D), dtype, 1)
    k = _randn(dev, (B, Sk, Hkv, D), dtype, 2)
    v = _randn(dev, (B, Sk, Hkv, Dv), dtype, 3)
    dout = _randn(dev, (B, Sq, Hq, Dv), dtype, 4)
    path = route(dtype, D, Dv)
    stats = (torch.empty((2, B, Hq, Sq), dtype=torch.float32, device=dev)
             if path == "wgmma" else None)
    out = flash_attention(q, k, v, causal=causal, window=window, stats=stats)
    before = flash_attention_bwd.launches
    before_route = flash_attention_bwd.route_launches[path]
    got = flash_attention_bwd(q, k, v, out, dout, causal=causal,
                              window=window, stats=stats)
    assert flash_attention_bwd.launches == before + 1
    assert flash_attention_bwd.route_launches[path] == before_route + 1
    want = ref.attention_bwd_ref(q, k, v, dout, causal=causal, window=window)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _grad_close(g, w)
    again = flash_attention_bwd(q, k, v, out, dout, causal=causal,
                                window=window, stats=stats)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("B,nc,Q,H,P,N,stride0", [
    (8, 2, 256, 24, 64, 128, True),     # mamba2-130m's training step
    (8, 2, 256, 64, 64, 64, True),      # zamba2-1.2b's
    (8, 2, 256, 24, 64, 128, False),    # B/C one per head
    (2, 1, 16, 8, 16, 16, True),        # the smoke configs
    (1, 2, 100, 3, 128, 48, True),      # ragged tiles, N off the buckets
    (2, 3, 64, 4, 32, 16, False),
    (1, 1, 1024, 2, 64, 256, False),    # the longest chunk, the widest N
    # the tensor-core route in bf16: ragged tiles, P = 128, N = 128
    (2, 2, 200, 4, 64, 64, True),
    (1, 1, 100, 2, 128, 128, False),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_chunk_bwd_equals_plain(exact_f32, B, nc, Q, H, P, N,
                                         stride0, dtype):
    """dx, ddt, dA, dB and dC against ``ssd_chunk_bwd_ref`` (autograd of
    the plain version, y asked in f32 as the model asks it) as
    ``_ssd_grad_close`` holds them, on every route that takes the shape
    (the backward's ``path``), each from the cum of the same route's
    forward (the tensor-core route's and the CUDA-core one's are the
    plain version's bit for bit), with nonzero cotangents on y, the state
    and cum; B and C a stride-0 head get their per-head gradient; a rerun
    is equal bit for bit (no atomics)."""
    from repro_torch.kernels.ssd_chunk import route, ssd_chunk, ssd_chunk_bwd
    args = _ssd_inputs(exact_f32, B, nc, Q, H, P, N, dtype, stride0, 0.1,
                       Q + N + 1)
    dy = _randn(exact_f32, (B, nc, Q, H, P), torch.float32, 1)
    dstate = _randn(exact_f32, (B, nc, H, N, P), torch.float32, 2)
    dcum = _randn(exact_f32, (B, nc, Q, H), torch.float32, 3)
    want = ref.ssd_chunk_bwd_ref(*args, dy, dstate, dcum, torch.float32)
    for path in sorted({route(dtype, P, N), "simt"}):
        cum = ssd_chunk(*args, out_dtype=torch.float32, path=path)[2]
        before = ssd_chunk_bwd.launches
        routed = ssd_chunk_bwd.route_launches[path]
        got = ssd_chunk_bwd(*args, cum, dy, dstate, dcum, path=path)
        assert ssd_chunk_bwd.launches == before + 1
        assert ssd_chunk_bwd.route_launches[path] == routed + 1
        for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
            assert torch.isfinite(g).all()
            _ssd_grad_close(name, g, w)
        again = ssd_chunk_bwd(*args, cum, dy, dstate, dcum, path=path)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("B,nc,Q,H,P,N", [
    (2, 2, 256, 4, 64, 128), (1, 2, 256, 8, 64, 64), (1, 1, 200, 4, 128, 64),
    (2, 1, 100, 2, 128, 128), (1, 1, 16, 2, 64, 64)])
def test_cuda_ssd_bwd_wgmma_keeps_split(cuda_device, B, nc, Q, H, P, N):
    """The tensor-core backward against the CPU emulation of its
    arithmetic (``ssd_bwd_wgmma_emulation.py``) on the same bf16 inputs
    and full-f32 cotangents.  With dy, dstate and the weights split into
    bf16 hi and lo halves the kernel's bf16 dx, dB and dC are the split
    emulation's rounded outputs on nearly all elements (at most 1% differ:
    expf and the tensor cores' order of summation may move a value across
    a rounding boundary); one bf16 rounding of those operands changes
    44-51% of them (measured on the CPU), so at least 30% must differ
    from that emulation, and each output's mean error against an f64
    gradient must be at least 1.5x below the single rounding's (1.78-1.99x
    on the CPU) and within 2% of the split's.  ddt and dA: within 2e-5 of
    their scale of the f64 gradient (the split emulation: 0.8-3.5e-6) and
    at least 10x nearer to it than the single rounding (2.6e-4 to 3.8e-3
    of their scale)."""
    from ssd_bwd_wgmma_emulation import emulate_bwd, exact_bwd

    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_bwd
    cpu = torch.device("cpu")
    args = _ssd_inputs(cpu, B, nc, Q, H, P, N, torch.bfloat16, True, 0.1,
                       Q + P + N)
    cot = (_randn(cpu, (B, nc, Q, H, P), torch.float32, 1),
           _randn(cpu, (B, nc, H, N, P), torch.float32, 2),
           _randn(cpu, (B, nc, Q, H), torch.float32, 3))
    dev = [t.to(cuda_device) for t in args + cot]
    cum = ssd_chunk(*dev[:5], out_dtype=torch.float32)[2]
    before = ssd_chunk_bwd.route_launches["wgmma"]
    got = [g.cpu() for g in ssd_chunk_bwd(*dev[:5], cum, *dev[5:])]
    assert ssd_chunk_bwd.route_launches["wgmma"] == before + 1
    cum = cum.cpu()
    split = emulate_bwd(*args, cum, *cot)
    one = emulate_bwd(*args, cum, *cot, split=False)
    exact = exact_bwd(*args, *cot)

    def err(t, e):
        return float((t.double() - e).abs().mean())
    for name, g, s, o, e in zip(("dx", "ddt", "dA", "dB", "dC"), got, split,
                                one, exact):
        if name in ("ddt", "dA"):
            scale = float(e.abs().max())
            worst = lambda t: float((t.double() - e).abs().max())
            found = (name, worst(g) / scale, worst(s) / scale,
                     worst(o) / scale)
            assert worst(g) <= 2e-5 * scale, found
            assert worst(g) * 10 <= worst(o), found
            continue
        s16, o16 = s.to(torch.bfloat16), o.to(torch.bfloat16)
        miss_split = float((g != s16).float().mean())
        miss_one = float((g != o16).float().mean())
        found = (name, miss_split, miss_one, err(g, e), err(s16, e),
                 err(o16, e))
        assert miss_split <= 0.01 and miss_one >= 0.3, found
        assert err(g, e) * 1.5 <= err(o16, e), found
        assert err(g, e) <= err(s16, e) * 1.02, found


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_cuda_ssm_training_takes_the_tensor_core_backward(exact_f32, arch):
    """Phase 8's models at full width (depth cut to two SSM layers, one
    row of 256 tokens, the default bf16 policy): every ``ssd_chunk_bwd``
    of a training step's backward takes the tensor-core route, one a
    layer, and the gradient is finite."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd
    from repro_torch.models import init_model
    from repro_torch.models.model import loss_fn, tree_map
    from repro_torch.optim.adamw import tree_leaves

    cfg = dataclasses.replace(configs.get(arch), n_layers=2)
    params = init_model(cfg, torch.Generator(exact_f32).manual_seed(5))
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    tok = np.random.default_rng(6).integers(2, cfg.vocab, (1, 256)).astype(
        np.int32)
    before = dict(ssd_chunk_bwd.route_launches)
    loss, _ = loss_fn(cfg, p, {"tokens": torch.from_numpy(tok).to(
        exact_f32)})
    loss.backward()
    routes = {k: ssd_chunk_bwd.route_launches[k] - before[k]
              for k in before}
    assert routes == {"wgmma": 2, "simt": 0}, routes
    assert all(torch.isfinite(t.grad).all() for t in tree_leaves(p))


@pytest.mark.cuda
def test_cuda_ssd_chunk_bwd_checks_its_inputs(cuda_device):
    """The backward takes the forward's inputs (the same checks) and
    cotangents of the forward's output shapes, dy in f32 or x's dtype."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_bwd
    args = _ssd_inputs(cuda_device, 1, 1, 16, 2, 16, 16, torch.bfloat16,
                       True, 0.1, 0)
    y, st, cum = ssd_chunk(*args, out_dtype=torch.float32)
    x, dt, A, Bc, Cc = args
    with pytest.raises(ValueError, match="head dim"):
        ssd_chunk_bwd(x[..., :8], dt, A, Bc, Cc, cum, y[..., :8], st, cum)
    with pytest.raises(ValueError, match="dstate"):
        ssd_chunk_bwd(*args, cum, y, st[..., :8], cum)
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk_bwd(*args, cum, y, st, cum.bfloat16())
    with pytest.raises(TypeError, match="dy"):
        ssd_chunk_bwd(*args, cum, y.half(), st, cum)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_chunk_bwd(*args, cum, y, st.cpu(), cum)
    dx, ddt, dA, dB, dC = ssd_chunk_bwd(*args, cum, y.bfloat16(), st, cum)
    assert (dx.dtype, dB.shape, dB.is_contiguous()) == (
        torch.bfloat16, Bc.shape, True)


@pytest.mark.cuda
@pytest.mark.parametrize("D,window", [(64, 0), (128, 32), (80, 0),
                                      (256, 64)])
def test_cuda_flash_forward_writes_stats_under_grad_only(cuda_device, D,
                                                         window):
    """Asked with ``stats=``, the tensor-core forward writes each row's m
    and 1 / max(l, 1e-30) (within 1e-5 of the CPU emulation's, which sums
    in another order) and leaves its output bit-equal to a call without
    them.  ``ops.flash_attention`` asks for them only under grad, through
    ``FlashAttentionFn``, which saves them beside its output; without
    grad the forward gets no stats buffer and writes none
    (``flash_attention.stats_writes`` counts the launches that wrote
    them)."""
    from attention_bwd_emulation import row_stats
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    B, S, Hq, Hkv = 2, 200, 4, 2
    q = _randn(cuda_device, (B, S, Hq, D), torch.bfloat16, 1)
    k = _randn(cuda_device, (B, S, Hkv, D), torch.bfloat16, 2)
    v = _randn(cuda_device, (B, S, Hkv, D), torch.bfloat16, 3)
    plain = fa.flash_attention(q, k, v, causal=True, window=window)
    stats = torch.full((2, B, Hq, S), float("nan"), device=cuda_device)
    out = fa.flash_attention(q, k, v, causal=True, window=window,
                             stats=stats)
    assert torch.equal(out, plain) and torch.isfinite(stats).all()
    m, il = row_stats(q.cpu(), k.cpu(), causal=True, window=window)
    torch.testing.assert_close(stats[0].cpu(), m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stats[1].cpu(), il, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="tensor-core route"):
        fa.flash_attention(q.float(), k.float(), v.float(), stats=stats)

    writes = fa.flash_attention.stats_writes
    with torch.no_grad():
        assert torch.equal(ops.flash_attention(q, k, v, window=window),
                           plain)
    assert fa.flash_attention.stats_writes == writes
    qg = q.detach().requires_grad_()
    o = ops.flash_attention(qg, k, v, window=window)
    assert torch.equal(o, plain)
    assert fa.flash_attention.stats_writes == writes + 1
    saved = o.grad_fn.saved_tensors
    assert saved[4] is not None and torch.equal(saved[4], stats)
    with pytest.raises(ValueError, match="FlashAttentionFn"):
        fa.flash_attention_bwd(q, k, v, plain, plain, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_autograd_goes_through_the_backward_kernels(exact_f32, dtype):
    """``ops.rmsnorm`` and ``ops.flash_attention`` under grad take their
    ``autograd.Function``s (forward and backward kernels) and agree with
    autograd of the plain versions; without grad they launch the forward
    kernel alone.  ``ssd_chunk`` likewise takes ``SSDChunkFn`` (its
    forward kernel and ``ssd_chunk_bwd``), with B and C a stride-0 head
    view: its per-head gradient against the plain version's, and expand's
    backward sums it over the heads.
    ``decode_attention`` under grad raises on the card."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_bwd
    dev = exact_f32
    x = _randn(dev, (2, 64, 96), dtype, 5).requires_grad_()
    w = (_randn(dev, (96,), torch.float32, 6) * 0.1).requires_grad_()
    q = _randn(dev, (2, 64, 4, 64), dtype, 7).requires_grad_()
    k = _randn(dev, (2, 64, 2, 64), dtype, 8).requires_grad_()
    v = _randn(dev, (2, 64, 2, 64), dtype, 9).requires_grad_()
    counts = [f.launches for f in (rmsnorm, rmsnorm_bwd, flash_attention,
                                   flash_attention_bwd)]
    y = ops.rmsnorm(x, w)
    o = ops.flash_attention(q, k, v, causal=True)
    (y.float().square().sum() + o.float().square().sum()).backward()
    assert [f.launches for f in (rmsnorm, rmsnorm_bwd, flash_attention,
                                 flash_attention_bwd)] == [
        c + 1 for c in counts]
    xs, ws, qs, ks, vs = (t.detach().requires_grad_()
                          for t in (x, w, q, k, v))
    (ref.rmsnorm_ref(xs, ws).float().square().sum()
     + ref.attention_ref(qs, ks, vs).float().square().sum()).backward()
    for got, want in ((x, xs), (w, ws), (q, qs), (k, ks), (v, vs)):
        _grad_close(got.grad, want.grad)
    with torch.no_grad():
        ops.rmsnorm(x, w)
        ops.flash_attention(q, k, v)
    assert rmsnorm_bwd.launches == counts[1] + 1
    assert flash_attention_bwd.launches == counts[3] + 1
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.decode_attention(q[:, :1], k, v, 8)
    x, dt, A, Bc, Cc = _ssd_inputs(dev, 2, 2, 64, 2, 64, 64, dtype, True,
                                   0.1, 10)
    outs = []
    counts = (ssd_chunk.launches, ssd_chunk_bwd.launches)
    for fn in (ops.ssd_chunk, ref.ssd_chunk_ref):
        ins = [t.detach().requires_grad_() for t in (x, dt, A)] + [
            t[:, :, :, :1].detach().requires_grad_() for t in (Bc, Cc)]
        bc = [t.expand(-1, -1, -1, 2, -1) for t in ins[3:]]
        for t in bc:
            t.retain_grad()
        y, st, cum = fn(*ins[:3], *bc, torch.float32)
        (y.square().sum() + st.square().sum()
         + cum.exp().sum()).backward()
        outs.append([t.grad for t in ins[:3] + bc])
        # expand's backward sums the per-head gradients of the view
        for view, group in zip(bc, ins[3:]):
            assert torch.equal(group.grad, view.grad.sum(3, keepdim=True))
    assert (ssd_chunk.launches, ssd_chunk_bwd.launches) == (
        counts[0] + 1, counts[1] + 1)
    # per head, as the kernel returns them: in bf16 each side rounds each
    # head's gradient once, so their sums over the heads may differ by
    # those roundings where the heads cancel
    for name, got, want in zip(("dx", "ddt", "dA", "dB", "dC"), *outs):
        _ssd_grad_close(name, got, want)
    with torch.no_grad():
        ops.ssd_chunk(x.requires_grad_(), dt, A, Bc, Cc, torch.float32)
    assert (ssd_chunk.launches, ssd_chunk_bwd.launches) == (
        counts[0] + 2, counts[1] + 1)


@pytest.mark.cuda
def test_cuda_train_step_equals_cpu(exact_f32):
    """The smoke smollm's loss and gradients on the card against the
    CPU: under the f32 policy within rtol = atol = 1e-4 per leaf, under
    the default bf16 policy within a relative L2 of 2e-2 per leaf; the
    backward kernels launch.  The smoke mamba2 under the bf16 policy:
    ``ssd_chunk_bwd`` launches, and the loss and the whole gradient are
    the CPU's within a relative L2 of 2e-2, as is every leaf of at least
    64 values (the per-head vectors of 8 are sums of cancelling terms:
    ``tests/test_torch_train.py`` holds them by the whole gradient)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd
    from repro_torch.models import init_model
    from repro_torch.models.model import loss_fn, tree_map
    from repro_torch.optim.adamw import tree_leaves

    base = configs.SMOKE["smollm-360m"]
    tok = np.random.default_rng(3).integers(2, base.vocab, (2, 64)).astype(
        np.int32)
    for policy in (dict(compute_dtype=torch.float32), {}):
        cfg = dataclasses.replace(base, policy=dataclasses.replace(
            base.policy, **policy))
        params = init_model(cfg, torch.Generator(exact_f32).manual_seed(4))
        grads = []
        for dev in (exact_f32, torch.device("cpu")):
            p = tree_map(lambda t: t.detach().to(dev).requires_grad_(),
                         params)
            leaves = list(tree_leaves(p))
            before = (rmsnorm_bwd.launches, flash_attention_bwd.launches)
            loss, _ = loss_fn(cfg, p, {"tokens": torch.from_numpy(tok).to(
                dev)})
            loss.backward()
            if dev.type == "cuda":
                assert rmsnorm_bwd.launches > before[0]
                assert flash_attention_bwd.launches > before[1]
            grads.append((float(loss), [t.grad.cpu() for t in leaves]))
        (l_card, g_card), (l_cpu, g_cpu) = grads
        if policy:
            assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
            for a, b in zip(g_card, g_cpu):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        else:
            assert abs(l_card - l_cpu) <= 2e-2 * abs(l_cpu)
            for a, b in zip(g_card, g_cpu):
                assert float((a - b).norm()) <= 2e-2 * float(b.norm()) + 1e-6
    cfg = configs.SMOKE["mamba2-130m"]
    params = init_model(cfg, torch.Generator(exact_f32).manual_seed(4))
    grads = []
    for dev in (exact_f32, torch.device("cpu")):
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(), params)
        leaves = list(tree_leaves(p))
        before = ssd_chunk_bwd.launches
        loss, _ = loss_fn(cfg, p, {"tokens": torch.from_numpy(
            tok[:, :32]).to(dev)})
        loss.backward()
        if dev.type == "cuda":
            assert ssd_chunk_bwd.launches > before
        grads.append((float(loss), [t.grad.cpu() for t in leaves]))
    (l_card, g_card), (l_cpu, g_cpu) = grads
    assert abs(l_card - l_cpu) <= 2e-2 * abs(l_cpu)
    whole = lambda gs: torch.cat([g.reshape(-1) for g in gs])
    assert float((whole(g_card) - whole(g_cpu)).norm()) <= 2e-2 * float(
        whole(g_cpu).norm())
    for a, b in zip(g_card, g_cpu):
        if b.numel() >= 64:
            assert float((a - b).norm()) <= 2e-2 * float(b.norm()) + 1e-6


@pytest.mark.cuda
def test_cuda_trainer_equals_cpu_trainer(cuda_device, tmp_path):
    """The smoke smollm's ``Trainer`` on the card and on the CPU from the
    same initial state, with a failure at step 5 and a resume: the same
    events (each wall-clock straggler event held to the watchdog's rule
    instead), fabric counters and grant log (the fabric sees only keys),
    finite losses within 2e-2 of each other, and on the card the resumed
    steps equal the first run's bit for bit."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import init_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import (Trainer, TrainerConfig,
                                            steady_events)

    cfg = configs.SMOKE["smollm-360m"]
    params0 = init_model(cfg, torch.Generator().manual_seed(0))
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        tr = Trainer(cfg, tcfg=TrainerConfig(
            total_steps=8, ckpt_period=3, ckpt_dir=str(tmp_path / dev.type)),
            data=SyntheticLM(cfg, DataConfig(global_batch=2, seq_len=32)),
            device=dev)
        state = adamw.init_state(adamw.tree_map(
            lambda t: t.to(dev, copy=True), params0), cfg.policy.moment_dtype)
        with pytest.raises(RuntimeError, match="simulated node failure"):
            tr.run(state=state, fail_at=5)
        first = [loss for _, loss in tr.history]
        res = tr.resume()
        runs.append((tr, first, res))
    (tc, fc, rc), (th, fh, rh) = runs
    factor = tc.tcfg.straggler_factor
    assert steady_events(tc.events, factor) == steady_events(th.events,
                                                             factor)
    assert rc["fabric_stats"] == rh["fabric_stats"]
    assert list(tc.fabric.grant_log) == list(th.fabric.grant_log)
    # the restart resumes at step 3: steps 3 and 4 ran twice on the card
    assert rc["losses"][:2] == fc[3:5]
    assert all(np.isfinite(rc["losses"]))
    np.testing.assert_allclose(fc + rc["losses"], fh + rh["losses"],
                               rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_cuda_ssm_trainer_equals_cpu_trainer(cuda_device, tmp_path, arch):
    """The smoke SSM and hybrid ``Trainer`` on the card and on the CPU
    from the same initial state, a failure at step 5 and a resume from
    the step-3 checkpoint: ``ssd_chunk_bwd`` launches, the events (but
    the wall-clock straggler events, each held to the watchdog's rule),
    fabric counters and grant log are the CPU's, the losses within 2e-2 of the
    CPU's, and on the card the resumed steps repeat the first run's
    losses bit for bit."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd
    from repro_torch.models import init_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import (Trainer, TrainerConfig,
                                            steady_events)

    cfg = configs.SMOKE[arch]
    params0 = init_model(cfg, torch.Generator().manual_seed(0))
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        before = ssd_chunk_bwd.launches
        tr = Trainer(cfg, tcfg=TrainerConfig(
            total_steps=8, ckpt_period=3, ckpt_dir=str(tmp_path / dev.type)),
            data=SyntheticLM(cfg, DataConfig(global_batch=2, seq_len=32)),
            device=dev)
        state = adamw.init_state(adamw.tree_map(
            lambda t: t.to(dev, copy=True), params0), cfg.policy.moment_dtype)
        with pytest.raises(RuntimeError, match="simulated node failure"):
            tr.run(state=state, fail_at=5)
        first = [loss for _, loss in tr.history]
        res = tr.resume()
        if dev.type == "cuda":
            assert ssd_chunk_bwd.launches > before
        runs.append((tr, first, res))
    (tc, fc, rc), (th, fh, rh) = runs
    factor = tc.tcfg.straggler_factor
    assert steady_events(tc.events, factor) == steady_events(th.events,
                                                             factor)
    assert rc["fabric_stats"] == rh["fabric_stats"]
    assert list(tc.fabric.grant_log) == list(th.fabric.grant_log)
    assert rc["losses"][:2] == fc[3:5]
    assert all(np.isfinite(rc["losses"]))
    np.testing.assert_allclose(fc + rc["losses"], fh + rh["losses"],
                               rtol=2e-2)


@pytest.mark.cuda
def test_cuda_decode_past_the_cache_end_equals_cpu(exact_f32):
    """ROADMAP Queue 3 F8 on the card: the smoke smollm under the f32
    policy, 16-token prompts into a cache of 18 rows and five decode
    steps (pos 16-20): the card no longer raises (its decode kernel gets
    kv_len = min(pos + 1, 18)), its ids equal the CPU's and its caches
    agree within rtol = atol = 1e-4 after every step (the CPU is held to
    the reference past the end in ``test_torch_cache_end.py``)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import decode_step, init_cache, init_model
    from repro_torch.models import prefill
    from repro_torch.models.config import Policy
    from repro_torch.models.model import tree_map
    from repro_torch.optim.adamw import tree_leaves

    cfg = dataclasses.replace(configs.SMOKE["smollm-360m"], policy=Policy(
        compute_dtype=torch.float32, cache_dtype=torch.float32))
    params = init_model(cfg, torch.Generator(exact_f32).manual_seed(0))
    cpu = tree_map(lambda t: t.cpu(), params)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab, (2, 16)).astype(np.int32))
    sides = []
    for dev, p in ((exact_f32, params), (torch.device("cpu"), cpu)):
        nxt, cache = prefill(cfg, p, tok.to(dev), init_cache(cfg, 2, 18, dev))
        sides.append([nxt, cache])
    before = decode_attention.launches
    for pos in range(16, 21):
        for side, p in zip(sides, (params, cpu)):
            side[0], side[1] = decode_step(cfg, p, side[1], side[0][:, None],
                                           pos)
        np.testing.assert_array_equal(sides[0][0].cpu().numpy(),
                                      sides[1][0].numpy())
        for a, b in zip(tree_leaves(sides[0][1]), tree_leaves(sides[1][1])):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    assert decode_attention.launches == before + 5 * cfg.n_layers


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _set_leaves(tree, names, fill):
    """Replace every leaf of ``tree`` (nested dicts) whose key is in
    ``names`` by ``fill(leaf)``."""
    for key, val in tree.items():
        if isinstance(val, dict):
            _set_leaves(val, names, fill)
        elif key in names:
            tree[key] = fill(val)


@pytest.mark.cuda
def test_cuda_qkv_bias_model_equals_cpu(cuda_device):
    """The smoke qwen2.5-14b (``qkv_bias``, the path no other card test
    runs), its q, k and v biases drawn nonzero, in its bf16 policy:
    ``forward``, ``prefill`` and three decode steps (both sides decoding
    the card's ids) on the card against the CPU within a relative L2 of
    2e-2 (both sides round to bf16 at every layer)."""
    from repro_torch import configs
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_model, prefill)
    from repro_torch.models.model import tree_map
    from repro_torch.optim.adamw import tree_leaves

    cfg = configs.SMOKE["qwen2.5-14b"]
    assert cfg.qkv_bias
    params = init_model(cfg, torch.Generator(cuda_device).manual_seed(3))
    gen = torch.Generator(cuda_device).manual_seed(4)
    _set_leaves(params, ("bq", "bk", "bv"), lambda t: 0.5 * torch.randn(
        t.shape, generator=gen, device=t.device, dtype=t.dtype))
    cpu = tree_map(lambda t: t.cpu(), params)
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        2, cfg.vocab, (2, 24)).astype(np.int32))
    h_card, _ = forward(cfg, params, tok.to(cuda_device))
    h_cpu, _ = forward(cfg, cpu, tok)
    assert _rel(h_card.cpu(), h_cpu) <= 2e-2
    n_card, c_card = prefill(cfg, params, tok.to(cuda_device),
                             init_cache(cfg, 2, 32, cuda_device))
    n_cpu, c_cpu = prefill(cfg, cpu, tok, init_cache(cfg, 2, 32, "cpu"))
    before = decode_attention.launches
    for step in range(3):
        ids = n_card[:, None]
        n_card, c_card = decode_step(cfg, params, c_card, ids, 24 + step)
        n_cpu, c_cpu = decode_step(cfg, cpu, c_cpu, ids.cpu(), 24 + step)
        for a, b in zip(tree_leaves(c_card), tree_leaves(c_cpu)):
            assert _rel(a.cpu(), b) <= 2e-2
    assert decode_attention.launches > before


def _grad_case(arch):
    """(config, batch maker): the model's attention at its full head dim
    on small widths.  hubert-xlarge: 2 non-causal heads of 80 (frames,
    labels and a mask); gemma3-4b: 6 layers (the first global one last)
    of 2 over 1 heads of 256, window 16 on 64 tokens; llava-next-34b: the
    patches frontend with 2 over 1 heads of 128."""
    import dataclasses

    from repro_torch import configs
    cfg = configs.SMOKE[arch]
    if arch == "hubert-xlarge":
        cfg = dataclasses.replace(cfg, n_heads=2, n_kv_heads=2, d_head=80)
    elif arch == "gemma3-4b":
        cfg = dataclasses.replace(cfg, n_layers=6, n_heads=2, n_kv_heads=1,
                                  d_head=256)
    else:
        cfg = dataclasses.replace(cfg, n_heads=2, n_kv_heads=1, d_head=128)

    def batch(rng, B=2, S=64):
        if arch == "hubert-xlarge":
            return {"frames": rng.standard_normal(
                        (B, S, cfg.d_frontend)).astype(np.float32),
                    "labels": rng.integers(0, cfg.vocab, (B, S)).astype(
                        np.int32),
                    "mask": (rng.random((B, S)) < 0.7).astype(np.float32)}
        out = {"tokens": rng.integers(2, cfg.vocab, (B, S)).astype(np.int32)}
        if arch == "llava-next-34b":
            out["patches"] = (0.1 * rng.standard_normal(
                (B, cfg.n_patch_tokens, cfg.d_model))).astype(np.float32)
        return out
    return cfg, batch


@pytest.mark.cuda
@pytest.mark.parametrize("arch,D", [("hubert-xlarge", 80), ("gemma3-4b", 256),
                                    ("llava-next-34b", 128)])
@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_cuda_loss_fn_grads_at_the_models_head_dims_equal_cpu(exact_f32,
                                                              arch, D,
                                                              policy):
    """``loss_and_grads`` on the card against the CPU at the model's head
    dim (``_grad_case``): every attention layer's backward on the card is
    one ``flash_attention_bwd`` launch on its route (bf16: the tensor
    cores, from the forward's row statistics; f32: the CUDA cores).
    Under the f32 policy the loss and every leaf within rtol = atol =
    1e-4; under bf16 the loss, the whole gradient and every leaf of at
    least 64 values within a relative L2 of 2e-2."""
    import dataclasses

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.models import init_model
    from repro_torch.models.model import tree_map
    from repro_torch.models.training import loss_and_grads
    from repro_torch.optim.adamw import tree_leaves

    cfg, batch = _grad_case(arch)
    assert cfg.d_head == D
    if policy == "f32":
        cfg = dataclasses.replace(cfg, policy=dataclasses.replace(
            cfg.policy, compute_dtype=torch.float32))
    path = "simt" if policy == "f32" else "wgmma"
    params = init_model(cfg, torch.Generator(exact_f32).manual_seed(6))
    data = batch(np.random.default_rng(7))
    out = []
    for dev in (exact_f32, torch.device("cpu")):
        before = (dict(flash_attention_bwd.route_launches),
                  flash_attention.stats_writes)
        loss, _, grads = loss_and_grads(
            cfg, tree_map(lambda t: t.to(dev), params),
            {k: torch.from_numpy(v).to(dev) for k, v in data.items()})
        if dev.type == "cuda":
            got = {k: flash_attention_bwd.route_launches[k] - before[0][k]
                   for k in before[0]}
            assert got[path] == cfg.n_layers and sum(got.values()) == \
                cfg.n_layers, got
            if path == "wgmma":
                assert flash_attention.stats_writes - before[1] >= \
                    cfg.n_layers
        out.append((loss.cpu(), [g.cpu() for g in tree_leaves(grads)]))
    (l_card, g_card), (l_cpu, g_cpu) = out
    assert all(torch.isfinite(g).all() for g in g_card)
    if policy == "f32":
        torch.testing.assert_close(l_card, l_cpu, rtol=1e-4, atol=1e-4)
        for a, b in zip(g_card, g_cpu):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        return
    assert _rel(l_card, l_cpu) <= 2e-2
    whole = lambda gs: torch.cat([g.reshape(-1) for g in gs])
    assert _rel(whole(g_card), whole(g_cpu)) <= 2e-2
    for a, b in zip(g_card, g_cpu):
        if b.numel() >= 64 and b.abs().max() > 0:
            assert _rel(a, b) <= 2e-2


def _moe_train_case(arch, dtype):
    """The smoke MoE config to train on the card: deepseek-v2 with MLA's
    real head dims (``_mla_cfg``: flash at (192, 128)), llama4-maverick
    as it is (head dim 16, the CUDA-core kernels); bf16: the full
    configs' own policy (bf16 params and moments), f32: compute in f32.
    Returns (config, the flash backward's route)."""
    import dataclasses

    from repro_torch import configs
    cfg = _mla_cfg(dtype) if arch == "deepseek-v2-236b" \
        else configs.SMOKE[arch]
    if dtype == torch.bfloat16:
        return dataclasses.replace(cfg, policy=configs.ARCHS[arch].policy), \
            ("wgmma" if arch == "deepseek-v2-236b" else "simt")
    return dataclasses.replace(cfg, policy=dataclasses.replace(
        cfg.policy, compute_dtype=torch.float32,
        cache_dtype=torch.float32)), "simt"


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_moe_loss_fn_grads_equal_cpu(exact_f32, arch, dtype):
    """``loss_and_grads`` of the smoke MoE models (``_moe_train_case``) on
    the card against the CPU on the same weights and tokens: every
    attention layer's backward one ``flash_attention_bwd`` launch on the
    route of the config's dtype and head dims, aux > 0 on both; under the
    f32 policy the loss and every leaf within rtol = atol = 1e-4; in
    bf16 the loss and the whole gradient within a relative L2 of 2e-2."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.models import init_model
    from repro_torch.models.model import tree_map
    from repro_torch.models.training import loss_and_grads
    from repro_torch.optim.adamw import tree_leaves

    cfg, path = _moe_train_case(arch, dtype)
    params = init_model(cfg, torch.Generator(exact_f32).manual_seed(4))
    tok = np.random.default_rng(5).integers(2, cfg.vocab, (2, 64)).astype(
        np.int32)
    out = []
    for dev in (exact_f32, torch.device("cpu")):
        before = dict(flash_attention_bwd.route_launches)
        loss, metrics, grads = loss_and_grads(
            cfg, tree_map(lambda t: t.to(dev), params),
            {"tokens": torch.from_numpy(tok).to(dev)})
        if dev.type == "cuda":
            got = {k: flash_attention_bwd.route_launches[k] - before[k]
                   for k in before}
            assert got[path] == cfg.n_layers and sum(got.values()) == \
                cfg.n_layers, got
        assert float(metrics["aux"]) > 0
        out.append((loss.cpu(), [g.cpu() for g in tree_leaves(grads)]))
    (l_card, g_card), (l_cpu, g_cpu) = out
    assert all(torch.isfinite(g.float()).all() for g in g_card)
    if dtype == torch.float32:
        torch.testing.assert_close(l_card, l_cpu, rtol=1e-4, atol=1e-4)
        for a, b in zip(g_card, g_cpu):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        return
    assert _rel(l_card, l_cpu) <= 2e-2
    whole = lambda gs: torch.cat([g.float().reshape(-1) for g in gs])
    assert _rel(whole(g_card), whole(g_cpu)) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "llama4-maverick-400b-a17b"])
def test_cuda_moe_trainer_steps_repeat_bit_for_bit(cuda_device, tmp_path,
                                                   arch):
    """Two steps of the smoke MoE models' ``Trainer.step_fn`` on the card
    under the configs' own bf16 policy, run twice from the same seeded
    state (the step updates its state in place): the losses, aux and the
    whole state after each step equal bit for bit (what a resume needs;
    the MoE dispatch's backward is a gather's and a sum's, no atomics)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg, _ = _moe_train_case(arch, torch.bfloat16)
    tr = Trainer(cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                        total_steps=4),
                 TrainerConfig(total_steps=4, ckpt_dir=str(tmp_path)),
                 data=SyntheticLM(cfg, DataConfig(global_batch=2,
                                                  seq_len=64)),
                 device=cuda_device)
    runs = []
    for _ in range(2):
        state = tr.init_state(0)
        seen = []
        for step in range(2):
            state, m = tr.step_fn(state, tr.data.batch(step))
            seen.append((m["loss"].cpu(), m["aux"].cpu(), [
                t.cpu() for t in adamw.tree_leaves(
                    {"params": state.params, "m": state.m, "v": state.v})]))
        runs.append(seen)
        del state
    for (la, aa, sa), (lb, ab, sb) in zip(*runs):
        assert torch.isfinite(la) and float(aa) > 0
        assert torch.equal(la, lb) and torch.equal(aa, ab)
        assert all(torch.equal(a, b) for a, b in zip(sa, sb))


# ------------------------------------------------- expert parallelism
_MESH_WORLD = {}
EP_ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")
EP_MESHES = ((1, 2), (2, 1))
EP_TOL = 2e-2                 # card vs CPU in bf16, relative L2


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def _mesh_tasks(ckpt_dir):
    """The same tasks on CUDA tensors and on CPU tensors: the MoE layer,
    the loss, gradients and 3 train steps (the configs' own bf16 compute;
    deepseek's at MLA's own head dims, the pair the flash kernels build),
    each collective, and a mesh ``Trainer``'s failure and resume."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.params import materialize
    tasks = []
    rng = np.random.default_rng(40)
    for arch in EP_ARCHS:
        cfg = configs.SMOKE[arch]
        if cfg.is_mla:
            full = configs.ARCHS[arch]
            cfg = dataclasses.replace(cfg, nope_head_dim=full.nope_head_dim,
                                      rope_head_dim=full.rope_head_dim,
                                      v_head_dim=full.v_head_dim)
        w = _np_tree(materialize(moe.moe_spec(cfg),
                                   torch.Generator().manual_seed(1)))
        h = rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)
        params = _np_tree(M.init_model(cfg, torch.Generator().manual_seed(2)))
        batches = [{"tokens": rng.integers(0, cfg.vocab, (4, 64)).astype(
            np.int32)} for _ in range(3)]
        for dev in ("cuda", "cpu"):
            for shape in EP_MESHES:
                common = {"mesh": shape, "arch": arch, "policy": "own",
                          "device": dev, "mla_heads": cfg.is_mla}
                tasks.append({"kind": "moe", "params": w, "h": h,
                              "name": ("moe", arch, shape, dev), **common})
                tasks.append({"kind": "grads", "params": params,
                              "batch": batches[0], "steps": batches,
                              "opt": dict(lr=1e-3, warmup_steps=1,
                                          total_steps=20),
                              "name": ("grads", arch, shape, dev), **common})
    for dev in ("cuda", "cpu"):
        tasks.append({"kind": "collectives", "mesh": (1, 2),
                      "arch": EP_ARCHS[1], "device": dev,
                      "name": ("collectives", dev)})
    tasks.append({"kind": "trainer", "name": "trainer", "mesh": (1, 2),
                  "arch": EP_ARCHS[1], "policy": "own", "device": "cuda",
                  "seed": 3, "batch": 2, "seq": 64, "total": 5, "fail": 3,
                  "ckpt_dir": ckpt_dir})
    return tasks


def _mesh_world(tmp_path):
    """One gloo world of two ranks sharing the card
    (``tests/torch_mesh_worker.py``), run once for the tests below."""
    import os
    import pathlib
    import pickle
    import subprocess
    import sys
    if "res" in _MESH_WORLD:
        return _MESH_WORLD["res"]
    root = pathlib.Path(__file__).resolve().parent.parent
    (tmp_path / "job.pkl").write_bytes(pickle.dumps(
        {"tasks": _mesh_tasks(str(tmp_path / "ckpt")), "threads": 2}))
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(root / "tests" / "torch_mesh_worker.py"),
         str(r), "2", str(tmp_path / "rdzv"), str(tmp_path / "job.pkl"),
         str(tmp_path / f"out{r}.pkl")], env=env, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    errs = []
    for p in procs:
        try:
            errs.append(p.communicate(timeout=600)[1])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a rank did not finish in 600 s")
    assert all(p.returncode == 0 for p in procs), "\n".join(
        e[-3000:] for e in errs)
    _MESH_WORLD["res"] = [pickle.loads((tmp_path / f"out{r}.pkl")
                                       .read_bytes()) for r in range(2)]
    return _MESH_WORLD["res"]


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [np.asarray(tree).ravel()]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", EP_ARCHS)
@pytest.mark.parametrize("shape", EP_MESHES)
def test_cuda_mesh_moe_and_train_step_equal_cpu(cuda_device, tmp_path, arch,
                                                shape):
    """The expert-parallel MoE layer and the mesh train step in a gloo
    world of two ranks sharing the card equal the same world on CPU
    tensors within a relative L2 of 2e-2 (bf16 compute): the layer's
    output and aux, the loss and the whole gradient, three steps'
    losses; each replicated leaf equal bit for bit on both ranks after
    the steps."""
    ranks = _mesh_world(tmp_path)
    for res in ranks:
        c, h = (res[("moe", arch, shape, d)] for d in ("cuda", "cpu"))
        assert _rel_l2(c["out"], h["out"]) <= EP_TOL
        assert abs(c["aux"] - h["aux"]) <= EP_TOL * abs(h["aux"])
        c, h = (res[("grads", arch, shape, d)] for d in ("cuda", "cpu"))
        assert abs(c["loss"] - h["loss"]) <= EP_TOL * abs(h["loss"])
        assert _rel_l2(np.concatenate(_tree_leaves(c["grads"])),
                       np.concatenate(_tree_leaves(h["grads"]))) <= EP_TOL
        np.testing.assert_allclose(c["losses"], h["losses"], rtol=EP_TOL)
    for d in ("cuda", "cpu"):
        a, b = (res[("grads", arch, shape, d)]["digests"] for res in ranks)
        assert a == b


@pytest.mark.cuda
def test_cuda_mesh_collectives_on_gloo(cuda_device, tmp_path):
    """Every collective the mesh path issues runs on gloo with CUDA
    tensors (none moved to the CPU by the caller) and gives the CPU's
    results exactly."""
    for res in _mesh_world(tmp_path):
        c, h = res[("collectives", "cuda")], res[("collectives", "cpu")]
        assert c["devices"] == ["cuda:0"] and h["devices"] == ["cpu"]
        for k in c:
            if k != "devices":
                assert np.array_equal(c[k], h[k]), k


@pytest.mark.cuda
def test_cuda_mesh_trainer_resume_repeats_losses(cuda_device, tmp_path):
    """``Trainer(mesh=)`` on the card: a failure at step 3 and a resume
    from the step-2 checkpoint (global tensors gathered from the shards)
    repeat the losses and the params bit for bit."""
    for res in _mesh_world(tmp_path):
        got = res["trainer"]
        assert got["resumed"] == got["losses"][2:]
        for a, b in zip(_tree_leaves(got["params"]),
                        _tree_leaves(got["resumed_params"])):
            assert np.array_equal(a, b)
