"""The port's ``obs.metrics.LatencyHistogram`` and
``obs.registry.MetricsRegistry`` against the reference's on the same
samples and fabric counters: every result equal (the same numpy
arithmetic)."""
import numpy as np
import pytest

from repro.obs import LatencyHistogram as RHist
from repro.obs import MetricsRegistry as RReg
from repro_torch.coherence.fabric import ArrayFabric, FabricConfig
from repro_torch.obs import LatencyHistogram as THist
from repro_torch.obs import MetricsRegistry as TReg

PCTS = (0, 1, 10, 50, 90, 95, 99, 99.9, 100)


def _both(samples, **kw):
    return (RHist(**kw).record_many(samples),
            THist(**kw).record_many(samples))


@pytest.mark.parametrize("seed,n,cap", [(0, 4096, 65536), (1, 512, 64),
                                        (2, 3000, 1000), (3, 1, 65536),
                                        (4, 0, 65536)])
def test_histogram_equals_reference(seed, n, cap):
    """Percentiles (exact while the samples are kept, bucket-interpolated
    past ``sample_cap``), buckets and summary."""
    rng = np.random.default_rng(seed)
    samples = rng.lognormal(mean=-8.0, sigma=2.0, size=n)
    r, t = _both(samples, sample_cap=cap)
    assert t.exact == r.exact == (n <= cap)
    for p in PCTS:
        assert t.percentile(p) == r.percentile(p), p
    assert t.buckets() == r.buckets()
    assert t.summary() == r.summary()
    assert (t.count, t.sum_s, t.min_s, t.max_s) == \
        (r.count, r.sum_s, r.min_s, r.max_s)


def test_histogram_merge_and_validation_equal_reference():
    rng = np.random.default_rng(5)
    a, b = rng.lognormal(-7, 1, 300), rng.lognormal(-5, 1, 200)
    for kw in ({}, {"sample_cap": 256}, {"base": 1e-5, "growth": 1.5,
                                         "n_buckets": 30}):
        r, t = _both(a, **kw)
        r.merge(RHist(**kw).record_many(b))
        t.merge(THist(**kw).record_many(b))
        assert t.summary() == r.summary() and t.buckets() == r.buckets()
        for p in PCTS:
            assert t.percentile(p) == r.percentile(p)
    with pytest.raises(ValueError):
        THist().record(-1e-3)
    with pytest.raises(ValueError):
        THist().merge(THist(base=1e-3))
    with pytest.raises(ValueError):
        THist(growth=1.0)


def test_registry_deltas_equal_reference_on_a_fabric():
    """Snapshots and deltas of a port fabric's counters (its ``stats()``)
    through both registries, with latencies observed, and the
    summaries."""
    fab = ArrayFabric(FabricConfig(n_shards=2, rd_lease=4, wr_lease=2),
                      n_nodes=2, replicas_per_node=2, device="cpu")
    regs = (RReg(), TReg())
    key = ("array", "smoke")
    snaps = [reg.snapshot(key, fab) for reg in regs]
    assert snaps[0] == snaps[1]
    rng = np.random.default_rng(6)
    for i in range(4):
        fab.write_batch([(f"k{j}", f"v{i}") for j in range(3)], replica=0)
        fab.fence()
        fab.read_batch([f"k{j}" for j in range(5)], replica=1)
        ds = [reg.delta(key, fab, advance=i % 2 == 0) for reg in regs]
        assert ds[0] == ds[1]
        dt = float(rng.lognormal(-7, 1))
        for reg in regs:
            reg.observe(key, "total", dt)
    assert regs[0].last_snapshot(key) == regs[1].last_snapshot(key)
    assert regs[0].delta(("other",), {"reads": 3}) == \
        regs[1].delta(("other",), {"reads": 3}) == {"reads": 3}
    assert regs[0].summary() == regs[1].summary()
    with pytest.raises(TypeError):
        regs[1].snapshot(key, 3)
