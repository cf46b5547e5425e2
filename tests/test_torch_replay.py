"""One recorded request trace replayed open-loop through ``repro``'s
fabric and scheduler and through the port's, side by side.

The trace is synthesized once, recorded to npz and loaded back by each
package's own ``RequestTrace.load``.  A fixed ``service_model`` makes the
virtual clock deterministic, so both replays form the same waves; every
served result, the latency of every request, the wave telemetry, the grant
log and every counter (the per-link byte counters included) must match.
The port's copies of ``loadgen`` and ``scheduler`` are also held to the
reference on their own.
"""
import numpy as np
import pytest

from repro.coherence.fabric import ArrayFabric as RefArrayFabric
from repro.coherence.fabric import FabricConfig as RConfig
from repro.coherence.fabric import HostFabric
from repro.coherence.fabric import ReadBatchHandle as RHandle
from repro.runtime import loadgen as RL
from repro.runtime import scheduler as RS
from repro_torch.coherence.fabric import ArrayFabric, FabricConfig
from repro_torch.coherence.fabric import ReadBatchHandle as THandle
from repro_torch.runtime import loadgen as TL
from repro_torch.runtime import scheduler as TSched

# 96 keys over 4 x 16 TSU entries: the table fills and evicts
REPLAY = dict(n_shards=4, rd_lease=8, wr_lease=4, tsu_capacity=16,
              shared_sets=32, shared_ways=4, replica_sets=16, replica_ways=4,
              max_in_flight=4)
N_KEYS = 96
LINK_BYTES = ("bytes_l1_l2", "bytes_l2_mm", "bytes_inter_gpu")


def service_model(n: int) -> float:
    return 1e-3 + 2e-5 * n


class Recorder:
    """``replay``'s backend: forwards to a fabric and records every served
    read batch in resolve order."""

    def __init__(self, fab, handle_cls):
        self.fab = fab
        self.handle_cls = handle_cls
        self.served = []

    def read_batch_async(self, keys, replica):
        h = self.fab.read_batch_async(keys, replica=replica)
        return self.handle_cls(lambda: self._record(h.result()))

    def _record(self, out):
        self.served.append(out)
        return out

    def write_batch(self, items, replica):
        self.fab.write_batch(items, replica=replica)

    def fence(self):
        return self.fab.fence()


def _replay(fab, sched, handle_cls, trace):
    keys = [f"prefix/{k}" for k in range(N_KEYS)]
    fab.write_batch([(k, f"{k}@0") for k in keys], replica=0)
    fab.fence()
    fab.read_batch(keys, replica=1)
    rec = Recorder(fab, handle_cls)
    pol = sched.BatchPolicy(mode="continuous", max_batch=16, min_bucket=8,
                            max_wait_s=1.5 * service_model(16))
    res = sched.replay(rec, trace, pol, republish_every=32, republish_n=8,
                       service_model=service_model)
    return rec, res


@pytest.mark.parametrize("process", ["diurnal", "poisson"])
def test_recorded_trace_replays_identically(process, tmp_path):
    path = tmp_path / "trace.npz"
    RL.synthesize(300, N_KEYS, a=1.2, process=process, rate=2000.0,
                  seed=11).save(path)
    ref_trace, port_trace = RL.RequestTrace.load(path), \
        TL.RequestTrace.load(path)
    make = lambda cls, cfg: cls(cfg(**REPLAY), n_nodes=2,
                                replicas_per_node=2)
    ref = make(RefArrayFabric, RConfig)
    host = make(HostFabric, RConfig)
    port = ArrayFabric(FabricConfig(**REPLAY), n_nodes=2,
                       replicas_per_node=2, device="cpu")
    runs = [_replay(ref, RS, RHandle, ref_trace),
            _replay(host, RS, RHandle, ref_trace),
            _replay(port, TSched, THandle, port_trace)]

    (rec0, res0) = runs[0]
    for rec, res in runs[1:]:
        assert rec.served == rec0.served
        np.testing.assert_array_equal(res.latency_s, res0.latency_s)
        assert (res.t_end, res.batch_sizes, res.padded_sizes, res.fires,
                res.events) == (res0.t_end, res0.batch_sizes,
                                res0.padded_sizes, res0.fires, res0.events)
    assert list(port.grant_log) == list(ref.grant_log) \
        == list(host.grant_log)
    st = port.stats()
    assert st == ref.stats() == host.stats()
    for r in range(port.n_replicas):
        assert port.replica_stats(r) == ref.replica_stats(r) \
            == host.replica_stats(r)
    assert all(st[k] > 0 for k in LINK_BYTES)
    assert st["tsu_evictions"] > 0 and st["refetches"] > 0
    for k in range(N_KEYS):
        assert port.memts(f"prefix/{k}") == ref.memts(f"prefix/{k}")


@pytest.mark.parametrize("process,kw", [
    ("poisson", {}), ("diurnal", dict(amplitude=0.9, cycles=3.0)),
    ("burst", {})])
def test_loadgen_copy_matches_reference(process, kw):
    a = RL.synthesize(500, 64, a=1.1, process=process, rate=300.0, seed=3,
                      **kw)
    b = TL.synthesize(500, 64, a=1.1, process=process, rate=300.0, seed=3,
                      **kw)
    np.testing.assert_array_equal(a.t, b.t)
    np.testing.assert_array_equal(a.kid, b.kid)
    assert a.meta == b.meta
    np.testing.assert_array_equal(RL.bounded_zipf(64, 1.1).pmf(),
                                  TL.bounded_zipf(64, 1.1).pmf())


@pytest.mark.parametrize("mode", ["continuous", "fixed"])
def test_scheduler_copy_forms_the_same_waves(mode):
    tr = RL.synthesize(200, 32, process="burst", rate=500.0, seed=5)
    kw = dict(mode=mode, max_batch=8, min_bucket=4, max_wait_s=4e-3)
    items = list(range(len(tr)))
    assert RS.form_waves(tr.t, items, RS.BatchPolicy(**kw)) \
        == TSched.form_waves(tr.t, items, TSched.BatchPolicy(**kw))
    for n in (0, 3, 8, 9):
        assert RS.pad_to_bucket(list(range(n)), RS.BatchPolicy(**kw)) \
            == TSched.pad_to_bucket(list(range(n)), TSched.BatchPolicy(**kw))
