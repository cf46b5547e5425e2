"""The port's batched grant pipeline against the reference's.

The numpy round schedulers must give ``repro``'s rounds exactly (same
inputs as ``tests/test_round_coloring.py``), and each torch pass — miss,
write, fence — run on a state loaded from a reference fabric must leave
the same state and return the same result block as the reference's
jitted pass on the same inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.coherence.fabric import ArrayFabric as RefArrayFabric
from repro.coherence.fabric import FabricConfig as RConfig
from repro.coherence.fabric import pipeline as RP_
from repro.coherence.fabric.arrays import _build_fence_run
from repro_torch.coherence.fabric import pipeline as TP_
from repro_torch.coherence.fabric.arrays import _next_pow2

from test_fabric_parity import KEYS, SMALL, random_trace
from test_round_coloring import _random_ops
from test_torch_fabric import assert_same_state, port_fabric, reference_state


def _rounds_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_read_schedulers_match_reference(seed):
    rng = np.random.default_rng(seed)
    kids, s1, s2, _ = _random_ops(rng, 64)
    fps = [((0, k), (1, a), (2, b)) for k, a, b in zip(kids, s1, s2)]
    assert TP_.color_rounds(fps) == RP_.color_rounds(fps)
    for fn in ("conflict_rounds", "conflict_rounds_greedy"):
        got = getattr(TP_, fn)(kids, s1, s2)
        _rounds_equal(got, getattr(RP_, fn)(kids, s1, s2))
        R = _next_pow2(len(got))
        np.testing.assert_array_equal(TP_.round_masks(got, R, 64),
                                      RP_.round_masks(got, R, 64))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("splitter", ["colored", "greedy"])
def test_write_schedule_matches_reference(seed, splitter):
    rng = np.random.default_rng(seed)
    kids, s1, s2, shard = _random_ops(rng, 40)
    pending = [(int(k), int(a), int(b), int(sh), 1, -1)
               for k, a, b, sh in zip(*_random_ops(rng, 2))]
    args = (kids, s1, s2, shard, 1, -1, pending, 3)
    got, gs = TP_.write_schedule(*args, splitter=splitter)
    want, ws = RP_.write_schedule(*args, splitter=splitter)
    _rounds_equal(got, want)
    np.testing.assert_array_equal(gs, ws)
    if splitter == "greedy":
        _rounds_equal(TP_.write_rounds_greedy(*args)[0],
                      RP_.write_rounds_greedy(*args)[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_fence_schedule_matches_reference(seed):
    rng = np.random.default_rng(seed)
    kids, s1, s2, shard = _random_ops(rng, 24)
    ents = [(int(k), int(a), int(b), int(sh), int(r), int(w), int(n))
            for k, a, b, sh, r, w, n in zip(
                kids, s1, s2, shard, rng.integers(0, 4, 24),
                rng.integers(-1, 3, 24), np.sort(rng.integers(0, 2, 24)))]
    got, gs = TP_.fence_schedule(ents)
    want, ws = RP_.fence_schedule(ents)
    _rounds_equal(got, want)
    np.testing.assert_array_equal(gs, ws)
    assert TP_.WRITE_RES_FIELDS == RP_.WRITE_RES_FIELDS
    assert TP_.WRITE_SCHED_FIELDS == RP_.WRITE_SCHED_FIELDS
    assert TP_.FENCE_SCHED_FIELDS == RP_.FENCE_SCHED_FIELDS


# ------------------------------------------------------------ the passes
def _loaded_pair(seed):
    """A reference fabric mid-run (dirty tiers, non-empty write queues)
    and a port fabric loaded with its state."""
    ref = RefArrayFabric(RConfig(**SMALL), n_nodes=2, replicas_per_node=2)
    ref.apply(random_trace(np.random.default_rng(seed), 160, 4))
    port = port_fabric(SMALL)
    port.load_state(*reference_state(ref))
    return ref, port


def _adopt(ref, af):
    """Adopt a reference pass's output state (its input was donated)."""
    ref._af = af


@pytest.mark.parametrize("seed", [0, 1])
def test_miss_pass_matches_reference(seed):
    ref, port = _loaded_pair(seed)
    rng = np.random.default_rng(seed + 50)
    kids = np.asarray([port._kid(KEYS[int(i)]) for i in
                       rng.integers(0, len(KEYS), 12)], np.int32)
    meta = port._meta[kids]
    rounds = TP_.conflict_rounds(kids, meta[:, 0], meta[:, 1])
    M, R = max(32, _next_pow2(len(kids))), max(4, _next_pow2(len(rounds)))
    masks = TP_.round_masks(rounds, R, M)
    ops = np.zeros((4, M), np.int32)
    ops[:, :len(kids)] = np.stack([kids, meta[:, 0], meta[:, 1],
                                   meta[:, 2]])
    rd, wr = SMALL["rd_lease"], SMALL["wr_lease"]
    af, want = ref._miss_run(ref._af, jnp.asarray(ops), jnp.asarray(masks),
                             np.int32(2), np.int32(1), jnp.int32(rd),
                             jnp.int32(wr))
    _adopt(ref, af)
    _, got = port._miss_run(port._af, ops, masks, 2, 1, rd, wr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_same_state(ref, port)


@pytest.mark.parametrize("seed", [0, 1])
def test_write_pass_matches_reference(seed):
    ref, port = _loaded_pair(seed)
    rng = np.random.default_rng(seed + 60)
    kids = np.asarray([port._kid(KEYS[int(i)]) for i in
                       rng.integers(0, len(KEYS), 9)], np.int32)
    meta = port._meta[kids]
    rep, node, wl = 3, 1, 30000
    pending = [(k, *port._meta[k].tolist(), r, w)
               for k, _, r, w in port._qmirror[node]]
    rounds, sched = TP_.write_schedule(kids, meta[:, 0], meta[:, 1],
                                       meta[:, 2], rep, wl, pending,
                                       SMALL["max_in_flight"])
    M, R = max(32, _next_pow2(len(kids))), max(4, _next_pow2(len(rounds)))
    masks = TP_.round_masks(rounds, R, M)
    ops = np.zeros((4, M), np.int32)
    ops[:, :len(kids)] = np.stack([kids, meta[:, 0], meta[:, 1],
                                   meta[:, 2]])
    sched = np.pad(sched, ((0, 0), (0, M - len(kids))))
    rd, wr = SMALL["rd_lease"], SMALL["wr_lease"]
    af, want = ref._write_run(ref._af, jnp.asarray(ops), jnp.asarray(sched),
                              jnp.asarray(masks), np.int32(rep),
                              np.int32(node), jnp.int32(wl), jnp.int32(rd),
                              jnp.int32(wr))
    _adopt(ref, af)
    _, got = port._write_run(port._af, ops, sched, masks, rep, node, wl, rd,
                             wr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(np.asarray(want)[0].sum()) > 0           # drains happened
    assert_same_state(ref, port)


def test_fence_pass_matches_reference():
    """The reference runs its fence pass only on the sharded fabric; the
    jitted pass itself is the oracle here."""
    ref, port = _loaded_pair(7)
    for f in (ref, port):
        f.write_batch([(k, f"{k}@q") for k in KEYS[:5]], replica=2)
    entries = [(kid, *port._meta[kid].tolist(), rep, wl, nd)
               for nd in range(2) for kid, _v, rep, wl in port._qmirror[nd]]
    assert entries
    rounds, sched = TP_.fence_schedule(entries)
    D = max(8, _next_pow2(len(entries)))
    R = max(4, _next_pow2(len(rounds)))
    sched = np.pad(sched, ((0, 0), (0, D - len(entries))))
    masks = TP_.round_masks(rounds, R, D)
    rd, wr = SMALL["rd_lease"], SMALL["wr_lease"]
    run = _build_fence_run(port._W1, port._W2, port._KS, 2, 4, port._Q)
    af, want, gmax = run(ref._af, jnp.asarray(sched), jnp.asarray(masks),
                         jnp.int32(rd), jnp.int32(wr))
    _adopt(ref, af)
    _, got, tgmax = port._fence_run(port._af, sched, masks, rd, wr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(tgmax) == int(jax.device_get(gmax))
    assert_same_state(ref, port)
