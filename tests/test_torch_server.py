"""The port's serving path (``repro_torch.runtime.server.Server``) against
``repro.runtime.server.Server``, on the CPU.

Both servers get the same weights (carried across with
``repro_torch.models.convert``) and the same request waves.  Under the
f32 policy the greedy tokens must be equal; the fabric sees only prefix
keys, so the lease-cache and fabric counters must be equal under any
policy.  The model runs at the smoke size of smollm-360m, and of
deepseek-v2 (MLA and MoE) and llama4-maverick (MoE) where named.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.models import init_model as r_init_model
from repro.models.config import Policy as RPolicy
from repro.runtime.server import Request as RRequest
from repro.runtime.server import Server as RServer
from repro_torch import configs as tcfgs
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models.config import Policy as TPolicy
from repro_torch.runtime.server import Request, Server

ARCH = "smollm-360m"


def _cfgs(f32: bool, arch=ARCH):
    rc, tc = rcfgs.SMOKE[arch], tcfgs.SMOKE[arch]
    if f32:
        rc = dataclasses.replace(rc, policy=RPolicy(
            compute_dtype=jnp.float32, cache_dtype=jnp.float32))
        tc = dataclasses.replace(tc, policy=TPolicy(
            compute_dtype=torch.float32, cache_dtype=torch.float32))
    return rc, tc


@pytest.fixture(scope="module")
def weights():
    """One set of reference weights, as jax arrays and as numpy."""
    rp = r_init_model(rcfgs.SMOKE[ARCH], jax.random.PRNGKey(1))
    return rp, jax.tree.map(np.asarray, rp)


def _servers(weights, f32, **kw):
    rc, tc = _cfgs(f32)
    rp, npp = weights
    make_r = lambda: RServer(rc, rp, batch_size=2, max_len=64, **kw)
    make_t = lambda: Server(tc, convert.params_from_numpy(tc, npp, "cpu"),
                            batch_size=2, max_len=64, device="cpu", **kw)
    return make_r, make_t


def _waves(seed, n_prompts, schedule, max_new=3, cls=Request):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, 256, 16).astype(np.int32)
               for _ in range(n_prompts)]
    return [[cls(rid=i, prompt=prompts[i % n_prompts], max_new=max_new)
             for i in wave] for wave in schedule]


def _serve_all(srv, waves):
    out = {}
    for wave in waves:
        out.update(srv.serve(wave))
    return out


def _assert_same_out(a, b):
    assert set(a) == set(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])


def test_serve_matches_reference_server_f32(weights):
    """Equal greedy tokens, lease-cache stats and fabric stats, and the
    cross-wave lease-hit path is taken."""
    make_r, make_t = _servers(weights, f32=True)
    # identical prompt composition per wave: waves 2-3 re-probe wave 1's
    # group keys
    sched = [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    out_r = _serve_all(srv_r := make_r(),
                       _waves(3, 3, sched, cls=RRequest))
    out_t = _serve_all(srv_t := make_t(), _waves(3, 3, sched))
    _assert_same_out(out_t, out_r)
    assert srv_t.cache_stats == srv_r.cache_stats
    assert srv_t.fabric_stats == srv_r.fabric_stats
    assert srv_t.cache_stats["hits"] >= 1


def test_serve_stream_matches_sequential_serve_and_reference(weights):
    """``serve_stream`` equals back-to-back ``serve`` calls (tokens and
    telemetry), and both equal the reference's ``serve_stream``."""
    make_r, make_t = _servers(weights, f32=True)
    sched = [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    out_seq = _serve_all(srv_seq := make_t(), _waves(3, 3, sched))
    out_str = (srv_str := make_t()).serve_stream(iter(_waves(3, 3, sched)))
    out_ref = (srv_ref := make_r()).serve_stream(
        iter(_waves(3, 3, sched, cls=RRequest)))
    _assert_same_out(out_str, out_seq)
    _assert_same_out(out_str, out_ref)
    assert srv_str.cache_stats == srv_seq.cache_stats == srv_ref.cache_stats
    assert srv_str.fabric_stats == srv_seq.fabric_stats == \
        srv_ref.fabric_stats
    assert srv_str.cache_stats["hits"] >= 1


def test_serve_stream_ragged_waves_match_sequential_serve(weights):
    """Empty waves, a singleton, non-pow2 waves and a final partial wave,
    in the default bf16 policy: the stream equals sequential serving, and
    the counters equal the reference's (the fabric sees only keys)."""
    make_r, make_t = _servers(weights, f32=False)
    sched = [[], [0], [1, 2, 3], [], [4, 5, 6, 7], [8]]
    waves = lambda cls=Request: _waves(7, 4, sched, cls=cls)
    out_seq = _serve_all(srv_seq := make_t(), waves())
    out_str = (srv_str := make_t()).serve_stream(iter(waves()))
    _assert_same_out(out_str, out_seq)
    assert set(out_seq) == set(range(9))
    assert all(v.shape == (3,) and v.dtype == np.int32
               for v in out_seq.values())
    assert srv_str.cache_stats == srv_seq.cache_stats
    assert srv_str.fabric_stats == srv_seq.fabric_stats
    srv_ref = make_r()
    _serve_all(srv_ref, waves(RRequest))
    assert srv_seq.cache_stats == srv_ref.cache_stats
    assert srv_seq.fabric_stats == srv_ref.fabric_stats


def test_prefix_payload_unchanged_by_decoding_from_it(weights):
    """A lease hit decodes from the cached ``(cache, first)`` payload; the
    decode must leave every tensor of it bit-identical."""
    _, make_t = _servers(weights, f32=False)
    srv = make_t()
    posted = []
    put = srv.kv.put_batch
    srv.kv.put_batch = lambda items: (posted.extend(items), put(items))
    waves = _waves(5, 2, [[0, 1], [2, 3], [4, 5]], max_new=5)
    out = srv.serve(waves[0])
    assert len(posted) == 1
    key, (cache, first) = posted[0]
    snap = [t.clone() for t in _tensors(cache)] + [first.clone()]
    out2 = srv.serve(waves[1])
    out3 = srv.serve(waves[2])
    assert len(posted) == 1 and srv.cache_stats["hits"] == 2
    for before, now in zip(snap, _tensors(cache) + [first]):
        assert torch.equal(before, now)
    assert not _tensors(cache)[0][:, :, 16:].any()    # nothing past the prompt
    for j in (0, 1):
        np.testing.assert_array_equal(out[j], out2[2 + j])
        np.testing.assert_array_equal(out[j], out3[4 + j])


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    return [tree]


def test_serve_launcher_on_cpu(capsys):
    srv, out = tserve.main(["--device", "cpu", "--requests", "8",
                            "--batch", "4", "--max-new", "4"])
    assert set(out) == set(range(8))
    assert srv.cache_stats["hits"] >= 1
    assert "lease-cache stats" in capsys.readouterr().out


def test_server_runs_on_the_card_by_default(weights):
    """``device=None`` means the CUDA card; without one the server raises
    instead of running on the CPU quietly."""
    _, tc = _cfgs(False)
    params = convert.params_from_numpy(tc, weights[1], "cpu")
    if torch.cuda.is_available():
        assert Server(tc, params).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Server(tc, params)


MOE_ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_server_matches_reference_f32(arch):
    """The smoke deepseek-v2 (MLA, its cache one ``ckv`` a layer; MoE) and
    llama4-maverick (MoE every other layer) behind the lease fabric under
    the f32 policy: equal tokens, lease-cache and fabric counters to the
    reference's, later waves from leases, and the leased cache payload
    bit-identical after decoding from it, nothing written past the
    prompt."""
    rc, tc = _cfgs(True, arch)
    rp = r_init_model(rcfgs.SMOKE[arch], jax.random.PRNGKey(2))
    srv_r = RServer(rc, rp, batch_size=2, max_len=64)
    srv_t = Server(tc, convert.params_from_numpy(
        tc, jax.tree.map(np.asarray, rp), "cpu"), batch_size=2, max_len=64,
        device="cpu")
    posted = []
    put = srv_t.kv.put_batch
    srv_t.kv.put_batch = lambda items: (posted.extend(items), put(items))
    sched = [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    out_r = _serve_all(srv_r, _waves(3, 3, sched, cls=RRequest))
    waves = _waves(3, 3, sched)
    out_t = srv_t.serve(waves[0])
    snap = [t.clone() for t in _tensors(posted[0][1][0])]
    for wave in waves[1:]:
        out_t.update(srv_t.serve(wave))
    _assert_same_out(out_t, out_r)
    assert srv_t.cache_stats == srv_r.cache_stats
    assert srv_t.fabric_stats == srv_r.fabric_stats
    assert srv_t.cache_stats["hits"] >= 1
    cache = posted[0][1][0]
    names = [k for k in _leaf_names(cache)]
    assert set(names) == ({"ckv"} if tc.is_mla else {"k", "v"})
    for before, now in zip(snap, _tensors(cache)):
        assert torch.equal(before, now)
        assert not now[..., 16:, :].any()       # nothing past the prompt


def _leaf_names(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaf_names(tree[k])
        else:
            yield k


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_launcher_runs_moe_archs_on_cpu(arch, capsys):
    """``launch.serve --arch deepseek-v2-236b`` (and llama4-maverick)
    serves its smoke config on the CPU: two waves, the second from
    leases."""
    srv, out = tserve.main(["--arch", arch, "--device", "cpu",
                            "--requests", "8", "--batch", "4",
                            "--max-new", "4"])
    assert set(out) == set(range(8))
    assert all(v.shape == (4,) for v in out.values())
    assert srv.cache_stats["hits"] >= 1
    assert "lease-cache stats" in capsys.readouterr().out
