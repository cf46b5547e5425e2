"""Decode steps past the cache's end (ROADMAP Queue 3 F8), port against
reference on the CPU.

The reference writes a step's k and v with ``dynamic_update_slice``,
which clamps the start to ``[0, S_max - s]``: at ``pos >= max_len`` a step
overwrites the cache's last row, and its decode mask (``k_pos >= pos +
S``) then masks nothing.  The port clamps the start the same way
(``layers.update_cache``) and gives the decode ``kv_len = min(pos + S,
S_max)``, the same set of rows, which the card's ``decode_attention``
also takes.  Inputs come from numpy with a seed; weights are carried
across by ``convert``.  Tolerances: the f32 policy, as
``test_torch_models.py`` holds the same models (``F32``); every greedy id
equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as rlayers
from repro.models import model as rmodel
from repro_torch.models import layers
from repro_torch.models import model as tmodel
from test_torch_models import F32, _leaves, _models, _np, _tokens

PROMPT, MAX_LEN, STEPS = 16, 18, 5       # pos 16 .. 20: three past the end


@pytest.mark.parametrize("S_max,s,pos", [
    (18, 1, 16), (18, 1, 17), (18, 1, 18), (18, 1, 25), (18, 3, 16),
    (18, 3, 0), (18, 18, 0), (6, 2, 5)])
def test_update_cache_clamps_its_start_as_dynamic_update_slice(S_max, s,
                                                               pos):
    rng = np.random.default_rng(S_max + s + pos)
    cache = rng.standard_normal((2, S_max, 8)).astype(np.float32)
    new = rng.standard_normal((2, s, 8)).astype(np.float32)
    want = rlayers.update_cache(jnp.asarray(cache), jnp.asarray(new), pos)
    given = torch.from_numpy(cache.copy())
    got = layers.update_cache(given, torch.from_numpy(new), pos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(given, torch.from_numpy(cache))    # out of place


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-236b"])
def test_decode_past_the_cache_end_matches_reference(arch):
    """The smoke model under the f32 policy, 16-token prompts into a
    cache of 18 rows, five greedy decode steps (pos 16-20, the last three
    past the end): after every step the caches agree within ``F32`` and
    the ids are equal.  deepseek-v2 takes MLA's latent ``ckv`` cache and
    its absorbed decode."""
    rc, tc, rp, tp = _models(arch, "f32")
    B = 2
    tj, tt = _tokens(np.random.default_rng(3), rc, B, PROMPT)
    nr, cr = rmodel.prefill(rc, rp, tj, rmodel.init_cache(rc, B, MAX_LEN))
    nt, ct = tmodel.prefill(tc, tp, tt, tmodel.init_cache(tc, B, MAX_LEN,
                                                          "cpu"))
    decode = jax.jit(rmodel.decode_step, static_argnums=(0,))
    for step in range(STEPS):
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nr))
        pos = PROMPT + step
        nr, cr = decode(rc, rp, cr, nr[:, None], pos)
        nt, ct = tmodel.decode_step(tc, tp, ct, nt[:, None], pos)
        for (name, a), (_, b) in zip(_leaves(cr), _leaves(ct)):
            assert b.shape == a.shape and MAX_LEN in b.shape, name
            np.testing.assert_allclose(_np(b), _np(a), err_msg=f"{name} "
                                       f"after pos {pos}", **F32)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nr))
