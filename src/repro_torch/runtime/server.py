"""Batched serving runtime on the lease fabric, on torch.

The port of ``repro.runtime.server``: requests are grouped into
fixed-size decode batches; shared prompt prefixes live in the
lease-coherent prefix cache (HALCONE semantics: reuse without
revalidation while the lease is live).  Each serve call issues ONE
batched lease probe for all its groups' prefix keys
(``BatchedKVLease.get_batch_async``), prefills each missing prefix once,
and posts their write-throughs as ONE ``put_batch``.  ``serve_stream``
dispatches wave N+1's probe before wave N's decode loop, so the fabric's
device work overlaps the decode; its results and fabric state equal
back-to-back ``serve`` calls.

The fabric payload of a prefix is ``(cache, first_ids)``: device tensors
that a later lease hit decodes from (a KV cache, or an SSM's final state
and conv tail).  The model never writes a cache it is given
(``layers.update_cache`` and ``ssm.ssm_apply`` build new tensors), so
decoding over a cached prefix leaves the payload other groups and
replicas read unchanged.  Every decode step brings its token ids to the host, as the
reference does.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.coherence.fabric import (FabricBackend, FabricConfig,
                                          default_fabric)
from repro_torch.coherence.fabric.backend import resolve_device
from repro_torch.coherence.kv_lease import BatchedKVLease
from repro_torch.models.model import (cast_params, decode_step, init_cache,
                                      prefill, tree_map)
from repro_torch.obs import trace as obs


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new: int = 8


def _prefix_key(tokens: np.ndarray) -> str:
    return hashlib.sha1(tokens.tobytes()).hexdigest()[:16]


class Server:
    def __init__(self, cfg, params, *, batch_size: int = 4,
                 max_len: int = 128,
                 fabric: Optional[FabricBackend] = None, replica: int = 0,
                 pipeline: Optional[str] = None, device=None):
        """``device`` (None = the CUDA card) is where the model runs and,
        when the server builds its own fabric, where the fabric runs.
        ``pipeline=`` applies only when the server builds its own fabric;
        an explicit fabric already carries its pipeline and device."""
        if fabric is not None and pipeline is not None:
            raise ValueError(
                "pipeline= only applies when Server builds its own fabric; "
                "construct the fabric with pipeline=... instead")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = cast_params(cfg, tree_map(
            lambda t: t.to(self.device), params))
        self.B, self.max_len = batch_size, max_len
        self.fabric = fabric if fabric is not None else default_fabric(
            FabricConfig(), pipeline=pipeline or "batched",
            device=self.device)
        self.kv = BatchedKVLease(self.fabric, replica=replica)

    def _prefill(self, prompts: np.ndarray):
        cache = init_cache(self.cfg, prompts.shape[0], self.max_len,
                           self.device)
        tokens = torch.from_numpy(np.ascontiguousarray(prompts)).to(
            self.device)
        first, cache = prefill(self.cfg, self.params, tokens, cache)
        return cache, first

    def _prefill_misses(self, keys: List[str],
                        prompts_by_key: Dict[str, np.ndarray],
                        leases: List) -> Dict[str, tuple]:
        """Prefill every missed prefix once; post ONE batched write-through."""
        filled: Dict[str, tuple] = {}
        with obs.span("serve.prefill", cat="serve"):
            for key, hit in zip(keys, leases):
                if hit is None and key not in filled:
                    cache, first = self._prefill(prompts_by_key[key])
                    obs.fence(first, "serve.prefill.device")
                    filled[key] = (cache, first)
        if filled:
            with obs.span("serve.put_batch", cat="serve",
                          n_filled=len(filled)):
                self.kv.put_batch(list(filled.items()))
        return filled

    def serve(self, requests: List[Request]) -> Dict[int, np.ndarray]:
        with obs.span("serve", cat="serve", n_requests=len(requests)):
            return self._serve(requests)

    def _group_wave(self, requests: List[Request]):
        """Group a wave into decode batches (pad the last one) and
        dispatch its batched lease probe (``kv.get_batch_async``)."""
        with obs.span("serve.group", cat="serve"):
            groups: List[List[Request]] = []
            for i in range(0, len(requests), self.B):
                group = requests[i:i + self.B]
                while len(group) < self.B:
                    group.append(Request(rid=-1, prompt=group[0].prompt))
                groups.append(group)
            prompts = [np.stack([g.prompt for g in group])
                       for group in groups]
            keys = [_prefix_key(p) for p in prompts]
        with obs.span("serve.lease_probe", cat="serve", n_groups=len(keys)):
            uniq = list(dict.fromkeys(keys))
            handle = self.kv.get_batch_async(uniq)
        return groups, prompts, keys, uniq, handle

    def _resolve_and_prefill(self, keys, prompts, uniq, handle):
        """Resolve the wave's probe handle and prefill + post the missed
        prefixes.  Must run before the next wave's probe dispatch — the
        fabric's handle ordering contract (resolve before the next
        write/fence)."""
        with obs.span("serve.lease_resolve", cat="serve"):
            leases_u = dict(zip(uniq, handle.result()))
            leases = [leases_u[k] for k in keys]
        filled = self._prefill_misses(keys, dict(zip(keys, prompts)), leases)
        return leases, filled

    def _decode_groups(self, groups, prompts, keys, leases,
                       filled) -> Dict[int, np.ndarray]:
        out: Dict[int, np.ndarray] = {}
        with obs.span("serve.decode", cat="serve"):
            for group, pr, key, hit in zip(groups, prompts, keys, leases):
                cache, nxt = hit[0] if hit is not None else filled[key]
                S = pr.shape[1]
                toks = [nxt.cpu().numpy()]
                max_new = max(g.max_new for g in group)
                for t in range(max_new - 1):
                    nxt, cache = decode_step(self.cfg, self.params, cache,
                                             nxt[:, None], S + t)
                    toks.append(nxt.cpu().numpy())
                gen = np.stack(toks, 1)                # [B, max_new]
                for j, g in enumerate(group):
                    if g.rid >= 0:
                        out[g.rid] = gen[j, :g.max_new]
        return out

    def _serve(self, requests: List[Request]) -> Dict[int, np.ndarray]:
        groups, prompts, keys, uniq, handle = self._group_wave(requests)
        leases, filled = self._resolve_and_prefill(keys, prompts, uniq,
                                                   handle)
        return self._decode_groups(groups, prompts, keys, leases, filled)

    def serve_stream(self, waves) -> Dict[int, np.ndarray]:
        """Pipelined serving over an iterable of request waves: resolve
        wave N's probe, prefill + post its misses, dispatch wave N+1's
        probe, then run wave N's decode loop.  Every fabric op happens in
        the order of back-to-back ``serve`` calls, so results and fabric
        state equal the sequential path."""
        out: Dict[int, np.ndarray] = {}
        pending = None
        with obs.span("serve_stream", cat="serve"):
            for wave in waves:
                if pending is None:
                    pending = self._group_wave(wave)
                    continue
                groups, prompts, keys, uniq, handle = pending
                leases, filled = self._resolve_and_prefill(
                    keys, prompts, uniq, handle)
                pending = self._group_wave(wave)     # overlaps the decode
                out.update(self._decode_groups(groups, prompts, keys,
                                               leases, filled))
            if pending is not None:
                groups, prompts, keys, uniq, handle = pending
                leases, filled = self._resolve_and_prefill(
                    keys, prompts, uniq, handle)
                out.update(self._decode_groups(groups, prompts, keys,
                                               leases, filled))
        return out

    @property
    def cache_stats(self):
        return dict(self.kv.stats)

    @property
    def fabric_stats(self):
        """Fabric-wide telemetry (engine.COUNTERS names + service extras)."""
        return self.fabric.stats()
