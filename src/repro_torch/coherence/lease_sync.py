"""Lease-synchronized data parallelism — HALCONE's insight applied to
distributed training; the port of ``repro.coherence.lease_sync``.

Mapping: parameters are the shared cache blocks, each data-parallel
worker is a GPU with logical clock cts = its local step count, the
parameter all-reduce is the write-through, and ``wr_lease`` is the
number of local steps a worker may run on its cached (stale) parameters
before the lease expires and a sync refreshes them.  wr_lease=1 is exact
synchronous DP; wr_lease=W cuts the collective bytes by ~W at bounded
staleness (local SGD with Lamport ordering — timestamps from the
coherence fabric).

Two implementations:
  * ``make_lease_window_step`` — over a ``torch.distributed`` group (the
    port's fabric group, ``launch.mesh.make_fabric_group``): W local
    AdamW steps per window on each rank, then ONE flattened f32
    ``all_reduce`` of params, m and v, divided by the world size.
  * ``VmappedWorkers`` — n workers as a leading ``[n]`` axis of the
    state in one process, stepped one worker at a time (the kernels'
    ``autograd.Function``s take a batch dim already and have no vmap
    rule); used to check the math (W=1 == sync DP).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.coherence.fabric.backend import resolve_device
from repro_torch.core import protocol
from repro_torch.models import model as M
from repro_torch.models.training import (all_reduce_mean, device_batch,
                                         loss_and_grads)
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class LeaseConfig:
    wr_lease: int = 4            # local steps between write-throughs
    rd_lease: int = 4            # eval/readers may be this stale (steps)


class LeaseClock:
    """Lamport bookkeeping for the parameter store (host-level).

    Thin adapter over the coherence fabric: the parameter blob is one
    block in the TSU service, and every window's write-through is an
    authority ``mm_write`` — so training's clock shares the 16-bit
    overflow reinit and the telemetry of the serving path instead of
    re-deriving the rules.  Takes any ``FabricBackend`` (default: the
    port's single-device array fabric on ``device``, None = the card);
    the host ``TSUFabric`` is accepted too, for the oracle tests.
    """

    PARAM_KEY = "params"

    def __init__(self, fabric=None, device=None):
        from repro_torch.coherence.fabric import FabricConfig, default_fabric
        self.fabric = fabric if fabric is not None else default_fabric(
            FabricConfig(n_shards=1, max_in_flight=0), device=device)

    @property
    def memts(self) -> int:
        return self.fabric.memts(self.PARAM_KEY)

    def on_sync(self, wr_lease: int, version_tag=None) -> protocol.Lease:
        from repro_torch.coherence.fabric import FabricBackend
        if isinstance(self.fabric, FabricBackend):
            wts, rts, _ = self.fabric.mm_write(self.PARAM_KEY, version_tag,
                                               wr_lease=wr_lease)
            return protocol.Lease(wts, rts)  # the new param version
        grant = self.fabric.write(self.PARAM_KEY, version_tag,
                                  wr_lease=wr_lease)
        return protocol.Lease(grant.wts, grant.rts)


def _local_step(cfg, opt, state: adamw.TrainState, batch):
    loss, _, grads = loss_and_grads(cfg, state.params, batch)
    return adamw.apply_updates(opt, state, grads), loss


def make_lease_window_step(cfg, opt: adamw.AdamWConfig, lease: LeaseConfig,
                           group=None):
    """Lease-synced training over a ``torch.distributed`` group (default:
    the whole world): each rank runs ``wr_lease`` local steps on its lease
    of the parameters, then one write-through — a single flattened f32
    ``all_reduce`` of params, m and v over the group, divided by its size
    (the step counter is the same on every rank and is not sent).

    ``window_step(state, batches)``: ``batches`` leaves ``[W, B_rank,
    S]`` (this rank's rows); returns (state, mean loss of the window as a
    host float).  The local steps update ``state``'s tensors in place
    (``adamw.apply_updates``)."""
    W = lease.wr_lease
    grp = dist.group.WORLD if group is None else group

    def window_step(state: adamw.TrainState, batches):
        dev = state.step.device
        losses = []
        for w in range(W):
            state, loss = _local_step(cfg, opt, state, device_batch(
                {k: v[w] for k, v in batches.items()}, dev))
            losses.append(loss)
        trees = (state.params, state.m, state.v)
        leaves = [t for tree in trees for t in adamw.tree_leaves(tree)]
        avg = iter(all_reduce_mean(leaves, grp))
        params, m, v = (adamw.tree_unflatten(tree, avg) for tree in trees)
        return (adamw.TrainState(params, m, v, state.step),
                float(torch.stack(losses).mean()))

    return window_step


class VmappedWorkers:
    """n_workers as a leading array axis on one device — the testable
    equivalent of the lease window.  ``params`` (one worker's tree) sets
    the start; by default the model is initialised from ``seed`` on
    ``device`` (None = the card)."""

    def __init__(self, cfg, opt: adamw.AdamWConfig, lease: LeaseConfig,
                 n_workers: int, seed: int = 0, device=None,
                 params: Optional[dict] = None):
        self.cfg, self.opt, self.lease = cfg, opt, lease
        self.n = n_workers
        dev = resolve_device(device)
        if params is None:
            params = M.init_model(cfg, torch.Generator(dev).manual_seed(seed))
        p0 = adamw.tree_map(lambda x: x.to(dev), params)
        rep = lambda x: x[None].expand((n_workers,) + x.shape).clone()
        zeros = lambda x: torch.zeros((n_workers,) + x.shape,
                                      dtype=cfg.policy.moment_dtype,
                                      device=dev)
        self.state = adamw.TrainState(
            params=adamw.tree_map(rep, p0), m=adamw.tree_map(zeros, p0),
            v=adamw.tree_map(zeros, p0),
            step=torch.zeros((n_workers,), dtype=torch.int32, device=dev))
        self.clock = LeaseClock(device=dev)
        self.local_steps = 0
        self.collective_bytes = 0         # accounting for the lease claim

    def _worker(self, i: int) -> adamw.TrainState:
        s = self.state
        pick = lambda x: x[i]
        return adamw.TrainState(adamw.tree_map(pick, s.params),
                                adamw.tree_map(pick, s.m),
                                adamw.tree_map(pick, s.v), s.step[i])

    def step(self, batches) -> float:
        """batches: per-worker batch dict with a leading [n_workers] dim."""
        dev = self.state.step.device
        outs, losses = [], []
        for i in range(self.n):
            st, loss = _local_step(self.cfg, self.opt, self._worker(i),
                                   device_batch({k: v[i] for k, v in
                                                 batches.items()}, dev))
            outs.append(st)
            losses.append(loss)
        stack = lambda *xs: torch.stack(xs)
        self.state = adamw.TrainState(
            *(adamw.tree_map(stack, *(getattr(o, f) for o in outs))
              for f in ("params", "m", "v")),
            step=torch.stack([o.step for o in outs]))
        self.local_steps += 1
        if self.local_steps % self.lease.wr_lease == 0:
            self.state = self._sync(self.state)
            self.clock.on_sync(self.lease.wr_lease)
            self.collective_bytes += sum(
                x.numel() * x.element_size() // self.n
                for x in adamw.tree_leaves(self.state.params))
        return float(torch.stack(losses).mean())

    @staticmethod
    def _sync(state: adamw.TrainState) -> adamw.TrainState:
        # each worker's row a tensor of its own: the next local step
        # updates the rows in place, so they must not be one broadcast
        avg = lambda x: x.to(torch.float32).mean(0, keepdim=True).to(
            x.dtype).expand(x.shape).contiguous()
        return adamw.TrainState(adamw.tree_map(avg, state.params),
                                adamw.tree_map(avg, state.m),
                                adamw.tree_map(avg, state.v), state.step)
