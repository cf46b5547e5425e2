"""Fault-tolerant training runtime — the port of
``repro.runtime.trainer``.

Checkpoint/restart (the write-through manager), straggler detection (a
per-step wall-time watchdog with an EMA and a threshold), simulated node
failures and resume, optionally on another device or over a
``torch.distributed`` group (the counterpart of the reference's
``resume(mesh=)``: state is restored onto the new placement).  On a
(data, model) ``mesh`` (``launch.mesh.make_model_mesh``) the step is the
mesh step, the state this rank's shards of the seeded global init
(``models.model.init_model_shard``), and a checkpoint holds the global
tensors, gathered from the shards as the reference's holds its global
arrays; a resume on the same mesh restores them and takes its shards
again.  Re-meshing on resume under a mesh is not ported (ROADMAP item
25).  The
trainer owns the state it trains: ``step_fn`` (and so ``run``) writes
each step's weights and moments into the tensors of the state it is
given (``adamw.apply_updates`` is in place), the memory plan that lets a
state near the card's size train (deepseek-v2).  A checkpoint's snapshot
is enqueued on the stream before the next step's writes, so it holds the
step it was taken at.  Every
checkpoint publish is a batched write-through on the coherence fabric:
one ``write_batch`` re-stamps every parameter block under the
reference's keys, in its order, then a ``fence``, then the parameter
clock's ``mm_write`` — so the fabric's counters and grant log equal the
reference trainer's.  Runs on the CUDA card unless ``device`` says
otherwise.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.coherence.fabric import (FabricBackend, FabricConfig,
                                          default_fabric)
from repro_torch.coherence.fabric.backend import resolve_device
from repro_torch.coherence.lease_sync import LeaseClock
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_model
from repro_torch.models.comm import full_tree
from repro_torch.models.model import (init_model_shard, model_spec,
                                      param_placement, shard_model)
from repro_torch.models.params import P
from repro_torch.optim import adamw


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_period: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    straggler_ema: float = 0.9
    straggler_factor: float = 3.0       # step > factor*EMA => straggler event
    keep: int = 3


def param_keys(cfg) -> List[str]:
    """The fabric key of every parameter block, in the reference's order:
    ``"ckpt" + jax.tree_util.keystr(path)`` over the parameter tree with
    dict keys sorted (``ckpt['embed']``, ``ckpt['ln_f']``,
    ``ckpt['segments']['seg0']['0']['attn']['wk']``, ...).  Stacked
    layers share a block, so the keys do not depend on depth."""
    def walk(spec, path: Tuple[str, ...]):
        if isinstance(spec, P):
            yield "ckpt" + "".join(f"[{k!r}]" for k in path)
            return
        for k in sorted(spec):
            yield from walk(spec[k], path + (k,))
    return list(walk(model_spec(cfg), ()))


class Trainer:
    def __init__(self, cfg, opt: Optional[adamw.AdamWConfig] = None,
                 tcfg: TrainerConfig = TrainerConfig(),
                 data: Optional[SyntheticLM] = None,
                 fabric: Optional[FabricBackend] = None, device=None,
                 group=None, mesh=None):
        self.cfg, self.tcfg = cfg, tcfg
        self.opt = opt or adamw.AdamWConfig(total_steps=tcfg.total_steps)
        self.data = data
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        # every checkpoint publish is a parameter write-through on the
        # coherence fabric: eval readers hold the previous version on a
        # ckpt_period-step lease instead of being invalidated
        self.fabric = fabric if fabric is not None else default_fabric(
            FabricConfig(n_shards=1, max_in_flight=0), device=self.device)
        self.param_clock = LeaseClock(fabric=self.fabric)
        self.events: List[Dict] = []
        self.history: List[Tuple[int, float]] = []   # (step, loss) run
        self._ema = None
        self.mesh = mesh
        self._build(group)

    # --------------------------------------------------------- building
    def _build(self, group):
        self.group = group
        self.step_fn = make_train_step(self.cfg, self.opt, group=group,
                                       mesh=self.mesh)
        self.specs = None if self.mesh is None else param_placement(
            self.cfg, self.mesh)
        # stable per-parameter-block fabric keys: each checkpoint publish
        # re-stamps the SAME keys (a republish storm — eval readers
        # self-invalidate on lease expiry, never via invalidations)
        self._param_keys = param_keys(self.cfg)

    def init_state(self, seed: int = 0) -> adamw.TrainState:
        gen = torch.Generator(self.device).manual_seed(seed)
        params = (init_model(self.cfg, gen) if self.mesh is None
                  else init_model_shard(self.cfg, gen, self.mesh))
        return adamw.init_state(params, self.cfg.policy.moment_dtype)

    def global_state(self, state: adamw.TrainState) -> adamw.TrainState:
        """The state's global tensors: itself off a mesh, else its params
        and moments gathered from the mesh's shards (every rank calls
        it)."""
        if self.mesh is None:
            return state
        return state._replace(**{k: full_tree(getattr(state, k), self.specs,
                                              self.mesh)
                                 for k in ("params", "m", "v")})

    # ----------------------------------------------------------- loop
    def run(self, state: Optional[adamw.TrainState] = None,
            start_step: int = 0,
            fail_at: Optional[int] = None) -> Dict[str, Any]:
        """Train to total_steps.  fail_at simulates a node failure at that
        step (raises, then the caller — or resume() — restarts from the
        checkpoint).  Each step's loss is read on the host (one sync a
        step, as the reference's) and logged in ``history``."""
        if state is None:
            state = self.init_state()
        losses = []
        step = start_step
        while step < self.tcfg.total_steps:
            batch = self.data.batch(step)
            t0 = time.time()
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"simulated node failure at step {step}")
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            self._watch(step, dt)
            losses.append(loss)
            self.history.append((step, loss))
            step += 1
            if step % self.tcfg.ckpt_period == 0 or \
                    step == self.tcfg.total_steps:
                self.ckpt.save(step, self.global_state(state))
                # the checkpoint publish is a batched republish storm:
                # every parameter block's version stamp goes out as ONE
                # posted write_batch (the batched write pass) and the
                # fence drains + jumps the clocks, then the window lease
                # advances on the authority (mm_write)
                self.fabric.write_batch(
                    [(k, step) for k in self._param_keys], replica=0,
                    wr_lease=self.tcfg.ckpt_period)
                self.fabric.fence()
                lease = self.param_clock.on_sync(self.tcfg.ckpt_period,
                                                 version_tag=step)
                self.events.append({"kind": "param_lease", "step": step,
                                    "wts": int(lease.wts),
                                    "rts": int(lease.rts),
                                    "blocks": len(self._param_keys)})
        self.ckpt.wait()
        return {"state": state, "losses": losses, "events": self.events,
                "final_step": step,
                "fabric_stats": self.fabric.stats()}

    def resume(self, device=None, group=None,
               template: Optional[adamw.TrainState] = None,
               **kw) -> Dict[str, Any]:
        """Restart from the latest checkpoint — optionally on another
        ``device`` or over a ``torch.distributed`` ``group`` (elastic
        scaling after node loss): the step is rebuilt and the state
        restored onto the new placement."""
        if self.mesh is not None and (device is not None
                                      or group is not None):
            raise NotImplementedError("re-meshing a mesh trainer on resume "
                                      "is not ported")
        if device is not None or group is not None:
            if device is not None:
                self.device = resolve_device(device)
            self._build(group)
            self.events.append({"kind": "elastic_remesh", "devices": (
                1 if group is None else dist.get_world_size(group))})
        step = self.ckpt.latest_step()
        if self.mesh is not None:
            # the checkpoint's global tensors, on the host, then this
            # rank's shards of them
            spec = model_spec(self.cfg)
            pol = self.cfg.policy
            meta = lambda dt: adamw.tree_map(lambda _: torch.empty(
                0, dtype=dt, device="meta"), spec)
            glob = self.ckpt.restore(step, adamw.TrainState(
                meta(pol.param_dtype), meta(pol.moment_dtype),
                meta(pol.moment_dtype), torch.empty(0, dtype=torch.int32)),
                device="cpu")
            state = adamw.TrainState(*(adamw.tree_map(
                lambda t: t.to(self.device),
                shard_model(self.cfg, getattr(glob, k), self.mesh))
                for k in ("params", "m", "v")),
                step=glob.step.to(self.device))
            self.events.append({"kind": "restore", "step": step})
            return self.run(state=state, start_step=step, **kw)
        if template is None:
            template = self.init_state()
        state = self.ckpt.restore(step, template, device=self.device)
        self.events.append({"kind": "restore", "step": step})
        return self.run(state=state, start_step=step, **kw)

    # ------------------------------------------------------- watchdog
    def _watch(self, step: int, dt: float):
        if self._ema is None:
            self._ema = dt
            return
        if dt > self.tcfg.straggler_factor * self._ema and step > 3:
            self.events.append({"kind": "straggler", "step": step,
                                "dt": dt, "ema": self._ema})
        a = self.tcfg.straggler_ema
        self._ema = a * self._ema + (1 - a) * dt


def steady_events(events: List[dict], factor: float) -> List[dict]:
    """The events that another run of the same steps logs again: all but
    the watchdog's straggler events, which read the run's own wall clock
    (two runs on different devices, packages or loads need not log the
    same ones).  Raises if a straggler event breaks the watchdog's rule: a
    step after the third slower than ``factor`` x the moving average."""
    bad = [e for e in events if e["kind"] == "straggler"
           and not (e["step"] > 3 and e["dt"] > factor * e["ema"])]
    if bad:
        raise ValueError(f"straggler events outside the watchdog's rule "
                         f"(step > 3, dt > {factor} x ema): {bad}")
    return [e for e in events if e["kind"] != "straggler"]
