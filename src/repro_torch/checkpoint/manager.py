"""Write-through checkpointing — the port of
``repro.checkpoint.manager``, with its on-disk format.

HALCONE's WT policy is what makes its timestamp overflow safe (MM always
has the data); this manager plays the MM role for the trainer: every
``period`` steps the whole state is written through to durable storage,
so any worker ("cache") can be lost and refilled.

On disk a checkpoint is ``step_%08d/state.npz``, one array per leaf
under its ``/``-path (dict keys in sorted order, NamedTuple fields in
order, list items by index) with ``/`` written as ``|``, beside
``meta.json`` — the reference's layout, so a checkpoint written by either
package restores in the other.  ``save`` snapshots the state to host
memory through pinned buffers, allocated at the first save and refilled
by every later one (the copies are enqueued on the stream, not waited
for: a copy from the card into pageable memory would stall the training
loop), and a background thread waits for them and writes the files.  ``restore`` puts each leaf on ``device``, or on its template
leaf's device.  numpy has no bfloat16: a bfloat16 leaf (the bf16-param
and bf16-moment policies of deepseek-v2 and llama4-maverick) is written
as its bits, an int16 array, with ``bfloat16`` as its dtype in
``meta.json``, and restored by viewing the bits, so it comes back bit
for bit; a template leaf whose dtype is bfloat16 where the checkpoint's
is not, or the other way round, raises.  (The reference writes such a
leaf as raw 2-byte records, which it cannot restore itself; the port
views those bits the same way.)
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.coherence.fabric.backend import to_device


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}")
    elif hasattr(tree, "_fields"):                    # NamedTuple
        for k in tree._fields:
            yield from _flatten(getattr(tree, k), f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _unflatten_into(template, flat: Dict[str, np.ndarray], device,
                    dtypes: Dict[str, str], prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat, device, dtypes,
                                   f"{prefix}/{k}")
                for k in sorted(template)}
    if hasattr(template, "_fields"):
        return type(template)(*[
            _unflatten_into(getattr(template, k), flat, device, dtypes,
                            f"{prefix}/{k}")
            for k in template._fields])
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_into(v, flat, device, dtypes, f"{prefix}/{i}")
            for i, v in enumerate(template))
    arr = flat[prefix]
    if isinstance(template, torch.Tensor):
        dev = template.device if device is None else torch.device(device)
        bf16 = dtypes[prefix] == "bfloat16"
        if bf16 != (template.dtype == torch.bfloat16):
            raise TypeError(f"{prefix}: the checkpoint's leaf is "
                            f"{dtypes[prefix]}, the template's "
                            f"{template.dtype}")
        if bf16:
            return to_device(arr.view(np.int16), dev).view(torch.bfloat16)
        return to_device(arr, dev)
    return arr


def _snapshot(state, bufs: Dict[str, torch.Tensor]):
    """Every leaf of ``state`` copied to host memory: CUDA tensors into
    the pinned buffers of ``bufs`` (by path; allocated on a path's first
    save or when its shape or dtype changes) with ``non_blocking=True``
    (one event marks the copies' end), CPU tensors cloned, anything else
    as a numpy array; a bfloat16 leaf as its bits (int16).  Returns
    ({path: host tensor or array}, event or None)."""
    flat, card = {}, None
    for path, leaf in _flatten(state):
        if not isinstance(leaf, torch.Tensor):
            flat[path] = np.array(leaf)
            continue
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.int16)
        if leaf.device.type == "cuda":
            buf = bufs.get(path)
            if buf is None or buf.shape != leaf.shape or \
                    buf.dtype != leaf.dtype:
                buf = bufs[path] = torch.empty(leaf.shape, dtype=leaf.dtype,
                                               pin_memory=True)
            buf.copy_(leaf, non_blocking=True)
            card = leaf.device
        else:
            buf = leaf.clone()
        flat[path] = buf
    if card is None:
        return flat, None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(card))
    return flat, event


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_write: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned: Dict[str, torch.Tensor] = {}   # reused across saves

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        """Write-through: snapshot to host memory (enqueued on the stream,
        not waited for), then persist in a background thread that waits
        for the copies (off the training critical path — HALCONE's
        TSU-parallel-to-DRAM placement, in spirit).  The previous save's
        write is waited for first: its thread reads the pinned buffers
        this snapshot refills, one set kept for the manager's life."""
        self.wait()
        bf16 = {p for p, leaf in _flatten(state)
                if isinstance(leaf, torch.Tensor)
                and leaf.dtype == torch.bfloat16}
        flat, event = _snapshot(state, self._pinned)

        def _write():
            if event is not None:
                event.synchronize()
            arrays = {p: (v.numpy() if isinstance(v, torch.Tensor) else v)
                      for p, v in flat.items()}
            meta = {"step": int(step), "time": time.time(),
                    "extra": extra or {},
                    "leaves": {p: [list(v.shape), "bfloat16" if p in bf16
                                   else str(v.dtype)]
                               for p, v in arrays.items()}}
            tmp = self.dir / f"step_{step:08d}.tmp"
            final = self.dir / f"step_{step:08d}"
            tmp.mkdir(parents=True, exist_ok=True)
            np.savez(tmp / "state.npz",
                     **{p.replace("/", "|"): v for p, v in arrays.items()})
            (tmp / "meta.json").write_text(json.dumps(meta))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)                       # atomic durability point
            self._gc()

        if self.async_write:
            def _run():
                try:
                    _write()
                except BaseException as e:     # raised again by wait()
                    self._error = e
            self._pending = threading.Thread(target=_run, daemon=True)
            self._pending.start()
        else:
            _write()

    def wait(self):
        """Wait for the background write; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        ckpts = sorted(self.dir.glob("step_*"))
        ckpts = [c for c in ckpts if c.is_dir() and not c.suffix == ".tmp"]
        for c in ckpts[:-self.keep]:
            shutil.rmtree(c, ignore_errors=True)

    # ---------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        self.wait()
        ckpts = sorted(self.dir.glob("step_*"))
        ckpts = [c for c in ckpts if c.is_dir() and not c.suffix == ".tmp"]
        if not ckpts:
            return None
        return int(ckpts[-1].name.split("_")[1])

    def restore(self, step: Optional[int], template: Any,
                device=None) -> Any:
        """Rebuild ``template``-structured state from checkpoint ``step``
        (None: the latest).  A tensor leaf comes back on ``device``, or on
        its template leaf's device when ``device`` is None, through
        pinned memory; any other leaf as a numpy array.  A tensor leaf
        that ``meta.json`` records as bfloat16 needs a bfloat16 template
        leaf, and the other way round."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        with np.load(path / "state.npz") as data:
            flat = {k.replace("|", "/"): data[k] for k in data.files}
        meta = json.loads((path / "meta.json").read_text())
        dtypes = {p: d for p, (_, d) in meta["leaves"].items()}
        return _unflatten_into(template, flat, device, dtypes)
