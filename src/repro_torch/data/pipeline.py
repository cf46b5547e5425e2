"""Deterministic synthetic data pipeline — the port's copy of
``repro.data.pipeline`` (pure numpy; batches bit-equal to the
reference's).

Seeded, shardable, restartable: batch ``i`` is a pure function of (seed,
i), so a restarted job resumes mid-epoch with no state beyond the step
counter (write-through semantics, the property HALCONE gets from WT
caches).  Per-host slicing takes rows ``host_index * B .. + B`` of the
global batch.  Batches are numpy arrays; the train step moves them to
its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.runtime.loadgen import bounded_zipf


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 1234
    n_docs: int = 4096          # synthetic corpus size
    mean_doc_len: int = 512
    host_index: int = 0
    host_count: int = 1


class SyntheticLM:
    """Zipf-distributed token stream with document structure (BOS=0, EOS=1).

    Statistically language-like enough to drive loss-goes-down training runs
    and data-pipeline tests without an external corpus.
    """

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dcfg
        if dcfg.global_batch % dcfg.host_count:
            raise ValueError(f"global batch {dcfg.global_batch} does not "
                             f"split over {dcfg.host_count} hosts")
        self.local_batch = dcfg.global_batch // dcfg.host_count

    def _doc(self, doc_id: int) -> np.ndarray:
        rng = np.random.default_rng((self.dcfg.seed, doc_id))
        n = max(8, int(rng.exponential(self.dcfg.mean_doc_len)))
        # Zipf body tokens in [2, vocab); simple bigram structure for signal.
        # bounded_zipf samples the truncated law exactly — numpy's
        # rng.zipf % n wraps the unbounded tail and flattens the skew.
        base = bounded_zipf(self.cfg.vocab - 2, 1.3).sample(rng, size=n) + 2
        shift = (doc_id * 7919) % (self.cfg.vocab - 2) + 2
        base[1::2] = (base[:-1:2] + shift) % (self.cfg.vocab - 2) + 2
        return np.concatenate([[0], base, [1]]).astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        B, S = self.local_batch, self.dcfg.seq_len
        out = np.empty((B, S), np.int32)
        for b in range(B):
            row = self.dcfg.host_index * B + b
            rng = np.random.default_rng((self.dcfg.seed, step, row))
            doc = int(rng.integers(self.dcfg.n_docs))
            buf = self._doc(doc)
            while len(buf) < S:
                doc = (doc + 1) % self.dcfg.n_docs
                buf = np.concatenate([buf, self._doc(doc)])
            start = int(rng.integers(max(1, len(buf) - S)))
            out[b] = buf[start:start + S]
        batch = {"tokens": out}
        if self.cfg.frontend == "audio":
            rng = np.random.default_rng((self.dcfg.seed, step, 999))
            batch = {"frames": rng.standard_normal(
                         (B, S, self.cfg.d_frontend)).astype(np.float32),
                     "labels": out % self.cfg.vocab}
        elif self.cfg.frontend == "vision":
            rng = np.random.default_rng((self.dcfg.seed, step, 998))
            batch["patches"] = (rng.standard_normal(
                (B, self.cfg.n_patch_tokens, self.cfg.d_model))
                .astype(np.float32) * 0.02)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
