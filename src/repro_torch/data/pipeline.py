"""Deterministic, resumable host data pipeline; counterpart of
``repro/data/pipeline.py``'s ``PipelineSpec``, ``TokenPipeline``,
``ProbingPipeline`` and ``RecsysPipeline``.

Every batch is a pure numpy function of (seed, step, host_id): there is no
iterator state to checkpoint. After a restart, training resumes at step N
and the pipeline regenerates exactly the batches it would have produced,
equal bit for bit to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not split over "
                             f"{self.n_hosts} hosts")
        return self.global_batch // self.n_hosts


class TokenPipeline:
    """Next-token LM batches from a synthetic Zipf token stream: int32
    ``tokens`` and ``labels`` [host_batch, seq_len], labels one ahead."""

    def __init__(self, spec: PipelineSpec, seq_len: int, vocab: int):
        self.spec = spec
        self.seq_len = seq_len
        self.vocab = vocab

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.spec.seed, step, self.spec.host_id))
        toks = np.minimum(rng.zipf(1.3, (self.spec.host_batch, self.seq_len + 1)),
                          self.vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ProbingPipeline:
    """Probing-model training batches: samples (query, cent_dist, labels) rows
    from a precomputed label matrix; deterministic per step."""

    def __init__(self, spec: PipelineSpec, x: np.ndarray, cent_dist: np.ndarray, labels: np.ndarray):
        self.spec = spec
        self.x, self.cd, self.labels = x, cent_dist, labels

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.spec.seed, step, self.spec.host_id))
        sel = rng.integers(0, len(self.x), self.spec.host_batch)
        return {"q": self.x[sel], "cent_dist": self.cd[sel], "labels": self.labels[sel]}


class RecsysPipeline:
    """Click-log batches of ``make_recsys_batch``: int32 ``sparse_ids``
    [host_batch, n_sparse, nnz], f32 ``label`` and, with dense features,
    ``dense``. The reference's fields only: no MIND history."""

    def __init__(self, spec: PipelineSpec, config):
        self.spec = spec
        self.cfg = config

    def batch_at(self, step: int) -> dict:
        from repro_torch.data.synthetic import make_recsys_batch

        rng = np.random.default_rng((self.spec.seed, step, self.spec.host_id))
        b = make_recsys_batch(rng, self.spec.host_batch, self.cfg.n_dense,
                              self.cfg.n_sparse, self.cfg.vocab_per_field,
                              multi_hot=self.cfg.nnz)
        out = {"sparse_ids": b["sparse_ids"], "label": b["label"]}
        if self.cfg.n_dense:
            out["dense"] = b["dense"]
        return out
