"""Deterministic, resumable host data pipeline for probing-model training;
counterpart of ``repro/data/pipeline.py``'s ``PipelineSpec`` and
``ProbingPipeline``.

Every batch is a pure numpy function of (seed, step, host_id): there is no
iterator state to checkpoint. After a restart, training resumes at step N
and the pipeline regenerates exactly the batches it would have produced,
equal bit for bit to the reference's.
"""
from __future__ import annotations

import dataclasses

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
