"""Baselines from the paper (§4.1): IVF, IVFFuzzy, IVFPQ, BLISS-lite;
counterpart of ``repro/core/baselines.py``.

All share the PartitionStore and the evaluation engine (``core/retrieval``),
so the accounting (recall / cmp / nprobe) is identical across methods: only
the probe policy and the store construction differ, as in the paper.

Every build function runs on ``device`` (default: x's device when it is a
tensor, else the card, raising when there is none). k-means starts from
k-means++ on ``generator`` or, where a caller passes it, from the given
starting centroids ``init``, so a test can start the port and the reference
from the same point (the random streams of the two packages differ).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import pq as pqmod
from repro_torch.core.kmeans import KMeansState, centroid_distances, kmeans_fit, lloyd, segment_sum
from repro_torch.core.partitions import PartitionStore, build_store
from repro_torch.train.optimizer import AdamW
from repro_torch.utils.device import input_device


def _kmeans(x: torch.Tensor, b: int, n_iters: int, generator, init) -> KMeansState:
    if init is not None:
        return lloyd(x, torch.as_tensor(init, dtype=torch.float32, device=x.device), n_iters)
    if generator is None:
        raise ValueError("pass a generator (k-means++ start) or init (starting centroids)")
    return kmeans_fit(x, b, n_iters, generator=generator)


def build_ivf(x, b: int, *, n_iters: int = 20, generator: Optional[torch.Generator] = None,
              init=None, device=None) -> PartitionStore:
    """Vanilla IVF (Faiss IVFFlat equivalent): K-Means + nearest-centroid lists."""
    dev = input_device(device, x)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    st = _kmeans(xt, b, n_iters, generator, init)
    ids = np.arange(len(xt), dtype=np.int32)
    return build_store(xt, ids, st.assign, st.centroids)


def build_ivf_fuzzy(x, b: int, *, n_iters: int = 20, generator: Optional[torch.Generator] = None,
                    init=None, device=None) -> PartitionStore:
    """IVFFuzzy: every point goes to its TWO nearest clusters (paper §4.1)."""
    dev = input_device(device, x)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    st = _kmeans(xt, b, n_iters, generator, init)
    d2 = centroid_distances(xt, st.centroids)
    near2 = torch.sort(d2, dim=1, stable=True).indices[:, :2]
    ids = np.arange(len(xt), dtype=np.int32)
    return build_store(xt, ids, near2[:, 0], st.centroids, extra=(xt, ids, near2[:, 1]))


class IVFPQIndex(NamedTuple):
    store: PartitionStore          # reconstructed vectors (ADC-exact evaluation)
    pq: pqmod.PQCodebook
    codes: np.ndarray              # [N, m]
    assign: np.ndarray             # [N] int32


def build_ivfpq(x, b: int, *, m: int = 16, ks: int = 256, n_iters: int = 20,
                generator: Optional[torch.Generator] = None, init=None, pq_init=None,
                device=None) -> IVFPQIndex:
    """IVFPQ with residual encoding: the store holds centroid + decode(PQ(residual)),
    so ``partition_topk`` over it ranks exactly as LUT-based ADC. ``pq_init``
    [m, ks, d_sub] starts the codebooks' k-means (else k-means++ on
    ``generator``)."""
    dev = input_device(device, x)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    st = _kmeans(xt, b, n_iters, generator, init)
    assign, cents = st.assign.long(), st.centroids
    resid = xt - cents[assign]
    if pq_init is None and generator is None:
        raise ValueError("pass a generator or pq_init for the PQ codebooks")
    book = pqmod.train_pq(resid, m=m, ks=ks, generator=generator, init=pq_init)
    codes = pqmod.encode(book, resid)
    recon = cents[assign] + pqmod.decode(book, codes)
    ids = np.arange(len(xt), dtype=np.int32)
    store = build_store(recon, ids, assign, cents)
    return IVFPQIndex(store=store, pq=book, codes=codes.cpu().numpy(),
                      assign=st.assign.cpu().numpy())


# ------------------------------------------------------------------ BLISS-lite

class BlissMLP(nn.Module):
    """BLISS's routing MLP: ``nn.Linear`` layers with ReLU between them and
    none after the last. Weights are He-normal (std sqrt(2/fan_in)) from
    ``generator``, biases zero: the reference's init, not its numbers."""

    def __init__(self, sizes: Sequence[int], *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b, device=device)
                                    for a, b in zip(sizes[:-1], sizes[1:]))
        with torch.no_grad():
            for layer in self.layers:
                w = torch.randn(layer.weight.shape, generator=generator, device=device)
                layer.weight.copy_(w * (2.0 / layer.in_features) ** 0.5)
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i + 1 < len(self.layers):
                x = F.relu(x)
        return x

    @classmethod
    def from_jax(cls, params, device=None) -> "BlissMLP":
        """The MLP carrying the reference's ``[{"w": [in, out], "b": [out]}, ...]``
        (numpy leaves)."""
        sizes = [int(np.shape(params[0]["w"])[0])] + [int(np.shape(p["w"])[1]) for p in params]
        mlp = cls(sizes, device=device)
        with torch.no_grad():
            for layer, p in zip(mlp.layers, params):
                layer.weight.copy_(torch.as_tensor(np.asarray(p["w"], np.float32)).T)
                layer.bias.copy_(torch.as_tensor(np.asarray(p["b"], np.float32)))
        return mlp


class BlissGroup(NamedTuple):
    store: PartitionStore
    model: BlissMLP               # routing MLP
    assign: np.ndarray            # [N] int32


def build_bliss(
    x,
    b: int,
    *,
    n_groups: int = 4,
    knn_ids: np.ndarray | None = None,
    reparts: int = 2,
    epochs: int = 3,
    hidden: int = 128,
    generator: Optional[torch.Generator] = None,
    init=None,
    device=None,
) -> list[BlissGroup]:
    """BLISS (Gupta et al. KDD'22), reduced: ``n_groups`` independent
    (model, partition) pairs trained by iterative re-partitioning — the model
    learns to map a point to the partitions of its kNN, points are reassigned
    to their argmax partition, repeat. knn_ids: precomputed kNN of x (for the
    learning signal); falls back to one-hot labels of the current assignment
    when absent.

    Each group's random start (a uniform assignment over ``b`` partitions and
    the MLP's weights) comes from ``generator``, or from ``init``: one
    ``(assign [N], mlp params as BlissMLP.from_jax takes them)`` a group.
    Its epochs shuffle with ``np.random.default_rng(g)``, as the reference's
    do, so from the same start both see the same batches."""
    dev = input_device(device, x)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    n, d = xt.shape
    knn = None if knn_ids is None else torch.as_tensor(knn_ids, device=dev).long()
    groups = []
    for g in range(n_groups):
        if init is not None:
            assign = torch.as_tensor(np.asarray(init[g][0]), device=dev).long()
            mlp = BlissMLP.from_jax(init[g][1], device=dev)
        else:
            if generator is None:
                raise ValueError("pass a generator or init for BLISS's random starts")
            assign = torch.randint(b, (n,), generator=generator, device=dev)
            mlp = BlissMLP((d, hidden, b), generator=generator, device=dev)
        params = list(mlp.parameters())
        tx = AdamW(params, 1e-3)
        host = np.random.default_rng(g)
        for _ in range(reparts):
            # labels: distribution over partitions of the point's kNN (soft);
            # counts of small integers, so the sums are exact in any order
            if knn is not None:
                lab = torch.zeros((n, b), dtype=torch.float32, device=dev)
                rows = torch.arange(n, device=dev).repeat_interleave(knn.shape[1])
                lab.index_put_((rows, assign[knn].reshape(-1)),
                               torch.ones(rows.shape[0], device=dev), accumulate=True)
                lab /= lab.sum(-1, keepdim=True)
            else:
                lab = F.one_hot(assign, b).float()
            for _ in range(epochs):
                perm = host.permutation(n)
                for s in range(0, n - 511, 512):
                    sel = torch.as_tensor(perm[s:s + 512], device=dev)
                    logp = F.log_softmax(mlp(xt[sel]), dim=-1)
                    loss = -(lab[sel] * logp).sum(-1).mean()
                    tx.update(torch.autograd.grad(loss, params))
            # re-partition: argmax of model scores (BLISS's unbalanced step)
            with torch.no_grad():
                assign = mlp(xt).argmax(-1)

        # centroids for bookkeeping (means of final groups; empty -> zeros)
        counts = torch.bincount(assign, minlength=b).float()
        cents = segment_sum(xt, assign, b) / counts.clamp_min(1.0)[:, None]
        ids = np.arange(n, dtype=np.int32)
        store = build_store(xt, ids, assign, cents)
        groups.append(BlissGroup(store=store, model=mlp,
                                 assign=assign.to(torch.int32).cpu().numpy()))
    return groups


@torch.no_grad()
def bliss_scores(group: BlissGroup, queries) -> np.ndarray:
    """The group's routing logits for ``queries`` [Q, B], on the model's device."""
    dev = next(group.model.parameters()).device
    q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
    return group.model(q).cpu().numpy()
