"""Graph batch construction for DimeNet: padding, triplet alignment, sampling
(counterpart of ``repro/data/graph.py``; numpy only, the reference's bytes).

Triplets are sorted so that triplet t lives on the shard owning edge ji[t]
(the reference's layout for its edge-sharded mesh: the triplet→edge segment
sum needs no collective there); ``trip_ji_local`` holds the LOCAL edge offset
within that shard, whose rank ``models.dimenet`` gives the shard's edges.
With ``n_shards`` 1 the local offset is the edge id.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import build_triplets, make_geometric_graph


def _pad_to(n, mult):
    return int(-(-n // mult) * mult)


def build_graph_batch(
    rng,
    *,
    n_nodes: int,
    n_edges: int,
    d_feat: int,
    triplet_mult: int,
    n_graphs: int = 1,
    n_shards: int = 1,
    avg_degree: int | None = None,
):
    """Returns a dict matching dimenet.make_bundle's input_specs (real data):
    numpy arrays, int32 indices and masks, f32 positions and targets."""
    host = np.random.default_rng(rng if isinstance(rng, int) else 0)
    total_nodes = n_nodes * n_graphs
    deg = avg_degree or max(1, n_edges // max(n_nodes, 1))

    pos_l, ei_l = [], []
    for g in range(n_graphs):
        p, _, ei = make_geometric_graph(host, n_nodes, deg, d_feat=1)
        pos_l.append(p)
        ei_l.append(ei + g * n_nodes)
    pos = np.concatenate(pos_l)
    ei = np.concatenate(ei_l, axis=1)
    # trim/pad edges to the target count
    e_target = _pad_to(n_edges * n_graphs, max(n_shards, 256) if total_nodes > 64 else n_shards)
    if ei.shape[1] > e_target:
        ei = ei[:, :e_target]
    src, dst = ei
    e_real = ei.shape[1]

    kj, ji = build_triplets(ei, max_triplets=triplet_mult * e_real)
    t_target = _pad_to(max(len(kj), 1), max(n_shards, 256) if total_nodes > 64 else n_shards)
    t_target = max(t_target, _pad_to(triplet_mult * e_real, n_shards))

    # pad edges
    e_pad = _pad_to(e_real, n_shards)
    src_p = np.zeros(e_pad, np.int32); src_p[:e_real] = src
    dst_p = np.zeros(e_pad, np.int32); dst_p[:e_real] = dst
    emask = np.zeros(e_pad, np.int32); emask[:e_real] = 1

    # align triplets with the shard of their ji edge
    e_loc = e_pad // n_shards
    owner = ji // e_loc
    order = np.argsort(owner, kind="stable")
    kj, ji = kj[order], ji[order]
    # pad per-shard so each shard gets t_loc triplets holding only its edges
    t_loc = t_target // n_shards
    kj_p = np.zeros(t_target, np.int32)
    ji_p = np.zeros(t_target, np.int32)
    jil_p = np.zeros(t_target, np.int32)
    tmask = np.zeros(t_target, np.int32)
    for s in range(n_shards):
        sel = np.where(owner[order] == s)[0][:t_loc]
        out0 = s * t_loc
        nsel = len(sel)
        kj_p[out0 : out0 + nsel] = kj[sel]
        ji_p[out0 : out0 + nsel] = ji[sel]
        jil_p[out0 : out0 + nsel] = ji[sel] - s * e_loc
        tmask[out0 : out0 + nsel] = 1

    batch = {
        "pos": pos.astype(np.float32),
        "src": src_p, "dst": dst_p, "edge_mask": emask,
        "trip_kj": kj_p, "trip_ji": ji_p, "trip_ji_local": jil_p, "trip_mask": tmask,
        "node_mask": np.ones(total_nodes, np.int32),
        "target": host.normal(0, 1, total_nodes).astype(np.float32),
    }
    if d_feat > 0:
        batch["feat"] = host.normal(0, 1, (total_nodes, d_feat)).astype(np.float32)
    else:
        batch["z"] = host.integers(0, 100, total_nodes).astype(np.int32)
    return batch


class NeighborSampler:
    """CSR uniform fanout sampler (GraphSAGE-style) for minibatch training.

    Produces padded subgraph batches with the same layout as build_graph_batch;
    deterministic given (seed, step), so a restart resamples the same batch.
    """

    def __init__(self, n_nodes: int, edge_index: np.ndarray, fanout=(15, 10), seed: int = 0):
        src, dst = edge_index
        order = np.argsort(dst, kind="stable")
        self.nbr = src[order]
        counts = np.bincount(dst, minlength=n_nodes)
        self.offsets = np.concatenate([[0], np.cumsum(counts)])
        self.n_nodes = n_nodes
        self.fanout = fanout
        self.seed = seed

    def sample(self, step: int, batch_nodes: int):
        rng = np.random.default_rng((self.seed, step))
        seeds = rng.integers(0, self.n_nodes, batch_nodes)
        nodes = [seeds]
        edges_src, edges_dst = [], []
        frontier = seeds
        for f in self.fanout:
            nxt = []
            for u in frontier:
                lo, hi = self.offsets[u], self.offsets[u + 1]
                if hi == lo:
                    continue
                take = rng.integers(lo, hi, min(f, hi - lo))
                nb = self.nbr[take]
                nxt.append(nb)
                edges_src.append(nb)
                edges_dst.append(np.full(len(nb), u))
            frontier = np.concatenate(nxt) if nxt else np.empty(0, np.int64)
            nodes.append(frontier)
        all_nodes = np.unique(np.concatenate(nodes))
        remap = {int(g): i for i, g in enumerate(all_nodes)}
        es = np.array([remap[int(x)] for x in np.concatenate(edges_src)] if edges_src else [], np.int32)
        ed = np.array([remap[int(x)] for x in np.concatenate(edges_dst)] if edges_dst else [], np.int32)
        return all_nodes.astype(np.int32), np.stack([es, ed]) if len(es) else np.zeros((2, 0), np.int32)
