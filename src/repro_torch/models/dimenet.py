"""DimeNet (Klicpera et al., arXiv:2003.03123): directional message passing
with triplet interactions (counterpart of ``repro/models/dimenet.py``),
training over a mesh of ranks (``launch.mesh``).

  * parameters: the reference's tree, one tensor a leaf (``api.TreeModel``),
    the blocks' weights stacked [n_blocks, ...] as there; ``node_proj``'s
    input width follows the shape's ``d_feat`` (0: the atom-type embedding,
    16 wide); ``from_jax_params`` / ``to_jax_params`` carry a JAX tree by
    copying;
  * placement, as the reference's ``shard_map`` regions: the edge arrays
    are cut over the flattened mesh (every axis, row-major), rank ``r``
    holding edges [r·E_loc, (r+1)·E_loc) and the triplets [r·T_loc,
    (r+1)·T_loc), which ``data.graph`` aligns with the shard of their ji
    edge; node arrays are whole, on the mesh's first device, and so are the
    weights (a rank on another device reads their ``api.replica``). Each rank
    computes its edges' and triplets' features; the three ops that cross
    ranks are the reference's:
      - ``sharded_edge_gather``: each rank gathers the rows of its own index
        slice that fall in its edge range (zeros elsewhere), and the ranks'
        partials are summed in rank order; every rank gets that sum. As in
        the reference's psum, slot i of the sum adds rank r's i-th triplet
        for every r, so on more than one rank the meshed model is not the
        one-rank model: it is the reference's meshed function;
      - ``sharded_segment_to_nodes``: each rank's segment sum over its
        edges, summed in rank order;
      - ``local_segment_to_edges``: each rank's segment sum of its triplets
        into its own edges (``trip_ji_local``), no collective;
    an edge gather of node rows (``hx[src]``) or of a rank's own edges
    (``m[kj]``) is ``layers.take_rows``, and the segment sums are
    ``core.kmeans.segment_sum``, both with backward and forward sums in a
    fixed order, so a step gives the same bits on every run on the card
    (``index_add_`` would add by float atomics);
  * each interaction block runs under ``torch.utils.checkpoint`` when
    ``cfg.remat`` is "full" and autograd records, as the reference's
    ``jax.checkpoint`` of its scan body: only the block's inputs are kept;
  * training: the masked node MSE, gradients clipped to global norm 1, then
    the bundle's AdamW (cosine schedule 1e-3, 100 warm-up steps of 10,000).

Simplification kept from the reference: the spherical basis is a Chebyshev
angular × sinc radial product, with the paper's n_spherical × n_radial
feature count.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig
from repro_torch.core.kmeans import segment_sum
from repro_torch.launch.mesh import psum
from repro_torch.models.api import (ModelBundle, ShapeSpec, StepDef, TreeModel, adamw,
                                    adamw_state_pspecs, adamw_state_specs, from_jax_tree, nest, on, replica, sds, to_jax_tree)
from repro_torch.models.layers import take_rows
from repro_torch.train import optimizer as opt

BLOCK_WEIGHTS = ("w_sbf", "w_kj", "w_bil", "w_e1", "w_e2", "out_rbf", "out_w")


# ----------------------------------------------------------------- bases

def _ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x**n (n ≥ 1) by repeated squaring, the products XLA makes of an
    integer power: near the cutoff the envelope's terms cancel to ~1e-4, so
    a last-bit difference in each would show."""
    acc, base = None, x
    while n:
        if n & 1:
            acc = base if acc is None else acc * base
        n >>= 1
        if n:
            base = base * base
    return acc


def envelope(d: torch.Tensor, cutoff: float, p: int = 6) -> torch.Tensor:
    x = d / cutoff
    return (1.0 - (p + 1) * (p + 2) / 2 * _ipow(x, p) + p * (p + 2) * _ipow(x, p + 1)
            - p * (p + 1) / 2 * _ipow(x, p + 2)) * (x < 1.0)


def radial_basis(d: torch.Tensor, n_radial: int, cutoff: float = 5.0) -> torch.Tensor:
    """sin(nπ d/c)/d with smooth envelope. [E] -> [E, n_radial]."""
    d = torch.clamp(d, min=1e-6)[:, None]
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    # the f32 square root of f32(2 / cutoff), as jnp.sqrt computes it
    scale = torch.sqrt(torch.tensor(2.0 / cutoff, dtype=torch.float32, device=d.device))
    return envelope(d, cutoff) * scale * torch.sin(n * math.pi * d / cutoff) / d


def spherical_basis(angle: torch.Tensor, d: torch.Tensor, n_spherical: int, n_radial: int,
                    cutoff: float = 5.0) -> torch.Tensor:
    """Chebyshev(cos θ) × radial product basis. [T] -> [T, n_spherical*n_radial]."""
    cosang = torch.clamp(torch.cos(angle), -1.0, 1.0)[:, None]
    ls = torch.arange(n_spherical, dtype=torch.float32, device=angle.device)
    ang = torch.cos(ls * torch.arccos(cosang))                   # [T, S]
    rad = radial_basis(d, n_radial, cutoff)                      # [T, R]
    return (ang[:, :, None] * rad[:, None, :]).reshape(d.shape[0], -1)


# ----------------------------------------------------------------- params

def _param_defs(cfg: GNNConfig, d_feat: int) -> dict:
    """path -> shape, in the reference's order."""
    h, nb, ns, nr = cfg.d_hidden, cfg.n_blocks, cfg.n_spherical, cfg.n_radial
    nbl = cfg.n_bilinear
    d_in = d_feat if d_feat > 0 else 16  # atom-type embedding width
    return {
        "node_proj": (d_in, h),
        "atom_embed": (100, 16),          # used when d_feat == 0
        "rbf_proj": (nr, h),
        "edge_w": (3 * h, h),
        "blocks.w_sbf": (nb, ns * nr, nbl),
        "blocks.w_kj": (nb, h, h),
        "blocks.w_bil": (nb, nbl, h, h),
        "blocks.w_e1": (nb, h, h),
        "blocks.w_e2": (nb, h, h),
        "blocks.out_rbf": (nb, nr, h),
        "blocks.out_w": (nb, h, h),
        "readout1": (h, h),
        "readout2": (h, 1),
    }


def param_specs(cfg: GNNConfig, d_feat: int) -> dict:
    """The parameter tree as meta tensors (no storage)."""
    return nest({k: sds(s) for k, s in _param_defs(cfg, d_feat).items()})


def param_pspecs(cfg: GNNConfig, d_feat: int, mesh) -> dict:
    """Every parameter replicated (``()``), as in the reference."""
    return nest({k: () for k in _param_defs(cfg, d_feat)})


@torch.no_grad()
def init_params(cfg: GNNConfig, d_feat: int, generator: torch.Generator,
                device=None) -> TreeModel:
    """The reference's distribution, not its random numbers: every leaf
    normal / sqrt(fan_in) (fan_in its ``shape[-2]``), drawn in f32 from
    ``generator`` on its device. The model lives on ``device`` (default:
    the generator's)."""
    model = TreeModel(cfg, _param_defs(cfg, d_feat),
                      device if device is not None else generator.device)
    for _, shape, (t,) in model.named_leaves():
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        t.copy_(torch.randn(shape, generator=generator, device=generator.device)
                / math.sqrt(fan_in))
    return model


def from_jax_params(params_np: dict, cfg: GNNConfig, d_feat: int, device=None) -> TreeModel:
    """A model holding the JAX parameter tree ``params_np`` (nested dict of
    numpy arrays) for a shape of ``d_feat``, on ``device`` (default the
    card)."""
    return from_jax_tree(TreeModel(cfg, _param_defs(cfg, d_feat), device), params_np)


def to_jax_params(model: TreeModel) -> dict:
    """The inverse of ``from_jax_params``: the nested tree of numpy arrays."""
    return to_jax_tree(model)


# ----------------------------------------------------------------- sharded ops

def sharded_edge_gather(feats: list, idx: list, devices: list) -> list:
    """``feat[idx]`` with ``feats`` (rank r's edge rows [E_loc, H]) and
    ``idx`` (rank r's global edge ids [T_loc]) cut over the ranks: rank r
    gathers the rows of its ``idx`` in its own edge range (zeros elsewhere),
    the partials are summed in rank order and every rank gets the sum. An
    id outside the rank's range reads row ``(id - e0) mod E_loc`` (zeroed
    all the same), so the backward meets no long run of one row
    (``recsys._lookup``)."""
    e_loc = feats[0].shape[0]

    def part(r, feat, ids):
        rel = ids - r * e_loc
        ok = (rel >= 0) & (rel < e_loc)
        return on(torch.where(ok[:, None], take_rows(feat, rel.remainder(e_loc)), 0.0),
                  devices[0])

    tot = psum(part(r, feat, ids) for r, (feat, ids) in enumerate(zip(feats, idx)))
    return [on(tot, dev) for dev in devices]


def sharded_segment_to_nodes(feats: list, dst: list, n_nodes: int, devices: list):
    """Edge rows into whole node rows: each rank's segment sum [N, H] over
    its edges, summed in rank order on the first device."""
    return psum(on(segment_sum(feat, d, n_nodes), devices[0]) for feat, d in zip(feats, dst))


def local_segment_to_edges(trips: list, ji_local: list, e_loc: int) -> list:
    """Triplet rows into edge rows, each rank's into its own ``e_loc``
    edges (the triplets were aligned with their ji edge's rank): no
    collective."""
    return [segment_sum(t, jl, e_loc) for t, jl in zip(trips, ji_local)]


# ----------------------------------------------------------------- forward

def _block(m, node_out, ws, out_w, *, sbf, rbf, kj, ji_local, dst, tmask, emask, devices):
    """One interaction block over the ranks' lists (``m`` etc., one tensor a
    rank): triplet messages into edges, edges into nodes. ``ws``: the
    block's (w_sbf, w_kj, w_bil, w_e1, w_e2, out_rbf) on each of the ranks'
    distinct devices in turn, flat; ``out_w`` on the first."""
    k = len(BLOCK_WEIGHTS) - 1
    at = {dev: i * k for i, dev in enumerate(dict.fromkeys(devices))}
    ws = [ws[at[dev]:at[dev] + k] for dev in devices]
    u = sharded_edge_gather(m, kj, devices)                     # [T_loc, H] a rank
    agg = []
    for r, (w_sbf_r, w_kj_r, w_bil_r, *_) in enumerate(ws):
        a = sbf[r] @ w_sbf_r                                    # [T_loc, nbl]
        u_r = u[r] @ w_kj_r                                     # [T_loc, H]
        msg = torch.zeros_like(u_r)
        for b in range(w_bil_r.shape[0]):                       # unrolled bilinear
            msg = msg + a[:, b:b + 1] * (u_r @ w_bil_r[b])
        agg.append(msg * tmask[r])
    agg = local_segment_to_edges(agg, ji_local, m[0].shape[0])
    m = [(m_r + F.silu(F.silu((m_r + agg_r) @ w[3]) @ w[4])) * em
         for m_r, agg_r, w, em in zip(m, agg, ws, emask)]
    contrib = sharded_segment_to_nodes([(rb @ w[5]) * m_r for rb, m_r, w in zip(rbf, m, ws)],
                                       dst, node_out.shape[0], devices)
    return (*m, node_out + contrib @ out_w)


def rank_slices(batch: dict, devices: list) -> dict:
    """The edge and triplet arrays cut over ``devices`` (the flattened
    mesh's ranks): name -> one slice a rank, on its device. The number of
    ranks must divide both counts."""
    n = len(devices)
    out = {}
    for keys in (("src", "dst", "edge_mask"),
                 ("trip_kj", "trip_ji", "trip_ji_local", "trip_mask")):
        size = batch[keys[0]].shape[0]
        if size % n:
            raise ValueError(f"{size} {'edges' if keys[0] == 'src' else 'triplets'} do not "
                             f"split over {n} ranks")
        for k in keys:
            out[k] = [on(c, dev) for c, dev in zip(batch[k].chunk(n), devices)]
    return out


def forward(model: TreeModel, batch: dict, *, n_nodes: int, d_feat: int,
            devices=None) -> torch.Tensor:
    """batch: pos [N, 3], feat [N, d_feat] or z [N], edge src / dst [E],
    triplet kj and ji [T] (global edge ids) and ji_local [T] (the ji edge's
    offset within its rank's slice), edge_mask [E], trip_mask [T], the edge
    and triplet arrays cut over ``devices`` (the flattened mesh's ranks;
    default one rank on the model's device). Returns per-node scalar
    predictions [N] on the first device."""
    cfg = model.cfg
    devices = list(devices or [model.device])
    dev0 = devices[0]
    pos = on(batch["pos"], dev0)
    if d_feat > 0:
        hx = on(batch["feat"], dev0) @ model["node_proj"]
    else:
        hx = take_rows(model["atom_embed"], on(batch["z"], dev0).long()) @ model["node_proj"]
    hx = F.silu(hx)                                             # [N, H] whole

    sl = rank_slices(batch, devices)
    src = [t.long() for t in sl["src"]]
    dst = [t.long() for t in sl["dst"]]
    emask = [t.float()[:, None] for t in sl["edge_mask"]]
    tmask = [t.float()[:, None] for t in sl["trip_mask"]]
    kj = [t.long() for t in sl["trip_kj"]]
    vec, dist, rbf, m = [], [], [], []
    for r, dev in enumerate(devices):
        pos_r, hx_r = on(pos, dev), on(hx, dev)
        vec.append(pos_r[dst[r]] - pos_r[src[r]])               # [E_loc, 3]
        dist.append(torch.linalg.vector_norm(vec[r] + 1e-9, dim=-1))
        rbf.append(radial_basis(dist[r], cfg.n_radial))         # [E_loc, R]
        m.append(F.silu(torch.cat([take_rows(hx_r, src[r]), take_rows(hx_r, dst[r]),
                                   rbf[r] @ replica(model, model["rbf_proj"], dev)], -1)
                        @ replica(model, model["edge_w"], dev)) * emask[r])  # [E_loc, H]

    # triplet geometry: angle between edge ji and edge kj at vertex j
    v_ji = sharded_edge_gather(vec, [t.long() for t in sl["trip_ji"]], devices)   # [T_loc, 3]
    v_kj = sharded_edge_gather(vec, kj, devices)
    d_kj = sharded_edge_gather([d[:, None] for d in dist], kj, devices)
    sbf = []
    for a, b, d in zip(v_ji, v_kj, d_kj):
        cos_t = torch.sum(-a * b, -1) / (
            torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1) + 1e-9)
        angle = torch.arccos(torch.clamp(cos_t, -1 + 1e-6, 1 - 1e-6))
        sbf.append(spherical_basis(angle, d[:, 0], cfg.n_spherical, cfg.n_radial))  # [T_loc, S*R]

    block = functools.partial(_block, sbf=sbf, rbf=rbf, kj=kj,
                              ji_local=[t.long() for t in sl["trip_ji_local"]], dst=dst,
                              tmask=tmask, emask=emask, devices=devices)
    n = len(devices)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    node_out = torch.zeros((n_nodes, cfg.d_hidden), dtype=torch.float32, device=dev0)
    stacks = [replica(model, model[f"blocks.{w}"], dev)
              for dev in dict.fromkeys(devices) for w in BLOCK_WEIGHTS[:-1]]
    for i in range(cfg.n_blocks):
        ws = [w[i] for w in stacks]
        out_w = model["blocks.out_w"][i]
        if remat:
            out = checkpoint(lambda *a: block(list(a[:n]), a[n], a[n + 1:-1], a[-1]), *m,
                             node_out, *ws, out_w, use_reentrant=False)
        else:
            out = block(m, node_out, ws, out_w)
        m, node_out = list(out[:n]), out[n]
    return (F.silu(node_out @ model["readout1"]) @ model["readout2"])[:, 0]   # [N]


def node_mse(pred: torch.Tensor, batch: dict) -> torch.Tensor:
    """The mean squared error over the nodes ``node_mask`` keeps."""
    mask = batch["node_mask"].float()
    return torch.sum(((pred - batch["target"]) ** 2) * mask) / torch.clamp(mask.sum(), min=1.0)


# ----------------------------------------------------------------- steps

def make_train_step(cfg: GNNConfig, mesh, *, n_nodes: int, d_feat: int):
    """One optimizer step: ``train_step(state, batch) -> (state, metrics)``
    with ``state`` a ``TrainState`` (or any ``(model, tx)``), updated in
    place. The edge and triplet arrays are cut over the mesh's ranks, all
    its axes flattened. A leaf the loss does not reach (``atom_embed`` under
    features) gets a zero gradient, as in JAX. Metrics: loss and grad_norm
    (before the clip)."""
    devices = list(mesh.devices)

    def train_step(state, batch):
        model, tx = state
        pred = forward(model, batch, n_nodes=n_nodes, d_feat=d_feat, devices=devices)
        loss = node_mse(pred, {k: on(batch[k], pred.device) for k in ("node_mask", "target")})
        grads = torch.autograd.grad(loss, tx.params, allow_unused=True, materialize_grads=True)
        grads, gnorm = opt.clip_by_global_norm(grads, 1.0)
        tx.update(grads)
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def _pad_to(n, mult):
    return int(-(-n // mult) * mult)


def make_bundle(cfg: GNNConfig, mesh) -> ModelBundle:
    """The bundle over ``mesh``: ``init(generator, shape)`` builds the model
    for the shape's ``d_feat`` on the mesh's first device (the parameters
    are replicated); ``optimizer(model)`` is the reference's AdamW (cosine
    schedule 1e-3, 100 warm-up steps of 10,000); the ``graph_train`` step,
    called with ``TrainState(model, optimizer(model))``, its edges and
    triplets padded to a multiple of max(ranks, 256)."""
    device = mesh.devices[0]
    nshard = len(mesh.devices)

    def step(shape: ShapeSpec) -> StepDef:
        if shape.kind != "graph_train":
            raise ValueError(f"unknown shape kind {shape.kind} for graph arch")
        n_graphs = shape.dims.get("batch", 1)
        n_nodes = shape["n_nodes"] * n_graphs
        n_edges = _pad_to(shape["n_edges"] * n_graphs, max(nshard, 256))
        n_trip = _pad_to(shape["n_edges"] * n_graphs * shape["triplet_mult"], max(nshard, 256))
        d_feat = shape["d_feat"]
        specs = {"pos": sds((n_nodes, 3))}
        specs.update({k: sds((n_edges,), torch.int32) for k in ("src", "dst")})
        specs.update({k: sds((n_trip,), torch.int32) for k in ("trip_kj", "trip_ji",
                                                               "trip_ji_local")})
        specs.update({"edge_mask": sds((n_edges,), torch.int32),
                      "trip_mask": sds((n_trip,), torch.int32),
                      "node_mask": sds((n_nodes,), torch.int32),
                      "target": sds((n_nodes,))})
        if d_feat > 0:
            specs["feat"] = sds((n_nodes, d_feat))
        else:
            specs["z"] = sds((n_nodes,), torch.int32)
        return StepDef(fn=make_train_step(cfg, mesh, n_nodes=n_nodes, d_feat=d_feat),
                       input_specs=specs)

    def d_feat_of(shape):
        return shape["d_feat"] if shape is not None else 0

    return ModelBundle(
        name=cfg.arch,
        config=cfg,
        init=lambda generator, shape=None: init_params(cfg, d_feat_of(shape), generator, device),
        param_specs=lambda shape=None: param_specs(cfg, d_feat_of(shape)),
        param_pspecs=lambda shape=None: param_pspecs(cfg, d_feat_of(shape), mesh),
        step=step,
        optimizer=lambda model: adamw(model, opt.cosine_schedule(1e-3, 100, 10_000)),
        opt_specs=lambda shape=None: adamw_state_specs(param_specs(cfg, d_feat_of(shape))),
        opt_pspecs=lambda shape=None: adamw_state_pspecs(
            param_pspecs(cfg, d_feat_of(shape), mesh)),
    )
