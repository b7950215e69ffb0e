"""DimeNet (Klicpera et al., arXiv:2003.03123): directional message passing
with triplet interactions (counterpart of ``repro/models/dimenet.py``),
training on one device.

  * parameters: the reference's tree, one tensor a leaf (``api.TreeModel``),
    the blocks' weights stacked [n_blocks, ...] as there; ``node_proj``'s
    input width follows the shape's ``d_feat`` (0: the atom-type embedding,
    16 wide); ``from_jax_params`` / ``to_jax_params`` carry a JAX tree by
    copying;
  * the reference's sharded ops on one device: an edge gather (``m[kj]``,
    ``hx[src]``) is ``layers.take_rows``, and the triplet→edge and
    edge→node sums are ``core.kmeans.segment_sum``, both with backward and
    forward sums in a fixed order, so a step gives the same bits on every
    run on the card (``index_add_`` would add by float atomics);
  * each interaction block runs under ``torch.utils.checkpoint`` when
    ``cfg.remat`` is "full" and autograd records, as the reference's
    ``jax.checkpoint`` of its scan body: only the block's inputs are kept;
  * training: the masked node MSE, gradients clipped to global norm 1, then
    the bundle's AdamW (cosine schedule 1e-3, 100 warm-up steps of 10,000).

The reference shards the edges and triplets over its flattened mesh (a
partial gather and psum across shards); that meshed path is not ported yet:
a mesh other than 1 × 1 raises. Simplification kept from the reference: the
spherical basis is a Chebyshev angular × sinc radial product, with the
paper's n_spherical × n_radial feature count.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig
from repro_torch.core.kmeans import segment_sum
from repro_torch.models.api import (ModelBundle, ShapeSpec, StepDef, TreeModel, adamw,
                                    check_one_device, from_jax_tree, nest, sds, to_jax_tree)
from repro_torch.models.layers import take_rows
from repro_torch.train import optimizer as opt

_MESHED = "DimeNet's edge-sharded gathers and segment sums"
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


# ----------------------------------------------------------------- forward

def _block(m, node_out, w_sbf, w_kj, w_bil, w_e1, w_e2, out_rbf, out_w, *, sbf, rbf, kj,
           ji_local, dst, tmask, emask):
    """One interaction block: triplet messages into edges, edges into nodes."""
    a = sbf @ w_sbf                                             # [T, nbl]
    u = take_rows(m, kj) @ w_kj                                 # [T, H]
    msg = torch.zeros_like(u)
    for b in range(w_bil.shape[0]):                             # unrolled bilinear
        msg = msg + a[:, b:b + 1] * (u @ w_bil[b])
    msg = msg * tmask
    agg = segment_sum(msg, ji_local, m.shape[0])
    m = (m + F.silu(F.silu((m + agg) @ w_e1) @ w_e2)) * emask
    contrib = segment_sum((rbf @ out_rbf) * m, dst, node_out.shape[0])
    return m, node_out + contrib @ out_w


def forward(model: TreeModel, batch: dict, *, n_nodes: int, d_feat: int) -> torch.Tensor:
    """batch: pos [N, 3], feat [N, d_feat] or z [N], edge src / dst [E],
    triplet kj [T] and ji_local [T] (edge ids; the local offset is the edge
    id on one device), edge_mask [E], trip_mask [T]. Returns per-node
    scalar predictions [N]."""
    cfg = model.cfg
    pos = batch["pos"]
    src, dst = batch["src"].long(), batch["dst"].long()
    emask = batch["edge_mask"].float()[:, None]
    tmask = batch["trip_mask"].float()[:, None]

    if d_feat > 0:
        hx = batch["feat"] @ model["node_proj"]
    else:
        hx = take_rows(model["atom_embed"], batch["z"].long()) @ model["node_proj"]
    hx = F.silu(hx)                                             # [N, H]

    vec = pos[dst] - pos[src]                                   # [E, 3]
    dist = torch.linalg.vector_norm(vec + 1e-9, dim=-1)
    rbf = radial_basis(dist, cfg.n_radial)                      # [E, R]

    m = F.silu(torch.cat([take_rows(hx, src), take_rows(hx, dst), rbf @ model["rbf_proj"]], -1)
               @ model["edge_w"]) * emask                       # [E, H]

    # triplet geometry: angle between edge ji and edge kj at vertex j
    kj = batch["trip_kj"].long()
    v_ji, v_kj = vec[batch["trip_ji"].long()], vec[kj]          # [T, 3]
    cos_t = torch.sum(-v_ji * v_kj, -1) / (
        torch.linalg.vector_norm(v_ji, dim=-1) * torch.linalg.vector_norm(v_kj, dim=-1) + 1e-9)
    angle = torch.arccos(torch.clamp(cos_t, -1 + 1e-6, 1 - 1e-6))
    sbf = spherical_basis(angle, dist[kj], cfg.n_spherical, cfg.n_radial)   # [T, S*R]

    block = functools.partial(_block, sbf=sbf, rbf=rbf, kj=kj,
                              ji_local=batch["trip_ji_local"].long(), dst=dst, tmask=tmask,
                              emask=emask)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    node_out = torch.zeros((n_nodes, cfg.d_hidden), dtype=torch.float32, device=m.device)
    for i in range(cfg.n_blocks):
        weights = [model[f"blocks.{w}"][i] for w in BLOCK_WEIGHTS]
        if remat:
            m, node_out = checkpoint(block, m, node_out, *weights, use_reentrant=False)
        else:
            m, node_out = block(m, node_out, *weights)
    return (F.silu(node_out @ model["readout1"]) @ model["readout2"])[:, 0]   # [N]


def node_mse(pred: torch.Tensor, batch: dict) -> torch.Tensor:
    """The mean squared error over the nodes ``node_mask`` keeps."""
    mask = batch["node_mask"].float()
    return torch.sum(((pred - batch["target"]) ** 2) * mask) / torch.clamp(mask.sum(), min=1.0)


# ----------------------------------------------------------------- steps

def make_train_step(cfg: GNNConfig, mesh, *, n_nodes: int, d_feat: int):
    """One optimizer step: ``train_step(state, batch) -> (state, metrics)``
    with ``state`` a ``TrainState`` (or any ``(model, tx)``), updated in
    place. A leaf the loss does not reach (``atom_embed`` under features)
    gets a zero gradient, as in JAX. Metrics: loss and grad_norm (before the
    clip)."""
    check_one_device(mesh, _MESHED)

    def train_step(state, batch):
        model, tx = state
        loss = node_mse(forward(model, batch, n_nodes=n_nodes, d_feat=d_feat), batch)
        grads = torch.autograd.grad(loss, tx.params, allow_unused=True, materialize_grads=True)
        grads, gnorm = opt.clip_by_global_norm(grads, 1.0)
        tx.update(grads)
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def _pad_to(n, mult):
    return int(-(-n // mult) * mult)


def make_bundle(cfg: GNNConfig, mesh) -> ModelBundle:
    """The bundle over a 1 × 1 ``mesh``: ``init(generator, shape)`` builds
    the model for the shape's ``d_feat`` on the mesh's device;
    ``optimizer(model)`` is the reference's AdamW (cosine schedule 1e-3, 100
    warm-up steps of 10,000); the ``graph_train`` step, called with
    ``TrainState(model, optimizer(model))``."""
    check_one_device(mesh, _MESHED)
    device = mesh.devices[0]

    def step(shape: ShapeSpec) -> StepDef:
        if shape.kind != "graph_train":
            raise ValueError(f"unknown shape kind {shape.kind} for graph arch")
        n_graphs = shape.dims.get("batch", 1)
        n_nodes = shape["n_nodes"] * n_graphs
        n_edges = _pad_to(shape["n_edges"] * n_graphs, 256)
        n_trip = _pad_to(shape["n_edges"] * n_graphs * shape["triplet_mult"], 256)
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
        step=step,
        optimizer=lambda model: adamw(model, opt.cosine_schedule(1e-3, 100, 10_000)),
    )
