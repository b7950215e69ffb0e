"""RecSys architectures: DeepFM, AutoInt, MIND, DLRM-RM2 (counterpart of
``repro/models/recsys.py``), serving and training over a (pod, data, model)
mesh of ranks (``launch.mesh``).

  * parameters: the reference's tree, one tensor a leaf (``api.TreeModel``):
    ``tables`` [F, V, dim] (every field's table in one tensor), DeepFM's
    ``wide`` [F, V, 1], and the MLPs' ``<prefix>.<i>.w`` [in, out] /
    ``.b`` [out], AutoInt's ``attn.<i>.wq|wk|wv|wres``, MIND's
    ``s_bilinear``; ``from_jax_params`` / ``to_jax_params`` carry a JAX tree
    by copying;
  * placement: ``tables`` and ``wide`` are cut along V over the "model"
    ranks (``param_pspecs``: (None, "model", None)), each rank holding
    [F, V/model, dim] of every field (a batch row's rank on another device
    reads its ``api.replica``); the MLPs are stored once and are
    data-parallel, read on each batch row's device through its replica; the
    batch splits over the batch axes ("pod", "data");
  * ``embedding_bag``: each model rank looks up ``ids - v0`` in its rows,
    with the ids outside its range masked to zero (an id outside
    [0, V) is outside every range: it adds zeros, as the reference's mask
    does); the ranks' [B, F, nnz, dim] partials are summed in rank order as
    they come, then over the bag. Every element adds zeros to its one nonzero
    partial, so the lookup equals the one-rank lookup bit for bit (the
    reference sums the bag on each rank before its psum: the same values in
    another order). The gather goes through ``layers.take_rows``, whose
    backward sums each row's gradients in a fixed order, so a step gives the
    same bits on every run on the card (autograd's own would add them by
    float atomics);
  * training: mean BCE through ``logsigmoid``, gradients clipped to global
    norm 1, then the bundle's AdamW (cosine schedule 1e-3, 100 warm-up steps
    of 100,000), riding in ``api.TrainState``;
  * serving: scores [B]; ``retrieval`` scores every candidate through the
    whole model and returns the top 100 (ties to the lower index, as
    ``jax.lax.top_k``) with int32 ids. Rows are independent, so a serve step
    scores each batch rank's rows in chunks of ``SERVE_CHUNK``: one call over
    1,000,000 DLRM-RM2 candidates would gather [1M, 26, 4, 64] f32 rows
    (26.6 GB).

A mesh the reference cannot run raises: V not a multiple of the model ranks,
or a batch not a multiple of the batch ranks.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig
from repro_torch.distributed.sharding import axes_size, batch_axes, logical_to_pspec
from repro_torch.launch.mesh import psum
from repro_torch.models.api import (ModelBundle, ShapeSpec, StepDef, TreeModel, adamw,
                                    adamw_state_pspecs, adamw_state_specs, fill, from_jax_tree, model_splits, nest, on, replica, sds,
                                    to_jax_tree)
from repro_torch.models.layers import take_rows
from repro_torch.train import optimizer as opt

SERVE_CHUNK = 65_536          # rows a serve step scores at once
RETRIEVAL_TOPK = 100
_TABLES = ("tables", "wide")  # the leaves the meshed lookups read in row slices


# ------------------------------------------------------------ embedding bag

def _ranks(tables):
    """A table, or its model ranks' row slices in rank order, as a list."""
    return list(tables) if isinstance(tables, (list, tuple)) else [tables]


def _lookup(tables, ids: torch.Tensor, gather) -> torch.Tensor:
    """Σ in model-rank order of each rank's masked lookup: rank ``j`` holds
    rows [j·V_loc, (j+1)·V_loc) and runs ``gather`` of ``ids - v0`` in its
    slice, on the slice's device, the ids outside its rows zeroed; the
    partials are added on the first rank's device as they come. An id
    outside the rank's rows reads row
    ``(id - v0) mod V_loc``, not the clipped end row as in the reference:
    the value is zeroed all the same and its gradient is a zero, but the
    backward's sorted segment sum then meets no run of millions of equal
    rows (which the card's deterministic ``index_put_`` adds one by one)."""
    tabs = _ranks(tables)
    v_loc = tabs[0].shape[1]

    def part(j, tab):
        rel = on(ids, tab.device).long() - j * v_loc
        ok = (rel >= 0) & (rel < v_loc)
        return on(torch.where(ok[..., None], gather(tab, rel.remainder(v_loc)), 0.0),
                  tabs[0].device)

    return psum(part(j, tab) for j, tab in enumerate(tabs))


def embedding_bag(tables, ids: torch.Tensor) -> torch.Tensor:
    """tables [F, V, dim] (or its model ranks' [F, V/model, dim] slices, in
    rank order); ids [B, F, nnz] -> [B, F, dim], each field's bag summed over
    nnz after the gather; an id outside [0, V) adds zeros."""
    def gather(tab, rel):
        f, v_loc, d = tab.shape
        rows = rel + v_loc * torch.arange(f, device=rel.device)[:, None]
        return take_rows(tab.reshape(f * v_loc, d), rows)      # [B, F, nnz, dim]

    return _lookup(tables, ids, gather).sum(2)


def embedding_seq(tables, ids: torch.Tensor, field: int = 0) -> torch.Tensor:
    """Sequence lookup without a bag-sum: ids [B, T] -> [B, T, dim] from
    field ``field`` of ``tables`` (or of its model ranks' slices; MIND's
    history and target)."""
    return _lookup(tables, ids, lambda tab, rel: take_rows(tab[field], rel))


def _mlp(layers, x: torch.Tensor, final_act: bool = False) -> torch.Tensor:
    for i, (w, b) in enumerate(layers):
        x = x @ w + b
        if final_act or i + 1 < len(layers):
            x = F.relu(x)
    return x


def _mlp_defs(prefix, sizes) -> dict:
    out = {}
    for i, (fi, fo) in enumerate(zip(sizes[:-1], sizes[1:])):
        out[f"{prefix}.{i}.w"] = ((fi, fo), None)
        out[f"{prefix}.{i}.b"] = ((fo,), None)
    return out


def _layers(model: TreeModel, prefix: str, dev) -> list:
    """The MLP ``prefix``'s (w, b) pairs in order, read on ``dev``."""
    out, i = [], 0
    while f"{prefix}.{i}.w" in model.defs:
        out.append(tuple(_on(model, f"{prefix}.{i}.{n}", dev) for n in "wb"))
        i += 1
    return out


def _on(model: TreeModel, path: str, dev) -> torch.Tensor:
    """The whole leaf ``path`` read on ``dev`` (its replica there)."""
    return replica(model, model[path], dev)


def _rank_shards(model: TreeModel, path: str, devices) -> list:
    """The leaf's model-rank slices, rank ``j``'s read on ``devices[j]``
    (default: where each is stored)."""
    shards = model.shards(path)
    return shards if devices is None else [replica(model, t, d)
                                           for t, d in zip(shards, devices)]


# ------------------------------------------------------------ interactions

def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """emb [B, F, dim] -> the FM 2nd-order term [B] (sum-square trick)."""
    s = emb.sum(1)
    return 0.5 * (s * s - (emb * emb).sum(1)).sum(-1)


def dot_interaction(z: torch.Tensor) -> torch.Tensor:
    """z [B, F, dim] -> lower-triangle pairwise dots [B, F(F-1)/2], in the
    order of ``np.tril_indices(F, -1)``."""
    f = z.shape[1]
    g = torch.bmm(z, z.transpose(1, 2))
    iu, ju = (torch.from_numpy(a).to(z.device) for a in np.tril_indices(f, k=-1))
    return g[:, iu, ju]


def autoint_layer(x, wq, wk, wv, wres, n_heads: int) -> torch.Tensor:
    """x [B, F, dim] -> multi-head field self-attention (AutoInt eq. 6-8)."""
    b, f, _ = x.shape
    q = (x @ wq).reshape(b, f, n_heads, -1)
    k = (x @ wk).reshape(b, f, n_heads, -1)
    v = (x @ wv).reshape(b, f, n_heads, -1)
    att = torch.softmax(torch.einsum("bfhd,bghd->bhfg", q, k) / math.sqrt(q.shape[-1]), -1)
    o = torch.einsum("bhfg,bghd->bfhd", att, v).reshape(b, f, -1)
    return F.relu(o + x @ wres)


def capsule_routing(hist_emb, hist_mask, s_bilinear, n_interests: int, iters: int):
    """MIND B2I dynamic routing. hist_emb [B, T, dim] -> interests [B, K, dim]."""
    b, t, d = hist_emb.shape
    u = hist_emb @ s_bilinear                                     # [B, T, dim]
    blogit = torch.zeros((b, n_interests, t), dtype=torch.float32, device=u.device)
    neg = torch.where(hist_mask[:, None, :] > 0, 0.0, -1e30)
    caps = torch.zeros((b, n_interests, d), dtype=u.dtype, device=u.device)
    for _ in range(iters):
        w = torch.softmax(blogit + neg, dim=1)                    # over interests
        caps = torch.einsum("bkt,btd->bkd", w, u)
        norm2 = torch.sum(caps * caps, -1, keepdim=True)
        caps = caps * (norm2 / (1 + norm2)) / torch.sqrt(norm2 + 1e-9)   # squash
        blogit = blogit + torch.einsum("bkd,btd->bkt", caps, u)
    return caps


# ------------------------------------------------------------ params

def _param_defs(cfg: RecsysConfig) -> dict:
    """path -> shape, in the reference's order."""
    return {path: shape for path, (shape, _) in _param_axes(cfg).items()}


def _param_axes(cfg: RecsysConfig) -> dict:
    """path -> (shape, logical axes or None), in the reference's order."""
    f, v, d = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
    defs = {"tables": ((f, v, d), (None, "rows", None))}
    if cfg.interaction == "fm":               # DeepFM
        defs["wide"] = ((f, v, 1), (None, "rows", None))
        defs.update(_mlp_defs("deep", (f * d, *cfg.mlp, 1)))
    elif cfg.interaction == "self-attn":      # AutoInt
        da = cfg.d_attn * cfg.n_heads
        for i in range(cfg.n_attn_layers):
            d_in = d if i == 0 else da
            defs.update({f"attn.{i}.{w}": ((d_in, da), None) for w in ("wq", "wk", "wv", "wres")})
        defs.update(_mlp_defs("head", (f * da, 1)))
    elif cfg.interaction == "multi-interest":  # MIND
        defs["s_bilinear"] = ((d, d), None)
        defs.update(_mlp_defs("head", (d, 2 * d, d)))
    elif cfg.interaction == "dot":            # DLRM
        defs.update(_mlp_defs("bot", tuple(cfg.bot_mlp)))
        n_f = cfg.n_sparse + 1
        d_int = n_f * (n_f - 1) // 2 + cfg.bot_mlp[-1]
        defs.update(_mlp_defs("top", (d_int, *cfg.top_mlp)))
    else:
        raise ValueError(cfg.interaction)
    return defs


def param_specs(cfg: RecsysConfig) -> dict:
    """The parameter tree as meta tensors (no storage)."""
    return nest({k: sds(s) for k, s in _param_defs(cfg).items()})


def param_pspecs(cfg: RecsysConfig, mesh) -> dict:
    """The reference's partition specs: the tables' V over "model", the
    rest replicated (``()``)."""
    return nest({k: () if ax is None else logical_to_pspec(ax, mesh)
                 for k, (_, ax) in _param_axes(cfg).items()})


def new_model(cfg: RecsysConfig, device=None, mesh=None) -> TreeModel:
    """An uninitialised model on ``device``, or placed over ``mesh``: the
    tables cut along V, one slice a model rank."""
    if mesh is None:
        return TreeModel(cfg, _param_defs(cfg), device)
    _check_mesh(cfg, mesh)
    flat = {k: () if ax is None else logical_to_pspec(ax, mesh)
            for k, (_, ax) in _param_axes(cfg).items()}
    defs = _param_defs(cfg)
    return TreeModel(cfg, defs, mesh=mesh,
                     splits=model_splits(flat, [p for p in _TABLES if p in defs], defs, mesh))


@torch.no_grad()
def init_params(cfg: RecsysConfig, generator: torch.Generator, device=None,
                mesh=None) -> TreeModel:
    """The reference's distributions, not its random numbers: biases zero,
    the tables normal · 0.01, other weights normal / sqrt(fan_in), drawn in
    f32 from ``generator`` on its device, whole leaves whatever the mesh. The
    model lives on ``device`` (default: the generator's), or over ``mesh``."""
    model = new_model(cfg, device if device is not None else generator.device, mesh)
    for path, shape, tensors in model.named_leaves():
        if path.endswith(".b"):
            for t in tensors:
                t.zero_()
            continue
        scale = 0.01 if path in _TABLES else 1.0 / math.sqrt(
            shape[-2] if len(shape) > 1 else shape[-1])
        fill(model, path, shape, tensors,
             torch.randn(shape, generator=generator, device=generator.device).mul_(scale))
    return model


def from_jax_params(params_np: dict, cfg: RecsysConfig, device=None, mesh=None) -> TreeModel:
    """A model holding the JAX parameter tree ``params_np`` (nested dict of
    numpy arrays, whole leaves), on ``device`` (default the card) or placed
    over ``mesh``."""
    return from_jax_tree(new_model(cfg, device, mesh), params_np)


def to_jax_params(model: TreeModel) -> dict:
    """The inverse of ``from_jax_params``: the nested tree of numpy arrays."""
    return to_jax_tree(model)


# ------------------------------------------------------------ forward

def forward(model: TreeModel, batch: dict, devices=None) -> torch.Tensor:
    """Per-example score [B] of DeepFM, AutoInt and DLRM (MIND:
    ``mind_forward``) for the rows of one batch rank, whose model ranks sit
    on ``devices`` (default: where the table slices are); the score is on
    the first."""
    cfg = model.cfg
    if cfg.interaction == "multi-interest":
        raise RuntimeError("MIND uses mind_forward")
    emb = embedding_bag(_rank_shards(model, "tables", devices), batch["sparse_ids"])  # [B, F, d]
    b, dev = emb.shape[0], emb.device
    if cfg.interaction == "fm":
        wide = embedding_bag(_rank_shards(model, "wide", devices),
                             batch["sparse_ids"])[..., 0].sum(-1)
        deep = _mlp(_layers(model, "deep", dev), emb.reshape(b, -1))[:, 0]
        return wide + fm_interaction(emb) + deep
    if cfg.interaction == "self-attn":
        x = emb
        for i in range(cfg.n_attn_layers):
            x = autoint_layer(x, *(_on(model, f"attn.{i}.{w}", dev)
                                   for w in ("wq", "wk", "wv", "wres")), cfg.n_heads)
        return _mlp(_layers(model, "head", dev), x.reshape(b, -1))[:, 0]
    if cfg.interaction == "dot":
        dense = _mlp(_layers(model, "bot", dev), on(batch["dense"], dev), final_act=True)  # [B, d]
        inter = dot_interaction(torch.cat([dense[:, None, :], emb], 1))
        return _mlp(_layers(model, "top", dev), torch.cat([dense, inter], -1))[:, 0]
    raise ValueError(cfg.interaction)


def mind_forward(model: TreeModel, batch: dict, devices=None) -> torch.Tensor:
    """MIND: behaviour sequence -> K interests; score = max_k <interest,
    target>, for one batch rank's rows (as ``forward``)."""
    cfg = model.cfg
    tabs = _rank_shards(model, "tables", devices)
    hist = embedding_seq(tabs, batch["hist_ids"])                           # [B, T, d]
    dev = hist.device
    caps = capsule_routing(hist, on(batch["hist_mask"], dev), _on(model, "s_bilinear", dev),
                           cfg.n_interests, cfg.capsule_iters)                # [B, K, d]
    caps = _mlp(_layers(model, "head", dev), caps)
    target = embedding_seq(tabs, batch["target_id"][:, None])[:, 0]
    return torch.einsum("bkd,bd->bk", caps, target).amax(-1)                 # [B]


def _forward_fn(cfg: RecsysConfig):
    return mind_forward if cfg.interaction == "multi-interest" else forward


def bce_loss(score: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """The mean binary cross-entropy of the logits ``score``."""
    return -torch.mean(label * F.logsigmoid(score) + (1 - label) * F.logsigmoid(-score))


# ------------------------------------------------------------ steps

def _check_mesh(cfg: RecsysConfig, mesh) -> None:
    n = mesh.shape.get("model", 1)
    if cfg.vocab_per_field % n:
        raise ValueError(f"vocab_per_field {cfg.vocab_per_field} does not split over {n} "
                         f"model ranks")


def rank_rows(batch: dict, model: TreeModel, mesh):
    """The batch cut over the mesh's batch ranks ("pod" × "data"): a list,
    one (rows of the batch, devices of its model ranks) a batch rank, in
    rank order. A batch that does not split evenly raises, and so does a
    model placed over another number of model ranks."""
    n_model = mesh.shape.get("model", 1)
    split = model.split_of("tables")
    if (split[1] if split else 1) != n_model:
        raise ValueError(f"the model's tables are cut over {split[1] if split else 1} model "
                         f"ranks; the mesh has {n_model}")
    rows = axes_size(mesh, batch_axes(mesh))
    b = next(iter(batch.values())).shape[0]
    if b % rows:
        raise ValueError(f"batch {b} does not split over {rows} batch ranks (pod × data)")
    out = []
    for i in range(rows):
        devs = list(mesh.devices[i * n_model:(i + 1) * n_model])
        lo, hi = i * b // rows, (i + 1) * b // rows
        out.append(({k: on(v[lo:hi], devs[0]) for k, v in batch.items()}, devs))
    return out


def make_train_step(cfg: RecsysConfig, mesh):
    """One optimizer step: ``train_step(state, batch) -> (state, metrics)``
    with ``state`` a ``TrainState`` (or any ``(model, tx)``), updated in
    place: each batch rank scores its rows, the mean BCE is taken over the
    whole batch on the mesh's first device, its gradients (each table
    slice's its own) clipped to global norm 1, then ``tx.update``. Metrics:
    loss and grad_norm (before the clip)."""
    _check_mesh(cfg, mesh)
    fwd = _forward_fn(cfg)

    def train_step(state, batch):
        model, tx = state
        dev = mesh.devices[0]
        score = torch.cat([on(fwd(model, rows, devs), dev)
                           for rows, devs in rank_rows(batch, model, mesh)])
        loss = bce_loss(score, on(batch["label"], dev))
        grads = torch.autograd.grad(loss, tx.params)
        grads, gnorm = opt.clip_by_global_norm([on(g, dev) for g in grads], 1.0)
        tx.update([on(g, p.device) for g, p in zip(grads, tx.params)])
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_serve_step(cfg: RecsysConfig, mesh, *, topk: int = 0):
    """``serve_step(model, batch) -> scores [B]`` (on the mesh's first
    device), or with ``topk`` the ``topk`` best (values, int32 ids) over the
    batch's rows; each batch rank scores its rows ``SERVE_CHUNK`` at a
    time."""
    _check_mesh(cfg, mesh)
    fwd = _forward_fn(cfg)

    @torch.inference_mode()
    def serve_step(model: TreeModel, batch: dict):
        parts = []
        for rows, devs in rank_rows(batch, model, mesh):
            n = next(iter(rows.values())).shape[0]
            parts += [on(fwd(model, {k: v[i:i + SERVE_CHUNK] for k, v in rows.items()}, devs),
                         mesh.devices[0]) for i in range(0, n, SERVE_CHUNK)]
        score = torch.cat(parts)
        if topk:
            vals, idx = torch.sort(score, descending=True, stable=True)
            return vals[:topk], idx[:topk].to(torch.int32)
        return score

    return serve_step


def _batch_specs(cfg: RecsysConfig, b: int) -> dict:
    specs = {"sparse_ids": sds((b, cfg.n_sparse, cfg.nnz), torch.int32), "label": sds((b,))}
    if cfg.n_dense:
        specs["dense"] = sds((b, cfg.n_dense))
    if cfg.interaction == "multi-interest":
        specs.update({"hist_ids": sds((b, cfg.hist_len), torch.int32),
                      "hist_mask": sds((b, cfg.hist_len)),
                      "target_id": sds((b,), torch.int32)})
    return specs


def make_bundle(cfg: RecsysConfig, mesh) -> ModelBundle:
    """The bundle over ``mesh``: ``init(generator)`` builds the model placed
    over it; ``optimizer(model)`` is the reference's AdamW (cosine schedule
    1e-3, 100 warm-up steps of 100,000); the kinds ``rec_train`` (called
    with ``TrainState(model, optimizer(model))``), ``rec_serve`` and
    ``retrieval`` (every candidate scored, the top 100)."""
    _check_mesh(cfg, mesh)
    rows = axes_size(mesh, batch_axes(mesh))

    def step(shape: ShapeSpec) -> StepDef:
        if shape.kind in ("rec_train", "rec_serve", "retrieval"):
            b = shape["n_candidates"] if shape.kind == "retrieval" else shape["batch"]
            if b % rows:
                raise ValueError(f"batch {b} does not split over {rows} batch ranks "
                                 f"(pod × data)")
        if shape.kind == "rec_train":
            return StepDef(fn=make_train_step(cfg, mesh), input_specs=_batch_specs(cfg, shape["batch"]))
        if shape.kind == "rec_serve":
            return StepDef(fn=make_serve_step(cfg, mesh), input_specs=_batch_specs(cfg, shape["batch"]))
        if shape.kind == "retrieval":
            return StepDef(fn=make_serve_step(cfg, mesh, topk=RETRIEVAL_TOPK),
                           input_specs=_batch_specs(cfg, shape["n_candidates"]))
        raise ValueError(f"unknown shape kind {shape.kind} for recsys arch")

    return ModelBundle(
        name=cfg.arch,
        config=cfg,
        init=lambda generator, shape=None: init_params(cfg, generator, mesh=mesh),
        param_specs=lambda shape=None: param_specs(cfg),
        param_pspecs=lambda shape=None: param_pspecs(cfg, mesh),
        step=step,
        optimizer=lambda model: adamw(model, opt.cosine_schedule(1e-3, 100, 100_000)),
        opt_specs=lambda shape=None: adamw_state_specs(param_specs(cfg)),
        opt_pspecs=lambda shape=None: adamw_state_pspecs(param_pspecs(cfg, mesh)),
    )
