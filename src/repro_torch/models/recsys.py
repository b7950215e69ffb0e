"""RecSys architectures: DeepFM, AutoInt, MIND, DLRM-RM2 (counterpart of
``repro/models/recsys.py``), serving and training on one device.

  * parameters: the reference's tree, one tensor a leaf (``api.TreeModel``):
    ``tables`` [F, V, dim] (every field's table in one tensor), DeepFM's
    ``wide`` [F, V, 1], and the MLPs' ``<prefix>.<i>.w`` [in, out] /
    ``.b`` [out], AutoInt's ``attn.<i>.wq|wk|wv|wres``, MIND's
    ``s_bilinear``; ``from_jax_params`` / ``to_jax_params`` carry a JAX tree
    by copying;
  * ``embedding_bag``: every id of a bag gathered (an id outside [0, V) adds
    a zero row, as the reference's mask does), then summed over the bag. The
    gather goes through ``layers.take_rows``, whose backward sums each row's
    gradients in a fixed order, so a step gives the same bits on every run
    on the card (autograd's own would add them by float atomics);
  * training: mean BCE through ``logsigmoid``, gradients clipped to global
    norm 1, then the bundle's AdamW (cosine schedule 1e-3, 100 warm-up steps
    of 100,000), riding in ``api.TrainState``;
  * serving: scores [B]; ``retrieval`` scores every candidate through the
    whole model and returns the top 100 (ties to the lower index, as
    ``jax.lax.top_k``) with int32 ids. Rows are independent, so a serve step
    scores them in chunks of ``SERVE_CHUNK``: one call over 1,000,000
    DLRM-RM2 candidates would gather [1M, 26, 4, 64] f32 rows (26.6 GB).

The reference row-shards the tables over its mesh's "model" axis and sums the
partial lookups with a psum; that meshed path is not ported yet: a mesh other
than 1 × 1 raises.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.api import (ModelBundle, ShapeSpec, StepDef, TreeModel, adamw,
                                    check_one_device, from_jax_tree, nest, sds, to_jax_tree)
from repro_torch.models.layers import take_rows
from repro_torch.train import optimizer as opt

SERVE_CHUNK = 65_536          # rows a serve step scores at once
RETRIEVAL_TOPK = 100
_MESHED = "the row-sharded tables and their psum"


# ------------------------------------------------------------ embedding bag

def embedding_bag(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """tables [F, V, dim]; ids [B, F, nnz] -> [B, F, dim], each field's bag
    summed over nnz after the gather; an id outside [0, V) adds zeros."""
    f, v, d = tables.shape
    ids = ids.long()
    ok = (ids >= 0) & (ids < v)
    rows = ids.clamp(0, v - 1) + v * torch.arange(f, device=ids.device)[:, None]
    g = take_rows(tables.reshape(f * v, d), rows)              # [B, F, nnz, dim]
    return torch.where(ok[..., None], g, 0.0).sum(2)


def embedding_seq(tables: torch.Tensor, ids: torch.Tensor, field: int = 0) -> torch.Tensor:
    """Sequence lookup without a bag-sum: ids [B, T] -> [B, T, dim] from
    ``tables[field]`` (MIND's history and target)."""
    v = tables.shape[1]
    ids = ids.long()
    ok = (ids >= 0) & (ids < v)
    g = take_rows(tables[field], ids.clamp(0, v - 1))
    return torch.where(ok[..., None], g, 0.0)


def _mlp(layers, x: torch.Tensor, final_act: bool = False) -> torch.Tensor:
    for i, (w, b) in enumerate(layers):
        x = x @ w + b
        if final_act or i + 1 < len(layers):
            x = F.relu(x)
    return x


def _mlp_defs(prefix, sizes) -> dict:
    out = {}
    for i, (fi, fo) in enumerate(zip(sizes[:-1], sizes[1:])):
        out[f"{prefix}.{i}.w"] = (fi, fo)
        out[f"{prefix}.{i}.b"] = (fo,)
    return out


def _layers(model: TreeModel, prefix: str) -> list:
    """The MLP ``prefix``'s (w, b) pairs in order."""
    out, i = [], 0
    while f"{prefix}.{i}.w" in model.defs:
        out.append((model[f"{prefix}.{i}.w"], model[f"{prefix}.{i}.b"]))
        i += 1
    return out


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
    f, v, d = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
    defs = {"tables": (f, v, d)}
    if cfg.interaction == "fm":               # DeepFM
        defs["wide"] = (f, v, 1)
        defs.update(_mlp_defs("deep", (f * d, *cfg.mlp, 1)))
    elif cfg.interaction == "self-attn":      # AutoInt
        da = cfg.d_attn * cfg.n_heads
        for i in range(cfg.n_attn_layers):
            d_in = d if i == 0 else da
            defs.update({f"attn.{i}.{w}": (d_in, da) for w in ("wq", "wk", "wv", "wres")})
        defs.update(_mlp_defs("head", (f * da, 1)))
    elif cfg.interaction == "multi-interest":  # MIND
        defs["s_bilinear"] = (d, d)
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


@torch.no_grad()
def init_params(cfg: RecsysConfig, generator: torch.Generator, device=None) -> TreeModel:
    """The reference's distributions, not its random numbers: biases zero,
    the tables normal · 0.01, other weights normal / sqrt(fan_in), drawn in
    f32 from ``generator`` on its device. The model lives on ``device``
    (default: the generator's)."""
    model = TreeModel(cfg, _param_defs(cfg), device if device is not None else generator.device)
    for path, shape, (t,) in model.named_leaves():
        if path.endswith(".b"):
            t.zero_()
            continue
        scale = 0.01 if path in ("tables", "wide") else 1.0 / math.sqrt(
            shape[-2] if len(shape) > 1 else shape[-1])
        t.copy_(torch.randn(shape, generator=generator, device=generator.device).mul_(scale))
    return model


def from_jax_params(params_np: dict, cfg: RecsysConfig, device=None) -> TreeModel:
    """A model holding the JAX parameter tree ``params_np`` (nested dict of
    numpy arrays), on ``device`` (default the card)."""
    return from_jax_tree(TreeModel(cfg, _param_defs(cfg), device), params_np)


def to_jax_params(model: TreeModel) -> dict:
    """The inverse of ``from_jax_params``: the nested tree of numpy arrays."""
    return to_jax_tree(model)


# ------------------------------------------------------------ forward

def forward(model: TreeModel, batch: dict) -> torch.Tensor:
    """Per-example score [B] of DeepFM, AutoInt and DLRM (MIND:
    ``mind_forward``)."""
    cfg = model.cfg
    if cfg.interaction == "multi-interest":
        raise RuntimeError("MIND uses mind_forward")
    emb = embedding_bag(model["tables"], batch["sparse_ids"])            # [B, F, d]
    b = emb.shape[0]
    if cfg.interaction == "fm":
        wide = embedding_bag(model["wide"], batch["sparse_ids"])[..., 0].sum(-1)
        deep = _mlp(_layers(model, "deep"), emb.reshape(b, -1))[:, 0]
        return wide + fm_interaction(emb) + deep
    if cfg.interaction == "self-attn":
        x = emb
        for i in range(cfg.n_attn_layers):
            x = autoint_layer(x, *(model[f"attn.{i}.{w}"] for w in ("wq", "wk", "wv", "wres")),
                              cfg.n_heads)
        return _mlp(_layers(model, "head"), x.reshape(b, -1))[:, 0]
    if cfg.interaction == "dot":
        dense = _mlp(_layers(model, "bot"), batch["dense"], final_act=True)  # [B, d]
        inter = dot_interaction(torch.cat([dense[:, None, :], emb], 1))
        return _mlp(_layers(model, "top"), torch.cat([dense, inter], -1))[:, 0]
    raise ValueError(cfg.interaction)


def mind_forward(model: TreeModel, batch: dict) -> torch.Tensor:
    """MIND: behaviour sequence -> K interests; score = max_k <interest, target>."""
    cfg = model.cfg
    hist = embedding_seq(model["tables"], batch["hist_ids"])                 # [B, T, d]
    caps = capsule_routing(hist, batch["hist_mask"], model["s_bilinear"],
                           cfg.n_interests, cfg.capsule_iters)                # [B, K, d]
    caps = _mlp(_layers(model, "head"), caps)
    target = embedding_seq(model["tables"], batch["target_id"][:, None])[:, 0]
    return torch.einsum("bkd,bd->bk", caps, target).amax(-1)                 # [B]


def _forward_fn(cfg: RecsysConfig):
    return mind_forward if cfg.interaction == "multi-interest" else forward


def bce_loss(score: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """The mean binary cross-entropy of the logits ``score``."""
    return -torch.mean(label * F.logsigmoid(score) + (1 - label) * F.logsigmoid(-score))


# ------------------------------------------------------------ steps

def make_train_step(cfg: RecsysConfig, mesh):
    """One optimizer step: ``train_step(state, batch) -> (state, metrics)``
    with ``state`` a ``TrainState`` (or any ``(model, tx)``), updated in
    place: the loss's gradients clipped to global norm 1, then
    ``tx.update``. Metrics: loss and grad_norm (before the clip)."""
    check_one_device(mesh, _MESHED)
    fwd = _forward_fn(cfg)

    def train_step(state, batch):
        model, tx = state
        loss = bce_loss(fwd(model, batch), batch["label"])
        grads = torch.autograd.grad(loss, tx.params)
        grads, gnorm = opt.clip_by_global_norm(grads, 1.0)
        tx.update(grads)
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_serve_step(cfg: RecsysConfig, mesh, *, topk: int = 0):
    """``serve_step(model, batch) -> scores [B]``, or with ``topk`` the
    ``topk`` best (values, int32 ids) over the batch's rows; rows are scored
    ``SERVE_CHUNK`` at a time."""
    check_one_device(mesh, _MESHED)
    fwd = _forward_fn(cfg)

    @torch.inference_mode()
    def serve_step(model: TreeModel, batch: dict):
        n = next(iter(batch.values())).shape[0]
        score = torch.cat([fwd(model, {k: v[i:i + SERVE_CHUNK] for k, v in batch.items()})
                           for i in range(0, n, SERVE_CHUNK)])
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
    """The bundle over a 1 × 1 ``mesh``: ``init(generator)`` builds the
    model on the mesh's device; ``optimizer(model)`` is the reference's
    AdamW (cosine schedule 1e-3, 100 warm-up steps of 100,000); the kinds
    ``rec_train`` (called with ``TrainState(model, optimizer(model))``),
    ``rec_serve`` and ``retrieval`` (every candidate scored, the top 100)."""
    check_one_device(mesh, _MESHED)
    device = mesh.devices[0]

    def step(shape: ShapeSpec) -> StepDef:
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
        init=lambda generator, shape=None: init_params(cfg, generator, device),
        param_specs=lambda shape=None: param_specs(cfg),
        step=step,
        optimizer=lambda model: adamw(model, opt.cosine_schedule(1e-3, 100, 100_000)),
    )
