"""Dense + MoE GQA transformer LM, the five LM architectures (counterpart of
``repro/models/transformer.py``), serving and training over a (pod, data,
model) mesh of ranks (``launch.mesh``).

  * parameters: the reference's tree, ``embed`` [V, D], ``unembed`` [D, V],
    ``ln_f`` [D] and per layer ``ln1``, ``ln2``, ``wq`` [D, H·Dh], ``wk`` /
    ``wv`` [D, KV·Dh], ``wo`` [H·Dh, D] and the FFN's (dense ``wi``, ``wg``
    [D, F], ``wo_ff`` [F, D]; MoE ``router`` [D, E], ``wi_e`` / ``wg_e``
    [E, D, Fe], ``wo_e`` [E, Fe, D] and the shared experts' ``ws_i``,
    ``ws_g``, ``ws_o``), every weight [in, out] as in JAX, so
    ``from_jax_params`` / ``to_jax_params`` carry a JAX tree by copying;
  * attention: the online-softmax loop over KV blocks (``layers.
    flash_attention``), no [S, S] matrix;
  * MoE: the reference's ``shard_map`` expert parallelism, rank by rank
    (``_moe_block``): model rank j holds experts [j·E/model, (j+1)·E/model)
    (``wi_e`` / ``wg_e`` / ``wo_e`` stored in slices), batch row i the
    batch's i-th slice over ("pod", "data"). The "gather" path dispatches
    every token of the row (sequence gathered) to each rank's experts with
    the capacity of ``b_loc·s`` tokens and sums the ranks' outputs in rank
    order; "a2a" (sequence-sharded, model > 1) routes each rank's own
    tokens through ``layers.moe_a2a_local`` with the reference's ``c_send``
    and ``c_exp``. Capacities follow the per-rank batch, so which pairs drop
    depends on the mesh, as in the reference;
  * the dense FFN with ``ffn_impl="sp"``: model rank j holds its [D, F/model]
    columns of ``wi`` / ``wg`` and [F/model, D] rows of ``wo_ff``, and the
    ranks' partial outputs are summed in rank order (``_sp_ffn``);
  * serving: ``make_prefill_step`` returns last-position f32 logits and the
    cache ``{"k", "v"}`` as one [L, B_loc, S_loc, KV, Dh] slice a rank, in
    rank order, as the decode's ``cache_pspecs`` cut the reference's stacked
    [L, B, S, KV, Dh] (on one rank, the whole of it); ``join_cache`` /
    ``split_cache`` convert, so a JAX prefill's cache feeds this decode;
    ``make_decode_step`` writes the new K/V in place at (layer, pos) on the
    rank that owns pos, each rank attends over its slice under the
    ``cache_len`` mask and the ranks' (max, sum, output) are merged by
    log-sum-exp in rank order; it returns the greedy next token;
  * training: ``make_train_step`` — the loss ``ce + 0.01·aux`` (next-token
    cross-entropy, chunked over the sequence with ``cfg.logits_chunk``; the
    MoE load-balance aux summed over layers), each layer rematerialized in
    backward as ``cfg.remat`` says, ``cfg.grad_accum`` microbatches summed
    into an f32 accumulator, gradients clipped to global norm 1, then the
    optimizer (``adamw``: the reference's decay rule on its stacked tree).
    ``TrainState`` (``models.api``) lists the model and optimizer as the
    reference's checkpoint holds them, so a checkpoint either package writes resumes in
    the other.

The rest of the reference's step is sharding constraints (layout): the port
computes it on whole tensors on the mesh's first device, where the dense
weights are stored (a rank on another device reads its ``api.replica``). A
mesh the reference cannot run raises: E or F not a multiple of the model
ranks, a batch not a multiple of the batch ranks, a sequence not a multiple
of the model ranks (prefill, training) or a cache not a multiple of its
sequence ranks (decode).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import LMConfig
from repro_torch.distributed.sharding import (axes_entry, axes_size, batch_axes,
                                              logical_to_pspec)
from repro_torch.launch.mesh import AXES, make_mesh, psum
from repro_torch.models import layers as L
# TrainState and adamw stay importable from here: the LM's Trainer state and optimizer
from repro_torch.models.api import (ModelBundle, ShapeSpec, StepDef, TrainState, adamw,
                                   adamw_state_pspecs, adamw_state_specs, fill, join,
                                   model_splits, nest, on, replica, sds, sliced)
from repro_torch.train import optimizer as opt
from repro_torch.utils.device import resolve_device


# --------------------------------------------------------------- param layout

def _param_axes(cfg: LMConfig) -> dict:
    """path -> (shape, logical axes), the reference's. Layer params carry a
    leading stack axis [L, ...], as in the reference's tree."""
    d, v = cfg.d_model, cfg.vocab
    h_flat = cfg.n_heads * cfg.head_dim
    kv_flat = cfg.n_kv_heads * cfg.head_dim
    l = cfg.n_layers
    defs = {
        "embed": ((v, d), (None, "fsdp")),
        "unembed": ((d, v), ("fsdp", "vocab")),
        "ln_f": ((d,), (None,)),
        "layers.ln1": ((l, d), ("stack", None)),
        "layers.ln2": ((l, d), ("stack", None)),
        "layers.wq": ((l, d, h_flat), ("stack", "fsdp", "heads_flat")),
        "layers.wk": ((l, d, kv_flat), ("stack", "fsdp", "heads_flat")),
        "layers.wv": ((l, d, kv_flat), ("stack", "fsdp", "heads_flat")),
        "layers.wo": ((l, h_flat, d), ("stack", "heads_flat", "fsdp")),
    }
    if cfg.moe is None:
        f = cfg.d_ff
        defs.update({
            "layers.wi": ((l, d, f), ("stack", "fsdp", "mlp")),
            "layers.wg": ((l, d, f), ("stack", "fsdp", "mlp")),
            "layers.wo_ff": ((l, f, d), ("stack", "mlp", "fsdp")),
        })
    else:
        e, fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        defs.update({
            "layers.router": ((l, d, e), ("stack", None, None)),
            "layers.wi_e": ((l, e, d, fe), ("stack", "expert", "fsdp", None)),
            "layers.wg_e": ((l, e, d, fe), ("stack", "expert", "fsdp", None)),
            "layers.wo_e": ((l, e, fe, d), ("stack", "expert", None, "fsdp")),
        })
        if cfg.moe.n_shared:
            fs = cfg.moe.n_shared * fe
            defs.update({
                "layers.ws_i": ((l, d, fs), ("stack", "fsdp", "mlp")),
                "layers.ws_g": ((l, d, fs), ("stack", "fsdp", "mlp")),
                "layers.ws_o": ((l, fs, d), ("stack", "mlp", "fsdp")),
            })
    return defs


def _param_defs(cfg: LMConfig) -> dict:
    """path -> shape, the reference's tree."""
    return {path: shape for path, (shape, _) in _param_axes(cfg).items()}


def param_pspecs(cfg: LMConfig, mesh) -> dict:
    """The reference's partition specs (tuples) of the parameter tree."""
    return nest({k: logical_to_pspec(ax, mesh) for k, (_, ax) in _param_axes(cfg).items()})


def _splits(cfg: LMConfig, mesh) -> dict:
    """The leaves a model rank holds a slice of (path -> dim of the stacked
    leaf): the experts, which the reference's MoE ``shard_map`` cuts over
    "model", and with ``ffn_impl="sp"`` the dense FFN's F."""
    paths = (("layers.wi_e", "layers.wg_e", "layers.wo_e") if cfg.moe is not None
             else ("layers.wi", "layers.wg", "layers.wo_ff") if cfg.ffn_impl == "sp" else ())
    flat = {k: logical_to_pspec(ax, mesh) for k, (_, ax) in _param_axes(cfg).items()}
    if cfg.moe is not None and cfg.moe.n_experts % mesh.shape.get("model", 1):
        raise ValueError(f"n_experts {cfg.moe.n_experts} does not split over "
                         f"{mesh.shape['model']} model ranks")
    return model_splits(flat, paths, _param_defs(cfg), mesh)


def one_rank(device) -> Mesh:
    """The 1 × 1 mesh of ``device``."""
    return make_mesh((1, 1), AXES, device=device)


def _dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param_specs(cfg: LMConfig) -> dict:
    """The parameter tree as meta tensors (no storage)."""
    return nest({k: sds(s, _dtype(cfg)) for k, s in _param_defs(cfg).items()})


class LM(nn.Module):
    """The parameters of one LM: ``embed``, ``unembed``, ``ln_f`` and
    ``layers[i][name]`` (an ``nn.ParameterDict`` a layer), each of the
    reference's shape without the stack axis, uninitialised, on ``device``
    or, given a ``mesh``, on its first device; a leaf ``_splits`` names is
    held as ``layers[i][f"{name}:{j}"]``, model rank j's slice on that
    rank's device. ``init_params`` and ``from_jax_params`` fill them."""

    def __init__(self, cfg: LMConfig, device=None, mesh=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(mesh.devices[0] if mesh is not None else device)
        self.mesh = mesh if mesh is not None else one_rank(dev)
        self.splits = _splits(cfg, self.mesh)
        n = self.mesh.shape.get("model", 1)
        dt = _dtype(cfg)

        def param(shape, on_dev=dev):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=on_dev))

        defs = _param_defs(cfg)
        self.embed = param(defs["embed"])
        self.unembed = param(defs["unembed"])
        self.ln_f = param(defs["ln_f"])
        layers = []
        for _ in range(cfg.n_layers):
            lp = nn.ParameterDict()
            for path, shape in defs.items():
                if not path.startswith("layers."):
                    continue
                name = path.split(".", 1)[1]
                if path in self.splits:
                    for j in range(n):
                        lp[f"{name}:{j}"] = param(sliced(shape[1:], self.splits[path] - 1, n),
                                                  self.mesh.devices[j])
                else:
                    lp[name] = param(shape[1:])
            layers.append(lp)
        self.layers = nn.ModuleList(layers)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def split_of(self, path: str):
        """(dim of the stacked leaf, model ranks) for a leaf held in slices,
        else None."""
        return (self.splits[path], self.mesh.shape["model"]) if path in self.splits else None

    def named_leaves(self):
        """(path, shape of the reference's leaf, tensors) for every leaf of
        the reference's tree: one tensor for the top-level ones, a layer's
        slice each for the ``layers.*`` stacks (its model ranks' slices in
        rank order, layer by layer, for a split one)."""
        for path, shape in _param_defs(self.cfg).items():
            if path.startswith("layers."):
                name = path.split(".", 1)[1]
                if path in self.splits:
                    n = self.mesh.shape["model"]
                    yield path, shape, [lp[f"{name}:{j}"] for lp in self.layers for j in range(n)]
                else:
                    yield path, shape, [lp[name] for lp in self.layers]
            else:
                yield path, shape, [getattr(self, path)]


def _shards(lp, name: str) -> list:
    """A layer's weight ``name``: its model ranks' slices, or itself alone."""
    if name in lp:
        return [lp[name]]
    out, j = [], 0
    while f"{name}:{j}" in lp:
        out.append(lp[f"{name}:{j}"])
        j += 1
    return out


@torch.no_grad()
def init_params(cfg: LMConfig, generator: torch.Generator, device=None, mesh=None) -> LM:
    """Ones for the norms, ``normal / sqrt(fan_in)`` elsewhere (fan_in the
    reference's ``shape[-2]``), drawn in f32 from ``generator`` on its device
    a layer's whole leaf at a time and cast to ``cfg.dtype``: the
    reference's init, not its random numbers, and the same numbers on every
    mesh. The model lives on ``device`` (default: the generator's) or over
    ``mesh``."""
    model = LM(cfg, device if device is not None else generator.device, mesh)
    for path, shape, tensors in model.named_leaves():
        split = model.split_of(path)
        n = split[1] if split else 1
        whole = shape[1:] if path.startswith("layers.") else shape
        for i in range(0, len(tensors), n):
            group = tensors[i:i + n]
            if path.endswith(("ln1", "ln2", "ln_f")):
                for t in group:
                    t.fill_(1.0)
                continue
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            w = torch.randn(whole, generator=generator, dtype=torch.float32,
                            device=generator.device)
            w = (w / math.sqrt(fan_in)).to(group[0].dtype)
            for t, part in zip(group, w.chunk(n, split[0] - 1) if split else [w]):
                t.copy_(part)
    return model


@torch.no_grad()
def from_jax_params(params_np: dict, cfg: LMConfig, device=None, mesh=None) -> LM:
    """An LM holding the JAX parameter tree ``params_np`` (nested dict of
    numpy arrays, whole leaves, bf16 as ml_dtypes' or upcast to f32), each
    ``layers.*`` stack sliced into its layers (and a split leaf into its
    model ranks' slices), on ``device`` (default the card) or over
    ``mesh``."""
    model = LM(cfg, device, mesh)
    for path, shape, tensors in model.named_leaves():
        node = params_np
        for part in path.split("."):
            node = node[part]
        if tuple(np.shape(node)) != tuple(shape):
            raise ValueError(f"{path}: shape {np.shape(node)} does not fit {shape}")
        fill(model, path, shape, tensors, torch.from_numpy(np.array(node, dtype=np.float32)))
    return model


def to_jax_params(model: LM) -> dict:
    """The inverse of ``from_jax_params``: the reference's nested tree of
    whole leaves, the layers stacked on a leading axis, as numpy arrays (f32
    for f32 models; bfloat16 upcast to f32 exactly, as npy has no bf16)."""
    return nest({path: join(model, path, shape, tensors).float().cpu().numpy()
                 for path, shape, tensors in model.named_leaves()})


# --------------------------------------------------------------- layers

def _rows(mesh, axes, b: int) -> int:
    """The batch rows over ``axes``; a batch ``b`` they do not split raises."""
    rows = axes_size(mesh, axes)
    if b % rows:
        raise ValueError(f"batch {b} does not split over {rows} batch ranks (pod × data)")
    return rows


def _row_devices(mesh, i: int, rows: int) -> list:
    """The devices of batch row ``i``'s model ranks, in rank order (the
    batch axes lead the mesh, "model" is last). A batch the batch ranks do
    not cut (``rows`` 1 under a decode's replicated batch) is one row held
    by every batch rank alike: its first ranks compute it, as each of the
    reference's would."""
    per = len(mesh.devices) // rows
    return list(mesh.devices[i * per:i * per + mesh.shape.get("model", 1)])


def _moe_block(h: torch.Tensor, lp, cfg: LMConfig, mesh, b_axes: tuple, *,
               seq_sharded: bool, with_aux: bool):
    """The reference's ``_moe_block``, rank by rank. h: [B, S, D] whole.
    Batch row i (of the rows over ``b_axes``) takes h's i-th batch slice;
    its model rank j holds experts [j·E_loc, (j+1)·E_loc). Gather path: each
    rank dispatches the row's tokens (the sequence gathered when
    ``seq_sharded``) to its experts with the capacity of ``b_loc·s`` tokens,
    and the ranks' f32 outputs are summed in rank order (the reference's
    psum, or psum_scatter over the sequence). a2a path (``moe_impl="a2a"``,
    ``seq_sharded``, model > 1): ``layers.moe_a2a_local`` over the ranks'
    sequence slices. Returns (out [B, S, D], aux), aux None unless
    ``with_aux``: the load-balance aux summed over the model ranks (a2a: its
    per-rank approximation, averaged). The reference returns it as
    replicated over the batch rows, which it is not: its value is the first
    row's and its gradient the mean of the rows' gradients, as here."""
    moe = cfg.moe
    model_n = mesh.shape.get("model", 1)
    e_loc = moe.n_experts // model_n
    b, s, d = h.shape
    rows = _rows(mesh, b_axes, b)
    if seq_sharded and s % model_n:
        raise ValueError(f"sequence {s} does not split over {model_n} model ranks")
    b_loc = b // rows
    s_loc = s // model_n if seq_sharded else s
    t_gathered = b_loc * s
    capacity = max(1, int(math.ceil(t_gathered * moe.top_k / moe.n_experts * moe.capacity_factor)))
    use_a2a = cfg.moe_impl == "a2a" and seq_sharded and model_n > 1
    t_loc = b_loc * s_loc
    c_send = max(1, int(math.ceil(t_loc * moe.top_k / model_n * moe.capacity_factor)))
    c_exp = max(1, int(math.ceil(model_n * c_send / e_loc * moe.capacity_factor)))
    wi, wg, wo = (_shards(lp, n) for n in ("wi_e", "wg_e", "wo_e"))
    outs, auxes = [], []
    for i in range(rows):
        devs = _row_devices(mesh, i, rows)
        h_i = h[i * b_loc:(i + 1) * b_loc]
        router = [replica(lp, lp["router"], dev) for dev in devs]
        experts = [tuple(replica(lp, w[j], dev) for w in (wi, wg, wo))
                   for j, dev in enumerate(devs)]
        if use_a2a:
            x = [on(h_i[:, j * s_loc:(j + 1) * s_loc].reshape(-1, d), dev)
                 for j, dev in enumerate(devs)]
            parts = L.moe_a2a_local(x, router, e_loc, moe.top_k, c_send, c_exp, experts)
            out_i = torch.cat([on(p.reshape(b_loc, s_loc, d).to(h.dtype), devs[0])
                               for p in parts], 1)
            if with_aux:
                tot = None
                for xj, rj in zip(x, router):
                    probs = L.router_probs(xj, rj)
                    top = F.one_hot(probs.argmax(-1), moe.n_experts).float()
                    a_j = on(moe.n_experts * (probs.mean(0) * top.mean(0)).sum(), devs[0])
                    tot = a_j if tot is None else tot + a_j
                auxes.append(tot / model_n)
        else:
            x_flat = h_i.reshape(-1, d)
            tt = x_flat.shape[0]
            aux_parts = []

            def rank_parts():
                for j, dev in enumerate(devs):
                    xj = on(x_flat, dev)
                    buf, gbuf, tbuf = L.moe_dispatch_local(xj, router[j], j * e_loc, e_loc,
                                                           moe.top_k, capacity)
                    eout = L.moe_expert_ffn(buf, *experts[j])
                    yield on(L.moe_combine_local(eout, gbuf, tbuf, tt, moe.top_k), devs[0])
                    if with_aux:                 # Switch: E · Σ_e f_e · p_e, local experts
                        p_e = L.router_probs(xj, router[j]).mean(0)[j * e_loc:(j + 1) * e_loc]
                        f_e = (tbuf < tt).sum(-1).float() / max(tt * moe.top_k, 1)
                        aux_parts.append(on(moe.n_experts * (f_e * p_e).sum(), devs[0]))

            out_i = psum(rank_parts()).reshape(h_i.shape).to(h.dtype)
            if with_aux:
                aux_i = aux_parts[0]
                for a_j in aux_parts[1:]:
                    aux_i = aux_i + a_j
                auxes.append(aux_i)
        outs.append(on(out_i, h.device))
    out = torch.cat(outs) if rows > 1 else outs[0]
    if moe.n_shared:
        out = out + L.swiglu_mlp(h, lp["ws_i"], lp["ws_g"], lp["ws_o"])
    aux = None
    if auxes:
        # the reference returns the aux as replicated (out spec P()): its value is
        # the first batch row's, its cotangent is shared out evenly over the rows
        auxes = [on(a, h.device) for a in auxes]
        aux = auxes[0]
        if rows > 1:
            mean = sum(auxes[1:], auxes[0]) / rows
            aux = aux.detach() + (mean - mean.detach())
    return out, aux


def _sp_ffn(h2: torch.Tensor, lp) -> torch.Tensor:
    """The SwiGLU FFN with F cut over the model ranks: rank j computes its
    columns' ``(silu(h2 @ wg_j) * (h2 @ wi_j)) @ wo_ff_j`` and the partial
    outputs are summed in rank order in f32, then cast back: ``swiglu_mlp``
    up to the order of the sum over F."""
    return psum(on(L.swiglu_mlp(on(h2, wi.device), wi, wg, wo).float(), h2.device)
                for wi, wg, wo in zip(*(_shards(lp, n) for n in ("wi", "wg", "wo_ff")))
                ).to(h2.dtype)


def _ffn(h2: torch.Tensor, lp, cfg: LMConfig, mesh, b_axes: tuple, seq_sharded: bool,
         with_aux: bool = False):
    if cfg.moe is None:
        if len(_shards(lp, "wi")) > 1:
            return _sp_ffn(h2, lp), None
        return L.swiglu_mlp(h2, lp["wi"], lp["wg"], lp["wo_ff"]), None
    return _moe_block(h2, lp, cfg, mesh, b_axes, seq_sharded=seq_sharded, with_aux=with_aux)


def _layer(x: torch.Tensor, lp, cfg: LMConfig, positions: torch.Tensor, q_offset: int,
           mesh, with_aux: bool = False):
    """One causal layer over [B, S, D]: (x, k, v, aux), k and v as the cache
    keeps them (after RoPE), aux as ``_moe_block`` gives it. The MoE is
    sequence-sharded when S > 1, as in the reference's forward."""
    b, s, _ = x.shape
    h = L.rmsnorm(x, lp["ln1"])
    q = (h @ lp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ lp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ lp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = L.flash_attention(q, k, v, causal=True, block=min(cfg.attn_block, s), q_offset=q_offset,
                          score_dtype=getattr(torch, cfg.attn_score_dtype))
    x = x + o.reshape(b, s, -1) @ lp["wo"]
    ff, aux = _ffn(L.rmsnorm(x, lp["ln2"]), lp, cfg, mesh, batch_axes(mesh), s > 1, with_aux)
    return x + ff, k, v, aux


def _remat(fn, remat: str, *args):
    """``fn(*args)``; while autograd records, under the reference's per-layer
    remat policy: "full" keeps only the inputs and recomputes the rest in
    backward, "dots" keeps the matmul outputs too, "none" keeps everything.
    Remat changes what is held between forward and backward, not a value."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=_save_dots)
    raise ValueError(f"unknown remat {remat!r}: full, dots or none")


# JAX's checkpoint_dots saves every dot_general's output: here the aten
# products the layer's matmuls reach
_save_dots = functools.partial(create_selective_checkpoint_contexts,
                               [torch.ops.aten.mm.default, torch.ops.aten.bmm.default])


def _train_layer(x, lp, cfg: LMConfig, positions, q_offset: int, mesh):
    x, _, _, aux = _layer(x, lp, cfg, positions, q_offset, mesh, with_aux=True)
    return x, aux


def forward(model: LM, tokens: torch.Tensor, *, q_offset: int = 0, mesh=None):
    """Causal forward: tokens [B, S] -> (final hidden [B, S, D] before the
    unembed, MoE aux loss summed over layers, f32), over ``mesh`` (default
    the model's). Differentiable; while autograd records, each layer is
    rematerialized as ``cfg.remat`` says."""
    cfg = model.cfg
    mesh = mesh if mesh is not None else model.mesh
    _check_model(model, mesh)
    s = tokens.shape[1]
    x = L.take_rows(model.embed, on(tokens, model.device).long()).to(_dtype(cfg))
    positions = q_offset + torch.arange(s, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in model.layers:
        x, aux_l = _remat(_train_layer, cfg.remat, x, lp, cfg, positions, q_offset, mesh)
        if aux_l is not None:
            aux = aux + aux_l
    return L.rmsnorm(x, model.ln_f), aux


def _chunk_ce(hidden: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor):
    """Σ (logsumexp − gold logit) over [B, S'] positions; the logits are the
    product in the operands' type cast to f32, as prefill computes them."""
    logits = (hidden @ unembed).float()
    gold = torch.take_along_dim(logits, labels.long()[..., None], -1)[..., 0]
    return (torch.logsumexp(logits, -1) - gold).sum()


def _softmax_ce(hidden: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor,
                chunks: int) -> torch.Tensor:
    """Mean next-token cross-entropy over [B, S]. With ``chunks`` > 1 the
    sequence is cut into ``chunks`` pieces, added in order, each piece's
    [B, S/chunks, V] logits recomputed in backward rather than held."""
    b, s, _ = hidden.shape
    if chunks <= 1:
        return _chunk_ce(hidden, unembed, labels) / (b * s)
    if s % chunks:
        raise ValueError(f"sequence {s} does not split into {chunks} logits chunks")
    c = s // chunks
    loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(chunks):
        loss = loss + _remat(_chunk_ce, "full", hidden[:, i * c:(i + 1) * c], unembed,
                             labels[:, i * c:(i + 1) * c])
    return loss / (b * s)


def loss_fn(model: LM, tokens: torch.Tensor, labels: torch.Tensor, mesh=None):
    """(loss, ce, aux): the reference's ``ce + 0.01·aux``."""
    hidden, aux = forward(model, tokens, mesh=mesh)
    ce = _softmax_ce(hidden, model.unembed, labels, model.cfg.logits_chunk)
    return ce + 0.01 * aux, ce, aux


# --------------------------------------------------------------- mesh

def _check_model(model: LM, mesh) -> None:
    """A model that holds slices must hold one a model rank of the step's
    mesh (a model without slices runs over any mesh)."""
    have, want = model.mesh.shape.get("model", 1), mesh.shape.get("model", 1)
    if model.splits and have != want:
        raise ValueError(f"the model's slices are cut over {have} model ranks; the step's "
                         f"mesh has {want}")


def _check_seq(mesh, b: int, s: int) -> None:
    """Prefill and training shard the batch over ("pod", "data") and the
    sequence over "model": both must split evenly."""
    _rows(mesh, batch_axes(mesh), b)
    n = mesh.shape.get("model", 1)
    if s % n:
        raise ValueError(f"sequence {s} does not split over {n} model ranks")


def _decode_seq_axes(mesh, global_batch: int):
    """(batch axes, sequence axes) of the KV cache: the batch over the batch
    axes and the sequence over "model", or, when the batch is smaller than
    the batch ranks or does not split over them, the sequence over every
    axis."""
    b_axes = batch_axes(mesh)
    bprod = axes_size(mesh, b_axes)
    if global_batch % max(bprod, 1) == 0 and global_batch >= bprod:
        return b_axes, ("model",)
    return (), tuple(a for a in (*b_axes, "model") if a in mesh.axis_names)


def cache_pspecs(cfg: LMConfig, mesh, global_batch: int) -> dict:
    """The reference's partition specs of the decode cache [L, B, S, KV, Dh]."""
    b_axes, seq_axes = _decode_seq_axes(mesh, global_batch)
    spec = (None, axes_entry(b_axes), axes_entry(seq_axes), None, None)
    return {"k": spec, "v": spec}


def _coords(mesh, r: int) -> dict:
    """Rank ``r``'s index along every axis (row-major ranks)."""
    out = {}
    for ax, n in reversed(list(zip(mesh.axis_names, mesh.sizes))):
        out[ax] = r % n
        r //= n
    return out


def _index(mesh, coords: dict, axes: tuple) -> int:
    idx = 0
    for ax in axes:
        idx = idx * mesh.shape[ax] + coords[ax]
    return idx


def cache_layout(mesh, global_batch: int, seq_len: int) -> list:
    """One (batch slice, sequence slice) a rank, in rank order: rank r holds
    rows [b0, b1) and positions [s0, s1) of the cache. A batch or a cache
    length its ranks do not split raises."""
    b_axes, seq_axes = _decode_seq_axes(mesh, global_batch)
    nb, ns = axes_size(mesh, b_axes), axes_size(mesh, seq_axes)
    if global_batch % nb:
        raise ValueError(f"batch {global_batch} does not split over {nb} batch ranks")
    if seq_len % ns:
        raise ValueError(f"cache length {seq_len} does not split over {ns} sequence ranks")
    b_loc, s_loc = global_batch // nb, seq_len // ns
    out = []
    for r in range(len(mesh.devices)):
        c = _coords(mesh, r)
        bi, si = _index(mesh, c, b_axes), _index(mesh, c, seq_axes)
        out.append(((bi * b_loc, (bi + 1) * b_loc), (si * s_loc, (si + 1) * s_loc)))
    return out


def split_cache(cache: dict, mesh) -> dict:
    """The stacked cache ``{"k", "v"}: [L, B, S, KV, Dh]`` cut into one
    [L, B_loc, S_loc, KV, Dh] copy a rank, on its device (``cache_layout``):
    ``{"k": [rank 0's, ...], "v": [...]}``."""
    _, b, s, _, _ = cache["k"].shape
    out = {}
    for name in ("k", "v"):
        whole = cache[name]
        out[name] = [torch.empty((whole.shape[0], b1 - b0, s1 - s0, *whole.shape[3:]),
                                 dtype=whole.dtype, device=dev).copy_(whole[:, b0:b1, s0:s1])
                     for ((b0, b1), (s0, s1)), dev in zip(cache_layout(mesh, b, s), mesh.devices)]
    return out


def join_cache(cache: dict, mesh, global_batch: int) -> dict:
    """The inverse of ``split_cache`` for a batch of ``global_batch``: the
    stacked cache on the first rank's device."""
    ns = axes_size(mesh, _decode_seq_axes(mesh, global_batch)[1])
    k0 = cache["k"][0]
    layout = cache_layout(mesh, global_batch, k0.shape[2] * ns)
    out = {}
    for name in ("k", "v"):
        whole = torch.empty((k0.shape[0], global_batch, k0.shape[2] * ns, *k0.shape[3:]),
                            dtype=k0.dtype, device=k0.device)
        for ((b0, b1), (s0, s1)), part in zip(layout, cache[name]):
            whole[:, b0:b1, s0:s1] = on(part, k0.device)
        out[name] = whole
    return out


# --------------------------------------------------------------- prefill

def make_prefill_step(cfg: LMConfig, mesh):
    """Forward + KV cache and last-position logits (inference prefill):
    ``prefill_step(model, tokens [B, S]) -> (logits [B, V] f32, cache)``,
    the cache ``{"k", "v"}`` the ranks' slices of [L, B, S, KV, Dh] in
    rank order (``split_cache``'s layout)."""

    @torch.inference_mode()
    def prefill_step(model: LM, tokens: torch.Tensor):
        _check_model(model, mesh)
        b, s = tokens.shape
        _check_seq(mesh, b, s)
        x = model.embed[on(tokens, model.device).long()].to(_dtype(cfg))
        positions = torch.arange(s, device=x.device)
        layout = cache_layout(mesh, b, s)
        cache = {n: [torch.empty((cfg.n_layers, b1 - b0, s1 - s0, cfg.n_kv_heads, cfg.head_dim),
                                 dtype=x.dtype, device=dev)
                     for ((b0, b1), (s0, s1)), dev in zip(layout, mesh.devices)]
                 for n in ("k", "v")}
        for li, lp in enumerate(model.layers):
            x, k, v, _ = _layer(x, lp, cfg, positions, 0, mesh)
            for r, ((b0, b1), (s0, s1)) in enumerate(layout):
                cache["k"][r][li] = k[b0:b1, s0:s1]
                cache["v"][r][li] = v[b0:b1, s0:s1]
        last = L.rmsnorm(x[:, -1], model.ln_f)
        logits = (last @ model.unembed).float()
        return logits, cache

    return prefill_step


# --------------------------------------------------------------- decode

def _decode_partial(q: torch.Tensor, k_l: torch.Tensor, v_l: torch.Tensor, valid: torch.Tensor,
                    n_heads: int):
    """One rank's flash-decode over its cache slice: q [B, 1, H, Dh]; k_l,
    v_l [B, S_loc, KV, Dh]; valid [S_loc] bool. Returns f32 (m [B, KV, G],
    l [B, KV, G], o [B, KV, G, Dh]): the masked scores' max, the sum of
    exp(score − m) and the unnormalised output."""
    b, s, kv, dh = k_l.shape
    g = n_heads // kv
    qg = L.f32(q.to(k_l.dtype).reshape(b, kv, g, dh))
    sc = torch.matmul(qg, L.f32(k_l.permute(0, 2, 3, 1))) * L.score_scale(dh, q.device)  # [B, KV, G, S]
    sc = torch.where(valid, sc, -1e30)
    m = sc.amax(-1)
    p = torch.exp(sc - m[..., None])
    l = p.sum(-1)
    o = torch.matmul(p.to(k_l.dtype).float(), L.f32(v_l.permute(0, 2, 1, 3)))  # [B, KV, G, Dh]
    return m, l, o


def _flash_decode(q: torch.Tensor, kc: list, vc: list, layer: int, cache_len: int, layout,
                  n_heads: int) -> torch.Tensor:
    """q: [B, 1, H, Dh] whole; ``kc`` / ``vc``: the ranks' stacked cache
    slices. Each rank attends its batch rows over its positions under the
    ``cache_len`` mask; the ranks that share a batch slice merge in rank
    order: m = max of their m, l = Σ l·exp(m_r − m), o = Σ o·exp(m_r − m),
    out = o / l. Returns f32 [B, 1, H, Dh] on q's device."""
    b, _, h, dh = q.shape
    groups: dict = {}
    for r, ((b0, b1), (s0, s1)) in enumerate(layout):
        k_l = kc[r][layer]
        dev = k_l.device
        valid = (s0 + torch.arange(s1 - s0, device=dev)) < cache_len
        groups.setdefault((b0, b1), []).append(
            _decode_partial(on(q[b0:b1], dev), k_l, vc[r][layer], valid, n_heads))
    out = torch.empty((b, 1, h, dh), dtype=torch.float32, device=q.device)
    for (b0, b1), parts in groups.items():
        parts = [tuple(on(t, q.device) for t in p) for p in parts]
        m_g = parts[0][0]
        for m, _, _ in parts[1:]:
            m_g = torch.maximum(m_g, m)
        l_g = o_g = None
        for m, l, o in parts:
            corr = torch.exp(m - m_g)
            l_g = l * corr if l_g is None else l_g + l * corr
            o_g = o * corr[..., None] if o_g is None else o_g + o * corr[..., None]
        o = o_g / torch.clamp(l_g, min=1e-30)[..., None]          # [B_loc, KV, G, Dh]
        out[b0:b1] = o.reshape(b1 - b0, 1, h, dh)
    return out


@torch.inference_mode()
def decode_logits(model: LM, cache: dict, tokens: torch.Tensor, pos, mesh=None) -> torch.Tensor:
    """One decode step's f32 logits [B, V] for ``tokens`` [B, 1] at ``pos``
    (an int or a 0-d tensor, the current length), over ``mesh`` (default
    the model's), ``cache`` the ranks' slices (``split_cache``'s layout):
    the new K/V are written at (layer, pos) of the rank that owns pos, in
    place, then each layer attends over positions ≤ pos (``_flash_decode``).
    The MoE is not sequence-sharded here; its batch rows are the cache's."""
    cfg = model.cfg
    mesh = mesh if mesh is not None else model.mesh
    _check_model(model, mesh)
    dt = _dtype(cfg)
    pos = int(pos)
    b = tokens.shape[0]
    kc, vc = list(cache["k"]), list(cache["v"])
    if len(kc) != len(mesh.devices):
        raise ValueError(f"a cache of {len(kc)} slices for {len(mesh.devices)} ranks "
                         f"(split_cache cuts the stacked one)")
    b_axes, seq_axes = _decode_seq_axes(mesh, b)
    layout = cache_layout(mesh, b, kc[0].shape[2] * axes_size(mesh, seq_axes))
    x = model.embed[on(tokens, model.device).long()].to(dt)             # [B, 1, D]
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    for li, lp in enumerate(model.layers):
        h = L.rmsnorm(x, lp["ln1"])
        q = (h @ lp["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
        k = (h @ lp["wk"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ lp["wv"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
        q = L.apply_rope(q, posv, cfg.rope_theta)
        k = L.apply_rope(k, posv, cfg.rope_theta)
        for r, ((b0, b1), (s0, s1)) in enumerate(layout):
            if s0 <= pos < s1:                    # only the owner writes
                kc[r][li, :, pos - s0] = on(k[b0:b1, 0], kc[r].device).to(kc[r].dtype)
                vc[r][li, :, pos - s0] = on(v[b0:b1, 0], vc[r].device).to(vc[r].dtype)
        o = _flash_decode(q, kc, vc, li, pos + 1, layout, cfg.n_heads)
        x = (x + o.to(dt).reshape(b, 1, -1) @ lp["wo"]).to(dt)
        ff, _ = _ffn(L.rmsnorm(x, lp["ln2"]), lp, cfg, mesh, b_axes, False)
        x = (x + ff).to(dt)
    x = L.rmsnorm(x[:, 0], model.ln_f)
    return (x @ model.unembed).float()


def make_decode_step(cfg: LMConfig, mesh, global_batch: int, seq_len: int):
    """One greedy decode step: ``decode_step(model, cache, tokens [B, 1],
    pos) -> (next_tok [B] int32, cache)``, the cache written in place
    (``decode_logits``, the ranks' slices);
    the first of equal logits wins, as in JAX."""
    cache_layout(mesh, global_batch, seq_len)         # a mesh that cannot cut the cache raises

    def decode_step(model: LM, cache: dict, tokens: torch.Tensor, pos):
        logits = decode_logits(model, cache, tokens, pos, mesh)
        return logits.argmax(-1).to(torch.int32), cache

    return decode_step


# --------------------------------------------------------------- train step

def make_train_step(cfg: LMConfig, mesh):
    """One optimizer step: ``train_step(state, batch) -> (state, metrics)``
    with ``state`` a ``TrainState`` (or any ``(model, tx)``), updated in
    place, and ``batch`` ``{"tokens", "labels"}`` int [B, S]. With
    ``cfg.grad_accum`` > 1 the batch is cut into that many microbatches
    (each MoE layer's capacity from the microbatch's own tokens); each one's
    gradients are added, cast to f32, into an f32 accumulator, which is
    divided by their count and cast back to the parameters' dtype. Then the
    gradients (each rank's expert and FFN slices their own) are clipped to
    global norm 1 and ``tx.update`` applies them. Metrics: loss, ce, moe_aux
    (means over the microbatches) and grad_norm (before the clip). The
    reference takes its optimizer here; the port's is bound to a model's
    parameters, so it rides in the state."""
    resolve_device(mesh.devices[0])
    accum = max(1, cfg.grad_accum)

    def train_step(state, batch):
        model, tx = state
        _check_model(model, mesh)
        params = tx.params
        tokens, labels = (on(batch[k], model.device) for k in ("tokens", "labels"))
        b, s = tokens.shape
        if b % accum:
            raise ValueError(f"batch {b} does not split into {accum} microbatches")
        _check_seq(mesh, b // accum, s)
        if accum == 1:
            loss, ce, aux = loss_fn(model, tokens, labels, mesh)
            grads = torch.autograd.grad(loss, params)
        else:
            gacc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            loss = ce = aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for toks, labs in zip(tokens.reshape(accum, b // accum, -1),
                                  labels.reshape(accum, b // accum, -1)):
                l_i, ce_i, aux_i = loss_fn(model, toks, labs, mesh)
                for a, g in zip(gacc, torch.autograd.grad(l_i, params)):
                    a.add_(g.float())
                loss, ce, aux = loss + l_i.detach(), ce + ce_i.detach(), aux + aux_i.detach()
            grads = [(a / accum).to(p.dtype) for a, p in zip(gacc, params)]
            del gacc
            loss, ce, aux = loss / accum, ce / accum, aux / accum
        grads, gnorm = opt.clip_by_global_norm([on(g, model.device) for g in grads], 1.0)
        tx.update([on(g, p.device) for g, p in zip(grads, params)])
        return state, {"loss": loss.detach(), "ce": ce.detach(), "moe_aux": aux.detach(),
                       "grad_norm": gnorm}

    return train_step


# --------------------------------------------------------------- bundle

def cache_specs(cfg: LMConfig, global_batch: int, seq_len: int) -> dict:
    shape = (cfg.n_layers, global_batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": sds(shape, _dtype(cfg)), "v": sds(shape, _dtype(cfg))}


def make_bundle(cfg: LMConfig, mesh) -> ModelBundle:
    """The LM's bundle over ``mesh``: ``init(generator)`` builds the model
    placed over it; ``optimizer(model)`` is the reference's AdamW (cosine
    schedule 3e-4, 100 warm-up steps of 10,000, decay 0.1); the ``train``
    step is ``make_train_step``'s, called with ``TrainState(model,
    optimizer(model))``; ``prefill`` and ``decode`` are served. A shape the
    mesh cannot cut raises here."""
    _splits(cfg, mesh)                                # E or F the model ranks do not split raise

    def step(shape: ShapeSpec) -> StepDef:
        s, gb = shape["seq_len"], shape["global_batch"]
        if shape.kind == "train":
            _check_seq(mesh, gb // max(1, cfg.grad_accum), s)
            return StepDef(fn=make_train_step(cfg, mesh),
                           input_specs={"tokens": sds((gb, s), torch.int32),
                                        "labels": sds((gb, s), torch.int32)})
        if shape.kind == "prefill":
            _check_seq(mesh, gb, s)
            return StepDef(fn=make_prefill_step(cfg, mesh),
                           input_specs={"tokens": sds((gb, s), torch.int32)})
        if shape.kind == "decode":
            return StepDef(fn=make_decode_step(cfg, mesh, gb, s),
                           input_specs={"cache": cache_specs(cfg, gb, s),
                                        "tokens": sds((gb, 1), torch.int32),
                                        "pos": sds((), torch.int32)})
        raise ValueError(f"unknown shape kind {shape.kind} for LM arch")

    return ModelBundle(
        name=cfg.arch,
        config=cfg,
        init=lambda generator, shape=None: init_params(cfg, generator, mesh=mesh),
        param_specs=lambda shape=None: param_specs(cfg),
        param_pspecs=lambda shape=None: param_pspecs(cfg, mesh),
        step=step,
        optimizer=lambda model: adamw(model, opt.cosine_schedule(3e-4, warmup=100, total=10_000),
                                      weight_decay=0.1),
        opt_specs=lambda shape=None: adamw_state_specs(param_specs(cfg)),
        opt_pspecs=lambda shape=None: adamw_state_pspecs(param_pspecs(cfg, mesh)),
    )
