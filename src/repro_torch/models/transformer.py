"""Dense + MoE GQA transformer LM, the five LM architectures (counterpart of
``repro/models/transformer.py``), serving on one device.

  * parameters: the reference's tree, ``embed`` [V, D], ``unembed`` [D, V],
    ``ln_f`` [D] and per layer ``ln1``, ``ln2``, ``wq`` [D, H·Dh], ``wk`` /
    ``wv`` [D, KV·Dh], ``wo`` [H·Dh, D] and the FFN's (dense ``wi``, ``wg``
    [D, F], ``wo_ff`` [F, D]; MoE ``router`` [D, E], ``wi_e`` / ``wg_e``
    [E, D, Fe], ``wo_e`` [E, Fe, D] and the shared experts' ``ws_i``,
    ``ws_g``, ``ws_o``), every weight [in, out] as in JAX, so
    ``from_jax_params`` / ``to_jax_params`` carry a JAX tree by copying;
  * attention: the online-softmax loop over KV blocks (``layers.
    flash_attention``), no [S, S] matrix;
  * MoE: sort-based token-choice dispatch over every expert, capacity-bound,
    dropped pairs written to a spare row (``layers.moe_dispatch_local``);
  * serving: ``make_prefill_step`` returns last-position f32 logits and the
    stacked cache ``{"k", "v"}: [L, B, S, KV, Dh]`` (the reference's layout,
    so a JAX prefill's cache feeds this decode); ``make_decode_step`` writes
    the cache in place at (layer, pos) (the reference donates it) and
    returns the greedy next token.

The meshed LM (sequence-sharded decode, expert parallelism, the
sequence-parallel FFN) and training are not ported yet: a mesh other than
1 × 1 and the ``train`` shape kind raise.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.models import layers as L
from repro_torch.models.api import ModelBundle, ShapeSpec, StepDef, sds
from repro_torch.utils.device import resolve_device


# --------------------------------------------------------------- param layout

def _param_defs(cfg: LMConfig) -> dict:
    """path -> shape. Layer params carry a leading stack axis [L, ...], as in
    the reference's tree."""
    d, v = cfg.d_model, cfg.vocab
    h_flat = cfg.n_heads * cfg.head_dim
    kv_flat = cfg.n_kv_heads * cfg.head_dim
    l = cfg.n_layers
    defs = {
        "embed": (v, d),
        "unembed": (d, v),
        "ln_f": (d,),
        "layers.ln1": (l, d),
        "layers.ln2": (l, d),
        "layers.wq": (l, d, h_flat),
        "layers.wk": (l, d, kv_flat),
        "layers.wv": (l, d, kv_flat),
        "layers.wo": (l, h_flat, d),
    }
    if cfg.moe is None:
        f = cfg.d_ff
        defs.update({
            "layers.wi": (l, d, f),
            "layers.wg": (l, d, f),
            "layers.wo_ff": (l, f, d),
        })
    else:
        e, fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        defs.update({
            "layers.router": (l, d, e),
            "layers.wi_e": (l, e, d, fe),
            "layers.wg_e": (l, e, d, fe),
            "layers.wo_e": (l, e, fe, d),
        })
        if cfg.moe.n_shared:
            fs = cfg.moe.n_shared * fe
            defs.update({
                "layers.ws_i": (l, d, fs),
                "layers.ws_g": (l, d, fs),
                "layers.ws_o": (l, fs, d),
            })
    return defs


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, val in flat.items():
        node = out
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def _dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param_specs(cfg: LMConfig) -> dict:
    """The parameter tree as meta tensors (no storage)."""
    return _nest({k: sds(s, _dtype(cfg)) for k, s in _param_defs(cfg).items()})


class LM(nn.Module):
    """The parameters of one LM: ``embed``, ``unembed``, ``ln_f`` and
    ``layers[i][name]`` (an ``nn.ParameterDict`` a layer), each of the
    reference's shape without the stack axis, uninitialised, on ``device``.
    ``init_params`` and ``from_jax_params`` fill them."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dev, dt = resolve_device(device), _dtype(cfg)

        def param(shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=dev), requires_grad=False)

        defs = _param_defs(cfg)
        self.embed = param(defs["embed"])
        self.unembed = param(defs["unembed"])
        self.ln_f = param(defs["ln_f"])
        self.layers = nn.ModuleList(
            nn.ParameterDict({path.split(".", 1)[1]: param(shape[1:])
                              for path, shape in defs.items() if path.startswith("layers.")})
            for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def named_leaves(self):
        """(path, shape of the reference's leaf, tensors) for every leaf of
        the reference's tree: one tensor for the top-level ones, a layer's
        slice each for the ``layers.*`` stacks."""
        for path, shape in _param_defs(self.cfg).items():
            if path.startswith("layers."):
                name = path.split(".", 1)[1]
                yield path, shape, [lp[name] for lp in self.layers]
            else:
                yield path, shape, [getattr(self, path)]


@torch.no_grad()
def init_params(cfg: LMConfig, generator: torch.Generator, device=None) -> LM:
    """Ones for the norms, ``normal / sqrt(fan_in)`` elsewhere (fan_in the
    reference's ``shape[-2]``), drawn in f32 from ``generator`` on its device
    and cast to ``cfg.dtype``: the reference's init, not its random numbers.
    The model lives on ``device`` (default: the generator's)."""
    model = LM(cfg, device if device is not None else generator.device)
    for path, shape, tensors in model.named_leaves():
        for t in tensors:
            if path.endswith(("ln1", "ln2", "ln_f")):
                t.fill_(1.0)
            else:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                w = torch.randn(t.shape, generator=generator, dtype=torch.float32,
                                device=generator.device)
                t.copy_((w / math.sqrt(fan_in)).to(t.dtype))
    return model


@torch.no_grad()
def from_jax_params(params_np: dict, cfg: LMConfig, device=None) -> LM:
    """An LM holding the JAX parameter tree ``params_np`` (nested dict of
    numpy arrays, bf16 as ml_dtypes' or upcast to f32), each ``layers.*``
    stack sliced into its layers, on ``device`` (default the card)."""
    model = LM(cfg, device)
    for path, shape, tensors in model.named_leaves():
        node = params_np
        for part in path.split("."):
            node = node[part]
        if tuple(np.shape(node)) != tuple(shape):
            raise ValueError(f"{path}: shape {np.shape(node)} does not fit {shape}")
        src = torch.from_numpy(np.array(node, dtype=np.float32))
        if path.startswith("layers."):
            for t, layer_src in zip(tensors, src):
                t.copy_(layer_src)
        else:
            tensors[0].copy_(src)
    return model


def to_jax_params(model: LM) -> dict:
    """The inverse of ``from_jax_params``: the reference's nested tree, the
    layers stacked on a leading axis, as numpy arrays (f32 for f32 models;
    bfloat16 upcast to f32 exactly, as npy has no bf16)."""
    flat = {}
    for path, _, tensors in model.named_leaves():
        arrs = [t.detach().float().cpu().numpy() for t in tensors]
        flat[path] = np.stack(arrs) if path.startswith("layers.") else arrs[0]
    return _nest(flat)


# --------------------------------------------------------------- layers

def _check_mesh(mesh) -> None:
    if any(s != 1 for s in mesh.sizes):
        raise NotImplementedError(
            f"the LM runs on one device; mesh {mesh.shape} needs the meshed LM "
            f"(sequence-sharded decode, expert parallelism), which is not ported yet")


def _moe_block(h: torch.Tensor, lp, cfg: LMConfig, with_aux: bool):
    """The reference's ``_moe_block`` on one device (model axis 1: every
    expert local, no collective). h: [B, S, D]. Returns (out, aux), aux None
    unless ``with_aux`` (the serving steps have no use for it)."""
    moe = cfg.moe
    b, s, d = h.shape
    t = b * s
    capacity = max(1, int(math.ceil(t * moe.top_k / moe.n_experts * moe.capacity_factor)))
    x_flat = h.reshape(t, d)
    buf, gbuf, tbuf = L.moe_dispatch_local(x_flat, lp["router"], 0, moe.n_experts,
                                           moe.top_k, capacity)
    eout = L.moe_expert_ffn(buf, lp["wi_e"], lp["wg_e"], lp["wo_e"])
    out = L.moe_combine_local(eout, gbuf, tbuf, t, moe.top_k).reshape(b, s, d)
    aux = None
    if with_aux:                        # load-balance aux (Switch): E · Σ_e f_e · p_e
        p_e = L.router_probs(x_flat, lp["router"]).mean(0)
        f_e = (tbuf < t).sum(-1).float() / max(t * moe.top_k, 1)
        aux = moe.n_experts * (f_e * p_e).sum()
    out = out.to(h.dtype)
    if moe.n_shared:
        out = out + L.swiglu_mlp(h, lp["ws_i"], lp["ws_g"], lp["ws_o"])
    return out, aux


def _ffn(h2: torch.Tensor, lp, cfg: LMConfig, with_aux: bool = False):
    if cfg.moe is None:
        return L.swiglu_mlp(h2, lp["wi"], lp["wg"], lp["wo_ff"]), None
    return _moe_block(h2, lp, cfg, with_aux)


def _layer(x: torch.Tensor, lp, cfg: LMConfig, positions: torch.Tensor, q_offset: int,
           with_aux: bool = False):
    """One causal layer over [B, S, D]: (x, k, v, aux), k and v as the cache
    keeps them (after RoPE), aux as ``_moe_block`` gives it."""
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
    ff, aux = _ffn(L.rmsnorm(x, lp["ln2"]), lp, cfg, with_aux)
    return x + ff, k, v, aux


@torch.inference_mode()
def forward(model: LM, tokens: torch.Tensor, *, q_offset: int = 0):
    """Causal forward (inference only): tokens [B, S] -> (final hidden
    [B, S, D] before the unembed, MoE aux loss summed over layers)."""
    cfg = model.cfg
    s = tokens.shape[1]
    x = model.embed[tokens.long()].to(_dtype(cfg))
    positions = q_offset + torch.arange(s, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in model.layers:
        x, _, _, aux_l = _layer(x, lp, cfg, positions, q_offset, with_aux=True)
        if aux_l is not None:
            aux = aux + aux_l
    return L.rmsnorm(x, model.ln_f), aux


# --------------------------------------------------------------- prefill

def make_prefill_step(cfg: LMConfig, mesh):
    """Forward + KV cache and last-position logits (inference prefill):
    ``prefill_step(model, tokens [B, S]) -> (logits [B, V] f32, {"k", "v":
    [L, B, S, KV, Dh]})``."""
    _check_mesh(mesh)

    @torch.inference_mode()
    def prefill_step(model: LM, tokens: torch.Tensor):
        b, s = tokens.shape
        x = model.embed[tokens.long()].to(_dtype(cfg))
        positions = torch.arange(s, device=x.device)
        shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
        kc = torch.empty(shape, dtype=x.dtype, device=x.device)
        vc = torch.empty(shape, dtype=x.dtype, device=x.device)
        for li, lp in enumerate(model.layers):
            x, kc[li], vc[li], _ = _layer(x, lp, cfg, positions, 0)
        last = L.rmsnorm(x[:, -1], model.ln_f)
        logits = (last @ model.unembed).float()
        return logits, {"k": kc, "v": vc}

    return prefill_step


# --------------------------------------------------------------- decode

def _flash_decode(q: torch.Tensor, k_l: torch.Tensor, v_l: torch.Tensor, cache_len: int,
                  n_heads: int) -> torch.Tensor:
    """q: [B, 1, H, Dh]; k_l, v_l: one layer's cache [B, S, KV, Dh], read
    whole under the ``cache_len`` mask. Returns f32 [B, 1, H, Dh]. (The
    reference's log-sum-exp merge across sequence shards is the identity on
    one device.)"""
    b, s, kv, dh = k_l.shape
    g = n_heads // kv
    qg = L.f32(q.to(k_l.dtype).reshape(b, kv, g, dh))
    sc = torch.matmul(qg, L.f32(k_l.permute(0, 2, 3, 1))) * L.score_scale(dh, q.device)  # [B, KV, G, S]
    valid = torch.arange(s, device=q.device) < cache_len
    sc = torch.where(valid, sc, -1e30)
    m = sc.amax(-1)
    p = torch.exp(sc - m[..., None])
    l = p.sum(-1)
    o = torch.matmul(p.to(k_l.dtype).float(), L.f32(v_l.permute(0, 2, 1, 3)))  # [B, KV, G, Dh]
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, 1, n_heads, dh)


@torch.inference_mode()
def decode_logits(model: LM, cache: dict, tokens: torch.Tensor, pos) -> torch.Tensor:
    """One decode step's f32 logits [B, V] for ``tokens`` [B, 1] at ``pos``
    (an int or a 0-d tensor, the current length): the new K/V are written at
    (layer, pos) of the stacked cache in place, then each layer attends over
    positions ≤ pos."""
    cfg = model.cfg
    dt = _dtype(cfg)
    pos = int(pos)
    b = tokens.shape[0]
    x = model.embed[tokens.long()].to(dt)                               # [B, 1, D]
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    kc, vc = cache["k"], cache["v"]
    for li, lp in enumerate(model.layers):
        h = L.rmsnorm(x, lp["ln1"])
        q = (h @ lp["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
        k = (h @ lp["wk"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ lp["wv"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
        q = L.apply_rope(q, posv, cfg.rope_theta)
        k = L.apply_rope(k, posv, cfg.rope_theta)
        if 0 <= pos < kc.shape[2]:               # the reference writes nothing elsewhere
            kc[li, :, pos] = k[:, 0].to(kc.dtype)
            vc[li, :, pos] = v[:, 0].to(vc.dtype)
        o = _flash_decode(q, kc[li], vc[li], pos + 1, cfg.n_heads)
        x = (x + o.to(dt).reshape(b, 1, -1) @ lp["wo"]).to(dt)
        ff, _ = _ffn(L.rmsnorm(x, lp["ln2"]), lp, cfg)
        x = (x + ff).to(dt)
    x = L.rmsnorm(x[:, 0], model.ln_f)
    return (x @ model.unembed).float()


def make_decode_step(cfg: LMConfig, mesh, global_batch: int, seq_len: int):
    """One greedy decode step: ``decode_step(model, cache, tokens [B, 1],
    pos) -> (next_tok [B] int32, cache)``, the cache written in place
    (``decode_logits``); the first of equal logits wins, as in JAX."""
    del global_batch, seq_len   # the reference picks its sequence sharding from them
    _check_mesh(mesh)

    def decode_step(model: LM, cache: dict, tokens: torch.Tensor, pos):
        logits = decode_logits(model, cache, tokens, pos)
        return logits.argmax(-1).to(torch.int32), cache

    return decode_step


# --------------------------------------------------------------- bundle

def cache_specs(cfg: LMConfig, global_batch: int, seq_len: int) -> dict:
    shape = (cfg.n_layers, global_batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": sds(shape, _dtype(cfg)), "v": sds(shape, _dtype(cfg))}


def make_bundle(cfg: LMConfig, mesh) -> ModelBundle:
    """The LM's bundle over a 1 × 1 ``mesh``: ``init(generator)`` builds the
    model on the mesh's device; ``prefill`` and ``decode`` steps are served,
    ``train`` raises (LM training is not ported yet)."""
    _check_mesh(mesh)
    device = mesh.devices[0]

    def step(shape: ShapeSpec) -> StepDef:
        s, gb = shape["seq_len"], shape["global_batch"]
        if shape.kind == "train":
            raise NotImplementedError(
                "LM training (make_train_step with grad_accum, chunked CE, remat) is not "
                "ported yet")
        if shape.kind == "prefill":
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
        init=lambda generator, shape=None: init_params(cfg, generator, device),
        param_specs=lambda shape=None: param_specs(cfg),
        step=step,
    )
