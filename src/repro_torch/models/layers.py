"""Transformer building blocks (counterpart of ``repro/models/layers.py``):
RMSNorm, RoPE, flash attention (a loop over KV blocks with an online softmax —
no [S, S] matrix), GQA, the SwiGLU FFN and one device's MoE dispatch, expert
FFN and combine.

Each op keeps the reference's precision rule. Where JAX asks an einsum for
f32 accumulation (``preferred_element_type=float32``) of operands in a lower
type, both operands are upcast and multiplied in f32: a bf16 × bf16 product
is exact in f32, so this is the f32-accumulated result (the card must run
with TF32 off, as ``utils.device.resolve_device`` sets it). Where JAX
multiplies in the operands' type and casts the product afterwards
(``einsum(bf16, bf16).astype(f32)``), the product is rounded to the operands'
type first here too.

The expert-parallel pieces (``_sort_pack``, ``moe_a2a_local``) run only over a
model axis larger than 1 and are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    x32 = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * w.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, Dh]; positions: [B, S] or [S]. Rotate-half on the split
    halves of Dh, in f32."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                       # [Dh/2]
    ang = positions[..., None].float() * freqs                    # [.., S, Dh/2]
    if ang.ndim == 2:                                             # [S, Dh/2] -> batch
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous f32 copy, in one pass whatever its strides (a
    matmul would copy a permuted operand once more)."""
    return torch.empty(t.shape, dtype=torch.float32, device=t.device).copy_(t)


def score_scale(dh: int, device) -> torch.Tensor:
    """1 / sqrt(dh), rounded as the reference's f32 ``1.0 / jnp.sqrt(dh)``."""
    return 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32, device=device))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                    block: int = 1024, q_offset: int = 0,
                    score_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``block`` rows.

    q: [B, Sq, H, Dh]; k, v: [B, Skv, KV, Dh] (GQA: H = KV·G). The [Sq, Skv]
    score matrix never exists whole: a step holds a [B, KV, G, Sq, block] f32
    tile. Query heads are grouped by their KV head (K/V are never expanded to
    H heads). Every block is computed, masked ones too; masked scores are
    -1e30. ``q_offset`` is the global position of q[0] (chunked prefill);
    ``score_dtype=bfloat16`` rounds the scores to bf16 before the scale."""
    b, sq, h, dh = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    assert skv % block == 0, (skv, block)
    dev = q.device
    scale = score_scale(dh, dev)
    # [B, KV, G·Sq, Dh]: the query rows of one KV head, grouped
    qg = f32(q.to(k.dtype).reshape(b, sq, kv, g, dh).permute(0, 2, 3, 1, 4)).view(
        b, kv, g * sq, dh)
    rows = q_offset + torch.arange(sq, device=dev)
    acc = torch.zeros((b, kv, g, sq, dh), dtype=torch.float32, device=dev)
    m = torch.full((b, kv, g, sq), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kv, g, sq), dtype=torch.float32, device=dev)
    for blk in range(skv // block):
        ks = f32(k[:, blk * block:(blk + 1) * block].permute(0, 2, 3, 1))   # [B, KV, Dh, blk]
        vs = f32(v[:, blk * block:(blk + 1) * block].permute(0, 2, 1, 3))   # [B, KV, blk, Dh]
        s = torch.matmul(qg, ks).view(b, kv, g, sq, block)
        if score_dtype != torch.float32:
            s = s.to(score_dtype).float()
        s = s * scale
        if causal:
            cols = blk * block + torch.arange(block, device=dev)
            s = torch.where(cols[None, :] <= rows[:, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.matmul(p.to(k.dtype).float().view(b, kv, g * sq, block), vs)
        acc = acc * alpha[..., None] + pv.view(b, kv, g, sq, dh)
        m = m_new
        del s, p, pv
    out = acc / torch.clamp(l, min=1e-30)[..., None]            # [B, KV, G, Sq, Dh]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def swiglu_mlp(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
               wo: torch.Tensor) -> torch.Tensor:
    h = x @ wi
    g = x @ wg
    return (F.silu(g) * h) @ wo


# --------------------------------------------------------------------- MoE

def router_probs(x: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """softmax over experts of the router logits, the product rounded to the
    operands' type before the f32 cast (the reference's
    ``einsum(x, w).astype(f32)``)."""
    return torch.softmax((x @ router_w).float(), dim=-1)


def moe_dispatch_local(x_all: torch.Tensor, router_w: torch.Tensor, e0: int, e_loc: int,
                       top_k: int, capacity: int):
    """Sort-based token-choice dispatch for the experts [e0, e0 + e_loc).

    x_all: [T, D]. Returns (buf [E_loc, C, D], gate_buf [E_loc, C] f32,
    tok_buf [E_loc, C] int32 with T as the drop sentinel). The top-k keeps
    ``jax.lax.top_k``'s order (equal probabilities: the lower expert first)
    through a stable descending sort; a (token, expert) pair past an expert's
    capacity is dropped."""
    t, d = x_all.shape
    dev = x_all.device
    probs = router_probs(x_all, router_w)
    g, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    g, eidx = g[:, :top_k], eidx[:, :top_k]                      # [T, k]
    g = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)       # renormalize top-k

    flat_e = eidx.reshape(-1)
    flat_t = torch.arange(t, device=dev)[:, None].expand_as(eidx).reshape(-1)
    flat_g = g.reshape(-1)

    local = (flat_e >= e0) & (flat_e < e0 + e_loc)
    key = torch.where(local, flat_e - e0, e_loc)                 # e_loc = trash bucket
    skey, order = torch.sort(key, stable=True)
    start = torch.searchsorted(skey, torch.arange(e_loc + 1, device=dev))
    pos = torch.arange(t * top_k, device=dev) - start[skey.clamp(0, e_loc)]
    keep = (skey < e_loc) & (pos < capacity)
    # the reference scatters with mode="drop": here a spare row e_loc takes
    # the dropped writes and is cut off
    row = torch.where(keep, skey, e_loc)
    col = torch.where(keep, pos, 0)
    gate_buf = torch.zeros((e_loc + 1, capacity), dtype=torch.float32, device=dev)
    gate_buf[row, col] = flat_g[order]
    tok_buf = torch.full((e_loc + 1, capacity), t, dtype=torch.int32, device=dev)
    tok_buf[row, col] = flat_t[order].to(torch.int32)
    gate_buf, tok_buf = gate_buf[:e_loc], tok_buf[:e_loc]
    # scatter token indices first and gather rows once: no [T·k, D] copy
    x_pad = torch.cat([x_all, x_all.new_zeros((1, d))])
    return x_pad[tok_buf.long()], gate_buf, tok_buf


def moe_expert_ffn(buf: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
                   wo: torch.Tensor) -> torch.Tensor:
    """buf: [E, C, D]; wi/wg: [E, D, F]; wo: [E, F, D]."""
    h = torch.bmm(buf, wi)
    g = torch.bmm(buf, wg)
    return torch.bmm(F.silu(g) * h, wo)


def moe_combine_local(expert_out: torch.Tensor, gate_buf: torch.Tensor,
                      tok_buf: torch.Tensor, n_tokens: int, top_k: int) -> torch.Tensor:
    """Sum the gate-weighted expert outputs back onto the token axis (f32
    [n_tokens, D]); sentinel slots are dropped. A token adds its slots in
    slot order, as the reference's scatter-add applies its updates, and on
    every run the same way: the slots are sorted by token (stably) and
    gathered one rank at a time, where ``index_add_`` on a card would add by
    atomics in an order that changes from run to run. A token holds at most
    ``top_k`` slots (one an expert), so ``top_k`` ranks are gathered and the
    host never waits for the card."""
    d = expert_out.shape[-1]
    weighted = (expert_out.float() * gate_buf[..., None]).reshape(-1, d)
    tok_sorted, order = torch.sort(tok_buf.reshape(-1).long(), stable=True)
    start = torch.searchsorted(tok_sorted, torch.arange(n_tokens + 1, device=tok_sorted.device))
    count = start[1:] - start[:-1]                               # slots a token
    out = torch.zeros((n_tokens, d), dtype=torch.float32, device=expert_out.device)
    for j in range(top_k if n_tokens else 0):
        slot = order[(start[:-1] + j).clamp(max=order.numel() - 1)]
        out = out + torch.where((j < count)[:, None], weighted[slot], 0.0)
    return out
