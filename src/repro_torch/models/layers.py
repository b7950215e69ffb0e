"""Transformer building blocks (counterpart of ``repro/models/layers.py``):
RMSNorm, RoPE, flash attention (a loop over KV blocks with an online softmax —
no [S, S] matrix), GQA, the SwiGLU FFN and one rank's MoE dispatch, expert
FFN and combine.

Each op keeps the reference's precision rule. Where JAX asks an einsum for
f32 accumulation (``preferred_element_type=float32``) of operands in a lower
type, both operands are upcast and multiplied in f32: a bf16 × bf16 product
is exact in f32, so this is the f32-accumulated result (the card must run
with TF32 off, as ``utils.device.resolve_device`` sets it). Where JAX
multiplies in the operands' type and casts the product afterwards
(``einsum(bf16, bf16).astype(f32)``), the product is rounded to the operands'
type first here too.

Every function here is differentiable, to the reference's gradients. Two
choices keep a backward pass's bits the same on every run on the card:
  * a gather of rows by an index that repeats (``take_rows``: the embedding,
    the MoE dispatch's and combine's row gathers) sums its gradient rows
    per index in row order (``core.kmeans.segment_sum``), where autograd's
    own backward would add them by float atomics on the card;
  * the online-softmax loop recomputes each KV block's tiles in backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` of
    its scan body does, so no f32 [.., Sq, block] tile is kept per block.

The expert-parallel all-to-all MoE (``moe_a2a_local``) runs the reference's
``shard_map`` body rank by rank: its all-to-alls are transposes of the
ranks' send buffers (``all_to_all``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.kmeans import segment_sum
from repro_torch.launch import mesh as _mesh


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        out = segment_sum(grad.reshape(idx.numel(), -1), idx.reshape(-1), ctx.n_rows)
        return out.reshape(ctx.n_rows, *grad.shape[idx.ndim:]), None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (idx int64, any shape) whose backward sums the rows of
    each index in a fixed order, the same bits on every run."""
    if not torch.is_grad_enabled():           # serving: a plain gather, no autograd node
        return table[idx]
    return _TakeRows.apply(table, idx)


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
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    for blk in range(skv // block):
        args = (qg, k, v, acc, m, l, rows, scale, blk * block, block, causal, score_dtype)
        acc, m, l = (checkpoint(_attend_block, *args, use_reentrant=False) if remat
                     else _attend_block(*args))
    out = acc / torch.clamp(l, min=1e-30)[..., None]            # [B, KV, G, Sq, Dh]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def _attend_block(qg, k, v, acc, m, l, rows, scale, start: int, block: int, causal: bool,
                  score_dtype):
    """One step of ``flash_attention``'s loop: KV rows [start, start + block)
    folded into the running (acc, m, l)."""
    b, kv, gsq, dh = qg.shape
    g, sq = m.shape[2], m.shape[3]
    ks = f32(k[:, start:start + block].permute(0, 2, 3, 1))     # [B, KV, Dh, blk]
    vs = f32(v[:, start:start + block].permute(0, 2, 1, 3))     # [B, KV, blk, Dh]
    s = torch.matmul(qg, ks).view(b, kv, g, sq, block)
    if score_dtype != torch.float32:
        s = s.to(score_dtype).float()
    s = s * scale
    if causal:
        cols = start + torch.arange(block, device=qg.device)
        s = torch.where(cols[None, :] <= rows[:, None], s, -1e30)
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(-1)
    pv = torch.matmul(p.to(k.dtype).float().view(b, kv, gsq, block), vs)
    acc = acc * alpha[..., None] + pv.view(b, kv, g, sq, dh)
    return acc, m_new, l


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
                       top_k: int, capacity: int, dropped: list | None = None):
    """Sort-based token-choice dispatch for the experts [e0, e0 + e_loc).

    x_all: [T, D]. Returns (buf [E_loc, C, D], gate_buf [E_loc, C] f32,
    tok_buf [E_loc, C] int32 with T as the drop sentinel). The top-k keeps
    ``jax.lax.top_k``'s order (equal probabilities: the lower expert first)
    through a stable descending sort; a (token, expert) pair past an expert's
    capacity is dropped (``dropped``, when a list, gets their count)."""
    t, d = x_all.shape
    dev = x_all.device
    flat_e, flat_t, flat_g = moe_route(x_all, router_w, top_k)

    local = (flat_e >= e0) & (flat_e < e0 + e_loc)
    key = torch.where(local, flat_e - e0, e_loc)                 # e_loc = trash bucket
    skey, order = torch.sort(key, stable=True)
    start = torch.searchsorted(skey, torch.arange(e_loc + 1, device=dev))
    pos = torch.arange(t * top_k, device=dev) - start[skey.clamp(0, e_loc)]
    keep = (skey < e_loc) & (pos < capacity)
    if dropped is not None:
        dropped.append(int((skey < e_loc).sum()) - int(keep.sum()))
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
    return take_rows(x_pad, tok_buf.long()), gate_buf, tok_buf


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
        out = out + torch.where((j < count)[:, None], take_rows(weighted, slot), 0.0)
    return out


def _sort_pack(key: torch.Tensor, n_buckets: int, capacity: int) -> torch.Tensor:
    """Sort-based bucketing: key [N] in [0, n_buckets) (else dropped).
    Returns slot [n_buckets, capacity] int64 of indices into ``key``, in
    their order within a bucket, sentinel N; a bucket's entries past
    ``capacity`` are dropped."""
    n = key.shape[0]
    dev = key.device
    key_c = torch.where((key >= 0) & (key < n_buckets), key, n_buckets)
    skey, order = torch.sort(key_c, stable=True)
    start = torch.searchsorted(skey, torch.arange(n_buckets + 1, device=dev, dtype=skey.dtype))
    pos = torch.arange(n, device=dev) - start[skey.clamp(0, n_buckets)]
    keep = (skey < n_buckets) & (pos < capacity)
    # the reference scatters with mode="drop": a spare row takes the drops
    row = torch.where(keep, skey, n_buckets)
    col = torch.where(keep, pos, 0)
    slot = torch.full((n_buckets + 1, capacity), n, dtype=torch.int64, device=dev)
    slot[row, col] = order
    return slot[:n_buckets]


def all_to_all(bufs: list) -> list:
    """The ranks' send buffers [n, C, ...] (rank j's row k goes to rank k)
    -> the received ones: rank k gets [n, C, ...] with row j from rank j, on
    its own buffer's device (``launch.mesh.all_to_all``)."""
    return _mesh.all_to_all(bufs)


def moe_route(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """(expert ids [T·k], token ids [T·k], gates [T·k] f32): the top-k
    experts of every token in ``jax.lax.top_k``'s order, their gates
    renormalized, flattened token-major."""
    t = x.shape[0]
    probs = router_probs(x, router_w)
    g, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    g, eidx = g[:, :top_k], eidx[:, :top_k]
    g = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)
    flat_t = torch.arange(t, device=x.device)[:, None].expand_as(eidx).reshape(-1)
    return eidx.reshape(-1), flat_t, g.reshape(-1)


def moe_a2a_local(x: list, router_w: list, e_loc: int, top_k: int, c_send: int, c_exp: int,
                  experts: list, dropped: list | None = None) -> list:
    """Expert-parallel MoE over the model ranks of one batch row, rank by
    rank. ``x[j]``: rank j's local tokens [T_loc, D]; ``router_w[j]`` its
    copy of the router; ``experts[j]``: its (wi, wg, wo) slices [E_loc, ...]
    (experts [j·E_loc, (j+1)·E_loc)). Each rank routes its tokens and packs
    [model_n, c_send] send slots by destination rank (pairs past c_send
    dropped); the all-to-all hands each rank the pairs for its experts,
    which it packs into [E_loc, c_exp] (pairs past c_exp dropped), runs
    through the expert FFN and sends back; each source combines the
    returned rows with its gates, a token's slots added in slot order.
    Returns each rank's output [T_loc, D] f32. ``dropped``, when a list,
    gets each rank's count of routed pairs dropped (send and expert side)."""
    model_n = len(x)
    d = x[0].shape[1]
    send_x, send_e, src = [], [], []
    for j, xj in enumerate(x):
        t = xj.shape[0]
        flat_e, flat_t, flat_g = moe_route(xj, router_w[j], top_k)
        slot = _sort_pack(flat_e // e_loc, model_n, c_send)       # [model_n, c_send]
        pad = flat_e.shape[0]
        e_pad = torch.cat([flat_e, flat_e.new_full((1,), -1)])
        t_pad = torch.cat([flat_t, flat_t.new_full((1,), t)])
        g_pad = torch.cat([flat_g, flat_g.new_zeros(1)])
        x_pad = torch.cat([xj, xj.new_zeros((1, d))])
        # the sentinel slot (pad) reads token t: the zero row, gate 0
        send_x.append(take_rows(x_pad, t_pad[slot]))                 # [model_n, c_send, D]
        send_e.append(e_pad[slot])
        src.append((t_pad[slot], g_pad[slot], t))
        if dropped is not None:
            dropped.append(pad - int((slot < pad).sum()))
    recv_x, recv_e = all_to_all(send_x), all_to_all(send_e)
    back = []
    for k in range(model_n):
        rt = model_n * recv_x[k].shape[1]
        rx = recv_x[k].reshape(rt, d)
        re = recv_e[k].reshape(rt) - k * e_loc                      # negative = padding
        slot2 = _sort_pack(re, e_loc, c_exp)               # [e_loc, c_exp], sentinel rt
        rx_pad = torch.cat([rx, rx.new_zeros((1, d))])
        eout = moe_expert_ffn(take_rows(rx_pad, slot2), *experts[k])
        flat = moe_combine_local(eout, torch.ones(slot2.shape, device=rx.device), slot2, rt, 1)
        back.append(flat.reshape(model_n, -1, d).to(x[k].dtype))
        if dropped is not None:
            dropped[k] += int(((re >= 0) & (re < e_loc)).sum()) - int((slot2 < rt).sum())
    back = all_to_all(back)
    return [moe_combine_local(b, gate, tok, t, top_k) for b, (tok, gate, t) in zip(back, src)]
