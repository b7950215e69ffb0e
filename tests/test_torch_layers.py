"""The port's transformer building blocks (``repro_torch.models.layers``)
against the JAX package's (``repro.models.layers``) on the same seeded numpy
inputs, in f32 and bf16.

Tolerances: f32 results agree to 1e-5 absolute (the ops sum in another
order); bf16 results, cast from f32 math on both sides, agree to one bf16
rounding step of the largest output magnitude (``_bf16_atol``), except where
a rule below is exact: integer outputs (expert and token indices), values
that are copies of the inputs (the dispatch buffer) and the MoE combine of
the same expert outputs (the same f32 adds in the same order) are equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_ATOL = 1e-5


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(np.ascontiguousarray(a)).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x


def _bf16_atol(ref: np.ndarray, steps: float = 1.0) -> float:
    """``steps`` bf16 rounding steps (2^-7 relative) of the largest |ref|."""
    return steps * float(np.abs(ref).max()) * 2.0 ** -7


def _close(j, t, dtype: str, steps: float = 1.0):
    a, b = _np(j), _np(t)
    assert a.shape == b.shape, (a.shape, b.shape)
    atol = F32_ATOL if dtype == "float32" else _bf16_atol(a, steps)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= atol, f"max abs err {err} > {atol}"


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    (jx, tx), (jw, tw) = _pair(rng.normal(0, 2, (3, 5, 48)), dtype), _pair(rng.normal(1, .1, 48), dtype)
    _close(JL.rmsnorm(jx, jw), TL.rmsnorm(tx, tw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batched_positions", [False, True])
def test_apply_rope(dtype, batched_positions):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.normal(0, 1, (2, 7, 3, 16)), dtype)
    pos = (rng.integers(0, 5000, (2, 7)) if batched_positions else np.arange(7) + 40).astype(np.int32)
    np.testing.assert_allclose(_np(JL.rope_freqs(16, 1e4)), _np(TL.rope_freqs(16, 1e4)),
                               rtol=1e-6, atol=0)
    _close(JL.apply_rope(jx, jnp.asarray(pos), 1e4), TL.apply_rope(tx, torch.from_numpy(pos), 1e4),
           dtype)


def _attention_inputs(seed, b, sq, skv, h, kv, dh, dtype):
    rng = np.random.default_rng(seed)
    return (_pair(rng.normal(0, 1, (b, sq, h, dh)), dtype),
            _pair(rng.normal(0, 1, (b, skv, kv, dh)), dtype),
            _pair(rng.normal(0, 1, (b, skv, kv, dh)), dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
def test_flash_attention(dtype, causal, groups, score_dtype):
    """Four KV blocks of 16; GQA with 1, 2 and 4 query heads a KV head."""
    h = 4
    (jq, tq), (jk, tk), (jv, tv) = _attention_inputs(2, 2, 64, 64, h, h // groups, 16, dtype)
    j = JL.flash_attention(jq, jk, jv, causal=causal, block=16,
                           score_dtype=jnp.dtype(score_dtype))
    t = TL.flash_attention(tq, tk, tv, causal=causal, block=16,
                           score_dtype=getattr(torch, score_dtype))
    _close(j, t, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
def test_flash_attention_q_offset(dtype, score_dtype):
    """A chunk of 16 queries at positions 48..63 over 64 keys (chunked
    prefill): the causal mask follows the global positions."""
    (jq, tq), (jk, tk), (jv, tv) = _attention_inputs(3, 2, 16, 64, 8, 2, 16, dtype)
    j = JL.flash_attention(jq, jk, jv, causal=True, block=32, q_offset=48,
                           score_dtype=jnp.dtype(score_dtype))
    t = TL.flash_attention(tq, tk, tv, causal=True, block=32, q_offset=48,
                           score_dtype=getattr(torch, score_dtype))
    _close(j, t, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_mlp(dtype):
    rng = np.random.default_rng(4)
    (jx, tx), (ji, ti), (jg, tg), (jo, to) = (
        _pair(rng.normal(0, 1, s) / np.sqrt(s[0] if len(s) == 2 else 1), dtype)
        for s in ((2, 5, 32), (32, 48), (32, 48), (48, 32)))
    _close(JL.swiglu_mlp(jx, ji, jg, jo), TL.swiglu_mlp(tx, ti, tg, to), dtype, steps=2.0)


def _router_case(seed, t, d, e, dtype, tied: bool):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (t, d))
    w = rng.normal(0, 1, (d, e)) / np.sqrt(d)
    if tied:
        # experts 1 and 2, and 5 and 6, have the same router column: every
        # token's probabilities tie there, and top-k must take the lower
        # index first as jax.lax.top_k does
        w[:, 2] = w[:, 1]
        w[:, 6] = w[:, 5]
    return _pair(x, dtype), _pair(w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("capacity", [2, 5, 64])
def test_moe_dispatch_local(dtype, tied, capacity):
    """32 tokens, 8 experts, top-3: a capacity of 2 or 5 drops pairs (12 a
    expert on average), 64 drops none."""
    (jx, tx), (jw, tw) = _router_case(5, 32, 16, 8, dtype, tied)
    jbuf, jgate, jtok = JL.moe_dispatch_local(jx, jw, 0, 8, 3, capacity)
    tbuf, tgate, ttok = TL.moe_dispatch_local(tx, tw, 0, 8, 3, capacity)
    np.testing.assert_array_equal(_np(jtok), _np(ttok))
    np.testing.assert_array_equal(_np(jbuf), _np(tbuf))
    np.testing.assert_allclose(_np(jgate), _np(tgate), rtol=0, atol=1e-6)
    dropped = 32 * 3 - int((_np(ttok) < 32).sum())
    assert (dropped > 0) == (capacity < 12), dropped


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_dispatch_local_expert_range(dtype):
    """The local expert range [e0, e0 + e_loc) of a model shard: pairs routed
    elsewhere go to the trash bucket."""
    (jx, tx), (jw, tw) = _router_case(6, 24, 16, 8, dtype, tied=False)
    for j, t in zip(JL.moe_dispatch_local(jx, jw, 4, 4, 2, 6),
                    TL.moe_dispatch_local(tx, tw, 4, 4, 2, 6)):
        np.testing.assert_allclose(_np(j), _np(t), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_expert_ffn_and_combine(dtype):
    """The expert FFN on a dispatch buffer, then the gate-weighted scatter-add
    back to the tokens (the sentinel slots dropped)."""
    (jx, tx), (jw, tw) = _router_case(7, 32, 16, 8, dtype, tied=True)
    rng = np.random.default_rng(8)
    (ji, ti), (jg, tg), (jo, to) = (_pair(rng.normal(0, 1, s) / np.sqrt(s[1]), dtype)
                                    for s in ((8, 16, 24), (8, 16, 24), (8, 24, 16)))
    jbuf, jgate, jtok = JL.moe_dispatch_local(jx, jw, 0, 8, 2, 6)
    tbuf, tgate, ttok = TL.moe_dispatch_local(tx, tw, 0, 8, 2, 6)
    jout, tout = JL.moe_expert_ffn(jbuf, ji, jg, jo), TL.moe_expert_ffn(tbuf, ti, tg, to)
    _close(jout, tout, dtype, steps=2.0)
    # combine the same expert outputs and gates on both sides: the same f32
    # adds in the same (slot) order, so the same bits
    same = _np(jout)
    jc = JL.moe_combine_local(jnp.asarray(same, DTYPES[dtype][0]), jgate, jtok, 32)
    tc = TL.moe_combine_local(torch.from_numpy(same).to(DTYPES[dtype][1]),
                              torch.from_numpy(_np(jgate)), ttok, 32, 2)
    np.testing.assert_array_equal(_np(jc), _np(tc))
    assert _np(tc).dtype == np.float32 and tc.shape == (32, 16)
