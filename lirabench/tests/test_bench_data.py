"""The vectors' element type: the f32 draw unchanged where a configuration
names none, and the 8-bit integer draws mapped from that same f32 draw."""
from __future__ import annotations

import hashlib

import pytest
import torch

from lirabench import data
from lirabench.tests.conftest import TOY_CONFIG

# SHA-256 of the toy spec's base (3,000 rows) and query set (128 rows), as
# drawn on the CPU before the element type existed
F32_DIGEST = "baccaa099c5184936a69b1820983d1198d7465529df6ac672b92a98c91efb589"


def _spec(**keys):
    return {**TOY_CONFIG["data"], **keys}


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("keys", [{}, {"dtype": "float32"}], ids=["absent", "float32"])
def test_float_draw_is_the_earlier_draw_bit_for_bit(keys):
    base, queries = data.make_vectors(_spec(**keys), 3000, 128, "cpu")
    assert base.dtype == queries.dtype == torch.float32
    assert _digest(base, queries) == F32_DIGEST


@pytest.mark.parametrize("dtype,lo,hi", [("uint8", 0, 255), ("int8", -128, 127)])
def test_integer_draw_maps_the_f32_draw(dtype, lo, hi):
    spec = _spec(dtype=dtype)
    b1, q1 = data.make_vectors(spec, 3000, 128, "cpu")
    b2, q2 = data.make_vectors(spec, 3000, 128, "cpu")
    fb, fq = data.make_vectors(_spec(), 3000, 128, "cpu")
    _, scale, offset, *_ = data.int_mapping(spec, data.mixture(spec))
    for got, again, f32 in ((b1, b2, fb), (q1, q2, fq)):
        assert got.dtype == getattr(torch, dtype)
        assert got.equal(again)
        want = torch.clamp(torch.round(f32 * scale + offset), lo, hi).to(got.dtype)
        assert got.equal(want)
    # the mapping spreads the draw over the type's range and clips few values
    assert int(b1.min()) < lo + 64 and int(b1.max()) > hi - 64
    assert float(((b1 == lo) | (b1 == hi)).float().mean()) < 0.01


@pytest.mark.parametrize("dtype,lo,hi", [("uint8", 0, 255), ("int8", -128, 127)])
def test_integer_mapping_comes_from_the_mixture(dtype, lo, hi):
    """Three scales either side of every mode's centre go onto the type's range."""
    spec = _spec(dtype=dtype)
    mix = data.mixture(spec)
    _, scale, offset, t_lo, t_hi = data.int_mapping(spec, mix)
    assert (t_lo, t_hi) == (lo, hi)
    x_lo = float((mix["centers"] - 3 * mix["scales"]).min())
    x_hi = float((mix["centers"] + 3 * mix["scales"]).max())
    assert x_lo * scale + offset == pytest.approx(lo)
    assert x_hi * scale + offset == pytest.approx(hi)
    assert data.int_mapping(_spec(), mix) is None


def test_an_unknown_dtype_is_refused():
    with pytest.raises(ValueError, match="float16"):
        data.make_vectors(_spec(dtype="float16"), 10, 4, "cpu")


def test_widest_exact_integer_width_is_drawn_and_judged():
    from lirabench import reference

    base, _ = data.make_vectors(_spec(dtype="int8", dim=258), 10, 4, "cpu")
    assert base.shape == (10, 258) and base.dtype == torch.int8
    assert reference.as_f32(base).dtype == torch.float32
    wider, _ = data.make_vectors(_spec(dtype="int8", dim=259), 10, 4, "cpu")
    with pytest.raises(ValueError, match="258"):
        reference.as_f32(wider)
    assert 255 ** 2 * 258 < 2 ** 24 < 255 ** 2 * 259
