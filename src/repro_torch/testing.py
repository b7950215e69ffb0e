"""The rule by which a top-k kernel is held against its plain version (and
the port against the JAX reference), and the edge-case inputs that exercise
the kernels. ``chip_smoke.py`` runs the cases at the main path's widths on
the card; the tests run them small on the CPU.

Tolerances: distances rtol 1e-5, atol 1e-5·max(‖q‖²+‖c‖²) — the L2 expansion
‖q‖² − 2q·c + ‖c‖² loses precision in proportion to the norms, not to the
distance. Ids are set-equal per row except among candidates whose distances
tie within that tolerance at the k-th place; where the inputs are small
integers the distances are exact and the ids must match element for element
(the lowest index wins a tie). The merge does no arithmetic, so its outputs
must be equal. The ADC scan only adds, in a fixed order, so the kernel must
equal its plain version; against the JAX oracle, which adds the offsets in
the other order, distances agree to rtol 1e-5, atol 1e-5·(the largest
|LUT sum| + |q_off| + |cand_off|) (``adc_atol``). The k-means assignment's
minimum distances agree to rtol 1e-5, atol 1e-5·(max ‖x‖² + max ‖c‖²), and
an assignment may differ only at a near-tie: where the plain distance to the
other side's centroid is within that tolerance of the plain minimum
(``assert_assign_match``); with small-integer inputs both are exact.
"""
from __future__ import annotations

import numpy as np
import torch

RTOL = 1e-5


def occupied(q_pad, qbuf):
    """Dispatch slots that hold a query (the last row of q_pad is the empty
    slot's sentinel)."""
    return qbuf < q_pad.shape[0] - 1


def l2_atol(queries, cands, cand_ids) -> float:
    """1e-5 · (max ‖q‖² + max ‖c‖² over the valid candidates whose ‖c‖² is
    finite), at least 1e-5 (a candidate whose ‖c‖² overflows gives a distance
    that is not finite, which is compared exactly)."""
    q, c = torch.as_tensor(queries).float(), torch.as_tensor(cands).float()
    qn = float((q * q).sum(-1).max()) if q.shape[0] else 0.0
    norms = (c * c).sum(-1)
    keep = (torch.as_tensor(cand_ids) >= 0) & torch.isfinite(norms)
    cn = float(norms[keep].max()) if bool(keep.any()) else 0.0
    return 1e-5 * max(qn + cn, 1.0)


def qbuf_atol(q_pad, qbuf, cands, cand_ids) -> float:
    """``l2_atol`` over the queries that occupy a dispatch slot."""
    q_pad, qbuf = torch.as_tensor(q_pad), torch.as_tensor(qbuf)
    return l2_atol(q_pad[qbuf[occupied(q_pad, qbuf)].long()], cands, cand_ids)


def _tensor(a):
    """Arrays (numpy or jax) as tensors; they are copied, as jax's are read-only."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def assert_topk_match(d_a, i_a, d_b, i_b, atol: float, *, exact_ids: bool = False,
                      what: str = "top-k") -> float:
    """Hold the top-k (d_a, i_a) against the reference (d_b, i_b), arrays or
    tensors of shape [..., k]: the same non-finite entries with the same ids,
    finite distances within rtol 1e-5 / ``atol``, and ids equal per row as
    sets except among candidates tied within the tolerance at the k-th place
    (element for element with ``exact_ids``). Returns the largest absolute
    distance error."""
    d_a = _tensor(d_a).float()
    d_b, i_a, i_b = (_tensor(a).to(d_a.device) for a in (d_b, i_a, i_b))
    d_b = d_b.float()
    k = d_a.shape[-1]
    d_a, d_b, i_a, i_b = (t.reshape(-1, k) for t in (d_a, d_b, i_a, i_b))
    fin = torch.isfinite(d_b)
    if not torch.equal(torch.isfinite(d_a), fin):
        raise AssertionError(f"{what}: the finite entries differ")
    if not (torch.equal(d_a[~fin], d_b[~fin]) and torch.equal(i_a[~fin], i_b[~fin])):
        raise AssertionError(f"{what}: the non-finite entries or their ids differ")
    err = float((d_a[fin] - d_b[fin]).abs().max()) if bool(fin.any()) else 0.0
    if not torch.allclose(d_a[fin], d_b[fin], rtol=RTOL, atol=atol):
        raise AssertionError(f"{what}: distances differ by up to {err} (atol {atol})")
    if exact_ids:
        if not torch.equal(i_a, i_b):
            raise AssertionError(f"{what}: ids differ")
        return err
    bad = (torch.sort(i_a, -1).values != torch.sort(i_b, -1).values).any(-1)
    for r in torch.nonzero(bad).flatten().tolist():
        fr = fin[r]
        kth = float(d_b[r][fr].max())
        dist = dict(zip(i_b[r][fr].tolist(), d_b[r][fr].tolist()))
        dist.update(zip(i_a[r][fr].tolist(), d_a[r][fr].tolist()))
        diff = set(i_a[r].tolist()) ^ set(i_b[r].tolist())
        if any(dist[i] < kth - (atol + RTOL * abs(kth)) for i in diff):
            raise AssertionError(f"{what}: row {r} ids differ beyond ties at the k-th "
                                 f"place: {sorted(diff)}")
    return err


# ------------------------------------------------------------ edge cases

# "small" runs in the CPU tests; "main" is the main path's width (d = 128,
# k = 100, a 1,024-query bucket's worth of rows) for the card
L2_WIDTHS = {"small": dict(b=4, s=12, c=60, d=16, n_rows=20, k=7),
             "main": dict(b=8, s=16, c=300, d=128, n_rows=300, k=100)}
DEDUP_WIDTHS = {"small": dict(q=6, p=64, n_ids=20, k=8),
                "main": dict(q=8, p=102_400, n_ids=50_000, k=100)}


# The cases of every L2 scan that stress its selection (case -> overrides of
# the width's defaults, a function of the width).
_L2_SELECTION_CASES = {
    # candidate i is (C + 3 - i) on the first axis: the distance falls along
    # each set for every query, so every candidate enters the list and the
    # selection's buffer merges many times; exact distances
    "descending distances": lambda w: dict(integer=True, rows="descending"),
    # every candidate the same small-integer row: one distance per query, so
    # the lowest positions must win, across merges and ranges
    "equal distances": lambda w: dict(integer=True, rows="equal"),
    # C ten times k, as a hot partition gives
    "long rows": lambda w: dict(c=10 * w["k"]),
    # a component of 1e20 at a fifth of the candidates, and at every valid
    # candidate of one set but k // 2: ||c||^2 overflows to +inf there, so
    # that set has fewer than k finite distances; the plain versions write
    # inf / -1 beside each
    "overflowing distances": lambda w: dict(overflow=True),
}

# case -> overrides of the width's defaults (a function of the width)
_L2_CASES = {
    "holes+padding": lambda w: {},
    "k>C": lambda w: dict(c=max(6, w["k"] // 3), pad_tail=2),
    "empty-slot rows": lambda w: dict(empty_frac=0.8),
    "all ids padding": lambda w: dict(hole_frac=1.0),
    "bf16 store": lambda w: dict(dtype="bfloat16"),
    # exact distances; 80 slots span several of the kernel's slot groups,
    # and d = 13 pads to the kernel's float4 reads
    "exact ties": lambda w: dict(integer=True, hole_frac=0.0, pad_tail=0, d=13, s=80,
                                 empty_frac=0.0),
    **_L2_SELECTION_CASES,
    # one bucket with every one of 80 slots occupied (more than one of the
    # kernel's slot groups) and the longest candidate list, with no hole,
    # 10,000 candidates: more than one of the kernel's candidate ranges
    "hot bucket": lambda w: dict(s=80, c=10_000, hot=True),
}
L2_CASES = tuple(_L2_CASES)


def l2_case(case: str, *, width: str = "small", seed: int = 0):
    """One ``l2_topk_qbuf`` edge case: (q_pad [R, d] f32, qbuf [B, S] int32,
    cands [B, C, d] f32, ids [B, C] int32) as numpy, k, the store dtype's
    name, and whether ids must match exactly. In every case bucket 0 has no
    valid candidate and the last bucket no occupied slot; the rest have
    holes (``hole_frac``), a padding tail and empty slots (``empty_frac``)."""
    w = L2_WIDTHS[width]
    kw = {**w, "hole_frac": 0.15, "pad_tail": None, "empty_frac": 0.3, **_L2_DEFAULTS,
          **_L2_CASES[case](w)}
    b, s, c, d, n_rows = (kw[n] for n in ("b", "s", "c", "d", "n_rows"))
    rng = np.random.default_rng(seed)
    q, cands = _l2_rows(rng, kw, (n_rows,), b, c, d, "pairs")
    q_pad = np.concatenate([q, np.full((1, d), 1e9, np.float32)])
    ids = _l2_ids(rng, kw, b, c)
    ids[0] = -1
    qbuf = rng.integers(0, n_rows, (b, s)).astype(np.int32)
    qbuf[rng.random((b, s)) < kw["empty_frac"]] = n_rows
    if kw["hot"]:  # bucket 1: every slot occupied, every candidate valid
        qbuf[1] = rng.integers(0, n_rows, s)
        ids[1] = rng.permutation(b * c)[:c]
    qbuf[-1] = n_rows
    _l2_overflow(rng, kw, cands, ids, 1)
    return (q_pad, qbuf, cands, ids), kw["k"], kw["dtype"], kw["integer"]


_L2_DEFAULTS = dict(integer=False, dtype="float32", rows="random", overflow=False, hot=False)


def _l2_rows(rng, kw, q_shape, b, c, d, dup):
    """Query rows [*q_shape, d] and candidates [b, c, d] for an L2 case: small
    integers (``integer``; a candidate repeats another, ``dup``: "pairs" the
    one before it, "halves" the one half a set before), rows falling along
    each set or all equal (``rows``), or normal floats."""
    if not kw["integer"]:
        cands = (rng.normal(size=(b, c, d)) * 3).astype(np.float32)
        return (rng.normal(size=(*q_shape, d)) * 3).astype(np.float32), cands
    if kw["rows"] == "descending":
        cands = np.zeros((b, c, d), np.float32)
        cands[:, :, 0] = c + 3 - np.arange(c)
    elif kw["rows"] == "equal":
        cands = np.broadcast_to(rng.integers(-3, 4, d).astype(np.float32), (b, c, d)).copy()
    else:
        cands = rng.integers(-3, 4, (b, c, d)).astype(np.float32)
        if dup == "pairs":
            cands[:, 1::2] = cands[:, ::2][:, :c // 2]   # duplicate rows, distinct ids
        else:
            cands[:, c // 2:2 * (c // 2)] = cands[:, :c // 2]
    return rng.integers(-3, 4, (*q_shape, d)).astype(np.float32), cands


def _l2_ids(rng, kw, b, c):
    """Distinct ids [b, c] with holes (``hole_frac``) and a padding tail."""
    ids = rng.permutation(b * c).reshape(b, c).astype(np.int32)
    ids[rng.random((b, c)) < kw["hole_frac"]] = -1
    pad = c // 6 if kw["pad_tail"] is None else kw["pad_tail"]
    if pad:
        ids[:, -pad:] = -1
    return ids


def _l2_overflow(rng, kw, cands, ids, full):
    """With ``overflow``: a component of 1e20 (its square overflows f32) at a
    fifth of the candidates, and at every valid candidate of set ``full`` but
    its first k // 2."""
    if not kw["overflow"]:
        return
    hit = rng.random(ids.shape) < 0.2
    hit[full] = True
    hit[full, np.flatnonzero(ids[full] >= 0)[:kw["k"] // 2]] = False
    b_i, c_i = np.nonzero(hit)
    cands[b_i, c_i, rng.integers(0, cands.shape[2], b_i.size)] = 1e20


_DEDUP_CASES = {
    "duplicates+padding+non-finite": lambda w: {},
    "exact ties": lambda w: dict(integer=True, n_ids=2 * w["n_ids"]),
    "k>P": lambda w: dict(p=max(5, w["k"] // 2)),
    "no duplicates": lambda w: dict(unique=True, nonfinite=False),
}
DEDUP_CASES = tuple(_DEDUP_CASES)


def dedup_case(case: str, *, width: str = "small", seed: int = 0):
    """One ``dedup_topk`` edge case: (dists [Q, P] f32, ids [Q, P] int32) as
    numpy, and k. Ids repeat (replicas) unless the case says otherwise, a
    fifth are padding (< 0), and the last row holds no valid entry."""
    w = DEDUP_WIDTHS[width]
    kw = {**w, "integer": False, "nonfinite": True, "unique": False,
          **_DEDUP_CASES[case](w)}
    q, p = kw["q"], kw["p"]
    rng = np.random.default_rng(seed)
    d = (rng.integers(0, 6, (q, p)) if kw["integer"] else rng.random((q, p)) * 10
         ).astype(np.float32)
    if kw["unique"]:
        ids = np.stack([rng.permutation(max(kw["n_ids"], 2 * p))[:p] for _ in range(q)])
    else:
        ids = rng.integers(0, kw["n_ids"], (q, p))
    ids = ids.astype(np.int32)
    ids[rng.random((q, p)) < 0.2] = -1
    ids[-1] = -1
    if kw["nonfinite"]:
        d[rng.random((q, p)) < 0.1] = np.inf
        d[rng.random((q, p)) < 0.05] = np.nan
        d[rng.random((q, p)) < 0.05] = -np.inf
    return (d, ids), kw["k"]


# "small" runs in the CPU tests; "main" is the quantized serve path's width
# (d = 128 as m = 16 subspaces of ks = 256 codewords, a shortlist of
# rk = 400) for the card
ADC_WIDTHS = {"small": dict(b=4, s=12, n=60, m=4, ks=16, n_rows=20, k=7),
              "main": dict(b=8, s=16, n=1500, m=16, ks=256, n_rows=300, k=400)}

_ADC_CASES = {
    "holes+padding": lambda w: {},
    "k>N": lambda w: dict(n=max(6, w["k"] // 3), pad_tail=2),
    "empty-slot rows": lambda w: dict(empty_frac=0.8),
    "all ids padding": lambda w: dict(hole_frac=1.0),
    # small-integer LUTs and duplicate code rows: exact distances, exact ties
    "exact ties": lambda w: dict(integer=True, hole_frac=0.0, pad_tail=0),
    "residual offsets": lambda w: dict(offsets=True),
    "uint16 codes": lambda w: dict(ks=512, offsets=True),
    # 40 occupied slots in a bucket span several of the kernel's slot groups
    "more slots than one group": lambda w: dict(s=40, empty_frac=0.0, offsets=True),
    # exact distances; the second half of each set repeats the first under
    # other ids, so exact ties lie half a set apart, in other candidate
    # ranges of the flat scan (eight tiles of 256)
    "exact ties across ranges": lambda w: dict(integer=True, hole_frac=0.0, pad_tail=0,
                                               n=2048, dup="halves"),
    # exact distances that fall along each row (LUT entry = code, codes
    # spelling n - 1 - position): every candidate beats the list, so the
    # selection's buffer fills and merges many times
    "descending distances": lambda w: dict(integer=True, codes="descending"),
    # k well over the valid count (rk = 1,600 at rerank 16 against ~1,000)
    "k above valid": lambda w: dict(k=w["n"] * 16 // 15),
    # one distance for every candidate: the lowest positions must win
    "equal distances": lambda w: dict(integer=True, lut="ones"),
    # N many times k, as a hot partition gives
    "long rows": lambda w: dict(n=10 * w["k"], offsets=True),
    # cand_off of -inf, +inf or NaN at some candidates: -inf leads its row
    # with id -1, +inf and NaN follow every finite distance, and NaN never
    # reaches the k smallest; eight tiles of 256, so the flat scan splits. (In
    # cand_off, not the LUT: the JAX kernels' one-hot contraction turns a
    # whole LUT row NaN, 0 * inf.)
    "non-finite distances": lambda w: dict(n=2048, offsets=True, nonfinite=True),
    # query counts that are no multiple of the flat kernels' rows a block (R)
    "one query row": lambda w: dict(s=1, empty_frac=0.0),
    "seven query rows": lambda w: dict(s=7, offsets=True),
    "nine query rows": lambda w: dict(s=9, offsets=True),
    # 16 codewords: R = 32 rows a block, every gather free of bank conflicts
    "ks 16": lambda w: dict(ks=16, offsets=True),
    # codes one element past a 16-byte boundary (ADC_UNALIGNED): the kernels
    # read them element by element
    "unaligned codes": lambda w: dict(offsets=True),
    # lists too large for the flat top-k's widest row group, so its plan
    # takes fewer rows a block; at the main width no merge fits either
    "k over a block's lists": lambda w: dict(k=250 * w["m"], n=300 * w["m"]),
    # LUT rows of 64 and 128 KB: two rows and one row a block
    "two rows a block": lambda w: dict(ks=16384 // w["m"], offsets=True),
    "one row a block": lambda w: dict(ks=32768 // w["m"], offsets=True),
}
ADC_CASES = tuple(_ADC_CASES)
# cases whose codes are to lie off a 16-byte boundary (``unaligned``)
ADC_UNALIGNED = ("unaligned codes",)


def unaligned(codes: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``codes`` that starts one element past a 16-byte
    boundary (a view into a larger buffer, on the same device)."""
    buf = codes.new_empty(codes.numel() + 16 // codes.element_size())
    off = (-(buf.data_ptr() % 16) // codes.element_size()) % (16 // codes.element_size()) + 1
    out = buf[off:off + codes.numel()].view(codes.shape)
    out.copy_(codes)
    return out


def adc_case(case: str, *, width: str = "small", seed: int = 0):
    """One ADC edge case: (lut_pad [R, m, ks] f32, qbuf [B, S]
    int32, codes [B, N, m] uint8 or uint16, ids [B, N] int32, cand_off [B, N]
    f32 or None, q_off [B, S] f32 or None) as numpy, k, and whether ids must
    match exactly. The last LUT row is the empty slot's zero row. In every
    case bucket 0 has no valid candidate and the last bucket no occupied
    slot; the rest have holes, a padding tail and empty slots."""
    w = ADC_WIDTHS[width]
    kw = {**w, "hole_frac": 0.15, "pad_tail": w["n"] // 6, "empty_frac": 0.3,
          "integer": False, "offsets": False, "dup": "pairs", "codes": "random",
          "lut": "random", "nonfinite": False, **_ADC_CASES[case](w)}
    b, s, n, m, ks, n_rows = (kw[x] for x in ("b", "s", "n", "m", "ks", "n_rows"))
    rng = np.random.default_rng(seed)
    if kw["lut"] == "ones":
        lut = np.ones((n_rows, m, ks), np.float32)
    elif kw["codes"] == "descending":
        lut = np.broadcast_to(np.arange(ks, dtype=np.float32), (n_rows, m, ks)).copy()
    elif kw["integer"]:
        lut = rng.integers(0, 4, (n_rows, m, ks)).astype(np.float32)
    else:
        lut = (rng.random((n_rows, m, ks)) * 10).astype(np.float32)
    lut_pad = np.concatenate([lut, np.zeros((1, m, ks), np.float32)])
    codes = rng.integers(0, ks, (b, n, m)).astype(np.uint8 if ks <= 256 else np.uint16)
    if kw["codes"] == "descending":  # codes summing to n - 1 - position, filled greedily
        total = (n - 1 - np.arange(n))[:, None] - (ks - 1) * np.arange(m)[None, :]
        codes[:] = np.clip(total, 0, ks - 1).astype(codes.dtype)[None]
    elif kw["integer"] and kw["dup"] == "pairs":
        codes[:, 1::2] = codes[:, ::2][:, :n // 2]   # duplicate rows, distinct ids
    elif kw["integer"]:
        codes[:, n // 2:2 * (n // 2)] = codes[:, :n // 2]
    ids = rng.permutation(b * n).reshape(b, n).astype(np.int32)
    ids[rng.random((b, n)) < kw["hole_frac"]] = -1
    if kw["pad_tail"]:
        ids[:, -kw["pad_tail"]:] = -1
    ids[0] = -1
    qbuf = rng.integers(0, n_rows, (b, s)).astype(np.int32)
    qbuf[rng.random((b, s)) < kw["empty_frac"]] = n_rows
    qbuf[-1] = n_rows
    cand_off = q_off = None
    if kw["offsets"]:
        cand_off = (rng.normal(size=(b, n)) * 5).astype(np.float32)
        q_off = (rng.normal(size=(b, s)) * 5).astype(np.float32)
    if kw["nonfinite"]:  # k // 4 at -inf, 5% each at +inf and NaN, per set
        kk, nn = max(1, kw["k"] // 4), n // 20
        for bi in range(b):
            pos = rng.permutation(n)
            cand_off[bi, pos[:kk]] = -np.inf
            cand_off[bi, pos[kk:kk + nn]] = np.inf
            cand_off[bi, pos[kk + nn:kk + 2 * nn]] = np.nan
    return (lut_pad, qbuf, codes, ids, cand_off, q_off), kw["k"], kw["integer"]


def adc_atol(lut_pad, cand_off=None, q_off=None) -> float:
    """1e-5 · (the largest |LUT sum| + max |q_off| + max |cand_off|), at
    least 1e-5, over the finite entries (a non-finite one gives a distance
    that is not finite, which is compared exactly)."""
    def finite_abs(a):
        a = torch.as_tensor(a).float().abs()
        return torch.where(torch.isfinite(a), a, 0.0)

    lut = finite_abs(lut_pad)
    top = float(lut.amax(-1).sum(-1).max()) if lut.numel() else 0.0
    for off in (cand_off, q_off):
        if off is not None and torch.as_tensor(off).numel():
            top += float(finite_abs(off).max())
    return 1e-5 * max(top, 1.0)


def kmeans_atol(x, centroids) -> float:
    """1e-5 · (max ‖x‖² + max ‖c‖²), at least 1e-5."""
    x, c = _tensor(x).float(), _tensor(centroids).float()
    xn = float((x * x).sum(-1).max()) if x.shape[0] else 0.0
    return 1e-5 * max(xn + float((c * c).sum(-1).max()), 1.0)


def assert_assign_match(a_a, d_a, a_b, d_b, x, centroids, *, exact: bool = False,
                        what: str = "kmeans_assign"):
    """Hold the assignment (a_a, d_a) against the reference (a_b, d_b), arrays
    or tensors of shape [N]: minimum distances within rtol 1e-5 /
    ``kmeans_atol``; where the assignments differ, the reference's distance
    to a_a's centroid within that tolerance of its own minimum (a near-tie).
    With ``exact`` both must be equal. Returns (the largest absolute distance
    error, the number of points assigned differently)."""
    d_a = _tensor(d_a).float()
    d_b, a_a, a_b = (_tensor(t).to(d_a.device) for t in (d_b, a_a, a_b))
    d_b = d_b.float()
    x, c = _tensor(x).to(d_a.device).float(), _tensor(centroids).to(d_a.device).float()
    atol = kmeans_atol(x, c)
    err = float((d_a - d_b).abs().max()) if d_a.numel() else 0.0
    if not torch.allclose(d_a, d_b, rtol=RTOL, atol=atol):
        raise AssertionError(f"{what}: min distances differ by up to {err} (atol {atol})")
    rows = torch.nonzero(a_a.long() != a_b.long()).flatten()
    if exact:
        if rows.numel() or not torch.equal(d_a, d_b):
            raise AssertionError(f"{what}: {rows.numel()} assignments or distances differ")
        return err, 0
    if rows.numel():
        xr, cr = x[rows], c[a_a[rows].long()]
        d_other = (xr * xr).sum(-1) - 2.0 * (xr * cr).sum(-1) + (cr * cr).sum(-1)
        gap = d_other - d_b[rows]
        if bool((gap > atol + RTOL * d_b[rows].abs()).any()):
            raise AssertionError(f"{what}: {int((gap > atol).sum())} of {rows.numel()} "
                                 f"differing assignments are not near-ties "
                                 f"(largest gap {float(gap.max())}, atol {atol})")
    return err, int(rows.numel())


# "small" runs in the CPU tests; "main" is the build's width (d = 128, B = 1024
# centroids) for the card. N is a multiple of no tile.
KMEANS_WIDTHS = {"small": dict(n=301, b=20, d=16), "main": dict(n=5003, b=1024, d=128)}

_KMEANS_CASES = {
    "ragged N and B": lambda w: dict(b=w["b"] - 1),
    "B=1": lambda w: dict(b=1),
    "d not a multiple of 4": lambda w: dict(d=w["d"] - 3),
    # small integers: exact distances; every odd centroid repeats the one
    # before it, so the lower index must win
    "duplicate centroids": lambda w: dict(integer=True),
    "bf16": lambda w: dict(dtype="bfloat16"),
    # SIFT-like: non-negative entries around a shared offset, so ||x||^2 is
    # large next to the gaps between centroids; a single TF32 product (an
    # 11-bit significand) misses the tolerance here, the three-product split
    # that the card's kernel uses does not
    "large common offset": lambda w: dict(offset=100.0),
    # fewer points than one warpgroup's 64 rows of the kernel's point tile,
    # fewer centroids than one of its centroid tiles (128)
    "points under one tile": lambda w: dict(n=50, b=7),
    # d past the 128 (f32) the kernel keeps resident: its point chunks are
    # loaded again for every centroid tile, the last panel partial
    "d over one panel": lambda w: dict(d=200),
    # rows of 600 bytes, not a multiple of 16: loaded through registers, and
    # 5 chunks of 64, past one panel of 4, so consecutive tiles cycle the slots
    "bf16 over one panel": lambda w: dict(dtype="bfloat16", d=300),
    # bf16 rows not a multiple of 16 bytes within one panel
    "bf16 d not a multiple of 8": lambda w: dict(dtype="bfloat16", d=w["d"] - 3),
}
KMEANS_CASES = tuple(_KMEANS_CASES)


def kmeans_case(case: str, *, width: str = "small", seed: int = 0):
    """One ``kmeans_assign`` edge case: (x [N, d] f32, centroids [B, d] f32)
    as numpy, the dtype's name, and whether the outputs must be equal."""
    w = KMEANS_WIDTHS[width]
    kw = {**w, "integer": False, "dtype": "float32", "offset": 0.0, **_KMEANS_CASES[case](w)}
    n, b, d = kw["n"], kw["b"], kw["d"]
    rng = np.random.default_rng(seed)
    if kw["integer"]:
        x = rng.integers(-3, 4, (n, d)).astype(np.float32)
        cents = rng.integers(-3, 4, (b, d)).astype(np.float32)
        cents[1::2] = cents[::2][:b // 2]
    elif kw["offset"]:
        x = np.abs(rng.normal(size=(n, d)) * 20 + kw["offset"]).astype(np.float32)
        cents = np.abs(rng.normal(size=(b, d)) * 20 + kw["offset"]).astype(np.float32)
    else:
        x = (rng.normal(size=(n, d)) * 3).astype(np.float32)
        cents = (rng.normal(size=(b, d)) * 3).astype(np.float32)
    return (x, cents), kw["dtype"], kw["integer"]


# "small" runs in the CPU tests; "main" is the main path's width (d = 128,
# k = 100) for the card. At both, C spans several of the kernel's candidate
# ranges on the card (two tiles of 64 a range at least).
L2_SCAN_WIDTHS = {"small": dict(b=3, q=10, c=300, d=16, k=7),
                  "main": dict(b=4, q=40, c=1000, d=128, k=100)}

_L2_SCAN_CASES = {
    "holes+padding": lambda w: {},
    "k>C": lambda w: dict(c=max(6, w["k"] // 3), pad_tail=2),
    "all ids padding": lambda w: dict(hole_frac=1.0),
    "bf16": lambda w: dict(dtype="bfloat16"),
    # small integers: exact distances; the second half of each set repeats
    # the first under other ids, so exact ties lie half a set apart, in other
    # candidate ranges; d = 13 pads to the kernel's float4 reads
    "exact ties across splits": lambda w: dict(integer=True, hole_frac=0.0, pad_tail=0, d=13),
    **_L2_SELECTION_CASES,
}
L2_SCAN_CASES = tuple(_L2_SCAN_CASES)


def l2_scan_case(case: str, *, width: str = "small", seed: int = 0):
    """One edge case of the flat and batched scans: (q [B, Q, d] f32, cands
    [B, C, d] f32, ids [B, C] int32) as numpy, k, the dtype's name, and
    whether ids must match exactly. The last set has no valid id in every
    case (the flat scan takes set 0); the rest have holes (``hole_frac``)
    and a padding tail."""
    w = L2_SCAN_WIDTHS[width]
    kw = {**w, "hole_frac": 0.15, "pad_tail": None, **_L2_DEFAULTS, **_L2_SCAN_CASES[case](w)}
    b, nq, c, d = (kw[n] for n in ("b", "q", "c", "d"))
    rng = np.random.default_rng(seed)
    q, cands = _l2_rows(rng, kw, (b, nq), b, c, d, "halves")
    ids = _l2_ids(rng, kw, b, c)
    ids[-1] = -1
    _l2_overflow(rng, kw, cands, ids, 0)
    return (q, cands, ids), kw["k"], kw["dtype"], kw["integer"]
