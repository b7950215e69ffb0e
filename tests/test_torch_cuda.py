"""The CUDA kernels against their plain PyTorch versions, on the card. This
file imports no jax, so it runs on a machine with a card and without the JAX
package: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Without a card (or nvcc) its ``cuda`` tests skip. The edge cases and the
comparison (with its tolerances) are ``repro_torch.testing``'s, which
``test_torch_kernels.py`` and ``chip_smoke.py`` share.
"""
import os
import shutil
import subprocess

import pytest
import torch

from repro_torch import testing as rt
from repro_torch.core import kmeans as km
from repro_torch.kernels import dedup_topk as dd_mod
from repro_torch.kernels import kmeans_assign as km_mod
from repro_torch.kernels import l2_topk as l2_mod
from repro_torch.kernels import pq_adc as adc_mod
from repro_torch.kernels import ref as tref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", rt.L2_CASES)
def test_l2_topk_qbuf_kernel_matches_plain(cuda_device, case):
    arrays, k, dtype, exact = rt.l2_case(case, seed=6)
    tdt = getattr(torch, dtype)
    q_pad, qbuf, cands, ids = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    q_pad, cands = q_pad.to(tdt), cands.to(tdt)
    before = l2_mod.launches
    kd, ki = l2_mod.l2_topk_qbuf(q_pad, qbuf, cands, ids, k)
    torch.cuda.synchronize()
    assert l2_mod.launches == before + 1
    pd, pi = tref.l2_topk_qbuf_ref(q_pad, qbuf, cands, ids, k)
    occ = rt.occupied(q_pad, qbuf)
    assert bool(torch.isinf(kd[~occ]).all()) and bool((ki[~occ] == -1).all())
    rt.assert_topk_match(kd[occ], ki[occ], pd[occ], pi[occ],
                         rt.qbuf_atol(q_pad, qbuf, cands, ids), exact_ids=exact)


@pytest.mark.cuda
@pytest.mark.parametrize("case", rt.DEDUP_CASES)
def test_dedup_topk_kernel_matches_plain(cuda_device, case):
    arrays, k = rt.dedup_case(case, seed=7)
    d, ids = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    before = dd_mod.launches
    kd, ki = dd_mod.dedup_topk(d, ids, k)
    torch.cuda.synchronize()
    assert dd_mod.launches == before + 1
    pd, pi = tref.dedup_topk_ref(d, ids, k)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


def _adc_inputs(case, dev, seed):
    (lut_pad, qbuf, codes, ids, coff, qoff), k, _ = rt.adc_case(case, seed=seed)
    args = [torch.from_numpy(a).to(dev) for a in (lut_pad, qbuf, codes, ids)]
    if case in rt.ADC_UNALIGNED:
        args[2] = rt.unaligned(args[2])
    offs = {name: None if a is None else torch.from_numpy(a).to(dev)
            for name, a in (("cand_off", coff), ("q_off", qoff))}
    return args, offs, k


@pytest.mark.cuda
@pytest.mark.parametrize("case", rt.ADC_CASES)
def test_pq_adc_topk_qbuf_kernel_equals_plain(cuda_device, case):
    """The kernel adds in the plain version's order: distances and ids equal.
    The plain version is fixed, so this also holds the kernel on the shared
    body (csrc/adc_scan.cuh) to the bits it gave before."""
    args, offs, k = _adc_inputs(case, cuda_device, 10)
    before = adc_mod.launches
    kd, ki = adc_mod.pq_adc_topk_qbuf(*args, k, **offs)
    torch.cuda.synchronize()
    assert adc_mod.launches == before + 1
    pd, pi = tref.pq_adc_topk_qbuf_ref(*args, k, **offs)
    occ = rt.occupied(args[0], args[1])
    assert bool(torch.isinf(kd[~occ]).all()) and bool((ki[~occ] == -1).all())
    assert torch.equal(kd[occ], pd[occ]) and torch.equal(ki[occ], pi[occ])


@pytest.mark.cuda
def test_pq_adc_wrapper_rejects_what_it_does_not_take(cuda_device):
    (lut_pad, qbuf, codes, ids), offs, k = _adc_inputs("residual offsets", cuda_device, 11)
    with pytest.raises(TypeError):                       # codes widened to int32
        adc_mod.pq_adc_topk_qbuf(lut_pad, qbuf, codes.int(), ids, k, **offs)
    with pytest.raises(TypeError):
        adc_mod.pq_adc_topk_qbuf(lut_pad.double(), qbuf, codes, ids, k)
    with pytest.raises(ValueError):                      # m differs
        adc_mod.pq_adc_topk_qbuf(lut_pad[:, :2], qbuf, codes, ids, k)
    with pytest.raises(ValueError):
        adc_mod.pq_adc_topk_qbuf(lut_pad, qbuf, codes, ids[:, :5], k)
    with pytest.raises(ValueError):
        adc_mod.pq_adc_topk_qbuf(lut_pad, qbuf, codes, ids, k, q_off=offs["q_off"][:, :3])
    # one slot's LUT (64 x 1024 x 4 B = 256 KB) exceeds a block's shared memory
    big = torch.zeros((lut_pad.shape[0], 64, 1024), device=cuda_device)
    before = adc_mod.launches
    with pytest.raises(RuntimeError, match="shared memory"):
        adc_mod.pq_adc_topk_qbuf(big, qbuf, torch.zeros((*ids.shape, 64), dtype=torch.uint16,
                                                        device=cuda_device), ids, k)
    assert adc_mod.launches == before


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_they_do_not_take(cuda_device):
    arrays, _, _, _ = rt.l2_case("holes+padding", seed=8)
    q_pad, qbuf, cands, ids = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    with pytest.raises(TypeError):
        l2_mod.l2_topk_qbuf(q_pad.double(), qbuf, cands.double(), ids, 5)
    with pytest.raises(TypeError):
        l2_mod.l2_topk_qbuf(q_pad, qbuf.long(), cands, ids, 5)
    with pytest.raises(ValueError):
        l2_mod.l2_topk_qbuf(q_pad[:, :3], qbuf, cands, ids, 5)
    d, i = (torch.from_numpy(a).to(cuda_device) for a in rt.dedup_case("exact ties", seed=9)[0])
    with pytest.raises(TypeError):
        dd_mod.dedup_topk(d.double(), i, 5)
    with pytest.raises(ValueError):
        dd_mod.dedup_topk(d, i[:, :3], 5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", rt.KMEANS_CASES)
def test_kmeans_assign_kernel_matches_plain(cuda_device, case):
    (x, c), dtype, exact = rt.kmeans_case(case, seed=12)
    tdt = getattr(torch, dtype)
    x, c = (torch.from_numpy(a).to(cuda_device).to(tdt) for a in (x, c))
    before = km_mod.launches
    ka, kd = km_mod.kmeans_assign(x, c)
    torch.cuda.synchronize()
    assert km_mod.launches == before + 1
    assert ka.dtype == torch.int32 and kd.dtype == torch.float32 and ka.shape == (x.shape[0],)
    pa, pd = tref.kmeans_assign_ref(x, c)
    rt.assert_assign_match(ka, kd, pa, pd, x, c, exact=exact)


@pytest.mark.cuda
def test_kmeans_assign_runs_on_the_tensor_cores(cuda_device):
    """The built library's SASS: both instantiations of the assignment kernel
    (f32 and bf16) contain HGMMA, Hopper's warpgroup product."""
    from repro_torch.kernels import _build

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        pytest.skip("needs cuobjdump to read the SASS")
    _build.load("kmeans_assign")
    sass = subprocess.run([cuobjdump, "-sass", str(_build._lib_path("kmeans_assign"))],
                          capture_output=True, text=True, check=True).stdout
    kernels = {}
    for section in sass.split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        if "kmeans_assign_kernel" in name:
            kernels["bfloat16" if "bfloat16" in name else "float32"] = section
    assert set(kernels) == {"float32", "bfloat16"}, list(kernels)
    for dtype, body in kernels.items():
        assert "HGMMA" in body, f"no HGMMA in the {dtype} kernel"


def _scan_inputs(case, dev, seed):
    (q, cands, ids), k, dtype, exact = rt.l2_scan_case(case, seed=seed)
    tdt = getattr(torch, dtype)
    q, cands = (torch.from_numpy(a).to(dev).to(tdt) for a in (q, cands))
    return q, cands, torch.from_numpy(ids).to(dev), k, exact


@pytest.mark.cuda
@pytest.mark.parametrize("case", rt.L2_SCAN_CASES)
def test_l2_topk_kernel_matches_plain(cuda_device, case):
    q, cands, ids, k, exact = _scan_inputs(case, cuda_device, 13)
    q, cands, ids = q[0], cands[0], ids[0]
    before = l2_mod.flat_launches
    kd, ki = l2_mod.l2_topk(q, cands, ids, k)
    torch.cuda.synchronize()
    assert l2_mod.flat_launches == before + 1
    pd, pi = tref.l2_topk_ref(q, cands, ids, k)
    rt.assert_topk_match(kd, ki, pd, pi, rt.l2_atol(q, cands, ids), exact_ids=exact)


@pytest.mark.cuda
@pytest.mark.parametrize("case", rt.L2_SCAN_CASES)
def test_l2_topk_batched_kernel_matches_plain(cuda_device, case):
    q, cands, ids, k, exact = _scan_inputs(case, cuda_device, 14)
    before = l2_mod.batched_launches
    kd, ki = l2_mod.l2_topk_batched(q, cands, ids, k)
    torch.cuda.synchronize()
    assert l2_mod.batched_launches == before + 1
    pd, pi = tref.l2_topk_batched_ref(q, cands, ids, k)
    rt.assert_topk_match(kd, ki, pd, pi, rt.l2_atol(q.reshape(-1, q.shape[-1]), cands, ids),
                         exact_ids=exact)


@pytest.mark.cuda
def test_l2_scans_report_their_launch_and_refuse_what_does_not_fit(cuda_device):
    """The launch-shape queries give a group of 16 or 32 rows that fits a
    block. At k = 2,000 not even 16 rows' lists fit a block: every L2 scan
    raises without counting a launch."""
    q, cands, ids, k, _ = _scan_inputs("holes+padding", cuda_device, 17)
    for shape in (l2_mod.occupancy(cands, k), l2_mod.scan_occupancy(cands, k)):
        rows = shape.get("slots_per_block", shape.get("rows_per_block"))
        assert rows in (16, 32) and shape["blocks_per_sm"] >= 1
        assert 0 < shape["smem_bytes"] <= 232448
    arrays, _, _, _ = rt.l2_case("holes+padding", seed=18)
    q_pad, qbuf, qc, qids = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    before = (l2_mod.launches, l2_mod.flat_launches, l2_mod.batched_launches)
    with pytest.raises(RuntimeError, match="shared memory"):
        l2_mod.l2_topk_qbuf(q_pad, qbuf, qc, qids, 2000)
    with pytest.raises(RuntimeError, match="shared memory"):
        l2_mod.l2_topk(q[0], cands[0], ids[0], 2000)
    with pytest.raises(RuntimeError, match="shared memory"):
        l2_mod.l2_topk_batched(q, cands, ids, 2000)
    assert (l2_mod.launches, l2_mod.flat_launches, l2_mod.batched_launches) == before


@pytest.mark.cuda
def test_l2_topk_qbuf_plan_covers_every_occupied_slot_once(cuda_device):
    """The dispatch-buffer scan's plan: each bucket's occupied slots in groups
    of G, in slot order; a group is one item over [0, its bucket's valid
    end), or, when cut, items whose candidate ranges tile that span in whole
    256-candidate units, with a run of partial lists of its own in the pool.
    The hot bucket's groups are cut."""
    arrays, k, _, _ = rt.l2_case("hot bucket", seed=19)
    q_pad, qbuf, cands, ids = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    g = l2_mod.occupancy(cands, k)["slots_per_block"]
    plan = l2_mod.plan(q_pad, qbuf, cands, ids, k)
    items = plan["items"].tolist()
    assert plan["split_items"] > 0 and 0 < plan["partial_lists"] <= plan["pool_lists"]
    occ = rt.occupied(q_pad, qbuf).sum(1).tolist()
    valid = (ids >= 0).cpu()
    lists = set()
    for b in range(qbuf.shape[0]):
        end = int(torch.nonzero(valid[b]).max()) + 1 if bool(valid[b].any()) else 0
        mine = sorted((it for it in items if it[0] == b), key=lambda it: (it[1], it[7]))
        groups = sorted({it[1] for it in mine})
        assert groups == list(range(0, occ[b], g))
        for s_lo in groups:
            parts = [it for it in mine if it[1] == s_lo]
            nq, ranges, list0 = parts[0][2], parts[0][5], parts[0][6]
            assert nq == min(g, occ[b] - s_lo) and len(parts) == ranges
            assert [it[7] for it in parts] == list(range(ranges))
            assert parts[0][3] == 0 and parts[-1][4] == end
            assert all(a[4] == z[3] and a[4] % 256 == 0 for a, z in zip(parts, parts[1:]))
            assert (list0 == -1) == (ranges == 1)
            if ranges > 1:
                run = set(range(list0, list0 + nq * ranges))
                assert not run & lists and max(run) < plan["pool_lists"]
                lists |= run


@pytest.mark.cuda
def test_l2_scans_sort_a_nan_as_the_plain_version(cuda_device):
    """A query with a component of 1e20 against a candidate with 1e20 in the
    same column: q.c and both norms overflow to +inf, so that distance is
    inf - inf, a NaN with a clear sign bit (the only NaN arithmetic on the
    card makes), and every other distance of the row is +inf. The NaN sorts
    after +inf, as the plain version's torch.sort puts it on the card, in
    the flat, batched and qbuf scans, and its id is -1: that row equal bit
    for bit, NaN included; the other rows under the usual rule. Every id is
    valid and k is the set's length, so the NaN is the row's last entry."""
    g = torch.Generator().manual_seed(37)
    n, d, k = 40, 16, 40
    cands = torch.randn((2, n, d), generator=g)
    q = torch.randn((2, 3, d), generator=g)
    q[:, 0, 5], cands[:, 7, 5] = 1e20, 1e20
    ids = torch.arange(2 * n, dtype=torch.int32).reshape(2, n)
    q, cands, ids = q.to(cuda_device), cands.to(cuda_device), ids.to(cuda_device)
    q_pad = torch.cat([q.reshape(6, d), torch.zeros_like(q[0, :1])])
    qbuf = torch.arange(6, dtype=torch.int32, device=cuda_device).reshape(2, 3)
    runs = [(l2_mod.l2_topk(q[0], cands[0], ids[0], k),
             tref.l2_topk_ref(q[0], cands[0], ids[0], k)),
            (l2_mod.l2_topk_batched(q, cands, ids, k),
             tref.l2_topk_batched_ref(q, cands, ids, k)),
            (l2_mod.l2_topk_qbuf(q_pad, qbuf, cands, ids, k),
             tref.l2_topk_qbuf_ref(q_pad, qbuf, cands, ids, k))]
    for (kd, ki), (pd, pi) in runs:
        kd, ki, pd, pi = (t.reshape(-1, 3, k) for t in (kd, ki, pd, pi))
        assert torch.equal(kd[:, 0].view(torch.int32), pd[:, 0].view(torch.int32))
        assert torch.equal(ki[:, 0], pi[:, 0])
        assert bool(torch.isnan(kd[:, 0, -1]).all()) and bool(torch.isinf(kd[:, 0, :-1]).all())
        assert bool((ki[:, 0] == -1).all())
        rt.assert_topk_match(kd[:, 1:], ki[:, 1:], pd[:, 1:], pi[:, 1:],
                             rt.l2_atol(q[:, 1:].reshape(-1, d), cands.reshape(-1, d),
                                        ids.reshape(-1)))


@pytest.mark.cuda
def test_scan_and_assign_wrappers_reject_what_they_do_not_take(cuda_device):
    q, cands, ids, k, _ = _scan_inputs("holes+padding", cuda_device, 15)
    with pytest.raises(TypeError):
        l2_mod.l2_topk_batched(q, cands.bfloat16(), ids, k)
    with pytest.raises(TypeError):
        l2_mod.l2_topk(q[0].double(), cands[0].double(), ids[0], k)
    with pytest.raises(TypeError):
        l2_mod.l2_topk(q[0], cands[0], ids[0].long(), k)
    with pytest.raises(ValueError):
        l2_mod.l2_topk_batched(q[:, :, :3], cands, ids, k)
    with pytest.raises(ValueError):
        l2_mod.l2_topk(q[0], cands[0], ids[0, :5], k)
    x = cands[0]
    with pytest.raises(TypeError):
        km_mod.kmeans_assign(x, x[:4].bfloat16())
    with pytest.raises(ValueError):
        km_mod.kmeans_assign(x, x[:4, :3])
    with pytest.raises(ValueError):
        km_mod.kmeans_assign(x, x[:0])


@pytest.mark.cuda
def test_lloyd_repeats_its_bits_on_the_card(cuda_device):
    """The deterministic segment sum: two fits from one start are equal, with
    the plain assignment and with the kernel's."""
    (x, c), _, _ = rt.kmeans_case("ragged N and B", seed=16)
    x, c = torch.from_numpy(x).to(cuda_device), torch.from_numpy(c).to(cuda_device)
    for use_kernel in (False, True):
        a, b = (km.lloyd(x, c, 4, use_kernel=use_kernel) for _ in range(2))
        assert torch.equal(a.centroids, b.centroids) and torch.equal(a.assign, b.assign)


def _expanded_inputs(case, dev, seed):
    """An ADC case expanded through qbuf, on ``dev``: (lut [B, S, m, ks],
    codes, ids), the offsets, k, and the dispatch-buffer form."""
    arrays, k, _ = rt.adc_case(case, seed=seed)
    lut_pad, qbuf, codes, ids, coff, qoff = (None if a is None else torch.from_numpy(a).to(dev)
                                             for a in arrays)
    if case in rt.ADC_UNALIGNED:
        codes = rt.unaligned(codes)
    return ((lut_pad[qbuf.long()], codes, ids), dict(cand_off=coff, q_off=qoff), k,
            [lut_pad, qbuf, codes, ids])


@pytest.mark.cuda
@pytest.mark.parametrize("case", rt.ADC_CASES)
def test_pq_adc_kernel_equals_plain(cuda_device, case):
    """Additions only, in m order: the full matrix equals the plain one."""
    (lut, codes, _), _, _, _ = _expanded_inputs(case, cuda_device, 30)
    for b in (0, 1):
        before = adc_mod.full_launches
        got = adc_mod.pq_adc(lut[b], codes[b])
        torch.cuda.synchronize()
        assert adc_mod.full_launches == before + 1
        assert torch.equal(got, tref.pq_adc_ref(lut[b], codes[b]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", rt.ADC_CASES)
def test_pq_adc_topk_kernel_equals_plain(cuda_device, case):
    """The flat scan, split into candidate ranges folded into each row's
    list, equals the plain version: distances and ids (ties to the lower
    position)."""
    (lut, codes, ids), offs, k, _ = _expanded_inputs(case, cuda_device, 31)
    for b in (0, 1):
        ob = {n: None if t is None else t[b] for n, t in offs.items()}
        before = adc_mod.flat_launches
        kd, ki = adc_mod.pq_adc_topk(lut[b], codes[b], ids[b], k, **ob)
        torch.cuda.synchronize()
        assert adc_mod.flat_launches == before + 1
        pd, pi = tref.pq_adc_topk_ref(lut[b], codes[b], ids[b], k, **ob)
        assert torch.equal(kd, pd) and torch.equal(ki, pi)


def _last_wave_fill(plan, q, splits, sms):
    """The share of the last wave's block places that ``splits`` candidate
    ranges of ``q`` query rows fill."""
    blocks = -(-q // plan["rows_per_block"]) * splits
    slots = plan["blocks_per_sm"] * sms
    return blocks / (-(-blocks // slots) * slots)


@pytest.mark.cuda
def test_flat_adc_plans_take_rows_by_lut_and_list_size(cuda_device):
    """The flat kernels' rows a block follow the shared memory a row needs:
    8 at the main widths, 32 at ks = 16, fewer where the top-k's lists grow,
    one at 128 KB rows. Where 1,000 rows' groups leave the last wave part
    empty, the plan takes the fewest candidate ranges that fill it to 98%."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    full = adc_mod.full_plan(1000, 10**6, 16, 256, 1, cuda_device)
    assert full["rows_per_block"] == 8
    assert adc_mod.full_plan(1000, 10**6, 16, 16, 1, cuda_device)["rows_per_block"] == 32
    assert adc_mod.full_plan(12, 60, 16, 2048, 2, cuda_device)["rows_per_block"] == 1
    flat = adc_mod.flat_plan(1000, 10**6, 16, 256, 100, 1, cuda_device)
    wide = adc_mod.flat_plan(1000, 10**6, 16, 256, 4000, 1, cuda_device)
    assert flat["rows_per_block"] == 8
    assert wide["rows_per_block"] < 8 and wide["smem_bytes"] <= 232448
    for plan in (full, flat, wide):
        assert _last_wave_fill(plan, 1000, 1, sms) < 0.98 < plan["splits"]  # one range leaves it
        assert _last_wave_fill(plan, 1000, plan["splits"], sms) >= 0.98
        assert _last_wave_fill(plan, 1000, plan["splits"] - 1, sms) < 0.98


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", (True, False), ids=("aligned", "unaligned"))
@pytest.mark.parametrize("m, ks", ((16, 256), (8, 512)), ids=("uint8", "uint16"))
def test_flat_adc_kernels_on_16_byte_code_rows(cuda_device, m, ks, aligned):
    """Code rows of 16 bytes (m · code size = 16), the main path's width:
    aligned, the flat kernels read a row with one 16-byte load; one element
    past a 16-byte boundary, element by element. ``pq_adc`` equals the plain
    version bit for bit, the flat top-k (offsets and holes, several candidate
    ranges) in distances and ids."""
    g = torch.Generator().manual_seed(37)
    q, n, k = 9, 2000, 20
    dtype = torch.uint8 if ks <= 256 else torch.uint16
    lut = torch.rand((q, m, ks), generator=g).to(cuda_device)
    codes = torch.randint(0, ks, (n, m), generator=g).to(dtype).to(cuda_device)
    if not aligned:
        codes = rt.unaligned(codes)
    assert (codes.data_ptr() % 16 == 0) == aligned
    ids = torch.arange(n, dtype=torch.int32)
    ids[torch.randperm(n, generator=g)[:n // 10]] = -1
    ids = ids.to(cuda_device)
    offs = dict(cand_off=torch.rand(n, generator=g).to(cuda_device),
                q_off=torch.rand(q, generator=g).to(cuda_device))
    assert adc_mod.flat_plan(q, n, m, ks, k, codes.element_size(), cuda_device)["splits"] > 1
    assert torch.equal(adc_mod.pq_adc(lut, codes), tref.pq_adc_ref(lut, codes))
    kd, ki = adc_mod.pq_adc_topk(lut, codes, ids, k, **offs)
    pd, pi = tref.pq_adc_topk_ref(lut, codes, ids, k, **offs)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


@pytest.mark.cuda
def test_pq_adc_topk_ties_across_ranges_go_to_the_lower_position(cuda_device):
    (lut, codes, ids), _, k, _ = _expanded_inputs("exact ties across ranges", cuda_device, 32)
    lut, codes, ids = lut[1], codes[1], ids[1]
    splits = adc_mod.flat_plan(lut.shape[0], codes.shape[0], codes.shape[1], lut.shape[2], k,
                               codes.element_size(), cuda_device)["splits"]
    assert splits > 1  # the tie partners half a set apart lie in other ranges
    kd, ki = adc_mod.pq_adc_topk(lut, codes, ids, k)
    pd, pi = tref.pq_adc_topk_ref(lut, codes, ids, k)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


@pytest.mark.cuda
def test_pq_adc_topk_equals_stable_topk_of_pq_adc(cuda_device):
    (lut, codes, _), _, k, _ = _expanded_inputs("exact ties across ranges", cuda_device, 33)
    lut, codes = lut[1], codes[1]
    ids = torch.arange(codes.shape[0], dtype=torch.int32, device=cuda_device)
    kd, ki = adc_mod.pq_adc_topk(lut, codes, ids, k)
    sd, si = tref.smallest_k(adc_mod.pq_adc(lut, codes), k)
    assert torch.equal(kd, sd) and torch.equal(ki, si.to(torch.int32))


@pytest.mark.cuda
def test_adc_topk_kernels_sort_a_negative_nan_as_the_plain_version(cuda_device):
    """With one subspace and no offsets a LUT entry reaches the selection as it
    is: a NaN whose sign bit is set sorts before every number, as the plain
    version's torch.sort puts it on the card (on the CPU it puts every NaN
    last), in the flat (split), batched and qbuf forms; its id is -1. Equal
    bit for bit, NaNs included."""
    def same_bits(got, want):
        return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want))

    g = torch.Generator().manual_seed(36)
    rows, n, ks, k = 12, 2048, 256, 16  # 12 and 9 NaN candidates in the two sets
    lut = torch.rand((rows, 1, ks), generator=g)
    lut[:, 0, 3] = torch.tensor([-4194304], dtype=torch.int32).view(torch.float32)  # 0xffc00000
    codes = torch.randint(0, ks, (2, n, 1), generator=g, dtype=torch.uint8)
    ids = torch.arange(2 * n, dtype=torch.int32).reshape(2, n)
    lut, codes, ids = lut.to(cuda_device), codes.to(cuda_device), ids.to(cuda_device)
    got = adc_mod.pq_adc_topk(lut, codes[0], ids[0], k)
    assert same_bits(got, tref.pq_adc_topk_ref(lut, codes[0], ids[0], k))
    lut_b = lut[None].expand(2, -1, -1, -1).contiguous()
    got = adc_mod.pq_adc_topk_batched(lut_b, codes, ids, k)
    assert same_bits(got, tref.pq_adc_topk_batched_ref(lut_b, codes, ids, k))
    lut_pad = torch.cat([lut, torch.zeros_like(lut[:1])])
    qbuf = torch.arange(rows, dtype=torch.int32, device=cuda_device)[None].repeat(2, 1)
    got = adc_mod.pq_adc_topk_qbuf(lut_pad, qbuf, codes, ids, k)
    assert same_bits(got, tref.pq_adc_topk_qbuf_ref(lut_pad, qbuf, codes, ids, k))
    d, i = got
    assert bool(torch.isnan(d[..., 0]).all()) and bool(torch.isfinite(d[..., -1]).all())
    assert bool((i[..., 0] == -1).all()) and bool((i[..., -1] >= 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", rt.ADC_CASES)
def test_pq_adc_topk_batched_kernel_equals_plain_and_qbuf(cuda_device, case):
    """Every row is scanned (the last row of the last bucket too: an identity
    map must not take it for the dispatch buffer's empty slot); on the
    occupied slots the batched kernel equals the qbuf kernel bit for bit."""
    (lut, codes, ids), offs, k, qb = _expanded_inputs(case, cuda_device, 34)
    before = adc_mod.batched_launches
    kd, ki = adc_mod.pq_adc_topk_batched(lut, codes, ids, k, **offs)
    torch.cuda.synchronize()
    assert adc_mod.batched_launches == before + 1
    pd, pi = tref.pq_adc_topk_batched_ref(lut, codes, ids, k, **offs)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    qd, qi = adc_mod.pq_adc_topk_qbuf(*qb, k, **offs)
    occ = rt.occupied(qb[0], qb[1])
    assert torch.equal(kd[occ], qd[occ]) and torch.equal(ki[occ], qi[occ])
    if bool((ids[-1] >= 0).any()):  # the last bucket has valid candidates
        assert bool(torch.isfinite(kd[-1, -1, 0])) and int(ki[-1, -1, 0]) >= 0


@pytest.mark.cuda
def test_adc_wrappers_reject_what_they_do_not_take(cuda_device):
    (lut, codes, ids), offs, k, _ = _expanded_inputs("residual offsets", cuda_device, 35)
    with pytest.raises(TypeError):
        adc_mod.pq_adc(lut[1].double(), codes[1])
    with pytest.raises(ValueError):
        adc_mod.pq_adc(lut[1][:, :2], codes[1])
    with pytest.raises(TypeError):
        adc_mod.pq_adc_topk_batched(lut, codes, ids.long(), k, **offs)
    with pytest.raises(TypeError):
        adc_mod.pq_adc_topk_batched(lut, codes.to(torch.int16), ids, k)
    with pytest.raises(ValueError):
        adc_mod.pq_adc_topk_batched(lut, codes, ids[:, :5], k)
    with pytest.raises(ValueError):
        adc_mod.pq_adc_topk(lut[1], codes[1], ids[1], k, q_off=offs["q_off"][1][:3])
    before = (adc_mod.full_launches, adc_mod.flat_launches, adc_mod.batched_launches)
    # int32 codes (ks > 65,536): one LUT row exceeds a block's shared memory
    with pytest.raises(RuntimeError, match="shared memory"):
        adc_mod.pq_adc(lut[1], codes[1].int())
    with pytest.raises(RuntimeError, match="shared memory"):
        adc_mod.pq_adc_topk(lut[1], codes[1].int(), ids[1], k)
    # 64 x 1024 x 4 B = 256 KB of LUT a row: refused by the kernels
    big = torch.zeros((2, 64, 1024), device=cuda_device)
    big_codes = torch.zeros((7, 64), dtype=torch.uint16, device=cuda_device)
    with pytest.raises(RuntimeError, match="shared memory"):
        adc_mod.pq_adc(big, big_codes)
    with pytest.raises(RuntimeError, match="shared memory"):
        adc_mod.pq_adc_topk(big, big_codes, torch.zeros(7, dtype=torch.int32,
                                                        device=cuda_device), 3)
    assert (adc_mod.full_launches, adc_mod.flat_launches, adc_mod.batched_launches) == before


# ------------------------------------------------------------ mesh and cluster

def _small_build(tier="residual_pq", n=6000, **kw):
    from repro_torch.data.synthetic import make_vector_dataset
    from repro_torch.serving.api import BuildConfig

    ds = make_vector_dataset(n=n, n_queries=37, dim=32, n_modes=24, seed=8)
    return ds, BuildConfig(n_partitions=16, k=10, eta=0.03, epochs=2, nprobe_max=8, pq_m=8,
                           pq_ks=32, tier=tier, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("data, model", ((1, 4), (2, 2)))
def test_meshed_step_kernels_match_plain(cuda_device, data, model):
    """Over a mesh on the card: impl="cuda" against "ref" under the rule,
    the kernels launched once a rank (and once a batch row to merge across
    ranks), and the f32 tier over model ranks alone equal to the unsharded
    search bit for bit."""
    import dataclasses

    import numpy as np

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serving.engine import LiraEngine

    ds, bc = _small_build()
    solo = LiraEngine.build(ds.base, bc, device=cuda_device)
    eng = dataclasses.replace(solo, mesh=make_test_mesh(data, model, device=cuda_device))
    for tier in ("f32", "residual_pq"):
        before = (l2_mod.launches, dd_mod.launches, adc_mod.launches)
        got = eng.search(ds.queries, tier=tier, impl="cuda")
        after = (l2_mod.launches, dd_mod.launches, adc_mod.launches)
        ranks = data * model
        scan = (ranks, 0) if tier == "f32" else (0, ranks)
        assert (after[0] - before[0], after[2] - before[2]) == scan
        assert after[1] - before[1] == ranks + data
        ref = eng.search(ds.queries, tier=tier, impl="ref")
        atol = rt.l2_atol(ds.queries, solo.store["vectors"], solo.store["ids"])
        rt.assert_topk_match(got.dists, got.ids, ref.dists, ref.ids, atol, what=tier)
        assert (got.overflow, got.stats.dedup_hits) == (ref.overflow, ref.stats.dedup_hits)
        one = solo.search(ds.queries, tier=tier, impl="cuda")
        assert got.stats.dedup_hits <= one.stats.dedup_hits
        if tier == "f32" and data == 1:
            np.testing.assert_array_equal(got.dists, one.dists)
            np.testing.assert_array_equal(got.ids, one.ids)


@pytest.mark.cuda
def test_ranks_on_the_card_over_a_store_elsewhere_follow_mutations(cuda_device):
    """A store on the CPU served by ranks on the card: each rank's block and
    the model are copied to the card, and copied again after a mutation. The
    default backend follows the ranks' device: the kernels launch, once a
    rank for the scan and once more for the cross-rank merge."""
    import dataclasses

    import numpy as np

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serving.engine import LiraEngine

    ds, bc = _small_build()
    host = LiraEngine.build(ds.base, bc, device="cpu")
    eng = dataclasses.replace(host, mesh=make_test_mesh(1, 2, device=cuda_device))
    ranks = eng.rank_operands()
    assert all(block["vectors"].device.type == "cuda" for _, _, block in ranks[0])
    assert next(ranks[0][0][1].parameters()).device.type == "cuda"
    atol = rt.l2_atol(ds.queries, host.store["vectors"], host.store["ids"])
    for tier, scan_mod in (("f32", l2_mod), ("residual_pq", adc_mod)):
        before = (scan_mod.launches, dd_mod.launches)
        first = eng.search(ds.queries, tier=tier)
        assert first.stats.impl == "cuda"
        assert (scan_mod.launches - before[0], dd_mod.launches - before[1]) == (2, 3)
        want = host.search(ds.queries, tier=tier)
        assert want.stats.impl == "ref"
        rt.assert_topk_match(first.dists, first.ids, want.dists, want.ids, atol, what=tier)
    dead = first.ids[:5, :2].reshape(-1)
    eng.delete(dead)
    before = adc_mod.launches
    after = eng.search(ds.queries)
    assert adc_mod.launches - before == 2
    assert eng.rank_operands() is not ranks and not np.isin(after.ids, dead).any()


@pytest.mark.cuda
def test_cluster_kernels_match_plain(cuda_device):
    from repro_torch.serving.cluster import ClusterConfig, LiraCluster
    from repro_torch.utils.clock import FakeClock

    ds, bc = _small_build(n=8000)
    cl = LiraCluster.build(ds.base, bc, ClusterConfig(n_shards=2, n_replicas=2, seed=1),
                           device=cuda_device, clock=FakeClock(), fixed_service_s=1e-3)
    atol = max(rt.l2_atol(ds.queries, g.engine.store["vectors"], g.engine.store["ids"])
               for g in cl.groups)
    for tier in ("f32", "residual_pq"):
        before = dd_mod.launches
        got = cl.search(ds.queries, tier=tier, impl="cuda")
        assert dd_mod.launches - before == 2     # one merge inside each shard engine
        ref = cl.search(ds.queries, tier=tier, impl="ref")
        rt.assert_topk_match(got.dists, got.ids, ref.dists, ref.ids, atol, what=tier)
        assert got.stats.impl == "cuda" and ref.stats.impl == "ref"
        assert (got.overflow, got.stats.dedup_hits) == (ref.overflow, ref.stats.dedup_hits)


@pytest.mark.cuda
@pytest.mark.parametrize("q_batch", [128, 5])
def test_partition_topk_runs_the_qbuf_kernel_over_a_dense_dispatch(cuda_device, q_batch):
    """The evaluation engine's within-partition top-k on a store on the card
    launches l2_topk_qbuf once a block of queries and matches the plain
    version on the CPU (short and empty partitions, replicated ids); every
    q_batch gives the same bits."""
    import numpy as np

    from repro_torch.core import partitions, retrieval

    rng = np.random.default_rng(9)
    x = rng.normal(size=(600, 24)).astype(np.float32)
    q = rng.normal(size=(37, 24)).astype(np.float32)
    assign = np.where(np.arange(600) < 3, 6, np.arange(600) % 6).astype(np.int32)
    ids = np.arange(600, dtype=np.int32)
    extra = (x[:50], ids[:50], ((assign[:50] + 1) % 6).astype(np.int32))
    cents = rng.normal(size=(8, 24)).astype(np.float32)            # partition 7 stays empty
    store = partitions.build_store(x, ids, assign, cents, extra=extra, device=cuda_device)
    cpu = partitions.build_store(x, ids, assign, cents, extra=extra, device="cpu")
    before = l2_mod.launches
    got = retrieval.partition_topk(store, q, 16, q_batch=q_batch)
    assert l2_mod.launches == before + -(-len(q) // q_batch)
    want = retrieval.partition_topk(cpu, q, 16)
    rt.assert_topk_match(got.dists, got.ids, want.dists, want.ids, rt.l2_atol(q, x, ids))
    assert (got.dists[..., 1:] >= got.dists[..., :-1]).all()
    assert np.isinf(got.dists[:, 6, 3:]).all() and (got.ids[:, 7] == -1).all()
    one = retrieval.partition_topk(store, q, 16, q_batch=len(q))
    assert np.array_equal(one.dists, got.dists) and np.array_equal(one.ids, got.ids)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "moonshot_v1_16b_a3b",
                                  "deepseek_coder_33b", "mistral_large_123b", "stablelm_3b"])
def test_lm_prefill_and_decode_on_the_card_equal_the_cpu(cuda_device, arch):
    """An LM SMOKE config in f32 (TF32 off): the same parameters on the card
    and on the CPU give prefill logits and caches within 1e-4 and the same
    token at each of 8 greedy decode steps (both fed the CPU's tokens)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as ttr

    cfg = dataclasses.replace(get_smoke(arch)[0], dtype="float32")
    cpu = ttr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(cpu).to(cuda_device)
    steps = {dev: (ttr.make_prefill_step(cfg, make_test_mesh(device=dev)),
                   ttr.make_decode_step(cfg, make_test_mesh(device=dev), 4, 72))
             for dev in ("cpu", cuda_device)}
    toks = torch.randint(1, cfg.vocab, (4, 64), generator=torch.Generator().manual_seed(1))
    out = {}
    for dev, model in (("cpu", cpu), (cuda_device, card)):
        logits, cache = steps[dev][0](model, toks.to(dev))
        out[dev] = logits.cpu(), {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 8))
                                  for n, c in cache.items()}
    (lc, cc), (lg, cg) = out["cpu"], out[cuda_device]
    assert (lg - lc).abs().max() <= 1e-4
    for n in ("k", "v"):
        assert (cg[n].cpu() - cc[n]).abs().max() <= 1e-4
    tok = lc.argmax(-1).to(torch.int32)[:, None]
    for pos in range(64, 72):
        nc, cc = steps["cpu"][1](cpu, cc, tok, pos)
        ng, cg = steps[cuda_device][1](card, cg, tok.to(cuda_device), pos)
        assert torch.equal(ng.cpu(), nc), (pos, ng, nc)
        tok = nc[:, None]
