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
from repro_torch.kernels import rerank_topk as rr_mod


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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 100, 300])
@pytest.mark.parametrize("width", [400, 6400, 16384, 19200, 102400])
def test_dedup_topk_kernel_counts_duplicates(cuda_device, width, k):
    """Answers and duplicate counts equal the plain version's at the
    cross-rank merge's width, the serve step's (64 probes of 100), a power of
    two, and rows whose hash table is too large for shared memory (64 probes
    of 300, the dense pool of 1,024 partitions of 100), which the kernel
    keeps in a global workspace; past 256 best keys (k 300) they are sorted
    rather than ranked."""
    p = width
    d, ids = (torch.from_numpy(a).to(cuda_device) for a in rt.dup_pool(p, seed=p + k))
    assert (dd_mod.workspace_slots(d.shape[0], p, k) > 0) == (p > 19_000)
    dups = torch.full((d.shape[0],), -7, dtype=torch.int64, device=cuda_device)
    before = dd_mod.launches
    kd, ki = dd_mod.dedup_topk(d, ids, k, dups=dups)
    torch.cuda.synchronize()
    assert dd_mod.launches == before + 1
    want = torch.full_like(dups, -7)
    pd, pi = tref.dedup_topk_ref(d, ids, k, dups=want)
    assert torch.equal(kd, pd) and torch.equal(ki, pi) and torch.equal(dups, want)
    assert dups.cpu().tolist() == rt.dup_count_np(ids.cpu().numpy()).tolist()
    kd, ki = dd_mod.dedup_topk(d, ids, k)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4096, 16384, 102400])
def test_dedup_topk_kernel_on_rows_of_distinct_ids(cuda_device, width):
    """Every entry valid and every id distinct, so the hash table is as full
    as it gets, at powers of two and past shared memory: the plain
    version's answers, and no duplicates."""
    g = torch.Generator().manual_seed(width)
    q = 4
    ids = torch.stack([torch.randperm(4 * width, generator=g)[:width] for _ in range(q)])
    d = torch.rand((q, width), generator=g)
    d, ids = d.to(cuda_device), ids.to(torch.int32).to(cuda_device)
    dups = torch.full((q,), -7, dtype=torch.int64, device=cuda_device)
    kd, ki = dd_mod.dedup_topk(d, ids, 100, dups=dups)
    pd, pi = tref.dedup_topk_ref(d, ids, 100)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    assert dups.cpu().tolist() == [0] * q


@pytest.mark.cuda
@pytest.mark.parametrize("n_partitions, nprobe_max, k", [(64, 64, 300), (2048, None, 100)],
                         ids=["k300-over-64-probes", "default-2048-partitions"])
def test_serve_step_merges_pools_past_shared_memory(cuda_device, n_partitions, nprobe_max, k):
    """Merge pools too wide for a shared-memory table: a request's k = 300
    over 64 probes (19,200 entries a row), and a build of 2,048 partitions
    with the default nprobe_max (256 probes of 100, 25,600). The kernels'
    answers, overflow and dedup_hits equal the plain path's."""
    from repro_torch.data.synthetic import make_vector_dataset
    from repro_torch.serving.api import BuildConfig
    from repro_torch.serving.engine import LiraEngine

    ds = make_vector_dataset(n=20_000, n_queries=37, dim=32, n_modes=24, seed=8)
    bc = BuildConfig(n_partitions=n_partitions, nprobe_max=nprobe_max, epochs=2)
    eng = LiraEngine.build(ds.base, bc, device=cuda_device)
    pool = eng.cfg.nprobe_max * k
    assert pool > 19_000 and dd_mod.workspace_slots(len(ds.queries), pool, k) > 0
    before = dd_mod.launches
    got = eng.search(ds.queries, sigma=-1.0, k=k, impl="cuda")
    assert dd_mod.launches - before == 1
    ref = eng.search(ds.queries, sigma=-1.0, k=k, impl="ref")
    atol = rt.l2_atol(ds.queries, eng.store["vectors"], eng.store["ids"])
    rt.assert_topk_match(got.dists, got.ids, ref.dists, ref.ids, atol, what=f"k={k}")
    assert (got.overflow, got.stats.dedup_hits) == (ref.overflow, ref.stats.dedup_hits)
    assert got.stats.dedup_hits > 0


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


def _rerank_inputs(case, dev, seed, width="small"):
    (q_pad, qbuf, vecs, ids, sl), k, dtype, exact = rt.rerank_case(case, width=width, seed=seed)
    args = [torch.from_numpy(a).to(dev) for a in (q_pad, qbuf, vecs, ids, sl)]
    args[2] = args[2].to(getattr(torch, dtype))
    return args, k, exact


@pytest.mark.cuda
@pytest.mark.parametrize("case", rt.RERANK_CASES)
def test_rerank_topk_qbuf_kernel_matches_plain(cuda_device, case):
    """The kernel sums the expansion in another order than the plain
    version's bmm: distances under l2_atol, ids equal up to ties at the
    k-th place (element for element where the distances are exact)."""
    args, k, exact = _rerank_inputs(case, cuda_device, 12)
    before = rr_mod.launches
    kd, ki = rr_mod.rerank_topk_qbuf(*args, k)
    torch.cuda.synchronize()
    assert rr_mod.launches == before + 1
    pd, pi = tref.rerank_topk_qbuf_ref(*args, k)
    q_pad, qbuf, vecs, ids, _ = args
    occ = rt.occupied(q_pad, qbuf)
    assert bool(torch.isinf(kd[~occ]).all()) and bool((ki[~occ] == -1).all())
    rt.assert_topk_match(kd[occ], ki[occ], pd[occ], pi[occ],
                         rt.qbuf_atol(q_pad, qbuf, vecs.float(), ids), exact_ids=exact, what=case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["holes+padding", "bf16 store", "odd d", "deep shortlist"])
def test_rerank_topk_qbuf_kernel_repeats_its_bits(cuda_device, case):
    """At the main path's widths: two runs of the kernel give equal bits."""
    args, k, _ = _rerank_inputs(case, cuda_device, 13, width="main")
    first = rr_mod.rerank_topk_qbuf(*args, k)
    again = rr_mod.rerank_topk_qbuf(*args, k)
    assert torch.equal(first[0].view(torch.int32), again[0].view(torch.int32))
    assert torch.equal(first[1], again[1])


@pytest.mark.cuda
def test_rerank_wrapper_rejects_what_it_does_not_take(cuda_device):
    (q_pad, qbuf, vecs, ids, sl), k, _ = _rerank_inputs("holes+padding", cuda_device, 14)
    before = rr_mod.launches
    with pytest.raises(TypeError):                       # a store of float64
        rr_mod.rerank_topk_qbuf(q_pad, qbuf, vecs.double(), ids, sl, k)
    with pytest.raises(TypeError):
        rr_mod.rerank_topk_qbuf(q_pad.half(), qbuf, vecs, ids, sl, k)
    with pytest.raises(TypeError):
        rr_mod.rerank_topk_qbuf(q_pad, qbuf, vecs, ids, sl.long(), k)
    with pytest.raises(ValueError):                      # d differs
        rr_mod.rerank_topk_qbuf(q_pad[:, :5], qbuf, vecs, ids, sl, k)
    with pytest.raises(ValueError):
        rr_mod.rerank_topk_qbuf(q_pad, qbuf, vecs, ids[:, :5], sl, k)
    with pytest.raises(ValueError):
        rr_mod.rerank_topk_qbuf(q_pad, qbuf, vecs, ids, sl[:, :3], k)
    with pytest.raises(ValueError):
        rr_mod.rerank_topk_qbuf(q_pad.cpu(), qbuf, vecs, ids, sl, k)
    with pytest.raises(ValueError):
        rr_mod.rerank_topk_qbuf(q_pad, qbuf, vecs, ids, sl, 0)
    # one pair's list of 40,000 keys (320 KB) exceeds a block's shared memory:
    # the launch is refused
    with pytest.raises(RuntimeError, match="k=40000"):
        rr_mod.rerank_topk_qbuf(q_pad, qbuf, vecs, ids, sl, 40_000)
    assert rr_mod.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
def test_quantized_scan_makes_no_host_sync(cuda_device, residual):
    """With impl="cuda" the quantized scan, both stages, runs without a host
    synchronization, and its answer meets the plain scan's under the rule."""
    from repro_torch.serving import scan

    case = "residual offsets" if residual else "holes+padding"
    (lut_pad, qbuf, codes, _, coff, _), _, _ = rt.adc_case(case, seed=15)
    b, n, _ = codes.shape
    g = torch.Generator().manual_seed(15)
    q_pad = torch.randn((lut_pad.shape[0], 24), generator=g)
    q_pad[-1] = 1e9
    vecs = torch.randn((b, n, 24), generator=g)
    ids = torch.randperm(b * n, generator=g).reshape(b, n).to(torch.int32)
    ids[torch.rand((b, n), generator=g) < 0.2] = -1
    kw = dict(lut_pad=torch.from_numpy(lut_pad), codes_loc=torch.from_numpy(codes), rk=12)
    if residual:
        kw.update(cterm_loc=torch.from_numpy(coff),
                  off_loc=torch.randn((b, lut_pad.shape[0]), generator=g))
    qbuf = torch.from_numpy(qbuf)
    k = 5
    dev = {name: t.to(cuda_device) for name, t in kw.items() if torch.is_tensor(t)}
    args = [t.to(cuda_device) for t in (qbuf, q_pad, vecs, ids)]
    scan.run("cuda", *args, k, rk=kw["rk"], **dev)           # built and loaded first
    torch.cuda.synchronize()
    before = (adc_mod.launches, rr_mod.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        gd, gi = scan.run("cuda", *args, k, rk=kw["rk"], **dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (adc_mod.launches, rr_mod.launches) == (before[0] + 1, before[1] + 1)
    pd, pi = scan.run("ref", qbuf, q_pad, vecs, ids, k, **kw)
    occ = rt.occupied(q_pad, qbuf)
    rt.assert_topk_match(gd.cpu()[occ], gi.cpu()[occ], pd[occ], pi[occ],
                         rt.qbuf_atol(q_pad, qbuf, vecs, ids))


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
        before = (l2_mod.launches, dd_mod.launches, adc_mod.launches, rr_mod.launches)
        got = eng.search(ds.queries, tier=tier, impl="cuda")
        after = (l2_mod.launches, dd_mod.launches, adc_mod.launches, rr_mod.launches)
        ranks = data * model
        scan = (ranks, 0) if tier == "f32" else (0, ranks)
        assert (after[0] - before[0], after[2] - before[2]) == scan
        assert after[3] - before[3] == scan[1]               # the rerank once a rank
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
    before = (adc_mod.launches, rr_mod.launches)
    after = eng.search(ds.queries)
    assert adc_mod.launches - before[0] == 2
    assert rr_mod.launches - before[1] == 2
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
        before = (dd_mod.launches, rr_mod.launches)
        got = cl.search(ds.queries, tier=tier, impl="cuda")
        assert dd_mod.launches - before[0] == 2  # one merge inside each shard engine
        # the rerank once inside each shard engine on the quantized tier
        assert rr_mod.launches - before[1] == (2 if tier == "residual_pq" else 0)
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
        logits, cache = steps[dev][0](model, toks.to(dev))            # one rank's slice
        out[dev] = logits.cpu(), {n: [torch.nn.functional.pad(c[0], (0, 0, 0, 0, 0, 8))]
                                  for n, c in cache.items()}
    (lc, cc), (lg, cg) = out["cpu"], out[cuda_device]
    assert (lg - lc).abs().max() <= 1e-4
    for n in ("k", "v"):
        assert (cg[n][0].cpu() - cc[n][0]).abs().max() <= 1e-4
    tok = lc.argmax(-1).to(torch.int32)[:, None]
    for pos in range(64, 72):
        nc, cc = steps["cpu"][1](cpu, cc, tok, pos)
        ng, cg = steps[cuda_device][1](card, cg, tok.to(cuda_device), pos)
        assert torch.equal(ng.cpu(), nc), (pos, ng, nc)
        tok = nc[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "stablelm_3b"])
def test_lm_train_step_on_the_card_equals_the_cpu(cuda_device, arch):
    """Two train steps of an LM SMOKE config in f32 (TF32 off) from the same
    parameters: the card's metrics and state within 1e-4 of the CPU's; on
    the card a rerun and remat "none" and "dots" give the same bits."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_bundle
    from repro_torch.models import transformer as ttr

    smoke, shapes = get_smoke(arch)
    toks = torch.randint(1, smoke.vocab, (2, 4, 65), generator=torch.Generator().manual_seed(1))

    def run(dev, remat="full"):
        cfg = dataclasses.replace(smoke, dtype="float32", remat=remat)
        bundle = build_bundle(cfg, make_test_mesh(device=dev))
        model = ttr.init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(dev)
        state = ttr.TrainState(model, bundle.optimizer(model))
        for t in toks:
            t = t.to(dev)
            state, m = bundle.step(shapes[0]).fn(state, {"tokens": t[:, :-1], "labels": t[:, 1:]})
        return torch.stack(list(m.values())).cpu(), [x.cpu() for x in state.leaves()]

    cm, cs = run("cpu")
    gm, gs = run(cuda_device)
    assert (gm - cm).abs().max() <= 1e-4, (gm, cm)
    for a, b in zip(gs, cs):
        assert (a.double() - b.double()).abs().max() <= 1e-4
    for again in (run(cuda_device), run(cuda_device, "none"), run(cuda_device, "dots")):
        assert torch.equal(again[0], gm) and all(torch.equal(a, b) for a, b in zip(again[1], gs))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepfm", "autoint", "mind", "dlrm_rm2"])
def test_recsys_on_the_card_equals_the_cpu(cuda_device, arch):
    """A recsys SMOKE config from the same parameters: serve scores and the
    top 100 of 512 candidates within 1e-5, two train steps' metrics and
    state within 1e-4 of the CPU's; a rerun on the card gives the same
    bits."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.smoke import make_smoke_inputs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_bundle, recsys
    from repro_torch.models.api import ShapeSpec, TrainState

    cfg, (train, serve) = get_smoke(arch)
    retrieval = ShapeSpec("retrieval_sm", "retrieval", {"batch": 1, "n_candidates": 512})

    def run(dev):
        mesh = make_test_mesh(device=dev)
        bundle = build_bundle(cfg, mesh)
        model = recsys.init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(dev)
        outs = [bundle.step(s).fn(model, make_smoke_inputs(cfg, s, mesh, seed=1)["batch"])
                for s in (serve, retrieval)]
        state = TrainState(model, bundle.optimizer(model))
        for seed in (2, 3):
            state, m = bundle.step(train).fn(state, make_smoke_inputs(cfg, train, mesh,
                                                                      seed=seed)["batch"])
        return ([outs[0].cpu(), *(t.cpu() for t in outs[1])], torch.stack(list(m.values())).cpu(),
                [x.cpu() for x in state.leaves()])

    cpu, card = run("cpu"), run(cuda_device)
    assert (card[0][0] - cpu[0][0]).abs().max() <= 1e-5
    assert (card[0][1] - cpu[0][1]).abs().max() <= 1e-5 and card[0][2].dtype == torch.int32
    assert (card[1] - cpu[1]).abs().max() <= 1e-4, (card[1], cpu[1])
    for a, b in zip(card[2], cpu[2]):
        assert (a.double() - b.double()).abs().max() <= 1e-4
    again = run(cuda_device)
    assert all(torch.equal(a, b) for a, b in zip(again[0], card[0]))
    assert torch.equal(again[1], card[1]) and all(torch.equal(a, b) for a, b in zip(again[2], card[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape_name", ["molecule_sm", "graph_sm"])
def test_dimenet_on_the_card_equals_the_cpu(cuda_device, shape_name):
    """DimeNet's SMOKE config, two train steps from the same parameters:
    metrics and state within 1e-4 of the CPU's; on the card a rerun and
    remat "none" give the same bits."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.data.smoke import make_smoke_inputs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_bundle, dimenet
    from repro_torch.models.api import TrainState

    smoke, shapes = get_smoke("dimenet")
    shape = next(s for s in shapes if s.name == shape_name)

    def run(dev, remat="full"):
        cfg = dataclasses.replace(smoke, remat=remat)
        mesh = make_test_mesh(device=dev)
        bundle = build_bundle(cfg, mesh)
        model = dimenet.init_params(cfg, shape["d_feat"], torch.Generator().manual_seed(0),
                                    "cpu").to(dev)
        state = TrainState(model, bundle.optimizer(model))
        batch = make_smoke_inputs(cfg, shape, mesh, seed=0)["batch"]
        for _ in range(2):
            state, m = bundle.step(shape).fn(state, batch)
        return torch.stack(list(m.values())).cpu(), [x.cpu() for x in state.leaves()]

    cm, cs = run("cpu")
    gm, gs = run(cuda_device)
    assert (gm - cm).abs().max() <= 1e-4, (gm, cm)
    for a, b in zip(gs, cs):
        assert (a.double() - b.double()).abs().max() <= 1e-4
    for again in (run(cuda_device), run(cuda_device, "none")):
        assert torch.equal(again[0], gm) and all(torch.equal(a, b) for a, b in zip(again[1], gs))
