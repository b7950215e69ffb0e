"""The dry run and its op-level cost counter (``repro_torch.launch.dryrun``,
``repro_torch.launch.op_cost``) against the reference's ``launch/dryrun.py``
and ``launch/hlo_cost.py``.

* ``model_flops`` equals the reference's on all 44 (arch × shape) cells, up
  to float rounding (rel 1e-12).
* The counter's FLOPs of every SMOKE cell's step, traced on meta tensors
  over one device, within ``SMOKE_FLOPS_SHARE`` (10%) of
  ``hlo_cost.analyze`` of the JAX cell compiled on the CPU over a 1 × 1
  mesh. The two count the same products; what parts them by up to ~6% is
  where the models differ in form (the LM's train step recomputes its
  chunked loss's logits, MIND's routing products). Bytes are not held:
  the reference models XLA's fusions, the counter PyTorch's ops.
* Twins of ``tests/test_hlo_cost.py``: a Python loop over L layers counts L
  times one layer (the reference's while trip count), a checkpointed layer
  stack counts the unrolled one plus its forward again (the recompute), and
  collective bytes are counted, here over a 1 × 4 mesh of CPU ranks.
* A twin of ``test_quantized_scan_traces_without_expanded_lut``: the
  quantized scan's trace holds no [b_loc, q_cap, m, ks] f32 tensor.
* The dry run itself: a cell over the 16 × 16 production mesh of meta ranks
  from the command line, its JSON, memory and ``counted_at`` for the
  quantized tier's data-dependent stage.
"""
import json
import os

import pytest
import torch

from repro_torch.configs import ARCH_IDS, all_cells, get_smoke
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_bundle, transformer
from repro_torch.serving import scan

SMOKE_FLOPS_SHARE = 0.10


def _jax_dryrun():
    """The reference's dry-run module without its 512-device XLA flag: it sets
    XLA_FLAGS at import, which would take effect at the JAX backend's first
    start in this process."""
    old = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as jd
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return jd


def test_model_flops_equal_the_reference_on_every_cell():
    from repro.configs import all_cells as jax_cells

    jd = _jax_dryrun()
    ours = list(all_cells())
    theirs = list(jax_cells())
    assert len(ours) == len(theirs) == 44
    for (arch, cfg, shape), (jarch, jcfg, jshape) in zip(ours, theirs):
        assert (arch, shape.name, shape.kind) == (jarch, jshape.name, jshape.kind)
        want = jd.model_flops(jcfg, jshape)
        assert dryrun.model_flops(cfg, shape) == pytest.approx(want, rel=1e-12), (arch, shape)
        assert want > 0, (arch, shape.name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_flops_track_hlo_cost(arch):
    from repro.configs import get_smoke as jax_smoke
    from repro.launch import hlo_cost
    from repro.launch.mesh import make_test_mesh as jax_mesh

    jd = _jax_dryrun()
    cfg, shapes = get_smoke(arch)
    jcfg, jshapes = jax_smoke(arch)
    for shape, jshape in zip(shapes, jshapes):
        compiled, _, _ = jd._lower_cell(jcfg, jshape, jax_mesh())
        want = hlo_cost.analyze(compiled.as_text())["flops"]
        got, _, _, _ = dryrun.trace_cell(cfg, shape, make_test_mesh(1, 1, device="meta"))
        assert want > 0 and got["flops"] > 0, (arch, shape.name)
        assert abs(got["flops"] / want - 1) <= SMOKE_FLOPS_SHARE, (arch, shape.name, got["flops"],
                                                                    want)


# ------------------------------------------------------ twins of test_hlo_cost

L, D, B = 6, 64, 8


def test_layer_loop_counts_every_iteration():
    """A loop of L matmuls counts L × one layer's 2·B·D·D."""
    w = torch.empty((L, D, D), device="meta")
    x = torch.empty((B, D), device="meta")

    def step(w, x):
        h = x
        for wl in w:
            h = torch.tanh(h @ wl)
        return h.sum()

    res = op_cost.analyze(step, w, x)
    assert res["flops"] == L * 2 * B * D * D
    assert set(res) >= {"flops", "bytes", "collective_bytes", "collectives", "top_flops"}
    assert res["top_flops"][0][0].startswith("<outside the package>")


def test_checkpointed_stack_counts_the_recompute():
    """Backward through checkpointed layers counts the unrolled step's
    forward and backward plus the forward once more (the recompute)."""
    from torch.utils.checkpoint import checkpoint

    w = torch.empty((L, D, D), device="meta", requires_grad=True)
    x = torch.empty((B, D), device="meta", requires_grad=True)

    def step(remat):
        h = x
        for i in range(L):
            h = (checkpoint(lambda a, b: torch.tanh(a @ b), h, w[i], use_reentrant=False)
                 if remat else torch.tanh(h @ w[i]))
        torch.autograd.grad(h.sum(), (w, x))

    fwd = L * 2 * B * D * D
    unrolled = op_cost.analyze(step, False)["flops"]
    remat = op_cost.analyze(step, True)["flops"]
    assert unrolled == 3 * fwd            # forward, and two products a layer in backward
    assert remat == unrolled + fwd


def test_collective_bytes_counted_over_four_ranks():
    """The SP FFN over a 1 × 4 mesh of CPU ranks sums the ranks' f32 partial
    outputs (psum): every layer hands each of the 4 ranks [B, S, D] f32."""
    import dataclasses

    cfg, _ = get_smoke("mistral_large_123b")
    cfg = dataclasses.replace(cfg, ffn_impl="sp", dtype="float32")
    mesh = make_test_mesh(1, 4, device="cpu")
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0), mesh=mesh)
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    res = op_cost.analyze(transformer.make_prefill_step(cfg, mesh), model, tokens, n_devices=4)
    per_layer = 2 * 8 * cfg.d_model * 4
    assert res["collectives"] == {"all-reduce": cfg.n_layers * per_layer}
    assert res["collective_bytes"] == cfg.n_layers * per_layer


def test_collectives_reach_only_an_active_counter():
    from repro_torch.launch import mesh as tmesh

    parts = [torch.ones(3) * i for i in range(4)]
    assert torch.equal(tmesh.psum(iter(parts)), torch.full((3,), 6.0))
    with op_cost.OpCounter() as c:
        tmesh.all_gather(parts)
        tmesh.all_to_all([torch.zeros((4, 2)) for _ in range(4)])
    assert dict(c.collectives) == {"all-gather": 4 * 12 * 4, "all-to-all": 4 * 8 * 4}
    assert tmesh.COLLECTIVE_SINKS == []


def test_quantized_scan_traces_without_expanded_lut():
    """No [b_loc, q_cap, m, ks] f32 tensor in the quantized scan's trace: the
    plain scan reads the compact LUT plane through qbuf, as the kernel
    does."""
    bb, s, qr, cap, d, m, ks, k = 5, 7, 11, 37, 16, 8, 16, 9
    g = torch.Generator().manual_seed(0)
    q_pad = torch.randn((qr + 1, d), generator=g)
    qbuf = torch.randint(0, qr + 1, (bb, s), generator=g, dtype=torch.int32)
    cands = torch.randn((bb, cap, d), generator=g)
    cid = torch.randint(0, 500, (bb, cap), generator=g, dtype=torch.int32)
    lut_pad = torch.randn((qr + 1, m, ks), generator=g)
    codes = torch.randint(0, ks, (bb, cap, m), generator=g).to(torch.uint8)
    with op_cost.OpCounter(shapes=True) as c:
        scan.run("cuda", qbuf, q_pad, cands, cid, k, lut_pad=lut_pad, codes_loc=codes, rk=k)
    shapes = {(shape, dtype) for _, shape, dtype in c.shapes}
    assert ((bb, s, m, ks), torch.float32) not in shapes
    assert ((bb, s, cap), torch.float32) in shapes       # the ADC distances, a slot a row


# ---------------------------------------------------------------- the dry run

def test_dryrun_cli_writes_a_cell(tmp_path, capsys):
    out = tmp_path / "cell.json"
    assert dryrun.main(["--arch", "dlrm-rm2", "--shape", "serve_p99", "--mesh", "single",
                        "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["n_chips"] == 256 and res["mesh"] == "single" and res["kind"] == "rec_serve"
    assert res["memory"]["fits_80g"] and res["memory"]["optimizer"] == 0
    assert res["ops"]["flops_per_device"] == pytest.approx(res["model_flops_per_device"],
                                                           rel=0.05)
    # the tables' rows split over the 16 model ranks: a psum of the lookups
    assert res["ops"]["collectives"]["all-reduce"] > 0
    assert "memory/device" in capsys.readouterr().out
    assert dryrun.RESULTS_DIR.relative_to(dryrun.ROOT).as_posix() == "build/dryrun_torch"


def test_dryrun_memory_and_worst_case_count():
    """A train cell's memory parts (dlrm-rm2 whole at a small batch: its
    tables split over 16 model ranks, the MLPs whole), and the quantized
    tier's stage 2 traced at every slot occupied (said so in the result)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import ShapeSpec

    cfg, _ = get_config("dlrm-rm2")
    res = dryrun.run_cell("dlrm-rm2", ShapeSpec("t", "rec_train", {"batch": 256}), "single",
                          verbose=False)
    specs = dict(dryrun._flat(build_bundle(cfg, make_test_mesh(1, 1, device="meta"))
                              .param_specs()))
    tables = sum(s.numel() for path, s in specs.items() if path[0] == "tables")
    rest = sum(s.numel() for path, s in specs.items() if path[0] != "tables")
    assert tables % 16 == 0 and res["memory"]["parameters"] == 4 * (tables // 16 + rest)
    assert res["memory"]["optimizer"] == 8 * (tables // 16 + rest) + 4
    assert res["memory"]["activation_peak"] > 0 and res["top_buffers"]
    assert "counted_at" not in res
    res = dryrun.run_cell("lira-ann-q", ShapeSpec("s", "lira_serve", {"n_queries": 64}), "one",
                          verbose=False)
    assert res["kind"] == "lira_serve" and res["counted_at"] == "every slot occupied"


def test_apply_variant():
    cfg, _ = get_smoke("qwen3_moe_235b_a22b")
    out = dryrun.apply_variant(cfg, "moe.capacity_factor=1.0,remat=dots")
    assert out.moe.capacity_factor == 1.0 and out.remat == "dots"
    assert dryrun.apply_variant(cfg, "baseline") is cfg
