"""An 8-bit integer deployment added as a configuration file and a manifest
entry: the harness draws its vectors as uint8, serves them and judges the
answers with exact distances. The f32 tier probing every partition is
exact on them, so the configuration holds ``dist_gap`` to 0."""
from __future__ import annotations

import json

import pytest

from lirabench import limits, run
from lirabench.tests.conftest import TOY_CONFIG

U8_CONFIG = json.loads(json.dumps(TOY_CONFIG))
U8_CONFIG["build"].update(tier="f32", sigma=-1.0, nprobe_max=U8_CONFIG["build"]["n_partitions"])
U8_CONFIG["data"].update(dtype="uint8")
U8_CONFIG["checks"] = {"recall": 1.0, "dist_gap": 0.0}
CELL = "toy-u8.batch"


def _add_u8(root, config=U8_CONFIG):
    (root / "lirabench" / "configs" / "toy-u8.json").write_text(json.dumps(config))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-u8", "source": "toy",
                             "file": "lirabench/configs/toy-u8.json", "reduced": [],
                             "why": "toy"})
    bench["workloads"].append({"name": CELL, "config": "toy-u8", "traffic": "toy-batch",
                               "chips": 1, "why": "toy"})
    bench["end_to_end"][0]["workloads"].append(CELL)        # qps
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, overrides=None):
    return run.run_cell(root, CELL, 2**31 + 11, 0.4, False, device="cpu",
                        overrides=overrides, log=lambda m: None)


def test_the_pool_is_drawn_as_uint8(toy_root):
    import torch

    cell = run.Cell.load(_add_u8(toy_root), CELL)
    base, pool = run.vectors(cell, torch.device("cpu"))
    assert base.dtype == pool.dtype == torch.uint8
    assert run.traffic(cell, pool, 5).stream.dtype.name == "uint8"


def test_exact_tier_on_uint8_reads_no_gap(toy_root):
    res = _run(_add_u8(toy_root))
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["recall"]["value"] == 1.0
    assert res["checks"]["dist_gap"]["value"] == 0.0
    assert set(res["metrics"]) == {"qps", "recall_at_100", "setup_s"}


def test_a_distance_off_by_one_is_not_correct(toy_root, monkeypatch):
    from repro_torch.kernels import ops

    inner = ops.dedup_topk

    def off_by_one(dists, ids, k, **kw):
        d, i = inner(dists, ids, k, **kw)
        d = d.clone()
        d[0, -1] += 1.0
        return d, i

    monkeypatch.setattr(ops, "dedup_topk", off_by_one)
    res = _run(_add_u8(toy_root))
    assert res["correct"] is False
    assert res["checks"]["dist_gap"]["value"] > 0.0


def test_bfloat16_control_cannot_separate_on_uint8(toy_root):
    """bfloat16 holds every integer up to 256: the default control loses
    nothing on 8-bit vectors, so an integer configuration names its own."""
    res = _run(_add_u8(toy_root), limits.CONTROL)
    assert res["checks"]["dist_gap"]["value"] == 0.0 and res["correct"] is True
    with pytest.raises(ValueError, match="control"):
        limits.control_of(U8_CONFIG)


def test_a_configuration_names_its_own_control():
    own = {"build": {"tier": "residual_pq", "pq_m": 4, "pq_ks": 16, "rerank": 1}}
    assert limits.control_of({**U8_CONFIG, "control": own}) == own
    assert limits.control_of(TOY_CONFIG) == {"build": {"store_dtype": "bfloat16"}}
    with pytest.raises(ValueError, match="data"):
        limits.control_of({**TOY_CONFIG, "control": {"data": {"dim": 8}}})


def _tied_base():
    """uint8 rows where rows 10-19 repeat row 0 and rows 20-29 repeat row 1."""
    import numpy as np
    import torch

    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, size=(400, 8)).astype(np.uint8)
    base[10:20], base[20:30] = base[0], base[1]
    return torch.from_numpy(base)


@pytest.mark.parametrize("k", [1, 5])
def test_integer_recall_counts_any_row_at_the_kth_distance(k):
    """Rows tied at the k-th distance are each a right answer on integer
    data, whichever of them the reference's own top-k holds."""
    import numpy as np
    import torch

    from lirabench import judge, reference

    base = _tied_base()
    pool = base[[0, 1]].clone()
    # the tied rows with the largest ids, not the reference's smallest
    ids = np.array([list(range(20 - k, 20)), list(range(30 - k, 30))], np.int32)
    dists = reference.pair_dists(base, reference.as_f32(pool), torch.from_numpy(ids).long())
    answers = judge.Answers(pool=np.arange(2), ids=ids, dists=dists.numpy())
    checks = judge.judge(answers, base, pool, k=k, limits={"recall": 1.0, "dist_gap": 0.0},
                         seed=1, sample=2)
    assert checks["recall"]["value"] == 1.0 and checks["dist_gap"]["value"] == 0.0
    # a row farther than the k-th is a miss
    far = ids.copy()
    far[0, -1] = 399
    dists = reference.pair_dists(base, reference.as_f32(pool), torch.from_numpy(far).long())
    answers = judge.Answers(pool=np.arange(2), ids=far, dists=dists.numpy())
    checks = judge.judge(answers, base, pool, k=k, limits={"recall": 1.0, "dist_gap": 0.0},
                         seed=1, sample=2)
    assert checks["recall"]["value"] == 1.0 - 1.0 / (2 * k)
