"""A toy copy of the benchmark for the CPU tests: the harness's files copied
under a temporary root, with a small configuration, a small mix and its
cell added as files and manifest entries (what a later change that
adds a cell does). The port runs its plain PyTorch path on the CPU."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TOY_CONFIG = {
    "source": "a toy of lira-ann-q for the CPU tests",
    "build": {"n_partitions": 8, "k": 10, "eta": 0.03, "nprobe_max": 8, "sigma": -1.0,
              "train_frac": 0.2, "epochs": 2, "q_cap_factor": 2.0, "auto_q_cap": False,
              "store_dtype": "float32", "impl": "auto", "seed": 0, "tier": "residual_pq",
              "pq_m": 4, "pq_ks": 16, "rerank": 4},
    "n_points": 3000,
    "n_queries_pool": 128,
    "recall_sample": 200,
    "data": {"dim": 16, "n_modes": 12, "boundary_frac": 0.4, "noise_frac": 0.02,
             "center_scale": 1.5, "spread": 2.0, "mixture_seed": 0, "data_seed": 0,
             "query_seed": 1},
    "checks": {"recall": 0.75, "dist_gap": 1e-5},
}
TOY_MIXES = {
    "toy-batch": {"mode": "closed", "batch_rows": 64, "rows": "zipf", "zipf_s": 1.0,
                  "ranking_seed": 2, "warm_calls": 2},
}
TOY_CELLS = {"toy.batch": "toy-batch"}


def make_toy_root(root: pathlib.Path, config: dict | None = None) -> pathlib.Path:
    """A checkout-like root: ``BENCHMARK.json`` plus ``lirabench/``, with the
    toy configuration, mix and cell added. Every metric that lists its
    cells gains the toy cell."""
    shutil.copytree(REPO / "lirabench", root / "lirabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "lirabench" / "configs" / "toy.json").write_text(json.dumps(config or TOY_CONFIG))
    bench["configs"].append({"name": "toy", "source": "toy", "file": "lirabench/configs/toy.json",
                             "reduced": [], "why": "toy"})
    for mix, spec in TOY_MIXES.items():
        (root / "lirabench" / "traffic" / f"{mix}.json").write_text(json.dumps(spec))
    for cell, mix in TOY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": "toy", "traffic": mix, "chips": 1,
                                   "why": "toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("toy.batch")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture
def toy_root(tmp_path):
    return make_toy_root(tmp_path)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
