"""Quickstart (counterpart of ``examples/quickstart.py``): build a LIRA index
on synthetic vectors and search it.

    PYTHONPATH=src python -m repro_torch.examples.quickstart                 # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Walks the paper's full pipeline on a small dataset: K-Means partitions →
probing-model training → learning-based redundancy → query-aware retrieval,
then compares against plain IVF through the evaluation engine
(``core/retrieval``, whose within-partition top-k runs ``l2_topk_qbuf`` on
the card).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import ground_truth as gt
from repro_torch.core import retrieval as ret
from repro_torch.core.kmeans import kmeans_fit
from repro_torch.core.partitions import build_store
from repro_torch.core.redundancy import plan_redundancy, replica_rows
from repro_torch.core.train_probing import train_probing_model
from repro_torch.data.synthetic import make_vector_dataset
from repro_torch.utils.device import resolve_device


def main(device=None) -> dict:
    """Returns LIRA's and IVF's ``retrieval.SearchResult`` at matched recall."""
    dev = resolve_device(device)
    n, n_queries, n_train, k, b = 20_000, 300, 8_000, 10, 32
    print(f"1) dataset: {n // 1000}k synthetic 64-d vectors (SIFT-like hardness)")
    ds = make_vector_dataset(n=n, n_queries=n_queries, dim=64, n_modes=64, seed=1)
    base = torch.as_tensor(ds.base, device=dev)

    print(f"2) K-Means partitions (B={b})")
    st = kmeans_fit(base, b, n_iters=15, generator=torch.Generator(dev).manual_seed(0))
    assign, cents = st.assign.cpu().numpy(), st.centroids

    print(f"3) probing-model labels from a {n_train // 1000}k training subset (paper A.3)")
    sub = np.random.default_rng(0).choice(len(ds.base), n_train, replace=False)
    xs = ds.base[sub]
    _, sti = gt.exact_knn(xs, xs, k, exclude_self=True, device=dev)
    lab = np.zeros((len(sub), b), np.float32)
    rows = np.repeat(np.arange(len(sub)), sti.shape[1])
    np.add.at(lab, (rows, assign[sub][sti].reshape(-1)), 1.0)
    lab = (lab > 0).astype(np.float32)

    print("4) train probing model f(q, I) = p̂  (BCE, paper §3.2)")
    model, tlog = train_probing_model(xs, lab, cents, epochs=6, batch=256, lr=2e-3,
                                      generator=torch.Generator(dev).manual_seed(1), device=dev)
    print(f"   loss {tlog.losses[0]:.2f} → {tlog.losses[-1]:.3f}; "
          f"kNN-partition recall {tlog.recalls[-1]:.3f}")

    print("5) learning-based redundancy (η=10%, paper §3.3)")
    ids = np.arange(len(ds.base), dtype=np.int32)
    plan = plan_redundancy(model, base, assign, cents, eta=0.10)
    store = build_store(base, ids, assign, cents, extra=replica_rows(plan, base, ids))

    print("6) query-aware retrieval vs IVF at matched recall")
    _, gti = gt.exact_knn(ds.queries, ds.base, k, device=dev)
    ptk = ret.partition_topk(store, ds.queries, k)
    cd = ret.lira_inputs(store, ds.queries)
    with torch.no_grad():
        p_hat = model.probs(torch.as_tensor(ds.queries, device=dev),
                            torch.as_tensor(cd, device=dev)).cpu().numpy()

    lira = ret.evaluate_probe(ptk, ret.probe_lira(p_hat, 0.15), gti, k)
    ivf = None
    for nprobe in range(1, b + 1):
        ivf = ret.evaluate_probe(ptk, ret.probe_ivf(cd, nprobe), gti, k)
        if ivf.recall >= lira.recall:
            break
    print(f"   LIRA: recall={lira.recall:.3f} cmp={lira.cmp_mean:.0f} nprobe={lira.nprobe_mean:.2f}")
    print(f"   IVF : recall={ivf.recall:.3f} cmp={ivf.cmp_mean:.0f} nprobe={ivf.nprobe_mean:.2f}")
    print(f"   → LIRA saves {1 - lira.cmp_mean / ivf.cmp_mean:.0%} distance computations")
    return {"lira": lira, "ivf": ivf}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    main(ap.parse_args().device)
