#!/usr/bin/env python3
"""Time DimeNet's train step on full_graph_sm over a mesh of ranks on one
card, for A/B runs of two checkouts: each checkout is timed in a process of
its own, and runs of two trees alternate in one call to the card.

    python3 tools/mesh_graph_ab.py [ROOT] [--mesh DATA MODEL] [--steps N]

ROOT is the checkout whose ``src/`` is imported (default: this one). The
model is ``get_config("dimenet")``'s, drawn from seed 0, and the batch
``make_smoke_inputs``' seed 0, laid out for the mesh's ranks, every rank on
``cuda``. The first step is a warm-up; the line printed gives each step's
ms (host clock after ``torch.cuda.synchronize``), the median of the rest
and the last loss, which must agree between two checkouts that compute the
same function. For example, a parent unpacked under ``build/ab/parent``:

    for r in build/ab/parent . build/ab/parent . ; do
        python3 tools/mesh_graph_ab.py $r; done
"""
import argparse
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--mesh", type=int, nargs=2, default=(2, 2))
    ap.add_argument("--steps", type=int, default=9)
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.data.smoke import make_smoke_inputs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_bundle
    from repro_torch.models.api import TrainState

    if not repro_torch.__file__.startswith(os.path.abspath(args.root)):
        raise SystemExit(f"imported {repro_torch.__file__}, not {args.root}'s")
    cfg, shapes = get_config("dimenet")
    shape = next(s for s in shapes if s.name == "full_graph_sm")
    mesh = make_test_mesh(*args.mesh, device="cuda")
    batch = make_smoke_inputs(cfg, shape, mesh, seed=0)["batch"]
    bundle = build_bundle(cfg, mesh)
    model = bundle.init(torch.Generator(device="cuda").manual_seed(0), shape)
    state = TrainState(model, bundle.optimizer(model))
    fn = bundle.step(shape).fn
    ms = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = fn(state, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    print(f"{args.root} over {args.mesh[0]} x {args.mesh[1]}: steps ms "
          f"{[round(x, 1) for x in ms]}, median after the first {np.median(ms[1:]):.1f}, "
          f"loss {float(metrics['loss']):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
