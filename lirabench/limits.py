"""The readings that the limits of ``correct`` are set from: the compared
numbers of sound runs over many seeds, of the control and of a fault, at the
cells' own size, load and window. The index does not depend on the run's
seed, so one process builds it once and drives every seed's window of every
named cell of its configuration on it, one after another.

    python3 lirabench/limits.py --cells lira-ann.batch8k lira-ann.batch8k-zipf \\
        --seeds 11 12 ... --control-seeds 21 22 23 --fault-seeds 31 32 33 \\
        --seconds 10 --out limits.jsonl

The control is the configuration served at the precision a later change
would be tempted to take, on an index of its own: the overrides that the
configuration file names under ``control`` (merged into its keys as a
cell's overrides are), or else ``CONTROL``, a bfloat16 vector store
(``store_dtype`` "bfloat16"). bfloat16 holds every integer up to 256
exactly, so on 8-bit integer vectors that store loses nothing and cannot
fail: an integer configuration has to name a control of its own, and
``control_of`` refuses one that does not. The fault
leaves out the second half of every batch where the merge produces it.
Both have to come out as not correct. One JSON line a (seed, side, cell)
goes to ``--out`` and to standard output, with the window's rate and the
profile of its calls.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

if pathlib.Path(sys.path[0] or ".").resolve() == pathlib.Path(__file__).resolve().parent:
    sys.path.pop(0)
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from lirabench import run  # noqa: E402

CONTROL = {"build": {"store_dtype": "bfloat16"}}


def control_of(config: dict) -> dict:
    """The overrides that make a configuration its control. They change the
    system served, never the vectors the reference judges it on. An integer
    configuration has to name its own: ``CONTROL`` cannot fail on it."""
    if "control" not in config and config["data"].get("dtype", "float32") != "float32":
        raise ValueError(f"a {config['data']['dtype']} configuration names its own control: "
                         "the bfloat16 store holds every 8-bit value exactly")
    control = config.get("control", CONTROL)
    if "data" in control:
        raise ValueError("a control changes the system served, not the data")
    return control


def half_left_out():
    """Leave out the second half of every batch's answers in the merge:
    (install, remove)."""
    from repro_torch.kernels import ops

    inner = ops.dedup_topk

    def broken(dists, ids, k, **kw):
        d, i = inner(dists, ids, k, **kw)
        d, i = d.clone(), i.clone()
        n = d.shape[0] // 2
        d[n:], i[n:] = float("inf"), -1
        return d, i

    return (lambda: setattr(ops, "dedup_topk", broken)), (lambda: setattr(ops, "dedup_topk", inner))


def readings(cells: list, runs: list, seconds: float, dev, control: bool):
    """``runs``: (side, seed) pairs driven in turn on one index."""
    import torch

    loaded = [run.Cell.load(run.ROOT, c) for c in cells]
    if control:
        loaded = [run.Cell.load(run.ROOT, c.name, control_of(c.config)) for c in loaded]
    if len({json.dumps(c.config, sort_keys=True) for c in loaded}) != 1:
        raise SystemExit("the cells must share one configuration")
    t0 = time.perf_counter()
    base, pool = run.vectors(loaded[0], dev)
    engine = run.build(loaded[0], base, dev)
    del base
    build_s = time.perf_counter() - t0
    install, remove = half_left_out()
    for side, seed in runs:
        wins = []
        for cell in loaded:
            mode = run.traffic(cell, pool, seed)
            run.prepare(cell, engine, mode, False, seconds)
            if side == "fault":
                install()
            try:
                wins.append(run.measure(cell, engine, mode, seconds, None, None, dev, 0.0).window)
            finally:
                remove()
            del mode
        k = engine.cfg.k
        checks = run.judge_all(loaded[0], [seed] * len(wins), dev,
                               [run.answers_of(w, k) for w in wins], k)
        for cell, win, chk in zip(loaded, wins, checks):
            line = {"cell": cell.name, "seed": seed, "side": side, "build_s": build_s,
                    "rows": win.rows, "seconds": win.seconds, "qps": win.rows / win.seconds,
                    "profile": run.call_profile(win),
                    "checks": {n: c["value"] for n, c in chk.items()}}
            yield line
        del wins
        torch.cuda.empty_cache()
    del engine


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="*", type=int, default=[])
    ap.add_argument("--fault-seeds", nargs="*", type=int, default=[])
    ap.add_argument("--control-seeds", nargs="*", type=int, default=[])
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    import torch

    dev = torch.device("cuda")
    sound = [("sound", s) for s in args.seeds] + [("fault", s) for s in args.fault_seeds]
    with open(args.out, "a") as fh:
        for control, runs in ((False, sound), (True, [("control", s) for s in args.control_seeds])):
            if not runs:
                continue
            for line in readings(args.cells, runs, args.seconds, dev, control):
                fh.write(json.dumps(line) + "\n")
                fh.flush()
                print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
