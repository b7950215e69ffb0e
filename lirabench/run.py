"""Run one cell of the benchmark of ``repro_torch`` once and print its result.

    python3 lirabench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process, in this order: make the configuration's vectors and query pool
on the card (``data.py``) and draw the cell's traffic over the pool from the
seed; build the index through ``repro_torch.serving.engine.LiraEngine.build``;
warm up the shapes the cell's traffic uses; drive the traffic for
``--seconds``; read the metrics; free the system; judge the answers against
the plain reference (``judge.py``); print the compared numbers and their
limits as the last lines of standard error, and one JSON object as the last
line of standard output.

Everything is found by name from ``BENCHMARK.json``: the configuration's file,
the traffic mix ``lirabench/traffic/<mix>.json`` and the generator of its
mode ``lirabench/modes/<mode>.py``, and a reader for each metric,
``lirabench/metrics/<name>.py`` for the end-to-end metrics (``--trace 0``) and
``lirabench/layers/<name>.py`` for the per-layer ones (``--trace 1``, with the
profiler, the program's spans and counters, and kernel hooks on). A reader's
``read(r)`` takes the ``Reading`` and returns a number, or None where it finds
nothing to read; a per-layer reader may also ``install(hooks)`` before
warm-up.

The kernels are built by the program into ``build/repro_torch/`` in this
checkout; nothing else is written.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == HERE:
    sys.path.pop(0)         # this folder's modules must not shadow others
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
# a fixed cache, inside the checkout, for any PTX that CUDA compiles at load time
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "lirabench" / "cuda-cache")

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
AT_LEAST = ("recall",)      # the compared numbers held from below; the rest from above


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must never load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_module(path: pathlib.Path, tag: str):
    spec = importlib.util.spec_from_file_location(f"lirabench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A cell as ``BENCHMARK.json`` names it, with its files read."""
    root: pathlib.Path
    name: str
    entry: dict
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, root, name: str, overrides: dict | None = None,
             entry: dict | None = None) -> "Cell":
        """The cell ``name`` of ``BENCHMARK.json``, or, given its ``entry``
        (config and traffic), a cell the manifest does not name yet."""
        root = pathlib.Path(root)
        bench = json.loads((root / "BENCHMARK.json").read_text())
        entry = entry or next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
        config = json.loads((root / conf["file"]).read_text())
        for key, val in (overrides or {}).items():
            config[key] = {**config[key], **val} if isinstance(val, dict) else val
        mix = json.loads((root / "lirabench" / "traffic" / f"{entry['traffic']}.json").read_text())

        def here(m):
            return "workloads" not in m or name in m["workloads"]

        e2e = [m for m in bench["end_to_end"] if here(m)]
        reported = {m["name"] for m in e2e}
        layers = [m for m in bench["per_layer"] if here(m) and m["moves"] in reported]
        return cls(root, name, entry, config, mix, e2e, layers)

    def reader(self, kind: str, name: str):
        return load_module(self.root / "lirabench" / kind / f"{name}.py", f"{kind}_{name}")


@dataclasses.dataclass
class Reading:
    """What a metric's reader may read."""
    cell: Cell
    window: object                   # window.Window
    setup_s: float
    registry: object = None          # obs.MetricsRegistry (traced runs)
    tracer: object = None            # obs.Tracer (traced runs)
    reduced: object = None           # capture.Reduced (traced runs on the card)
    hooks: object = None             # capture.Hooks (traced runs)
    window_peak_bytes: int | None = None
    checks: dict | None = None
    layer_values: dict = dataclasses.field(default_factory=dict)


def vectors(cell: Cell, dev):
    """The configuration's data set and query pool on ``dev``: (base, pool)."""
    from lirabench import data

    cfg = cell.config
    return data.make_vectors(cfg["data"], int(cfg["n_points"]), int(cfg["n_queries_pool"]), dev)


def traffic(cell: Cell, pool, seed: int):
    """The cell's traffic over the query pool, drawn from ``seed``."""
    return cell.reader("modes", cell.mix["mode"]).Mode(cell.mix, pool, seed)


def build(cell: Cell, base, dev):
    """The index over ``base``, built from the configuration's own seed."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serving import api
    from repro_torch.serving.engine import LiraEngine

    engine = LiraEngine.build(base, api.BuildConfig(**cell.config["build"]), device=dev)
    engine.metrics = obs_metrics.MetricsRegistry()
    return engine


def prepare(cell: Cell, engine, mode, trace: bool, seconds: float):
    """The traffic's shapes warmed up for a window of ``seconds``; with
    ``trace`` the per-layer readers' hooks go in first. Returns (readers,
    hooks)."""
    from lirabench import capture

    readers = hooks = None
    if trace:
        hooks = capture.Hooks()
        readers = {m["name"]: cell.reader("layers", m["name"]) for m in cell.per_layer}
        for r in readers.values():
            if hasattr(r, "install"):
                r.install(hooks)
    mode.warm(engine, seconds)
    return readers, hooks


def measure(cell: Cell, engine, mode, seconds: float, readers, hooks, dev, setup_s: float):
    """Drive the window (traced when ``hooks`` is given) and read the
    per-layer metrics. Returns the ``Reading``; ``layer_values`` on it."""
    import torch

    from lirabench import capture
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    tracer, registry, cap = obs_trace.NOOP, None, None
    if hooks is not None:
        tracer = obs_trace.Tracer(max_spans=1_000_000)
        registry = obs_metrics.MetricsRegistry()
        engine.tracer, engine.metrics = tracer, registry
        hooks.counting = True
        cap = capture.Capture(tracer, cuda)
        with cap:
            win = mode.run(engine, seconds, tracer)
        hooks.counting = False
    else:
        win = mode.run(engine, seconds, tracer)
    if cuda:
        torch.cuda.synchronize(dev)
    reading = Reading(cell=cell, window=win, setup_s=setup_s,
                      registry=registry, tracer=tracer if hooks is not None else None,
                      hooks=hooks,
                      window_peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else None)
    if hooks is not None:
        if cuda:
            reading.reduced = cap.reduce()
        for m in cell.per_layer:
            v = readers[m["name"]].read(reading)
            if v is not None:
                reading.layer_values[m["name"]] = v
        hooks.remove()
        engine.tracer = None
    return reading


def store_line(engine) -> str:
    """The store's live rows against its padded slots, and its bytes."""
    occ = engine.store["occupancy"]
    per = occ.sum(1)
    held = sum(t.nbytes for t in engine.store.values() if hasattr(t, "nbytes"))
    return (f"store: {int(per.sum())} live rows in {occ.numel()} slots (largest partition "
            f"{int(per.max())}, mean {float(per.float().mean()):.1f}), {held / 1e9:.3f} GB held")


def call_profile(win) -> str:
    """The host ms of the window's calls: the median of its first eight, of
    the rest, and the slowest."""
    import numpy as np

    ms = np.asarray(win.call_ms)
    if len(ms) < 9:
        return "too few calls for a profile"
    return (f"call ms: first 8 median {np.median(ms[:8]):.3f}, the rest median "
            f"{np.median(ms[8:]):.3f}, slowest {ms.max():.3f} (call {int(ms.argmax())})")


def answers_of(win, k: int):
    import numpy as np

    from lirabench import judge

    return judge.Answers(
        pool=np.concatenate(win.pool) if win.pool else np.zeros(0, np.int64),
        ids=np.concatenate(win.ids) if win.ids else np.zeros((0, k), np.int32),
        dists=np.concatenate(win.dists) if win.dists else np.zeros((0, k), np.float32),
        unanswered=win.unanswered)


def judge_all(cell: Cell, seeds: list, dev, answers: list, k: int) -> list:
    """Judge each of ``answers`` (of the run with the same place in
    ``seeds``) against the reference over the vectors drawn again (the
    system under test must be freed by now)."""
    from lirabench import judge

    cfg = cell.config
    base, pool = vectors(cell, dev)
    out = [judge.judge(a, base, pool, k=k, limits=cfg["checks"], seed=s,
                       sample=int(cfg["recall_sample"])) for s, a in zip(seeds, answers)]
    del base, pool
    return out


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             overrides: dict | None = None, log=None) -> dict:
    """Drive one run of ``workload`` on ``device`` and judge it. Returns the
    result object, the compared numbers last under ``"checks"``."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cell = Cell.load(root, workload, overrides)

    t0 = time.perf_counter()
    base, pool = vectors(cell, dev)
    mode = traffic(cell, pool, seed)
    del pool
    t1 = time.perf_counter()
    engine = build(cell, base, dev)
    del base
    if cuda:
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    readers, hooks = prepare(cell, engine, mode, trace, seconds)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T_START
    build_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log(f"{workload}: seed {seed}; {cell.config['n_points']} points, capacity "
        f"{engine.cfg.capacity}, tier {engine.cfg.tier}, store {engine.cfg.store_dtype}; "
        f"set-up {setup_s:.3f} s (start {t0 - T_START:.3f}, vectors and traffic {t1 - t0:.3f}, "
        f"build {t2 - t1:.3f}, warm-up {T_START + setup_s - t2:.3f}); peak before the window "
        f"{build_peak / 2**30:.3f} GiB; {store_line(engine)}")
    reading = measure(cell, engine, mode, seconds, readers, hooks, dev, setup_s)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded by the window: {found}")
    win, k = reading.window, engine.cfg.k
    log(f"{workload}: window {win.seconds:.3f} s, {win.calls} engine calls, {win.rows} rows, "
        f"{win.unanswered} unanswered, overflow "
        f"{win.overflow}; {call_profile(win)}")

    del engine, mode
    if cuda:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    answers = answers_of(win, k)
    reading.checks = judge_all(cell, [seed], dev, [answers], k)[0]
    log(f"{workload}: judged {len(answers.pool)} answers in {time.perf_counter() - t_judge:.3f} s")

    if trace:
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        metrics = {n: {"value": v, "unit": units[n]} for n, v in reading.layer_values.items()}
    else:
        metrics = {}
        for m in cell.end_to_end:
            v = cell.reader("metrics", m["name"]).read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(max(build_peak, reading.window_peak_bytes or 0))}
    checks = reading.checks
    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": int(win.rows), "failed": int(win.unanswered),
              "metrics": metrics, "device": device_info}
    red = reading.reduced
    if red is not None:
        device_info["busy_s"] = red.busy_s
        device_info["window_s"] = red.window_s
        result["breakdown"] = red.breakdown()
        log(f"{workload}: traced window {red.window_s:.3f} s, device busy {red.busy_s:.3f} s; "
            f"{red.events} device events, {red.unmatched} unmatched, {red.lost} launches "
            f"without a device event; ranges (ms) "
            + ", ".join(f"{n} {ms:.3f}" for n, ms in red.ranges.items()))
    result["checks"] = {n: {"value": c["value"], "limit": c["limit"]} for n, c in checks.items()}
    return result


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unread ({err})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the process loaded {found}: the port must not", file=sys.stderr)
        return 4
    print(f"card: {card_line()}", file=sys.stderr)
    for name, c in result["checks"].items():
        side = "at least" if name in AT_LEAST else "at most"
        print(f"check {name}: {c['value']!r} ({side} {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
