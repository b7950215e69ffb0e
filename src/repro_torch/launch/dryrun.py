"""The dry run (counterpart of ``repro/launch/dryrun.py``): every (arch ×
shape) cell's step traced over the production meshes — 16 × 16 ("single")
and 2 × 16 × 16 ("multi") — with every rank on the ``meta`` device, so
nothing is allocated or computed. For each cell it records a device's
memory (parameters, optimizer state, inputs and the activation peak), the
op counter's FLOPs, bytes and collective bytes (``launch/op_cost.py``), the
analytic ``model_flops`` and the trace time.

One cell (on the CPU, no card needed):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b \\
        --shape train_4k --mesh single

or every cell, one subprocess each (a failure is reported with its
traceback and the others go on):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Results go to ``build/dryrun_torch/`` at the root of the checkout.

How a device's numbers are taken: the port runs a mesh's ranks in one
process, so a step's trace holds every rank's work. Parameters and
optimizer state are counted as placed (a leaf split over "model" ranks
counts one slice a device, any other leaf whole); inputs, activations,
FLOPs, bytes and collective bytes are the trace's totals over the ranks
divided by their number, a device's mean share. Where a step's work depends
on its data (the quantized tiers' stage 2 reranks the occupied dispatch
slots), the trace counts every slot occupied and the result says so
(``counted_at``).
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[3]
RESULTS_DIR = ROOT / "build" / "dryrun_torch"

# the memory a device holds: an NVIDIA H100 80GB HBM3's total memory as
# torch.cuda.get_device_properties reports it (79.18 GiB); the card's own
# figure is read instead when one is present
H100_80GB_HBM3_BYTES = 85_017_493_504
TRAIN_KINDS = ("train", "graph_train", "rec_train", "lira_train")


def model_flops(config, shape) -> float:
    """Analytic model FLOPs: 6·N·D to train, 2·N·D to infer (plus the
    attention terms); a MoE counts its active parameters only. The
    reference's arithmetic, term for term."""
    from repro_torch.configs.base import GNNConfig, LiraSystemConfig, LMConfig, RecsysConfig

    if isinstance(config, LMConfig):
        n_act = config.active_param_count
        l, h, dh = config.n_layers, config.n_heads, config.head_dim
        if shape.kind == "train":
            t = shape["global_batch"] * shape["seq_len"]
            # causal: half of the full attention's
            attn = 6 * l * shape["global_batch"] * shape["seq_len"] ** 2 * h * dh
            return 6.0 * n_act * t + attn
        if shape.kind == "prefill":
            t = shape["global_batch"] * shape["seq_len"]
            attn = 2 * l * shape["global_batch"] * shape["seq_len"] ** 2 * h * dh
            return 2.0 * n_act * t + attn
        if shape.kind == "decode":
            b, s = shape["global_batch"], shape["seq_len"]
            attn = 4 * l * b * s * h * dh
            return 2.0 * n_act * b + attn
    if isinstance(config, GNNConfig):
        e = shape["n_edges"] * shape.dims.get("batch", 1)
        t = e * shape["triplet_mult"]
        hdim = config.d_hidden
        per_block = 2 * t * hdim * hdim * (config.n_bilinear + 1) + 6 * e * hdim * hdim
        fwd = config.n_blocks * per_block + 2 * e * (2 * hdim) * hdim
        return 3.0 * fwd  # train
    if isinstance(config, RecsysConfig):
        b = shape["batch"] if shape.kind != "retrieval" else shape["n_candidates"]
        d = config.embed_dim
        f = config.n_sparse
        per = 0.0
        if config.interaction == "fm":
            sizes = (f * d, *config.mlp, 1)
            per = sum(2 * a * bb for a, bb in zip(sizes[:-1], sizes[1:]))
        elif config.interaction == "self-attn":
            da = config.d_attn * config.n_heads
            d_in = d
            for _ in range(config.n_attn_layers):
                per += 2 * f * d_in * da * 4 + 4 * f * f * da
                d_in = da
            per += 2 * f * da
        elif config.interaction == "multi-interest":
            per = (config.capsule_iters * (4 * config.hist_len * config.n_interests * d)
                   + 2 * config.hist_len * d * d)
        elif config.interaction == "dot":
            sizes = tuple(config.bot_mlp)
            per += sum(2 * a * bb for a, bb in zip(sizes[:-1], sizes[1:]))
            nf = config.n_sparse + 1
            per += 2 * nf * nf * d
            d_int = nf * (nf - 1) // 2 + config.bot_mlp[-1]
            sizes = (d_int, *config.top_mlp)
            per += sum(2 * a * bb for a, bb in zip(sizes[:-1], sizes[1:]))
        mult = 3.0 if shape.kind == "rec_train" else 1.0
        return mult * b * per
    if isinstance(config, LiraSystemConfig):
        if shape.kind == "lira_serve":
            q = shape["n_queries"]
            return q * config.nprobe_max * config.capacity * 2.0 * config.dim
        if shape.kind == "lira_train":
            from repro_torch.core import probing

            pc = probing.ProbingConfig(dim=config.dim, n_partitions=config.n_partitions,
                                       q_hidden=tuple(config.q_hidden),
                                       i_hidden=tuple(config.i_hidden),
                                       p_hidden=tuple(config.p_hidden))
            n_params = sum(p.numel() for p in probing.ProbingModel(pc, device="meta").parameters())
            return 6.0 * n_params * shape["batch"]
    return 0.0


def apply_variant(config, variant: str):
    """Named variants: ``"baseline"`` or ``"field=value,..."`` overrides of
    the config, one level of nesting allowed (``moe.capacity_factor=1.0``)."""
    import dataclasses
    if variant == "baseline":
        return config
    overrides = {}
    for kv in variant.split(","):
        k, v = kv.split("=")
        if "." in k:
            outer, inner = k.split(".", 1)
            sub = overrides.get(outer, getattr(config, outer))
            cur = getattr(sub, inner)
            overrides[outer] = dataclasses.replace(
                sub, **{inner: type(cur)(v) if not isinstance(cur, bool) else v == "True"})
        else:
            cur = getattr(config, k)
            overrides[k] = type(cur)(v) if not isinstance(cur, bool) else v == "True"
    return dataclasses.replace(config, **overrides)


def top_buffers(counter_result: dict, n: int = 15) -> list:
    """The largest storages live at the activation peak: (bytes, the op that
    made it, the function that issued the op), from ``op_cost.analyze``."""
    return [tuple(b) for b in counter_result["peak_buffers"][:n]]


class MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: a bundle's ``init`` draws its
    parameters "on the generator's device", so they come out as meta
    tensors, shapes without storage."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat(tree, path=()):
    """(path, leaf) of every leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, (*path, k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, (*path, i))
    else:
        yield path, tree


def _split(model, path: str) -> int:
    """Slices a device holds one of: the model ranks a leaf is split over,
    else 1."""
    split = model.split_of(path) if hasattr(model, "split_of") else None
    return split[1] if split else 1


def _param_bytes(model) -> int:
    """The parameter bytes a device holds, as the model is placed: a leaf
    split over the model ranks one slice, any other leaf whole."""
    if not hasattr(model, "named_leaves"):
        return sum(_nbytes(p) for p in model.parameters())
    return int(sum(sum(_nbytes(t) for t in tensors) / _split(model, path)
                   for path, _, tensors in model.named_leaves()))


def _opt_bytes(bundle, shape, model) -> int:
    """The AdamW state bytes a device holds: the bundle's ``opt_specs``,
    each moment placed as its parameter (one slice of a split leaf)."""
    specs = bundle.opt_specs(shape)
    total = _nbytes(specs["step"])
    for moment in ("mu", "nu"):
        total += sum(_nbytes(t) / _split(model, ".".join(path))
                     for path, t in _flat(specs[moment]))
    return int(total)


def _mesh_for(mesh_kind: str):
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

    if mesh_kind == "one":
        return make_test_mesh(1, 1, device="meta")
    if mesh_kind not in ("single", "multi"):
        raise ValueError(f"mesh {mesh_kind!r}: single, multi or one")
    return make_production_mesh(multi_pod=mesh_kind == "multi", device="meta")


def trace_cell(config, shape, mesh) -> tuple:
    """Build ``config``'s bundle over ``mesh`` (meta ranks), make its model
    and, for a train kind, its optimizer state, and run the step on the
    input specs under the op counter. Returns (op_cost.analyze's result,
    the bundle, the model, the inputs as passed)."""
    import torch.fx.experimental._config as fx_config

    from repro_torch.launch import op_cost
    from repro_torch.models import build_bundle, transformer
    from repro_torch.models.api import TrainState

    bundle = build_bundle(config, mesh)
    model = bundle.init(MetaGenerator(), shape)
    sd = bundle.step(shape)
    ins = sd.input_specs
    n = len(mesh.devices)
    if shape.kind in TRAIN_KINDS:
        state = TrainState(model, bundle.optimizer(model))
        batch = ins["batch"] if shape.kind == "lira_train" else ins
        call = (sd.fn, state, batch)
    elif shape.kind == "prefill":
        call = (sd.fn, model, ins["tokens"])
    elif shape.kind == "decode":
        # the ranks' cache slices, cut outside the counter; the step writes
        # and attends at the last position (the whole cache)
        ins = dict(ins, cache=transformer.split_cache(ins["cache"], mesh))
        call = (sd.fn, model, ins["cache"], ins["tokens"], shape["seq_len"] - 1)
    elif shape.kind == "lira_serve":
        call = (sd.fn, model, ins["store"], ins["queries"])
    elif shape.kind in ("rec_serve", "retrieval"):
        call = (sd.fn, model, ins)
    else:
        raise ValueError(shape.kind)
    # a data-dependent count (torch.nonzero) on meta is taken at its most:
    # every element nonzero
    with fx_config.patch(meta_nonzero_assume_all_nonzero=True):
        res = op_cost.analyze(*call, n_devices=n)
    return res, bundle, model, ins


def run_cell(arch: str, shape_name, mesh_kind: str, variant: str = "baseline",
             out_path: str | None = None, verbose: bool = True,
             show_buffers: bool = False) -> dict:
    """Trace one cell and return (and write to ``out_path``) its record.
    ``shape_name`` names one of the arch's shapes or is a ``ShapeSpec``;
    ``mesh_kind`` is "single" (16 × 16), "multi" (2 × 16 × 16) or "one" (a
    single device)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import ShapeSpec

    config, shapes = get_config(arch)
    if variant != "baseline":
        config = apply_variant(config, variant)
    shape = (shape_name if isinstance(shape_name, ShapeSpec)
             else next(s for s in shapes if s.name == shape_name))
    mesh = _mesh_for(mesh_kind)
    n_chips = len(mesh.devices)

    t0 = time.perf_counter()
    ops, bundle, model, ins = trace_cell(config, shape, mesh)
    lower_s = time.perf_counter() - t0
    params = _param_bytes(model)
    opt_state = _opt_bytes(bundle, shape, model) if shape.kind in TRAIN_KINDS else 0
    inputs = sum(_nbytes(t) for _, t in _flat(ins) if isinstance(t, torch.Tensor)) / n_chips
    per_device = int(params + opt_state + inputs + ops["peak_bytes"])
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        hbm, hbm_of = int(props.total_memory), props.name
    else:
        hbm, hbm_of = H100_80GB_HBM3_BYTES, "NVIDIA H100 80GB HBM3 (stated, no card read)"
    mf = model_flops(config, shape)
    result = {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind, "variant": variant,
        "kind": shape.kind, "n_chips": n_chips, "lower_s": round(lower_s, 2),
        "memory": {
            "parameters": params,
            "optimizer": int(opt_state),
            "inputs": int(inputs),
            "activation_peak": int(ops["peak_bytes"]),
            "per_device_total": per_device,
            "device_memory": hbm,
            "device_memory_of": hbm_of,
            "fits_80g": bool(per_device <= hbm),
        },
        "ops": {
            "flops_per_device": ops["flops"],
            "bytes_per_device": ops["bytes"],
            "collective_bytes_per_device": ops["collective_bytes"],
            "collectives": ops["collectives"],
            "top_flops": ops["top_flops"][:8],
        },
        "model_flops_global": mf,
        "model_flops_per_device": mf / n_chips,
        "top_buffers": top_buffers(ops),
    }
    if ops["nonzero_calls"]:
        result["counted_at"] = "every slot occupied"
    if verbose:
        print(json.dumps({k: result[k] for k in
                          ("arch", "shape", "mesh", "variant", "n_chips", "lower_s")}))
        print(f"  memory/device: {per_device / 2**30:.2f} GiB (parameters "
              f"{params / 2**30:.2f}, optimizer {opt_state / 2**30:.2f}, inputs "
              f"{inputs / 2**30:.2f}, activation peak {ops['peak_bytes'] / 2**30:.2f}) "
              f"fits {hbm_of}: {result['memory']['fits_80g']}")
        print(f"  ops flops/dev: {ops['flops']:.3e}  bytes/dev: {ops['bytes']:.3e}  "
              f"coll/dev: {ops['collective_bytes']:.3e}")
        print(f"  model flops/dev: {mf / n_chips:.3e}  useful-ratio: "
              f"{(mf / n_chips) / max(ops['flops'], 1):.3f}")
    if show_buffers:
        for b, op, where in result["top_buffers"]:
            print(f"  {b / 2**30:7.2f} GiB {op:22s} {where}")
    if out_path:
        pathlib.Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(out_path).write_text(json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both", "one"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600, help="seconds a cell of --all may take")
    ap.add_argument("--out")
    ap.add_argument("--buffers", action="store_true", help="print the largest live buffers")
    args = ap.parse_args(argv)

    if args.all:
        from repro_torch.configs import ARCH_IDS, get_config

        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        failures, done = [], 0
        cells = [(arch.replace("_", "-"), shape.name, mk) for arch in ARCH_IDS
                 for shape in get_config(arch)[1] for mk in meshes]
        print(f"dry-run: {len(cells)} cells")
        src = str(pathlib.Path(__file__).resolve().parents[2])
        for arch, shape_name, mk in cells:
            out = RESULTS_DIR / f"{arch}__{shape_name}__{mk}__{args.variant}.json"
            if out.exists():
                done += 1
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape_name, "--mesh", mk, "--variant", args.variant,
                   "--out", str(out)]
            t0 = time.time()
            try:
                r = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout,
                                   env={**os.environ, "PYTHONPATH": src})
                if r.returncode != 0:
                    failures.append((arch, shape_name, mk, r.stderr[-3000:]))
                    print(f"FAIL {arch}/{shape_name}/{mk} ({time.time() - t0:.0f}s)")
                else:
                    done += 1
                    print(f"ok   {arch}/{shape_name}/{mk} ({time.time() - t0:.0f}s)")
            except subprocess.TimeoutExpired:
                failures.append((arch, shape_name, mk, "timeout"))
                print(f"TIMEOUT {arch}/{shape_name}/{mk}")
        print(f"\n{done}/{len(cells)} cells passed, {len(failures)} failures")
        for f in failures:
            print("-" * 60)
            print(f[0], f[1], f[2])
            print(f[3])
        return 1 if failures else 0

    if not args.arch or not args.shape:
        ap.error("--arch and --shape name a cell (or pass --all)")
    out = args.out or str(RESULTS_DIR
                          / f"{args.arch}__{args.shape}__{args.mesh}__{args.variant}.json")
    run_cell(args.arch, args.shape, args.mesh, args.variant, out, show_buffers=args.buffers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
