#!/usr/bin/env python3
"""A/B the flat ADC kernels (``csrc/pq_adc.cu``, the flat scan of
``csrc/pq_adc_topk.cu``) on one card: build variants side by side and time
them on the same inputs. It reproduces the A/B times PERF.md §6 gives for
the redesign of these two kernels onto ``csrc/adc_tile.cuh``, and is tied to
the sources of that commit: each variant is an exact-text edit of them, and
the script stops, naming the text, where a later change to the kernels
removed it. Re-pin the edits, or remove the tool, when the kernels change.

    python3 tools/adc_ab.py [--parent DIR] [--data pq|random] [VARIANT ...]

Variants of this checkout's sources (text edits of a copy under
``build/adc_ab/``, built with ``kernels._build.NVCC_FLAGS``):
  tile     the sources as they are
  scalar   both kernels reading one query row a lane (V = 1) in place of
           slabs of four rows read with one 16-byte gather
  t8       the flat top-k taking 8 consecutive candidates a lane, not 4
  nosel    the flat top-k with its offers taken out (the gathers, the vote
           and the loads alone; its answers are wrong)
  nostore  pq_adc with its stores taken out (the gathers alone; its output
           is not written)
With ``--parent DIR``, a checkout of the commit before the flat kernels
moved to ``adc_tile.cuh`` (one candidate a lane), also:
  parent     its pq_adc.cu and pq_adc_topk.cu as they are
  parent-cf  the same with lane l gathering at (l + j) mod ks in place of
             its code: no bank conflicts, answers wrong
Inputs: with ``--data pq`` (the default) those of chip_smoke.py's phases 10
and 11 (a plain PQ, m = 16, ks = 256, of the 1M-point base trained on
32,768 rows; the first 1,000 queries' LUTs; k = 100), with ``--data
random`` uniform LUTs and codes of the same shapes. Each variant is checked
against the plain version (the wrong-answer ones are reported, not failed),
then timed with CUDA events (5 launches after 2), in the order given and
again in reverse. Prints each time with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (file, text, replacement) edits of each variant's copy of the sources
EDITS = {
    "tile": [],
    "scalar": [("adc_tile.cuh", "constexpr int slab_rows(int R) { return R < 4 ? R : 4; }",
                "constexpr int slab_rows(int R) { return 1; }"),
               ("pq_adc.cu", "  return R >= 4 ? pq_adc_kernel<CT, NV, 4> : R == 2 ? "
                "pq_adc_kernel<CT, NV, 2>\n                                                    "
                ": pq_adc_kernel<CT, NV, 1>;", "  return pq_adc_kernel<CT, NV, 1>;"),
               ("pq_adc_topk.cu", "  return R >= 4 ? pq_adc_topk_flat_kernel<CT, NV, 4>\n"
                "                : R == 2 ? pq_adc_topk_flat_kernel<CT, NV, 2> : "
                "pq_adc_topk_flat_kernel<CT, NV, 1>;",
                "  return pq_adc_topk_flat_kernel<CT, NV, 1>;")],
    "t8": [("pq_adc_topk.cu", "constexpr int kFlatT = 4;", "constexpr int kFlatT = 8;")],
    "nosel": [("pq_adc_topk.cu",
               "          sel.offer(may != 0, topksel::pack(x, c + b / V), s * V + i, li, lane, done);\n",
               "          sink = may ? fminf(sink, x + (float)li) : sink;\n"),
              ("pq_adc_topk.cu", "  bool in[T];\n", "  bool in[T];\n  float sink = 0.f;\n"),
              ("pq_adc_topk.cu", "  sel.flush(lane, done);\n  __syncthreads();",
               "  if (sink == 12345.f) od[0] = sink;\n  sel.flush(lane, done);\n"
               "  __syncthreads();")],
    "nostore": [("pq_adc.cu", "          if (r >= nr) break;",
                 "          if (r >= nr || part(acc[0], i) != 12345.f) break;")],
    "parent": [],
    "parent-cf": [
        ("pq_adc.cu", "acc[r] = lut_s[r * mks + code];",
         "acc[r] = lut_s[r * mks + (((int)(threadIdx.x & 31) + (code & (int)(blockDim.x >> 16)))"
         " & (ks - 1))];"),
        ("pq_adc.cu", "acc[r] += lut_s[r * mks + j * ks + code];",
         "acc[r] += lut_s[r * mks + j * ks + (((int)(threadIdx.x & 31) + j + (code & "
         "(int)(blockDim.x >> 16))) & (ks - 1))];"),
        ("adc_scan.cuh", "const float x = L[j * ks + code];",
         "const float x = L[j * ks + (((int)(threadIdx.x & 31) + j + (int)(code & "
         "(blockDim.x >> 16))) & (ks - 1))];")],
}
WRONG = ("nosel", "nostore", "parent-cf")  # variants whose answers are wrong by design


def build(names, parent):
    """Copy, edit and nvcc each variant's two libraries, all at once."""
    from repro_torch.kernels import _build

    out = ROOT / "build" / "adc_ab"
    procs = {}
    for name in names:
        src = (pathlib.Path(parent) / "src/repro_torch/csrc" if name.startswith("parent")
               else _build.CSRC)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f in src.iterdir():
            if f.suffix in (".cu", ".cuh"):
                (d / f.name).write_text(f.read_text())
        for fname, old, new in EDITS[name]:
            text = (d / fname).read_text()
            if old not in text:
                raise SystemExit(f"{name}: {fname} no longer holds {old!r}")
            (d / fname).write_text(text.replace(old, new))
        for lib in ("pq_adc", "pq_adc_topk"):
            procs[(name, lib)] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / f"lib{lib}.so"),
                 str(d / f"{lib}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    for (name, lib), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}/{lib}:\n{log}")
    return out


class Variant:
    """One variant's two libraries, called through ctypes."""

    def __init__(self, d: pathlib.Path, parent: bool):
        p, i = ctypes.c_void_p, ctypes.c_int
        self.parent = parent
        self.full = ctypes.CDLL(str(d / "libpq_adc.so"))
        self.full.pq_adc_u8.argtypes = [p, i, i, i, p, i, p, p]
        self.topk = ctypes.CDLL(str(d / "libpq_adc_topk.so"))
        if parent:  # the batched entry point with one bucket
            self.topk.pq_adc_topk_u8.argtypes = [p, i, i, i, i, p, p, p, p, i, i, i,
                                                 p, p, p, p, p]
            self.topk.pq_adc_topk_splits.argtypes = [i] * 7
        else:
            self.topk.pq_adc_topk_flat_u8.argtypes = [p, i, i, i, p, p, p, p, i, i, p, p, p, p]
            self.topk.pq_adc_topk_flat_plan.argtypes = [i] * 6 + [p]
            self.topk.pq_adc_topk_flat_scratch_bytes.argtypes = [i, i]
            self.topk.pq_adc_topk_flat_scratch_bytes.restype = ctypes.c_longlong

    def splits(self, q, n, m, ks, k):
        if self.parent:
            return self.topk.pq_adc_topk_splits(1, q, n, m, ks, k, 1)
        plan = (ctypes.c_longlong * 5)()
        self.topk.pq_adc_topk_flat_plan(q, n, m, ks, k, 1, ctypes.addressof(plan))
        return int(plan[2])


def inputs(kind: str, dev):
    import torch

    if kind == "random":
        g = torch.Generator(device=dev).manual_seed(0)
        lut = torch.rand((1000, 16, 256), device=dev, generator=g)
        codes = torch.randint(0, 256, (1_000_000, 16), device=dev, dtype=torch.uint8, generator=g)
        return lut, codes
    from repro_torch.core import pq as pqmod
    from repro_torch.data.synthetic import make_vector_dataset

    ds = make_vector_dataset(n=1_000_000, n_queries=10_000, dim=128, seed=0)
    x = torch.as_tensor(ds.base, device=dev)
    book = pqmod.train_pq(x[:32_768], m=16, ks=256,
                          generator=torch.Generator(device=dev).manual_seed(0))
    codes = pqmod.encode(book, x)
    return pqmod.adc_lut(book, torch.as_tensor(ds.queries[:1000], device=dev)).contiguous(), codes


def time_ms(fn, iters: int = 5) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=None)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--data", choices=("pq", "random"), default="pq")
    args = ap.parse_args()
    import torch

    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        print("adc_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    names = args.variants or ["tile", "scalar", "t8", "nosel", "nostore"] + (
        ["parent", "parent-cf"] if args.parent else [])
    t0 = time.perf_counter()
    out = build(names, args.parent)
    print(f"built {names} in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    lut, codes = inputs(args.data, dev)
    q, m, ks = lut.shape
    n, k = codes.shape[0], 100
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    want_full = ref.pq_adc_ref(lut, codes)
    want_d, want_i = ref.pq_adc_topk_ref(lut, codes, ids, k)
    stream = torch.cuda.current_stream().cuda_stream
    full = torch.empty((q, n), device=dev)
    calls = {}
    for name in names:
        v = Variant(out / name, name.startswith("parent"))
        s = v.splits(q, n, m, ks, k)
        pd = torch.empty((s, q, k), device=dev)
        pc = torch.empty((s, q, k), dtype=torch.int32, device=dev)
        od = torch.empty((q, k), device=dev)
        oi = torch.empty((q, k), dtype=torch.int32, device=dev)
        scratch = torch.empty(0 if v.parent else v.topk.pq_adc_topk_flat_scratch_bytes(q, k),
                              dtype=torch.uint8, device=dev)

        def run_full(v=v):
            err = v.full.pq_adc_u8(lut.data_ptr(), q, m, ks, codes.data_ptr(), n, full.data_ptr(),
                                   stream)
            assert err == 0, err

        def run_topk(v=v, s=s, pd=pd, pc=pc, od=od, oi=oi, scratch=scratch):
            if v.parent:
                err = v.topk.pq_adc_topk_u8(lut.data_ptr(), 1, q, m, ks, codes.data_ptr(),
                                            ids.data_ptr(), None, None, n, k, s, pd.data_ptr(),
                                            pc.data_ptr(), od.data_ptr(), oi.data_ptr(), stream)
            else:
                err = v.topk.pq_adc_topk_flat_u8(lut.data_ptr(), q, m, ks, codes.data_ptr(),
                                                 ids.data_ptr(), None, None, n, k,
                                                 scratch.data_ptr(), od.data_ptr(),
                                                 oi.data_ptr(), stream)
            assert err == 0, err

        run_full()
        run_topk()
        torch.cuda.synchronize()
        same = (torch.equal(full, want_full), torch.equal(od, want_d) and torch.equal(oi, want_i))
        print(f"{name}: {s} candidate ranges; pq_adc equal to plain {same[0]}, flat top-k "
              f"equal to plain {same[1]}{' (wrong by design)' if name in WRONG else ''}",
              flush=True)
        if name not in WRONG and not all(same):
            raise SystemExit(f"{name}: a kernel differs from its plain version")
        calls[name] = (run_full, run_topk)
    times = {}
    for name in names + names[::-1]:
        run_full, run_topk = calls[name]
        times.setdefault(name, []).append((time_ms(run_full), time_ms(run_topk)))
    for name, ts in times.items():
        print(f"{name}: pq_adc " + " / ".join(f"{a:.3f}" for a, _ in ts) + " ms; flat top-k "
              + " / ".join(f"{b:.3f}" for _, b in ts) + " ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
