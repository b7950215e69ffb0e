"""Build and load the hand-written CUDA kernels under ``repro_torch/csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by nvcc
into its own shared library, loaded with ctypes (no PyTorch headers, so a
build takes seconds). Libraries land in ``build/repro_torch/`` at the root of
the checkout, named by a hash of the source, the headers beside it and the
flags, so an edited source is rebuilt at its next use. Each nvcc run adds
its seconds to ``lira_kernel_build_seconds_total{kernel}`` in
``obs.default_registry()``.

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("l2_topk_qbuf", "dedup_topk", "pq_adc_topk_qbuf", "kmeans_assign", "l2_topk",
           "pq_adc", "pq_adc_topk", "l2u8_topk_qbuf", "rerank_topk_qbuf")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return path


def _build_seconds():
    """The process-wide counter of the seconds nvcc ran, by kernel."""
    from repro_torch.obs.metrics import default_registry

    return default_registry().counter("lira_kernel_build_seconds_total",
                                      "seconds nvcc ran, by kernel library")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every source whose library is missing, one nvcc per source, all
    started together. Returns the seconds each build took (0.0 = up to date).
    Raises with nvcc's output if any build fails. The compiler's report
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside each
    library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    build_s = _build_seconds()
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_s.inc(seconds[name], kernel=name)
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output for the current build of ``name`` ('' if none kept)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed. A
    process that loaded one has the compile counter, zero where nothing was
    compiled."""
    lib = _LIBS.get(name)
    if lib is None:
        _build_seconds()
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
