"""Op-level cost counter (counterpart of ``repro/launch/hlo_cost.py``).

The reference parses the optimized HLO text of a compiled step. The port has
no such text: it counts the ATen ops a step dispatches while it runs, on
``meta`` tensors (shapes and dtypes, no storage, nothing computed) or on real
ones, under a ``TorchDispatchMode``:

  * FLOPs: the products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, the
    ``_scaled_dot_product_*`` kernels, convolutions; ``einsum`` and
    ``matmul`` reach these) at 2 · |result| · Π(contracted dims), by
    ``torch.utils.flop_counter``'s formulas. An op is counted each time it
    runs, so a Python loop over layers or KV blocks counts once an
    iteration (the reference's while trip count) and a product that
    ``torch.utils.checkpoint`` recomputes in backward counts again (the
    reference's remat);
  * bytes: result plus operand bytes of every op that materializes a
    tensor. Views are skipped (the reference's ``SKIP_BYTES_OPS``); a
    gather or slice is charged its result (``RESULT_SIZED_OPS``), a scatter
    or indexed write twice its update (``UPDATE_SIZED_OPS``);
  * collective bytes: what the rank-order collectives of
    ``launch/mesh.py`` (``psum``, ``all_gather``, ``all_to_all``) hand the
    ranks, reported to the counter while it is active;
  * memory: every storage an op creates, from its creation until it is
    freed (a ``weakref.finalize`` on the storage), so the running sum and
    its peak are what the step holds beyond its inputs, with the largest
    storages live at the peak, each with the op and the function that made
    it.

Each op is named by the innermost function of the port that issued it
(``models/layers.py:swiglu_mlp``), marked ``(backward)`` when autograd's
backward ran it. Totals are over the whole call; ``analyze`` divides them by
``n_devices``, so over a mesh of ranks run in one process they are means a
device.
"""
from __future__ import annotations

import heapq
import os
import sys
import time
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import mesh as _mesh

aten = torch.ops.aten

# ops that allocate or alias without moving data
SKIP_BYTES_OPS = {aten.empty, aten.empty_strided, aten.empty_like, aten.detach, aten.alias,
                  aten.lift_fresh, aten._local_scalar_dense, aten.set_, aten.resize_,
                  aten.new_empty, aten.new_empty_strided}
# ops that read only a result-sized region of their source
RESULT_SIZED_OPS = {aten.index, aten.gather, aten.index_select, aten.embedding, aten.slice,
                    aten.constant_pad_nd, aten.flip, aten.take_along_dim}
# indexed writes: they read and write the update's region only
UPDATE_SIZED_OPS = {aten.index_put, aten.index_put_, aten._index_put_impl_, aten.scatter,
                    aten.scatter_, aten.scatter_add, aten.scatter_add_, aten.index_add,
                    aten.index_add_, aten.index_copy, aten.index_copy_, aten.slice_scatter,
                    aten.select_scatter}
# argument index of the update operand of each UPDATE_SIZED_OPS op
_UPDATE_ARG = {aten.index_put: 2, aten.index_put_: 2, aten._index_put_impl_: 2,
               aten.slice_scatter: 1, aten.select_scatter: 1}

TOP_BUFFERS = 15          # storages kept of the live set at the peak
TOP_FLOPS = 15            # names kept of the largest FLOP counts

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.abspath(__file__)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _issuer() -> str:
    """The innermost function of the port on the Python stack (not this
    module): ``path/in/package.py:function``."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PACKAGE) and os.path.abspath(path) != _HERE:
            return f"{os.path.relpath(path, _PACKAGE)}:{f.f_code.co_name}"
        f = f.f_back
    return "<outside the package>"


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is active (``with OpCounter() as c``):
    ``flops``, ``bytes``, ``collectives`` (kind -> bytes), ``flops_by_name``,
    and the memory fields ``live_bytes``, ``peak_bytes`` and ``peak_buffers``
    (the largest storages live at the peak: bytes, op, issuer). With
    ``shapes=True``, ``shapes`` lists (op, shape, dtype) of every result."""

    def __init__(self, *, shapes: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: dict = defaultdict(float)
        self.flops_by_name: dict = defaultdict(float)
        self.shapes = [] if shapes else None
        self.nonzero_calls = 0    # data-dependent sizes (taken at their most on meta)
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_buffers: list = []
        self._snapshot_at = 0
        self._live: dict = {}     # storage id -> (bytes, op, issuer)

    # ------------------------------------------------------------ collectives

    def _collective(self, kind: str, nbytes: int) -> None:
        self.collectives[kind] += nbytes

    def __enter__(self):
        _mesh.COLLECTIVE_SINKS.append(self._collective)
        return super().__enter__()

    def __exit__(self, *exc):
        _mesh.COLLECTIVE_SINKS.remove(self._collective)
        return super().__exit__(*exc)

    # ---------------------------------------------------------------- memory

    def _freed(self, key: int) -> None:
        entry = self._live.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[0]

    def _track(self, outs, name: str, where: str) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            nbytes = st.nbytes()
            self._live[key] = (nbytes, name, where)
            weakref.finalize(st, self._freed, key)
            self.live_bytes += nbytes
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes
                # the largest live storages, retaken when the peak has grown by
                # a hundredth since the last snapshot
                if self.peak_bytes >= 1.01 * self._snapshot_at:
                    self._snapshot_at = self.peak_bytes
                    self.peak_buffers = heapq.nlargest(TOP_BUFFERS, self._live.values())

    # ------------------------------------------------------------- dispatch

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # under inference mode composite ops (matmul, einsum, linear) arrive
        # whole: run their decompositions, whose ops come back here
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet is aten.nonzero:
            self.nonzero_calls += 1
        flat_out = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        name = None
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            if f:
                self.flops += f
                name = self._name(packet)
                self.flops_by_name[name] += f
        if not func.is_view and packet not in SKIP_BYTES_OPS:
            self.bytes += self._op_bytes(packet, args, kwargs, flat_out)
            created = [t for t in flat_out if not self._aliases_input(t, args)]
            if created:
                self._track(created, str(packet).replace("aten.", ""),
                            name.rsplit(" ", 1)[0] if name else _issuer())
        if self.shapes is not None:
            for t in flat_out:
                self.shapes.append((str(packet), tuple(t.shape), t.dtype))
        return out

    @staticmethod
    def _name(packet) -> str:
        bwd = torch._C._current_autograd_node() is not None
        return f"{_issuer()}{' (backward)' if bwd else ''} {str(packet).replace('aten.', '')}"

    @staticmethod
    def _aliases_input(t: torch.Tensor, args) -> bool:
        """An in-place op's result is its input's storage: nothing new."""
        key = t.untyped_storage()._cdata
        return any(isinstance(a, torch.Tensor) and a.untyped_storage()._cdata == key
                   for a in tree_flatten(args)[0])

    @staticmethod
    def _op_bytes(packet, args, kwargs, outs) -> float:
        result = sum(_nbytes(t) for t in outs)
        if packet in RESULT_SIZED_OPS:
            return float(result)
        if packet in UPDATE_SIZED_OPS:
            flat = tree_flatten((args, kwargs))[0]
            i = _UPDATE_ARG.get(packet)
            upd = args[i] if i is not None and i < len(args) else kwargs.get("src", None)
            if not isinstance(upd, torch.Tensor):
                tensors = [a for a in flat if isinstance(a, torch.Tensor)]
                upd = tensors[-1] if tensors else None
            return 2.0 * (_nbytes(upd) if isinstance(upd, torch.Tensor) else 0)
        operands = sum(_nbytes(a) for a in tree_flatten((args, kwargs))[0]
                       if isinstance(a, torch.Tensor))
        return float(result + operands)


def analyze(fn, *args, n_devices: int = 1, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under an ``OpCounter`` and return the
    reference's keys, a device's share (totals / ``n_devices``): ``flops``,
    ``bytes``, ``collective_bytes``, ``collectives`` (kind -> bytes) and
    ``top_flops`` ((name, flops) pairs, largest first); and beside them
    ``peak_bytes`` (the most held beyond the inputs at once, a device's
    share), ``peak_buffers``, ``nonzero_calls`` (ops whose result size
    depends on the data), ``seconds`` (the run's wall time) and ``out``
    (what ``fn`` returned)."""
    n = max(1, int(n_devices))
    t0 = time.perf_counter()
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    seconds = time.perf_counter() - t0
    top = sorted(c.flops_by_name.items(), key=lambda kv: -kv[1])[:TOP_FLOPS]
    return {
        "flops": c.flops / n,
        "bytes": c.bytes / n,
        "collective_bytes": float(sum(c.collectives.values())) / n,
        "collectives": {k: v / n for k, v in sorted(c.collectives.items())},
        "top_flops": [(name, f / n) for name, f in top],
        "peak_bytes": c.peak_bytes / n,
        "peak_buffers": c.peak_buffers,
        "nonzero_calls": c.nonzero_calls,
        "seconds": seconds,
        "out": out,
    }
