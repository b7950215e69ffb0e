"""LIRA serving engine (counterpart of ``repro/serving/engine.py``).

serve step (each stage a ``torch.profiler.record_function`` range named in
``obs.profiling.RANGES`` and a span of the same name on the engine's tracer,
entered together by ``_stage``), run by every rank of the engine's mesh
(``launch/mesh.py``: one process, ranks over ``("data", "model")``, each on a
device) for its rows of the batch and its block of partitions:
  1. probing: query→centroid distances, the probing MLP, σ-masked
     top-``nprobe_max`` partitions (query-adaptive nprobe, paper §3.4);
  2. dispatch: a sort-based scatter of (query, partition) probes into the
     ``qbuf [b_loc, q_cap]`` buffer of the rank's partitions; probes beyond a
     partition's q_cap are counted as overflow, batch-padding rows never
     probe;
  3. scan (serving/scan.py): ``kernels.l2_topk_qbuf`` per partition for the
     f32 tier, ``kernels.l2u8_topk_qbuf`` over byte rows for the u8 tier;
     for the quantized tiers an ADC shortlist through
     ``kernels.pq_adc_topk_qbuf``, then the exact f32 rerank
     ``kernels.rerank_topk_qbuf``;
  4. merge: each query's dispatched lists gathered through a slot map into
     its [nprobe_max·k] pool, then the replica-aware ``kernels.dedup_topk``,
     which also counts the pool's duplicate ids; over more than one model
     rank, the ranks' lists gathered in rank order and merged and counted by
     ``dedup_topk`` again (the reference's ``all_gather`` and ``psum``).

The engine around it: a serve cache keyed like the reference's jit cache,
spans and metrics (``obs/``: the build's five stages, each stage of the
serve step, the live rows the scan reads and the merge pool's fill), the
single-query entry point and the batching front-end (serving/frontend.py), the mutable index (insert, delete, compact,
staleness-driven repartition, store epochs) and ``save`` / ``load`` in the
reference's checkpoint layout.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.ckpt import checkpoint
from repro_torch.configs.base import LiraSystemConfig
from repro_torch.core import ground_truth as gt
from repro_torch.core import probing
from repro_torch.core.kmeans import kmeans_fit
from repro_torch.core.partitions import build_store
from repro_torch.core.redundancy import plan_redundancy, replica_rows
from repro_torch.core import train_probing
from repro_torch.core.train_probing import train_probing_model
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import Mesh, all_gather, make_test_mesh, psum
from repro_torch.models.api import (ModelBundle, ShapeSpec, StepDef, adamw_state_pspecs,
                                    adamw_state_specs, sds)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.profiling import RANGES
from repro_torch.serving import api, mutable, scan, tiers
from repro_torch.serving.frontend import ServingFrontend
from repro_torch.train import optimizer as opt
from repro_torch.utils.device import resolve_device

# the dispatch sentinel query row: its ||q||² ≈ d·1e18 stays finite in f32,
# and 1e9 stays finite when cast to a bfloat16 store. A byte row's is 0 (1e9
# overflows a uint8): the kernels skip empty slots, so it is never read
_SENTINEL = 1e9


@contextlib.contextmanager
def _stage(tracer, name: str, **attrs):
    """One stage of the serve step: the profiler range ``name`` (one of
    ``RANGES``, the only range names the step may use) and a span of the
    same name on ``tracer``, entered and left together."""
    if name not in RANGES:
        raise ValueError(f"{name!r} is not a serve-step range {RANGES}")
    with record_function(name), tracer.span(name, **attrs):
        yield


def _count(counts: dict, name: str, value) -> None:
    """Add ``value`` (a device scalar or a Python number) to
    ``counts[name]``, on the device of the first value counted there."""
    have = counts.get(name)
    if have is None:
        counts[name] = value
    elif isinstance(have, torch.Tensor):
        counts[name] = have + value.to(have.device)
    else:
        counts[name] = have + value


def _live_rows(block: dict) -> torch.Tensor:
    """Live rows per partition of a rank's block ([b_loc] int64), kept in the
    block and counted again only when the occupancy plane has been written
    in place since (its version counter moved). A sum over the bool plane
    goes through an int64 copy of it: 0.2 ms a call at [1,024, 31,424] on an
    H100."""
    occ = block["occupancy"]
    kept = block.get("live_rows")
    if kept is None or kept[0] != occ._version:
        kept = block["live_rows"] = (occ._version, occ.sum(1))
    return kept[1]


@contextlib.contextmanager
def _build_stage(tracer, registry, dev: torch.device, stage: str):
    """One stage of ``LiraEngine.build``: a ``build.<stage>`` span that ends
    with a synchronize of ``dev``, so the card's work counts under the stage
    that queued it, and the stage's seconds added to
    ``lira_build_seconds_total{stage}``."""
    t0 = time.perf_counter()
    with tracer.span(f"build.{stage}"):
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    registry.counter("lira_build_seconds_total",
                     "seconds LiraEngine.build spent in each stage").inc(
        time.perf_counter() - t0, stage=stage)


def batch_mesh_info(mesh: Mesh):
    """(batch_axes, bprod) for the query-batch axes of a mesh: the one
    source for how the serve step and the batch buckets split queries."""
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    bprod = int(np.prod([mesh.shape[a] for a in batch_axes])) if batch_axes else 1
    return batch_axes, bprod


def place_ranks(model, store: dict, cfg: LiraSystemConfig, mesh: Mesh) -> list:
    """Each rank's operands on its device: ``ranks[i][j]`` is ``(device,
    model, block)`` for batch row ``i`` and model index ``j``. A block holds
    every store field, those the tier splits over ``"model"``
    (``store_pspecs``) cut to the rank's partitions ``[j·b_loc, (j+1)·b_loc)``
    along dim 0, the others whole. On the store's device a block is views of
    the store's planes and the model is the model itself; elsewhere both are
    copied, once a device."""
    if "model" in mesh.axis_names and mesh.axis_names[-1] != "model":
        raise ValueError(f"the model axis must be the mesh's last; axes {mesh.axis_names}")
    model_n = mesh.shape.get("model", 1)
    _, bprod = batch_mesh_info(mesh)
    b_loc = cfg.n_partitions // model_n
    pspecs = tiers.resolve(cfg.tier).store_pspecs(cfg)
    models, blocks, ranks = {}, {}, []
    for i in range(bprod):
        row = []
        for j in range(model_n):
            dev = mesh.devices[i * model_n + j]
            if dev not in models:
                on_dev = next(model.parameters()).device == dev
                models[dev] = model if on_dev else copy.deepcopy(model).to(dev)
            if (dev, j) not in blocks:
                blocks[dev, j] = {
                    name: (plane[j * b_loc:(j + 1) * b_loc] if pspecs.get(name) == "model"
                           else plane).to(dev)
                    for name, plane in store.items()}
            row.append((dev, models[dev], blocks[dev, j]))
        ranks.append(row)
    return ranks


def make_serve_step(cfg: LiraSystemConfig, n_queries: int, *, sigma: float, impl: str,
                    k: int, mesh: Mesh, tier=None):
    """The serve step for one batch size, kernel backend (``"ref"`` or
    ``"cuda"``), mesh and tier (default ``cfg.tier``). Returns
    ``serve_step(ranks, queries [n, d], valid [n] bool, *, tracer, counts)
    → (dists [n, k], ids [n, k], nprobe_eff [n] f32, overflow [],
    dedup_hits [])`` on the first rank's device; ``ranks`` is
    ``place_ranks``' placement of the model and store over ``mesh``. Each
    stage opens a span on ``tracer`` (default ``NOOP``) with its rank's
    model index, ``rank``. Given a dict ``counts``, each rank adds to it
    what its dispatch hands the scan and the merge: ``scan_pair_rows``, the
    live rows of each partition summed over the partition's dispatched
    queries (a device scalar); ``pool_written``, the merge pool's entries
    those pairs' top-k fill (a device scalar); and ``pool_allocated``, the
    entries the pool holds, ``q_row·nprobe_max·k`` (an int).

    The batch splits into ``bprod`` rows of ``q_row`` queries (the batch
    axes) and the partitions into ``model_n`` blocks of ``b_loc``; each rank
    probes, dispatches, scans and merges its block for its rows. Where
    ``model_n > 1`` a batch row's local top-k lists are gathered in rank
    order on its first rank's device, ``[q_row, model_n·k]``, and merged
    again by ``dedup_topk`` (replicas of one id can sit in two blocks):
    ``overflow`` is the sum over ranks, and ``dedup_hits`` the sum of the
    ranks' counts plus the gathered pool's, as the reference counts it. That
    is a lower bound on the one-rank count: a duplicate pair one of whose
    copies missed its block's top-k is never seen. The answers do not depend
    on the mesh."""
    _, bprod = batch_mesh_info(mesh)
    model_n = mesh.shape.get("model", 1)
    if n_queries % bprod or cfg.n_partitions % model_n:
        raise ValueError(f"{n_queries} queries and {cfg.n_partitions} partitions do not split "
                         f"over {bprod} batch rows and {model_n} model ranks")
    q_row = n_queries // bprod
    b_loc = cfg.n_partitions // model_n
    q_cap = max(8, int(q_row * cfg.nprobe_max / cfg.n_partitions * cfg.q_cap_factor))
    tier = tiers.resolve(tier if tier is not None else cfg.tier)
    # the tier's fields beyond the probing/dispatch/rerank operands go back
    # to the tier, which assembles the scan's extra operands from them
    extra_fields = tuple(n for n in tier.store_specs(cfg) if n not in tiers.BASE_FIELDS)

    def rank_step(model, block, q_in, valid, b0, tracer, counts, rank):
        dev = q_in.device
        # byte queries come as they crossed to the card: probing and dispatch
        # see them as f32, the scan as they are
        q = q_in if q_in.is_floating_point() else q_in.float()
        # tombstoned/free slots never surface ids: occupancy folds into the id
        # plane, which the scan masks as id < 0
        ids_loc = torch.where(block["occupancy"], block["ids"], -1)

        # ---- probing, over every partition
        with _stage(tracer, "lira.probing", rank=rank):
            cents = block["centroids"]
            cd = ((q * q).sum(-1, keepdim=True)
                  - 2.0 * q @ cents.T
                  + (cents * cents).sum(-1)[None, :])
            p = torch.sigmoid(model(q, cd))                          # [q_row, B]
            # jax.lax.top_k breaks ties by the lowest index and sigmoid
            # saturates to exactly 1.0 in f32, so ties are real: a stable
            # descending sort keeps the reference's partitions at the cutoff
            vals, pidx = torch.sort(p, dim=-1, descending=True, stable=True)
            vals, pidx = vals[:, :cfg.nprobe_max], pidx[:, :cfg.nprobe_max]
            probe_ok = vals > sigma
            probe_ok[:, 0] = True                                    # always ≥1 partition
            probe_ok &= valid[:, None]                               # padding rows never probe

        # ---- dispatch (sort-based), this rank's partitions only
        with _stage(tracer, "lira.dispatch", rank=rank):
            flat_p = pidx.reshape(-1) - b0
            flat_ok = probe_ok.reshape(-1) & (flat_p >= 0) & (flat_p < b_loc)
            flat_q = torch.arange(q_row, device=dev)[:, None].expand_as(pidx).reshape(-1)
            key = torch.where(flat_ok, flat_p, b_loc)
            skey, order = torch.sort(key, stable=True)
            start = torch.searchsorted(skey, torch.arange(b_loc + 1, device=dev))
            pos = torch.arange(skey.shape[0], device=dev) - start[skey.clamp(0, b_loc)]
            keep = (skey < b_loc) & (pos < q_cap)
            # probes beyond a hot partition's q_cap are dropped — and counted
            overflow = ((skey < b_loc) & (pos >= q_cap)).sum()
            row = torch.where(keep, skey, b_loc)
            col = torch.where(keep, pos, 0)
            # JAX's .at[row, col].set(mode="drop") has no torch twin: a spare
            # row b_loc takes the dropped writes and is cut off
            qbuf = torch.full((b_loc + 1, q_cap), q_row, dtype=torch.int32, device=dev)
            qbuf[row, col] = flat_q[order].to(torch.int32)
            qbuf = qbuf[:b_loc]                                      # q_row = empty slot
            if counts is not None:
                occ = (qbuf < q_row).sum(1)
                _count(counts, "scan_pair_rows", (occ * _live_rows(block)).sum())
                _count(counts, "pool_written", occ.sum() * k)
                _count(counts, "pool_allocated", q_row * pidx.shape[1] * k)

        # ---- per-partition scan
        with _stage(tracer, "lira.scan", rank=rank):
            sentinel = _SENTINEL if q_in.is_floating_point() else 0
            q_pad = torch.cat([q_in, torch.full((1, q.shape[1]), sentinel, dtype=q_in.dtype,
                                                device=dev)])
            ctx = tiers.ScanContext(q_loc=q, q_pad=q_pad, cd=cd, b0=b0, b_loc=b_loc, k=k)
            scan_kw = tier.scan_kwargs(cfg, ctx, {n: block[n] for n in extra_fields})
            dists, rids = scan.run(impl, qbuf, q_pad, block["vectors"], ids_loc, k, **scan_kw)

        # ---- merge: each query's dispatched lists only, gathered through the
        # slot map: a probe's row of the scan's output (row·q_cap + col), or
        # -1 where the probe was masked, is another rank's or overflowed
        # q_cap. Those become (inf, -1): an empty qbuf slot's list is the
        # sentinel query's, with finite distances and real ids.
        with _stage(tracer, "lira.merge", rank=rank):
            n_probe = pidx.shape[1]
            slot = torch.empty_like(order)                           # order: every probe once
            slot[order] = torch.where(keep, row * q_cap + col, -1)
            miss = (slot < 0).view(q_row, n_probe, 1)
            at = slot.clamp(min=0)
            pool_d = torch.index_select(dists.reshape(-1, k), 0, at).view(q_row, n_probe, k)
            pool_i = torch.index_select(rids.reshape(-1, k), 0, at).view(q_row, n_probe, k)
            pool_d = pool_d.masked_fill_(miss, torch.inf).view(q_row, -1)
            pool_i = pool_i.masked_fill_(miss, -1).view(q_row, -1)
            dups = torch.empty(q_row, dtype=torch.int64, device=dev)
            loc_d, loc_i = kops.dedup_topk(pool_d, pool_i, k, impl=impl, dups=dups)
            dedup_hits = dups.sum()
        return loc_d, loc_i, probe_ok.sum(-1).float(), overflow, dedup_hits

    @torch.no_grad()
    def serve_step(ranks, queries, valid, *, tracer=obs_trace.NOOP, counts=None):
        outs = []
        for i, row in enumerate(ranks):
            q, v = queries[i * q_row:(i + 1) * q_row], valid[i * q_row:(i + 1) * q_row]
            per = [rank_step(m, block, q.to(dev), v.to(dev), j * b_loc, tracer, counts, j)
                   for j, (dev, m, block) in enumerate(row)]
            dev0 = row[0][0]
            loc_d, loc_i, nprobe, overflow, dedup_hits = per[0]
            if model_n > 1:
                # the cross-rank merge: O(q_row·k·model_n), independent of N
                with _stage(tracer, "lira.merge", rank=0, ranks=model_n):
                    all_d = all_gather([r[0].to(dev0) for r in per], 1)
                    all_i = all_gather([r[1].to(dev0) for r in per], 1)
                    dups = torch.empty(q_row, dtype=torch.int64, device=dev0)
                    loc_d, loc_i = kops.dedup_topk(all_d, all_i, k, impl=impl, dups=dups)
                    dedup_hits = psum(r[4].to(dev0) for r in per) + dups.sum()
                    overflow = psum(r[3].to(dev0) for r in per)
            outs.append((loc_d, loc_i, nprobe, overflow, dedup_hits))
        if len(outs) == 1:
            return outs[0]
        out_dev = outs[0][0].device
        return (torch.cat([o[0].to(out_dev) for o in outs]),
                torch.cat([o[1].to(out_dev) for o in outs]),
                torch.cat([o[2].to(out_dev) for o in outs]),
                sum(o[3].to(out_dev) for o in outs),
                sum(o[4].to(out_dev) for o in outs))

    return serve_step


def make_bundle(cfg: LiraSystemConfig, mesh: Mesh) -> ModelBundle:
    """The LIRA system as an architecture (the reference's ``make_bundle``).
    ``init(generator)`` draws a probing model on the mesh's first device (the
    generator's device); ``optimizer(model)`` is the reference's AdamW on a
    cosine schedule (1e-3, 50 warm-up steps of 5,000).

      lira_serve: ``fn(model, store, queries)`` → ``make_serve_step``'s
                  outputs, every query valid, σ 0.5, k and impl the config's
                  (``"auto"`` resolved for the mesh's ranks);
      lira_train: ``fn((model, tx), batch)`` → (the same state, {"loss",
                  "grad_norm"}) after one step of ``core.train_probing``'s,
                  in place on the model and ``tx``.
    """
    pc = probing.ProbingConfig(dim=cfg.dim, n_partitions=cfg.n_partitions,
                               q_hidden=tuple(cfg.q_hidden), i_hidden=tuple(cfg.i_hidden),
                               p_hidden=tuple(cfg.p_hidden))
    rank_dev = next((d for d in mesh.devices if d.type == "cuda"), mesh.devices[0])
    impl = kops.resolve_impl(cfg.impl, rank_dev)

    def step(shape: ShapeSpec) -> StepDef:
        if shape.kind == "lira_serve":
            nq = shape["n_queries"]
            serve_step = make_serve_step(cfg, nq, sigma=0.5, impl=impl, k=cfg.k, mesh=mesh)

            def serve(model, store, queries):
                valid = torch.ones(nq, dtype=torch.bool, device=queries.device)
                return serve_step(place_ranks(model, store, cfg, mesh), queries, valid)

            specs = tiers.resolve(cfg.tier).store_specs(cfg)
            return StepDef(fn=serve, input_specs={
                "store": {n: sds(s, dt) for n, (s, dt) in specs.items()},
                "queries": sds((nq, cfg.dim))})
        if shape.kind == "lira_train":
            b = shape["batch"]

            def train(state, batch):
                return train_probing.make_train_step(*state)(state, batch)

            return StepDef(fn=train, input_specs={"batch": {
                "q": sds((b, cfg.dim)), "cent_dist": sds((b, cfg.n_partitions)),
                "labels": sds((b, cfg.n_partitions))}})
        raise ValueError(shape.kind)

    def param_specs(shape=None):
        return {n: sds(p.shape) for n, p in
                probing.ProbingModel(pc, device="meta").named_parameters()}

    return ModelBundle(
        name=cfg.arch,
        config=cfg,
        init=lambda generator, shape=None: probing.ProbingModel(
            pc, generator=generator, device=mesh.devices[0]),
        param_specs=param_specs,
        step=step,
        optimizer=lambda model: opt.AdamW(model.parameters(),
                                          lr=opt.cosine_schedule(1e-3, 50, 5000)),
        opt_specs=lambda shape=None: adamw_state_specs(param_specs()),
        opt_pspecs=lambda shape=None: adamw_state_pspecs({n: () for n in param_specs()}),
    )


def _jax_leaf_names(cfg: LiraSystemConfig) -> list:
    """Leaf paths of a JAX ``LiraEngine.save`` tree, in ``jax.tree.flatten``
    order (dict keys sorted, lists in order); the store's fields are those
    the config's tier declares."""
    n_layers = {"phi_i": len(cfg.i_hidden), "phi_p": len(cfg.p_hidden) + 1,
                "phi_q": len(cfg.q_hidden)}
    names = [("params", g, i, leaf) for g in sorted(n_layers)
             for i in range(n_layers[g]) for leaf in ("b", "w")]
    return names + [("store", f) for f in sorted(tiers.resolve(cfg.tier).store_specs(cfg))]




def _lexsort(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """``np.lexsort((minor, major))``: the permutation that sorts by
    ``major``, then ``minor``, ties kept in input order."""
    first = torch.sort(minor, stable=True).indices
    return first[torch.sort(major[first], stable=True).indices]


@dataclasses.dataclass
class LiraEngine:
    """Build (k-means → probing model → redundancy → store) then serve query
    batches through the serve step over the engine's ``mesh`` (default one
    rank on ``device``, where the store and the model live).

    Batches are padded to power-of-two buckets; the pad rows are masked out
    of dispatch. Serve steps are cached per (bucket, σ, tier, impl, k,
    q_cap_factor, capacity) key, 32 at most, least recently used first out:
    PyTorch runs eagerly, so an entry is the step's closure today (a captured
    CUDA graph is later work), and ``SearchStats.cache_hit`` says whether the
    call found it. With ``cfg.auto_q_cap`` the engine doubles
    ``q_cap_factor`` after ``_AUTO_Q_CAP_AFTER`` consecutive overflowing
    calls and drops the cache.

    The store is epoch-versioned: every mutation (insert, delete, compact,
    repartition) drains the attached front-end first, so no coalesced batch
    spans two epochs, and bumps ``epoch``, which searches stamp into
    ``SearchStats.epoch``. A mutation that keeps the store's shape writes
    into the store's tensors in place (the serve cache keeps hitting, and a
    captured entry would read the right memory); one that moves the capacity
    (growth, compaction, a repartition that needs more slots) puts new planes
    in a new store dict and clears the cache. Engines made from this one by
    ``dataclasses.replace`` share its store tensors, so they see its
    same-shape writes.
    """

    cfg: LiraSystemConfig
    model: probing.ProbingModel
    store: dict
    device: torch.device
    sigma: float = 0.5
    epoch: int = 0
    mesh: Optional[Mesh] = None     # None: one rank on ``device``
    # attached front-end (serving/frontend.py); search_one routes through it
    frontend: Optional[object] = dataclasses.field(default=None, repr=False, compare=False)
    # tracer=None: spans are free no-ops (obs.trace.NOOP); metrics=None:
    # the port's process-wide obs.metrics.default_registry()
    tracer: Optional[object] = dataclasses.field(default=None, repr=False, compare=False)
    metrics: Optional[object] = dataclasses.field(default=None, repr=False, compare=False)
    # per partition, inserts that landed off their argmin partition (no free
    # slot nearer): the drift half of the staleness signal, reset by a
    # repartition. None = zeros.
    _stale_inserts: Optional[np.ndarray] = dataclasses.field(default=None, repr=False,
                                                             compare=False)
    _serve_cache: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                           compare=False)
    _overflow_streak: int = dataclasses.field(default=0, init=False, repr=False,
                                              compare=False)
    # (epoch, store, capacity, mesh) → place_ranks' placement of the model and store
    _ranks: tuple = dataclasses.field(default=(None, None), init=False, repr=False,
                                      compare=False)

    _SERVE_CACHE_MAX = 32   # σ sweeps must not pile up cache entries forever
    _AUTO_Q_CAP_AFTER = 2   # consecutive overflowing calls before a bump
    _GROW_SLACK = 1.5       # capacity overshoot a grow, so a steady insert
    #                         stream grows (and drops the cache) rarely

    def __post_init__(self):
        if self.mesh is None:
            self.mesh = make_test_mesh(device=self.device)

    def _tracer(self):
        return self.tracer if self.tracer is not None else obs_trace.NOOP

    def _registry(self) -> obs_metrics.MetricsRegistry:
        return self.metrics if self.metrics is not None else obs_metrics.default_registry()

    def rank_operands(self) -> list:
        """``place_ranks`` of the model and store over the mesh, placed again
        only when the epoch, the store dict, the capacity or the mesh has
        moved."""
        key = (self.epoch, id(self.store), self.cfg.capacity, self.mesh)
        if self._ranks[0] != key:
            self._ranks = (key, place_ranks(self.model, self.store, self.cfg, self.mesh))
        return self._ranks[1]

    def resolve_impl(self, impl: Optional[str] = None) -> str:
        """The kernel backend for ``impl`` (None: the config's), with
        ``"auto"`` resolved for the devices the kernels run on, the mesh's
        ranks, not the store's: ``"cuda"`` when a rank is on a card (its
        wrappers take the plain versions for ranks on the CPU)."""
        dev = next((d for d in self.mesh.devices if d.type == "cuda"), self.mesh.devices[0])
        return kops.resolve_impl(impl if impl is not None else self.cfg.impl, dev)

    @classmethod
    def build(cls, x, config: api.BuildConfig, *, device=None,
              mesh: Optional[Mesh] = None, tracer=None, metrics=None) -> "LiraEngine":
        """Build an index over ``x`` [N, d] (array or tensor) on ``device``
        (default the card; raises when there is none), served over ``mesh``
        (default one rank on ``device``). A ``build`` span on ``tracer``
        (None: ``NOOP``) holds one span a stage, ``build.kmeans``,
        ``build.train`` (the subsample, its exact k-NN labels and the probing
        model), ``build.redundancy``, ``build.store`` (the padded plane) and
        ``build.tier`` (the tier's store: a cast, or PQ's codebooks and
        codes); each stage ends by synchronizing ``device`` and adds its
        seconds to ``metrics``' (None: ``default_registry()``)
        ``lira_build_seconds_total{stage}``. The engine keeps both. For a
        tier whose plane holds bytes (``u8``), ``x`` holds whole numbers in
        [0, 255], which the store keeps as bytes; the other stages see them
        as f32."""
        dev = resolve_device(device)
        tr = tracer if tracer is not None else obs_trace.NOOP
        reg = metrics if metrics is not None else obs_metrics.default_registry()
        tier = tiers.resolve(config.tier)
        gen = torch.Generator(device=dev)
        gen.manual_seed(config.seed)
        host = np.random.default_rng(config.seed)
        n_partitions = config.n_partitions
        if tier.plane_dtype.is_floating_point:
            xt = x_rows = torch.as_tensor(x, dtype=torch.float32, device=dev)
        else:
            # the store keeps the bytes; k-means, the probing model and the
            # redundancy plan see them cast to f32
            x_rows = tiers.as_bytes(torch.as_tensor(x, device=dev))
            xt = x_rows.float()
        n = xt.shape[0]
        with tr.span("build", rows=n, partitions=n_partitions, tier=tier.name):
            with _build_stage(tr, reg, dev, "kmeans"):
                st = kmeans_fit(xt, n_partitions, n_iters=20, generator=gen)
                assign, cents = st.assign, st.centroids

            with _build_stage(tr, reg, dev, "train"):
                sub = torch.as_tensor(host.choice(n, int(n * config.train_frac), replace=False),
                                      device=dev)
                xs = xt[sub]
                _, sti = gt.exact_knn(xs, xs, config.k, exclude_self=True)
                part_of = assign[sub].long()
                lab = torch.zeros((len(sub), n_partitions), dtype=torch.float32, device=dev)
                rows = torch.arange(len(sub), device=dev).repeat_interleave(sti.shape[1])
                lab[rows, part_of[torch.as_tensor(sti, device=dev).long()].reshape(-1)] = 1.0
                model, _ = train_probing_model(xs, lab, cents, epochs=config.epochs,
                                               log=config.log, generator=gen)

            with _build_stage(tr, reg, dev, "redundancy"):
                ids = np.arange(n, dtype=np.int32)
                plan = plan_redundancy(model, xt, assign, cents, eta=config.eta)
                extra = replica_rows(plan, x_rows, ids)
                del xt

            with _build_stage(tr, reg, dev, "store"):
                store_h = build_store(x_rows, ids, assign, cents, extra=extra,
                                      dtype=tier.plane_dtype)

            with _build_stage(tr, reg, dev, "tier"):
                cfg = LiraSystemConfig(
                    arch="lira", dim=x_rows.shape[1], n_partitions=n_partitions,
                    capacity=store_h.capacity, k=config.k,
                    nprobe_max=min(n_partitions, config.nprobe_max or max(8, n_partitions // 8)),
                    tier=tier.name, pq_m=config.pq_m or 0, pq_ks=config.pq_ks,
                    rerank=config.rerank, impl=config.impl, store_dtype=config.store_dtype,
                    q_cap_factor=config.q_cap_factor, auto_q_cap=config.auto_q_cap,
                    eta=config.eta)
                # the tier builds its store and may amend cfg (PQ resolves pq_m and
                # clamps pq_ks for a small store)
                store, cfg = tier.build_store(cfg, store_h, generator=gen)
                if not cfg.pq_m:  # tiers without PQ leave the knob at its default
                    cfg = dataclasses.replace(cfg, pq_m=16)
        return cls(cfg=cfg, model=model, store=store, device=dev, sigma=config.sigma,
                   mesh=mesh, tracer=tracer, metrics=metrics)

    # ------------------------------------------------------------ serving

    def _batch_bucket(self, nq: int) -> int:
        """Power-of-two batch buckets (≥8), rounded up to a multiple of the
        mesh's batch product so every batch row takes the same rows, as the
        reference pads: q_cap is derived from the bucket, so the same bucket
        dispatches the same way."""
        _, bprod = batch_mesh_info(self.mesh)
        bucket = max(8, 1 << max(0, nq - 1).bit_length())
        return -(-bucket // bprod) * bprod

    def serve_fn(self, nq_pad: int, sigma: float, tier: str = "f32",
                 impl: Optional[str] = None, k: Optional[int] = None):
        """The cached serve step for one (bucket, σ, tier, impl, k,
        q_cap_factor, capacity, mesh) key. Returns (fn, cache_hit, resolved impl).

        An entry is only a closure from ``make_serve_step``, so a hit saves
        no work yet: the cache keeps the reference's keys, LRU bound and
        invalidation (``SearchStats.cache_hit``, the q_cap bump, shape-changing
        mutations) ready for entries captured as CUDA graphs. With
        ``impl="cuda"`` no tier's scan waits on the host: the quantized
        tiers' rerank is one kernel (``kernels.ops.rerank_topk_qbuf``); the
        plain rerank still finds its occupied slots with ``torch.nonzero``."""
        # normalize before keying: None, "auto" and the resolved backend share
        # one entry; so do tier aliases and k=None
        impl = self.resolve_impl(impl)
        tier = tiers.resolve(tier).name
        k = self.cfg.k if k is None else int(k)
        # capacity is the shape mutations move (and PQ's rerank clamp), so it
        # keys the cache; same-shape mutations keep hitting. A step is made
        # for one mesh's q_row and b_loc
        key = (nq_pad, float(sigma), tier, impl, k, float(self.cfg.q_cap_factor),
               int(self.cfg.capacity), self.mesh)
        fn = self._serve_cache.pop(key, None)
        cache_hit = fn is not None
        if fn is None:
            fn = make_serve_step(self.cfg, nq_pad, sigma=float(sigma), impl=impl, k=k,
                                 mesh=self.mesh, tier=tier)
        self._serve_cache[key] = fn  # re-insert: dict order doubles as LRU
        while len(self._serve_cache) > self._SERVE_CACHE_MAX:
            self._serve_cache.pop(next(iter(self._serve_cache)))
        return fn, cache_hit, impl

    def search(self, queries, sigma: Optional[float] = None, impl: Optional[str] = None,
               *, k: Optional[int] = None, tier: Optional[str] = None) -> api.SearchResult:
        """Serve one query batch: ``queries`` is an [nq, dim] array or a
        SearchRequest (then no other arguments are allowed). The tier takes
        them as f32, or as uint8 (the u8 tier, which refuses others), and
        they cross to the card so; ``lira_engine_query_bytes_total`` counts
        the bytes."""
        if isinstance(queries, api.SearchRequest):
            if any(a is not None for a in (sigma, impl, k, tier)):
                raise TypeError("pass either a SearchRequest or keyword overrides, not both")
            req = queries
        else:
            req = api.SearchRequest(queries=queries, k=k, sigma=sigma, tier=tier, impl=impl)
        tr = self._tracer()
        # tracing only reads clocks around the stages: the device call and the
        # synchronize that ends it run the same traced or not
        with tr.span("engine.search") as sp_root:
            with tr.span("engine.prepare") as sp_prep:
                tier_obj = tiers.resolve(req.tier if req.tier is not None else self.cfg.tier)
                q = tier_obj.queries(req.queries)   # f32, or uint8 for the u8 tier
                if q.ndim != 2 or q.shape[1] != self.cfg.dim:
                    raise ValueError(f"queries must be [nq, {self.cfg.dim}], got {q.shape}")
                missing = [f for f in tier_obj.store_specs(self.cfg) if f not in self.store]
                if missing:
                    raise ValueError(f"engine store lacks {missing} required by tier "
                                     f"{tier_obj.name!r}; build with tier={tier_obj.name!r}")
                tier_obj.check_servable(self.cfg)  # e.g. pq refuses residual codes
                sigma = self.sigma if req.sigma is None else req.sigma
                k = self.cfg.k if req.k is None else int(req.k)
                nq = q.shape[0]
                nq_pad = self._batch_bucket(nq)
                fn, cache_hit, impl = self.serve_fn(nq_pad, sigma, tier_obj.name, req.impl, k)
                qt = torch.as_tensor(q, device=self.device)
                qp = qt.new_zeros((nq_pad, self.cfg.dim))
                qp[:nq] = qt
                valid = torch.zeros((nq_pad,), dtype=torch.bool, device=self.device)
                valid[:nq] = True
            counts = {}
            with tr.span("engine.device", tier=tier_obj.name, impl=impl, bucket=nq_pad,
                         cache_hit=cache_hit) as sp_dev:
                d, i, npb, ovf, dups = fn(self.rank_operands(), qp, valid, tracer=tr,
                                          counts=counts)
                # the span ends when the ranks' devices have finished, not
                # when the launches were queued
                with tr.span("engine.sync"):
                    for dev in self.mesh.unique_devices():
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
            with tr.span("engine.post") as sp_post:
                npb_np = npb[:nq].cpu().numpy()
                # the step's scalars come back in one copy
                overflow, dedup_hits, pair_rows, written = torch.stack([
                    t.to(ovf.device) for t in (ovf, dups, counts["scan_pair_rows"],
                                               counts["pool_written"])]).tolist()
                dists = d[:nq].cpu().numpy()
                ids_np = i[:nq].cpu().numpy()
            sp_root.set(tier=tier_obj.name, impl=impl, rows=nq)

        stages = None
        if tr.enabled:
            stages = {"prepare": sp_prep.duration_ms, "device": sp_dev.duration_ms,
                      "post": sp_post.duration_ms}
        lbl = {"tier": tier_obj.name, "impl": impl}
        m = self._registry()
        m.counter("lira_engine_searches_total", "engine.search calls").inc(**lbl)
        m.counter("lira_engine_rows_total", "query rows served (pre-padding)").inc(nq, **lbl)
        m.counter("lira_engine_query_bytes_total",
                  "query bytes copied to the card (pre-padding)").inc(q.nbytes, **lbl)
        m.counter("lira_engine_probes_total",
                  "partition probes attempted (pre q_cap drops — includes any counted by "
                  "overflow_probes_total)").inc(float(npb_np.sum()), **lbl)
        m.counter("lira_engine_overflow_probes_total",
                  "probes dropped by q_cap bucket overflow").inc(overflow, **lbl)
        m.counter("lira_engine_dedup_hits_total",
                  "replica-duplicate candidate slots merged away").inc(dedup_hits, **lbl)
        m.counter("lira_engine_scan_pair_rows_total",
                  "live rows the scan reads: each probed partition's live rows, once a "
                  "dispatched query").inc(pair_rows, **lbl)
        pool = m.counter("lira_engine_merge_pool_entries_total",
                         "the merge pool's (distance, id) entries: allocated, and written "
                         "by the dispatched pairs' top-k")
        pool.inc(counts["pool_allocated"], kind="allocated", **lbl)
        pool.inc(written, kind="written", **lbl)
        m.counter("lira_engine_jit_cache_hits_total" if cache_hit
                  else "lira_engine_jit_cache_misses_total", "serve-step cache").inc(**lbl)
        m.histogram("lira_engine_nprobe_eff", "effective probes per query (σ-adaptive fan-out)",
                    buckets=obs_metrics.NPROBE_BUCKETS).observe_many(npb_np, **lbl)
        m.gauge("lira_engine_q_cap_factor", "current dispatch-slack factor").set(
            float(self.cfg.q_cap_factor))

        result = api.SearchResult(
            dists=dists, ids=ids_np, nprobe_eff=npb_np, overflow=overflow,
            stats=api.SearchStats(tier=tier_obj.name, impl=impl, k=k, sigma=float(sigma),
                                  bucket=nq_pad, cache_hit=cache_hit, dedup_hits=dedup_hits,
                                  latency_ms=sp_root.duration_ms, stages=stages,
                                  epoch=self.epoch))
        if self.cfg.auto_q_cap:
            self._maybe_bump_q_cap(overflow)
        return result

    def overflow_rate(self) -> float:
        """Cumulative q_cap overflow rate: dropped probes / attempted probes
        over every tier and impl this engine's registry has seen (0.0 before
        any search). ``lira_engine_probes_total`` counts attempted probes, so
        it is the denominator by itself."""
        m = self._registry()
        dropped = m.counter("lira_engine_overflow_probes_total").total()
        attempted = m.counter("lira_engine_probes_total").total()
        return dropped / attempted if attempted > 0 else 0.0

    def search_one(self, request: api.SearchRequest) -> api.SearchResult:
        """The single-query entry point. With a front-end attached
        (``attach_frontend``) the request joins its batching queue and its
        result is demanded at once (coalescing with whatever compatible
        traffic is waiting); without one it is a one-row ``search``.
        ``request.queries`` is one query, ``[dim]`` or ``[1, dim]``."""
        if not isinstance(request, api.SearchRequest):
            raise TypeError("search_one takes a SearchRequest; for raw query batches "
                            "use search()")
        q = np.asarray(request.queries)
        if q.ndim == 1:
            request = dataclasses.replace(request, queries=q[None, :])
        elif q.ndim != 2 or q.shape[0] != 1:
            raise ValueError(f"search_one serves exactly one query (got shape {q.shape}); "
                             "use search() for batches")
        if self.frontend is not None:
            return self.frontend.submit(request).result()
        return self.search(request)

    def attach_frontend(self, config=None, **kwargs) -> ServingFrontend:
        """Create, attach and return a ``ServingFrontend`` over this engine
        (serving/frontend.py); detach with ``engine.frontend = None``."""
        self.frontend = ServingFrontend(self, config, **kwargs)
        return self.frontend

    def _maybe_bump_q_cap(self, overflow: int) -> None:
        """After _AUTO_Q_CAP_AFTER consecutive overflowing calls, double
        q_cap_factor and drop the serve cache, so the next call dispatches
        into wider buckets; the bump is counted."""
        if overflow <= 0:
            self._overflow_streak = 0
            return
        self._overflow_streak += 1
        if self._overflow_streak >= self._AUTO_Q_CAP_AFTER:
            self.cfg = dataclasses.replace(self.cfg, q_cap_factor=self.cfg.q_cap_factor * 2.0)
            self._serve_cache.clear()
            self._overflow_streak = 0
            m = self._registry()
            m.counter("lira_engine_q_cap_bumps_total",
                      "auto_q_cap adaptations (doubled q_cap_factor, dropped serve "
                      "cache)").inc()
            m.gauge("lira_engine_q_cap_factor", "current dispatch-slack factor").set(
                float(self.cfg.q_cap_factor))

    # ------------------------------------------------------------ mutation

    def _staleness_counters(self) -> np.ndarray:
        if self._stale_inserts is None or len(self._stale_inserts) != self.cfg.n_partitions:
            self._stale_inserts = np.zeros(self.cfg.n_partitions, np.int64)
        return self._stale_inserts

    def _quiesce_frontend(self) -> None:
        """Serve the front-end's queued requests before a mutation, so every
        coalesced batch is served within one epoch."""
        if self.frontend is not None:
            self.frontend.quiesce()

    def _bump_epoch(self, *, shape_changed: bool = False) -> None:
        self.epoch += 1
        if shape_changed:
            self._serve_cache.clear()
        m = self._registry()
        m.counter("lira_engine_epoch_bumps_total",
                  "store mutations (insert/delete/compact/repartition)").inc()
        if shape_changed:
            m.counter("lira_engine_shape_epoch_bumps_total",
                      "shape-changing mutations (capacity moved; serve cache "
                      "dropped)").inc()
        m.gauge("lira_engine_epoch", "current store epoch").set(float(self.epoch))

    def _tombstones_per_partition(self) -> np.ndarray:
        """A tombstone is a cleared-occupancy slot still holding an id ≥ 0
        (delete leaves the id behind; reuse or compaction heals it)."""
        occ, ids = self.store["occupancy"], self.store["ids"]
        return (~occ & (ids >= 0)).sum(1).cpu().numpy().astype(np.int64)

    def _update_store_gauges(self) -> None:
        occ = self.store["occupancy"]
        live = int(occ.sum())
        tomb = int(self._tombstones_per_partition().sum())
        m = self._registry()
        m.gauge("lira_engine_live_slots", "occupied store slots").set(live)
        m.gauge("lira_engine_tombstone_slots",
                "deleted-but-uncompacted slots (insertable, id not yet healed)").set(tomb)
        m.gauge("lira_engine_free_slots", "never-written or compacted-away slots").set(
            occ.numel() - live - tomb)

    def insert(self, x, ids) -> int:
        """Add rows to the live index. Each row takes a free slot in the
        nearest partition that has one (within ``mutable.PLACE_WINDOW``
        nearest); rows that land off their argmin partition count toward the
        staleness that triggers ``maybe_repartition``. When a row finds no
        slot, every per-slot plane grows (by ``_GROW_SLACK``): a shape change
        that drops the serve cache; otherwise the rows are written into the
        store in place. New rows get no η replicas until the next
        repartition. Callers own id uniqueness (an id inserted twice becomes
        two live rows, merged at search time like a replica). Returns the rows
        inserted."""
        dev = self.device
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        if x.ndim == 1:
            x = x[None, :]
        ids = torch.as_tensor(ids, device=dev).reshape(-1).to(torch.int32)
        if x.shape[0] != ids.shape[0]:
            raise ValueError(f"{x.shape[0]} rows but {ids.shape[0]} ids")
        if x.shape[1] != self.cfg.dim:
            raise ValueError(f"rows have dim {x.shape[1]}, index has dim {self.cfg.dim}")
        n = x.shape[0]
        if n == 0:
            return 0
        self._quiesce_frontend()
        tier = tiers.resolve(self.cfg.tier)
        with self._tracer().span("engine.insert", rows=n) as sp:
            occ = self.store["occupancy"].cpu().numpy()
            cents = self.store["centroids"].float()
            # each row's distance to every centroid, on the device (the
            # reference does this host-side in f32: the two can part only at
            # near-ties)
            d2 = ((x * x).sum(1)[:, None] - 2.0 * x @ cents.T
                  + (cents * cents).sum(1)[None, :])
            plan = mutable.plan_insert(occ, d2)
            parts, slots, mis = plan.parts, plan.slots, plan.misassigned
            shape_changed = not bool(plan.ok.all())
            if shape_changed:
                # grow so every unplaced row fits in its argmin partition
                occ_w = occ.copy()
                occ_w[parts[plan.ok], slots[plan.ok]] = True
                fail = ~plan.ok
                d2_fail = d2[torch.as_tensor(fail, device=dev)]
                demand = occ_w.sum(1) + np.bincount(
                    torch.argmin(d2_fail, 1).cpu().numpy(), minlength=self.cfg.n_partitions)
                new_cap = max(int(demand.max()),
                              int(np.ceil(self.cfg.capacity * self._GROW_SLACK)))
                self.store = dict(self.store)
                self.store.update(mutable.grow_store(
                    {f: self.store[f] for f in tier.slot_fields(self.cfg)}, new_cap))
                self.cfg = dataclasses.replace(self.cfg, capacity=new_cap)
                occ_w = mutable.grow_store({"occupancy": occ_w}, new_cap)["occupancy"].numpy()
                replan = mutable.plan_insert(occ_w, d2_fail)
                if not bool(replan.ok.all()):
                    raise RuntimeError("the grown store does not fit every row")
                parts = np.where(plan.ok, parts, -1)
                slots = np.where(plan.ok, slots, -1)
                parts[fail], slots[fail] = replan.parts, replan.slots
                mis = mis.copy()
                mis[fail] = replan.misassigned
            p = torch.as_tensor(parts, device=dev)
            s = torch.as_tensor(slots, device=dev)
            # the tier encodes its content planes for the destination
            # partitions; ids and occupancy are the engine's bookkeeping
            for name, vals in tier.encode_rows(self.cfg, self.store, x, p).items():
                self.store[name][p, s] = vals.to(self.store[name].dtype)
            self.store["ids"][p, s] = ids
            self.store["occupancy"][p, s] = True
            np.add.at(self._staleness_counters(), parts[mis], 1)
            sp.set(misassigned=int(mis.sum()), grew=shape_changed)
        self._bump_epoch(shape_changed=shape_changed)
        m = self._registry()
        m.counter("lira_engine_inserts_total", "rows inserted").inc(n)
        m.counter("lira_engine_misassigned_inserts_total",
                  "inserts placed off their argmin partition (staleness source)").inc(
                      int(mis.sum()))
        if shape_changed:
            m.counter("lira_engine_capacity_grows_total", "insert-driven capacity growths").inc()
        self._update_store_gauges()
        return n

    def delete(self, ids) -> int:
        """Tombstone every live slot holding one of ``ids`` (replicas
        included), in place: occupancy clears, the id stays until the slot is
        reused or compacted. Returns the slots tombstoned (0 for unknown ids,
        with no epoch bump)."""
        ids = torch.unique(torch.as_tensor(ids, device=self.device).reshape(-1).long())
        occ = self.store["occupancy"]
        hit = occ & torch.isin(self.store["ids"].long(), ids)
        removed = int(hit.sum())
        m = self._registry()
        m.counter("lira_engine_deletes_total", "ids passed to delete").inc(len(ids))
        m.counter("lira_engine_deleted_slots_total",
                  "live slots tombstoned by delete").inc(removed)
        if not removed:
            return 0
        self._quiesce_frontend()
        with self._tracer().span("engine.delete", slots=removed):
            occ.masked_fill_(hit, False)
        self._bump_epoch()
        self._update_store_gauges()
        return removed

    def compact(self) -> int:
        """Repack live slots to the front of every partition and shrink the
        capacity to the largest live count (at least cfg.k: the scan's top-k
        needs that many slots): tombstones and holes erased, dead tails reset
        to pad sentinels. Usually a shape change (new planes, the serve cache
        dropped); at an unchanged capacity the planes are rewritten in place.
        Returns the slots reclaimed (Δcapacity · B)."""
        self._quiesce_frontend()
        tier = tiers.resolve(self.cfg.tier)
        with self._tracer().span("engine.compact", capacity=int(self.cfg.capacity)) as sp:
            packed, new_cap = mutable.compact_store(
                {f: self.store[f] for f in tier.slot_fields(self.cfg)},
                self.store["occupancy"], min_capacity=self.cfg.k)
            shape_changed = new_cap != self.cfg.capacity
            reclaimed = (self.cfg.capacity - new_cap) * self.cfg.n_partitions
            if shape_changed:
                self.store = {**self.store, **packed}
                self.cfg = dataclasses.replace(self.cfg, capacity=new_cap)
            else:
                for name, plane in packed.items():
                    self.store[name].copy_(plane)
            sp.set(new_capacity=new_cap, reclaimed=reclaimed)
        self._bump_epoch(shape_changed=shape_changed)
        m = self._registry()
        m.counter("lira_engine_compactions_total", "compaction passes").inc()
        m.counter("lira_engine_reclaimed_slots_total",
                  "slots reclaimed by compaction").inc(reclaimed)
        self._update_store_gauges()
        return reclaimed

    def staleness(self) -> float:
        """(misassigned inserts + tombstoned slots) / live rows: the drift
        ``maybe_repartition`` gates on (cfg.repartition_threshold)."""
        live = int(self.store["occupancy"].sum())
        tomb = int(self._tombstones_per_partition().sum())
        return (int(self._staleness_counters().sum()) + tomb) / max(1, live)

    def maybe_repartition(self, *, force: bool = False, max_moves: Optional[int] = None) -> bool:
        """IRLI-style re-assignment (arxiv 2103.09944), gated on staleness:
        when it reaches ``cfg.repartition_threshold`` (or ``force=True``),
        every live row moves to its argmin partition (``max_moves`` caps the
        pass to the most misassigned rows, by margin), is re-encoded through
        the tier, the η replica set is refreshed by
        ``core.redundancy.plan_redundancy`` at the engine's σ, and the slot
        layout is rebuilt, erasing tombstones and resetting staleness.
        Centroids, codebooks and the probing model stay. The rows are gathered
        and laid out on the store's device. Returns True iff a repartition
        ran."""
        occ = self.store["occupancy"]
        frac = ((self._staleness_counters() + self._tombstones_per_partition())
                / np.maximum(1, occ.sum(1).cpu().numpy()))
        self._registry().histogram(
            "lira_engine_partition_staleness",
            "per-partition staleness fraction at repartition checks",
            buckets=obs_metrics.STALENESS_BUCKETS).observe_many(frac)
        if not force and self.staleness() < self.cfg.repartition_threshold:
            return False
        self._repartition(max_moves=max_moves)
        return True

    _REPARTITION_ROWS = 1 << 16  # rows a block of the [rows, B] distance matrix

    def _repartition(self, max_moves: Optional[int] = None) -> None:
        self._quiesce_frontend()
        tier = tiers.resolve(self.cfg.tier)
        with self._tracer().span("engine.repartition") as sp:
            store = self.store
            nb, cap = store["occupancy"].shape
            pb, ps = torch.nonzero(store["occupancy"], as_tuple=True)
            if len(pb) == 0:
                return
            cents = store["centroids"].float()
            x = store["vectors"][pb, ps].float()
            rid = store["ids"][pb, ps]
            # one primary copy per id (η replicas are regenerated below): the
            # copy nearest its own partition's centroid
            order = _lexsort(((x - cents[pb]) ** 2).sum(1), rid)
            first = torch.ones(len(order), dtype=torch.bool, device=x.device)
            first[1:] = rid[order][1:] != rid[order][:-1]
            keep = order[first]
            xu, idu, cur = x[keep], rid[keep], pb[keep]
            del x
            c2 = (cents * cents).sum(1)[None, :]
            best = torch.empty_like(cur)
            margin = torch.empty(len(cur), dtype=torch.float32, device=cur.device)
            for r0 in range(0, len(xu), self._REPARTITION_ROWS):
                xb = xu[r0:r0 + self._REPARTITION_ROWS]
                d2 = (xb * xb).sum(1)[:, None] - 2.0 * xb @ cents.T + c2
                b = torch.argmin(d2, 1)
                best[r0:r0 + len(xb)] = b
                cb = cur[r0:r0 + len(xb), None]
                margin[r0:r0 + len(xb)] = (d2.gather(1, cb) - d2.gather(1, b[:, None]))[:, 0]
            assign, mis = best, best != cur
            if max_moves is not None and int(mis.sum()) > int(max_moves):
                # a partial pass: only the most misassigned rows move, ranked
                # by how much nearer their argmin centroid is
                cand = torch.nonzero(mis).flatten()
                top = cand[torch.sort(-margin[cand], stable=True).indices[:int(max_moves)]]
                assign = cur.clone()
                assign[top] = best[top]
            moved = int((assign != cur).sum())
            x_all, id_all, a_all = xu, idu, assign
            if self.cfg.eta > 0:
                # replica refresh: boundary points picked by the probing model
                # against the drifted assignment
                plan = plan_redundancy(self.model, xu, assign, cents, eta=self.cfg.eta,
                                       sigma=self.sigma)
                rv, ri, ra = replica_rows(plan, xu, idu.cpu().numpy())
                x_all = torch.cat([xu, rv])
                id_all = torch.cat([idu, torch.as_tensor(ri, device=idu.device)])
                a_all = torch.cat([assign, torch.as_tensor(ra, device=assign.device).long()])
            slots, counts = mutable.layout_rows(a_all, nb)
            needed = max(int(counts.max()), self.cfg.k)
            # the capacity grows only when the new layout needs it: a layout
            # that fits keeps the shape, and the planes are rewritten in place
            shape_changed = needed > cap
            if shape_changed:
                self.cfg = dataclasses.replace(self.cfg, capacity=needed)
                self.store = store = dict(store)
            # codebooks, centroids and the probing model are unchanged, so an
            # unmoved row keeps the codes it had
            rows = tier.encode_rows(self.cfg, store, x_all, a_all)
            rows["ids"] = id_all.to(torch.int32)
            for name in tier.slot_fields(self.cfg):
                old = store[name]
                if shape_changed:
                    plane = old.new_full((nb, needed, *old.shape[2:]),
                                         mutable.fill_value(name, old.dtype))
                    store[name] = plane
                else:
                    plane = old.fill_(mutable.fill_value(name, old.dtype))
                plane[a_all, slots] = True if name == "occupancy" else rows[name].to(plane.dtype)
            self._stale_inserts = np.zeros(nb, np.int64)
            sp.set(rows=len(xu), moved=moved, replicas=len(x_all) - len(xu),
                   capacity=self.cfg.capacity)
        self._bump_epoch(shape_changed=shape_changed)
        m = self._registry()
        m.counter("lira_engine_repartitions_total", "IRLI-style re-assignment passes").inc()
        m.counter("lira_engine_repartition_moved_rows_total",
                  "rows moved to their argmin partition").inc(moved)
        self._update_store_gauges()

    # ------------------------------------------------------------ persistence

    def save(self, directory, step: int = 0):
        """Write the probing parameters, the store and the config in the
        reference's layout (``ckpt/checkpoint.py``), which the JAX
        ``LiraEngine.load`` and this class's ``load`` both read. bfloat16
        planes are upcast to f32 on disk (npy has no bf16); the kernel
        backend is written as "auto" unless it is "ref" (neither package can
        resolve the other's). ``epoch`` and the staleness counters go with
        it. Returns the step directory."""
        params = probing.params_to_jax(self.model)
        leaves = []
        for name in _jax_leaf_names(self.cfg):
            if name[0] == "params":
                _, group, i, leaf = name
                leaves.append(params[group][i][leaf])
            else:
                plane = self.store[name[1]]
                if plane.dtype == torch.bfloat16:
                    plane = plane.float()
                leaves.append(plane.cpu().numpy())
        config = dataclasses.asdict(self.cfg)
        config["impl"] = "ref" if self.cfg.impl == "ref" else "auto"
        extra = {"config": config, "sigma": self.sigma, "epoch": int(self.epoch),
                 "stale_inserts": [int(v) for v in self._staleness_counters()]}
        return checkpoint.CheckpointManager(directory).save(
            step, leaves, extra=extra, treedef=str(_jax_leaf_names(self.cfg)))

    @classmethod
    def load(cls, directory, device=None, step: Optional[int] = None, *,
             mesh: Optional[Mesh] = None) -> "LiraEngine":
        """An engine from a ``save`` directory of either package: the config
        from the manifest's ``extra.config``, the probing parameters and the
        store fields its tier declares from the leaf files, each checked
        against the manifest, and the epoch and staleness counters. bfloat16
        stores are cast back. A saved kernel backend other than "ref" becomes
        "auto" (the kernels on the card, the plain versions on the CPU).
        ``mesh`` as in ``build``."""
        dev = resolve_device(device)
        step_dir, meta = checkpoint.read_manifest(directory, step)
        fields = {f.name for f in dataclasses.fields(LiraSystemConfig)}
        raw = {key: tuple(val) if isinstance(val, list) else val
               for key, val in meta["extra"]["config"].items() if key in fields}
        cfg = LiraSystemConfig(**{**raw, "impl": "ref" if raw.get("impl") == "ref" else "auto"})
        tier = tiers.resolve(cfg.tier)
        names = _jax_leaf_names(cfg)
        if meta["n_leaves"] != len(names):
            raise ValueError(f"checkpoint has {meta['n_leaves']} leaves; a {tier.name!r}-tier "
                             f"engine of this config has {len(names)}")
        leaves = dict(zip(names, checkpoint.load_leaves(step_dir, meta)))
        params: dict = {}
        for name, arr in leaves.items():
            if name[0] == "params":
                _, group, i, leaf = name
                layers = params.setdefault(group, [])
                if i == len(layers):
                    layers.append({})
                layers[i][leaf] = arr
        model = probing.params_from_jax(params, device=dev)
        store = {}
        for name, (shape, dtype) in tier.store_specs(cfg).items():
            arr = leaves[("store", name)]
            if tuple(arr.shape) != shape:
                raise ValueError(f"store/{name}: shape {arr.shape}, config wants {shape}")
            store[name] = torch.as_tensor(arr, device=dev).to(dtype)
        extra = meta["extra"]
        stale = extra.get("stale_inserts")
        return cls(cfg=cfg, model=model, store=store, device=dev,
                   sigma=float(extra.get("sigma", 0.5)), epoch=int(extra.get("epoch", 0)),
                   mesh=mesh,
                   _stale_inserts=None if stale is None else np.asarray(stale, np.int64))

    @classmethod
    def load_jax(cls, directory, device=None, step: Optional[int] = None, *,
                 mesh: Optional[Mesh] = None) -> "LiraEngine":
        """``load`` of a JAX ``LiraEngine.save`` directory, the saved kernel
        backend not carried over at all: the engine serves with the device's
        default (the kernels on the card)."""
        eng = cls.load(directory, device=device, step=step, mesh=mesh)
        eng.cfg = dataclasses.replace(eng.cfg, impl="auto")
        return eng
