"""LIRA serving engine on one device (counterpart of
``repro/serving/engine.py``; the model-axis collectives are not ported yet).

serve step:
  1. probing: query→centroid distances, the probing MLP, σ-masked
     top-``nprobe_max`` partitions (query-adaptive nprobe, paper §3.4);
  2. dispatch: a sort-based scatter of (query, partition) probes into the
     ``qbuf [B, q_cap]`` buffer; probes beyond a partition's q_cap are counted
     as overflow, batch-padding rows never probe;
  3. scan (serving/scan.py): ``kernels.l2_topk_qbuf`` per partition for the
     f32 tier; for the quantized tiers an ADC shortlist through
     ``kernels.pq_adc_topk_qbuf``, then an exact f32 rerank;
  4. merge: scatter back per query, then the replica-aware
     ``kernels.dedup_topk`` over each query's [B·k] pool.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint
from repro_torch.configs.base import LiraSystemConfig
from repro_torch.core import ground_truth as gt
from repro_torch.core import probing
from repro_torch.core.kmeans import kmeans_fit
from repro_torch.core.partitions import build_store
from repro_torch.core.redundancy import plan_redundancy, replica_rows
from repro_torch.core.train_probing import train_probing_model
from repro_torch.kernels import ops as kops
from repro_torch.serving import api, scan, tiers
from repro_torch.utils.device import resolve_device

# the dispatch sentinel query row: its ||q||² ≈ d·1e18 stays finite in f32,
# and 1e9 stays finite when cast to a bfloat16 store
_SENTINEL = 1e9


def _dup_count(ids_pool: torch.Tensor) -> torch.Tensor:
    """Duplicate id slots per candidate pool row ([nq, pool]): valid slots
    (id ≥ 0) minus distinct ids, summed over queries — the replica-dedup hit
    count the merge collapses."""
    s = torch.sort(ids_pool, dim=1).values
    valid = s >= 0
    first = torch.ones_like(valid)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    return (valid.sum(1) - (valid & first).sum(1)).sum()


def make_serve_step(cfg: LiraSystemConfig, n_queries: int, *, sigma: float, impl: str,
                    k: int, tier=None):
    """The serve step for one batch size, tier (default ``cfg.tier``) and
    kernel backend (``"ref"`` or ``"cuda"``). Returns ``serve_step(model,
    store, queries [n, d], valid [n] bool) → (dists [n, k], ids [n, k],
    nprobe_eff [n] f32, overflow [], dedup_hits [])``, all tensors on the
    store's device."""
    q_row = n_queries
    b_loc = cfg.n_partitions
    q_cap = max(8, int(q_row * cfg.nprobe_max / cfg.n_partitions * cfg.q_cap_factor))
    tier = tiers.resolve(tier if tier is not None else cfg.tier)
    # the tier's fields beyond the probing/dispatch/rerank operands go back
    # to the tier, which assembles the scan's extra operands from them
    extra_fields = tuple(n for n in tier.store_specs(cfg) if n not in tiers.BASE_FIELDS)

    @torch.no_grad()
    def serve_step(model, store, queries, valid):
        dev = queries.device
        # tombstoned/free slots never surface ids: occupancy folds into the id
        # plane, which the scan masks as id < 0
        ids_loc = torch.where(store["occupancy"], store["ids"], -1)

        # ---- probing
        q = queries
        cents = store["centroids"]
        cd = ((q * q).sum(-1, keepdim=True)
              - 2.0 * q @ cents.T
              + (cents * cents).sum(-1)[None, :])
        p = torch.sigmoid(model(q, cd))                              # [q_row, B]
        # jax.lax.top_k breaks ties by the lowest index and sigmoid saturates
        # to exactly 1.0 in f32, so ties are real: a stable descending sort
        # keeps the reference's choice of partitions at the cutoff
        vals, pidx = torch.sort(p, dim=-1, descending=True, stable=True)
        vals, pidx = vals[:, :cfg.nprobe_max], pidx[:, :cfg.nprobe_max]
        probe_ok = vals > sigma
        probe_ok[:, 0] = True                                        # always ≥1 partition
        probe_ok &= valid[:, None]                                   # padding rows never probe

        # ---- dispatch (sort-based)
        flat_p = pidx.reshape(-1)
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
        qbuf = qbuf[:b_loc]                                          # q_row = empty slot

        # ---- per-partition scan
        q_pad = torch.cat([q, torch.full((1, q.shape[1]), _SENTINEL, dtype=q.dtype,
                                         device=dev)])
        ctx = tiers.ScanContext(q_loc=q, q_pad=q_pad, cd=cd, b_loc=b_loc, k=k)
        scan_kw = tier.scan_kwargs(cfg, ctx, {n: store[n] for n in extra_fields})
        dists, rids = scan.run(impl, qbuf, q_pad, store["vectors"], ids_loc, k, **scan_kw)

        # ---- scatter back per query (row q_row takes the empty slots), merge
        out_d = torch.full((q_row + 1, b_loc, k), torch.inf, dtype=torch.float32, device=dev)
        out_i = torch.full((q_row + 1, b_loc, k), -1, dtype=torch.int32, device=dev)
        cols = torch.arange(b_loc, device=dev)[:, None].expand_as(qbuf)
        qb = qbuf.long()
        out_d[qb, cols] = dists
        out_i[qb, cols] = rids
        pool_d = out_d[:q_row].reshape(q_row, -1)
        pool_i = out_i[:q_row].reshape(q_row, -1)
        dedup_hits = _dup_count(pool_i)
        loc_d, loc_i = kops.dedup_topk(pool_d, pool_i, k, impl=impl)
        return loc_d, loc_i, probe_ok.sum(-1).float(), overflow, dedup_hits

    return serve_step


def _jax_leaf_names(cfg: LiraSystemConfig) -> list:
    """Leaf paths of a JAX ``LiraEngine.save`` tree, in ``jax.tree.flatten``
    order (dict keys sorted, lists in order); the store's fields are those
    the config's tier declares."""
    n_layers = {"phi_i": len(cfg.i_hidden), "phi_p": len(cfg.p_hidden) + 1,
                "phi_q": len(cfg.q_hidden)}
    names = [("params", g, i, leaf) for g in sorted(n_layers)
             for i in range(n_layers[g]) for leaf in ("b", "w")]
    return names + [("store", f) for f in sorted(tiers.resolve(cfg.tier).store_specs(cfg))]


@dataclasses.dataclass
class LiraEngine:
    """Build (k-means → probing model → redundancy → store) then serve query
    batches through the serve step, on one device.

    Batches are padded to power-of-two buckets; the pad rows are masked out
    of dispatch. With ``cfg.auto_q_cap`` the engine doubles ``q_cap_factor``
    after ``_AUTO_Q_CAP_AFTER`` consecutive overflowing calls. (PyTorch runs
    eagerly, so there is no compiled serve step to cache; a CUDA-graph cache
    keyed like the reference's jit cache is later work.)
    """

    cfg: LiraSystemConfig
    model: probing.ProbingModel
    store: dict
    device: torch.device
    sigma: float = 0.5
    _overflow_streak: int = dataclasses.field(default=0, repr=False)

    _AUTO_Q_CAP_AFTER = 2

    @classmethod
    def build(cls, x, config: api.BuildConfig, *, device=None) -> "LiraEngine":
        """Build an index over ``x`` [N, d] (array or tensor) on ``device``
        (default the card; raises when there is none)."""
        dev = resolve_device(device)
        tier = tiers.resolve(config.tier)
        gen = torch.Generator(device=dev)
        gen.manual_seed(config.seed)
        host = np.random.default_rng(config.seed)
        n_partitions = config.n_partitions
        xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
        n = xt.shape[0]
        st = kmeans_fit(xt, n_partitions, n_iters=20, generator=gen)
        assign, cents = st.assign, st.centroids

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

        ids = np.arange(n, dtype=np.int32)
        plan = plan_redundancy(model, xt, assign, cents, eta=config.eta)
        extra = replica_rows(plan, xt, ids)
        store_h = build_store(xt, ids, assign, cents, extra=extra)
        cfg = LiraSystemConfig(
            arch="lira", dim=xt.shape[1], n_partitions=n_partitions,
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
        return cls(cfg=cfg, model=model, store=store, device=dev, sigma=config.sigma)

    @classmethod
    def load_jax(cls, directory, device=None, step: Optional[int] = None) -> "LiraEngine":
        """An engine from a JAX ``LiraEngine.save`` directory: the config from
        the manifest's ``extra.config``, the probing parameters and the store
        fields its tier declares (PQ codes, codebooks and cross terms
        included) from the leaf files, each leaf checked against the
        manifest. bfloat16 stores were saved upcast to f32 and are cast back.
        The saved kernel backend is not carried over: the engine serves with
        the device's default (the kernels on the card)."""
        dev = resolve_device(device)
        step_dir, meta = checkpoint.read_manifest(directory, step)
        fields = {f.name for f in dataclasses.fields(LiraSystemConfig)}
        raw = {key: tuple(val) if isinstance(val, list) else val
               for key, val in meta["extra"]["config"].items() if key in fields}
        # the saved kernel backend was the reference's choice (ref, pallas,
        # interpret); here only the caller's impl= picks the plain version
        cfg = LiraSystemConfig(**{**raw, "impl": "auto"})
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
        return cls(cfg=cfg, model=model, store=store, device=dev,
                   sigma=float(meta["extra"].get("sigma", 0.5)))

    def _batch_bucket(self, nq: int) -> int:
        """Power-of-two batch buckets (≥8), as the reference pads: q_cap is
        derived from the bucket, so the same bucket dispatches the same way."""
        return max(8, 1 << max(0, nq - 1).bit_length())

    def search(self, queries, sigma: Optional[float] = None, impl: Optional[str] = None,
               *, k: Optional[int] = None, tier: Optional[str] = None) -> api.SearchResult:
        """Serve one query batch: ``queries`` is an [nq, dim] array or a
        SearchRequest (then no other arguments are allowed)."""
        if isinstance(queries, api.SearchRequest):
            if any(a is not None for a in (sigma, impl, k, tier)):
                raise TypeError("pass either a SearchRequest or keyword overrides, not both")
            req = queries
        else:
            req = api.SearchRequest(queries=queries, k=k, sigma=sigma, tier=tier, impl=impl)
        q = np.asarray(req.queries, np.float32)
        if q.ndim != 2 or q.shape[1] != self.cfg.dim:
            raise ValueError(f"queries must be [nq, {self.cfg.dim}], got {q.shape}")
        tier_obj = tiers.resolve(req.tier if req.tier is not None else self.cfg.tier)
        missing = [f for f in tier_obj.store_specs(self.cfg) if f not in self.store]
        if missing:
            raise ValueError(f"engine store lacks {missing} required by tier "
                             f"{tier_obj.name!r}; build with tier={tier_obj.name!r}")
        tier_obj.check_servable(self.cfg)  # e.g. pq refuses residual codes
        sigma = self.sigma if req.sigma is None else req.sigma
        k = self.cfg.k if req.k is None else int(req.k)
        nq = q.shape[0]
        nq_pad = self._batch_bucket(nq)
        impl = kops.resolve_impl(req.impl if req.impl is not None else self.cfg.impl,
                                 self.device)
        fn = make_serve_step(self.cfg, nq_pad, sigma=float(sigma), impl=impl, k=k,
                             tier=tier_obj)
        qp = torch.zeros((nq_pad, self.cfg.dim), dtype=torch.float32, device=self.device)
        qp[:nq] = torch.as_tensor(q, device=self.device)
        valid = torch.zeros((nq_pad,), dtype=torch.bool, device=self.device)
        valid[:nq] = True
        d, i, npb, ovf, dups = fn(self.model, self.store, qp, valid)
        overflow = int(ovf)
        result = api.SearchResult(
            dists=d[:nq].cpu().numpy(), ids=i[:nq].cpu().numpy(),
            nprobe_eff=npb[:nq].cpu().numpy(), overflow=overflow,
            stats=api.SearchStats(tier=tier_obj.name, impl=impl, k=k, sigma=float(sigma),
                                  bucket=nq_pad, dedup_hits=int(dups)))
        if self.cfg.auto_q_cap:
            self._maybe_bump_q_cap(overflow)
        return result

    def _maybe_bump_q_cap(self, overflow: int) -> None:
        """After _AUTO_Q_CAP_AFTER consecutive overflowing calls, double
        q_cap_factor, so the next call dispatches into wider buckets."""
        if overflow <= 0:
            self._overflow_streak = 0
            return
        self._overflow_streak += 1
        if self._overflow_streak >= self._AUTO_Q_CAP_AFTER:
            self.cfg = dataclasses.replace(self.cfg, q_cap_factor=self.cfg.q_cap_factor * 2.0)
            self._overflow_streak = 0
