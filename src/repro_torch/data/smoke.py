"""Random batches for the smoke tests, one generator per step kind
(counterpart of ``repro/data/smoke.py``): the same numpy draws from the same
seed (``default_rng(seed)``), so the JAX package and the port get equal
inputs. The graph and recsys kinds are not ported yet."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import LiraSystemConfig, LMConfig


def make_smoke_inputs(config, shape, mesh, seed: int = 0) -> dict:
    """Keyword arguments for ``StepDef.fn``'s data arguments, as torch
    tensors on the mesh's first device."""
    host = np.random.default_rng(seed)
    dev = mesh.devices[0]

    def put(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    if isinstance(config, LMConfig):
        gb, s = shape["global_batch"], shape["seq_len"]
        if shape.kind == "train":
            toks = host.integers(1, config.vocab, (gb, s + 1)).astype(np.int32)
            return {"batch": {"tokens": put(toks[:, :-1]), "labels": put(toks[:, 1:])}}
        if shape.kind == "prefill":
            return {"tokens": put(host.integers(1, config.vocab, (gb, s)).astype(np.int32))}
        if shape.kind == "decode":
            dt = getattr(torch, config.dtype)
            cshape = (config.n_layers, gb, s, config.n_kv_heads, config.head_dim)
            cache = {"k": put(host.normal(0, 1, cshape).astype(np.float32), dt),
                     "v": put(host.normal(0, 1, cshape).astype(np.float32), dt)}
            return {"cache": cache,
                    "tokens": put(host.integers(1, config.vocab, (gb, 1)).astype(np.int32)),
                    "pos": torch.tensor(s // 2, dtype=torch.int32, device=dev)}

    if isinstance(config, LiraSystemConfig):
        if shape.kind == "lira_serve":
            # the serving tier declares which store planes exist (and their
            # dtypes): iterate its specs, in its order, as the reference does
            from repro_torch.serving import tiers

            nq = shape["n_queries"]
            specs = tiers.resolve(config.tier).store_specs(config)
            vecs = host.normal(0, 1, (config.n_partitions, config.capacity, config.dim)).astype(np.float32)
            ids = np.arange(config.n_partitions * config.capacity, dtype=np.int32).reshape(
                config.n_partitions, config.capacity)
            ids[:, -max(1, config.capacity // 8):] = -1          # padding tail rows
            store = {"centroids": put(vecs.mean(1)),
                     "vectors": put(vecs, specs["vectors"][1]),
                     "ids": put(ids)}
            for name, (sshape, dtype) in specs.items():
                if name in store:
                    continue
                if name == "occupancy":                          # live = non-padding ids
                    store[name] = put(ids >= 0)
                elif name == "codes":                            # bounded by pq_ks
                    store[name] = put(host.integers(0, config.pq_ks, sshape), dtype)
                elif not dtype.is_floating_point:
                    store[name] = torch.zeros(sshape, dtype=dtype, device=dev)
                else:
                    store[name] = put(host.normal(0, 1, sshape).astype(np.float32), dtype)
            return {"store": store,
                    "queries": put(host.normal(0, 1, (nq, config.dim)).astype(np.float32))}
        if shape.kind == "lira_train":
            b = shape["batch"]
            return {"batch": {
                "q": put(host.normal(0, 1, (b, config.dim)).astype(np.float32)),
                "cent_dist": put(host.uniform(1, 10, (b, config.n_partitions)).astype(np.float32)),
                "labels": put((host.uniform(size=(b, config.n_partitions)) < 0.1).astype(np.float32)),
            }}
    raise ValueError((type(config), shape.kind))
