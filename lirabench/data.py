"""The benchmark's vectors: a frozen copy of the SIFT-like mixture that
``repro_torch.data.synthetic.make_vector_dataset`` draws, rewritten in torch
so that millions of rows are drawn on the device in a few large calls.

The mixture (mode centres, per-mode anisotropic scales, Pareto weights, the
five nearest modes of each) is drawn on the host from the configuration's
``mixture_seed``. The base is the deployment's data set, drawn from the
configuration's ``data_seed``, so every run indexes the same rows and builds
the same index. The query pool is the deployment's query set, drawn from its
``query_seed``: every run draws its traffic from the same queries, in an
order (and, for a skewed mix, a choice) that the run's ``--seed`` decides.
Both on the run's device, in the shuffled order of these parts:
  * core points: a mode by weight, its centre plus Gaussian noise scaled by
    the mode's per-dimension scales;
  * boundary points (``boundary_frac``): on the segment between a mode and
    one of its five nearest modes, at a Beta(2, 2) position, with noise at
    half the two modes' mean scale;
  * a uniform background (``noise_frac``) over the centres' range.
The queries come from the same process as the base and are held out from it.

``dtype`` (optional, ``"float32"`` where absent) is the element type the
deployment hands the engine. ``"uint8"`` and ``"int8"`` map the f32 draw
above linearly onto [0, 255] or [-128, 127], rounded and clamped, as a
BIGANN or SPACEV user's vectors are bytes. The mapping comes from the
mixture alone, so the base and the queries share it: the span from the
lowest to the highest of every mode's centre less and plus three of its
scales, over all modes and dimensions, goes onto the type's 256 values. The reference and
the judge read such rows in f32 (``reference.as_f32``, which bounds the
width at which that is exact).

The same seed on the same device and torch build gives the same bytes.
"""
from __future__ import annotations

import numpy as np
import torch

INT_RANGE = {"uint8": (0, 255), "int8": (-128, 127)}


def _gamma2(shape, generator, device):
    """Gamma(2, 1) draws: the sum of two unit exponentials."""
    u = torch.rand((2, *shape), generator=generator, device=device)
    return -torch.log1p(-u).sum(0)


def mixture(spec: dict) -> dict:
    """The mixture's parameters, on the host, from ``spec['mixture_seed']``."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(spec["mixture_seed"]))
    n_modes, dim = int(spec["n_modes"]), int(spec["dim"])
    centers = torch.randn((n_modes, dim), generator=g) * float(spec["center_scale"])
    # numpy's gamma(2.0, 0.25): 0.25 times a Gamma(2, 1) draw
    scales = (0.3 + 0.25 * _gamma2((n_modes, dim), g, "cpu")) * float(spec["spread"])
    # numpy's pareto(1.5) is the Lomax law: U^(-1/a) - 1
    u = torch.rand(n_modes, generator=g, dtype=torch.float64)
    weights = (1.0 - u) ** (-1.0 / 1.5) - 1.0 + 0.05
    weights = weights / weights.sum()
    c2 = torch.cdist(centers.double(), centers.double()) ** 2
    c2.fill_diagonal_(float("inf"))
    near5 = torch.argsort(c2, dim=1)[:, :5]
    return {"centers": centers, "scales": scales, "weights": weights, "near5": near5}


def _draw(spec: dict, mix: dict, total: int, g, device) -> torch.Tensor:
    """``total`` rows of the mixture in the shuffled order."""
    centers, scales, near5 = mix["centers"], mix["scales"], mix["near5"]
    weights = mix["weights"].float()
    dim = centers.shape[1]
    n_bound = int(total * float(spec["boundary_frac"]))
    n_noise = int(total * float(spec["noise_frac"]))
    n_core = total - n_bound - n_noise
    x = torch.empty((total, dim), dtype=torch.float32, device=device)

    modes = torch.multinomial(weights, n_core, replacement=True, generator=g)
    x[:n_core] = torch.randn((n_core, dim), generator=g, device=device)
    x[:n_core].mul_(scales[modes]).add_(centers[modes])
    del modes

    a = torch.multinomial(weights, n_bound, replacement=True, generator=g)
    pick = torch.randint(0, 5, (n_bound,), generator=g, device=device)
    b = near5[a, pick]
    ga, gb = _gamma2((n_bound,), g, device), _gamma2((n_bound,), g, device)
    t = (ga / (ga + gb))[:, None]
    bound = x[n_core:n_core + n_bound]
    bound.copy_(torch.randn((n_bound, dim), generator=g, device=device))
    bound.mul_(0.25 * (scales[a] + scales[b]))
    bound.add_(centers[a] * (1 - t) + centers[b] * t)
    del a, b, t, pick

    lo, hi = float(centers.min()), float(centers.max())
    x[n_core + n_bound:] = lo + (hi - lo) * torch.rand((n_noise, dim), generator=g, device=device)
    return x[torch.randperm(total, generator=g, device=device)]


def int_mapping(spec: dict, mix: dict):
    """(dtype, scale, offset, lo, hi) that take the f32 draw to the spec's
    integer ``dtype`` as ``clamp(round(x * scale + offset), lo, hi)``, or
    None for float32. ``mix`` is ``mixture(spec)``."""
    name = spec.get("dtype", "float32")
    if name == "float32":
        return None
    if name not in INT_RANGE:
        raise ValueError(f"dtype {name!r}: float32, uint8 or int8")
    lo, hi = INT_RANGE[name]
    reach = 3.0 * mix["scales"]
    x_lo = float((mix["centers"] - reach).min())
    x_hi = float((mix["centers"] + reach).max())
    scale = (hi - lo) / (x_hi - x_lo)
    return getattr(torch, name), scale, lo - x_lo * scale, lo, hi


def make_vectors(spec: dict, n: int, n_queries: int, device) -> tuple:
    """(base [n, dim], queries [n_queries, dim]) on ``device`` in the spec's
    ``dtype``: the base from ``spec['data_seed']``, the queries from
    ``spec['query_seed']``."""
    device = torch.device(device)
    mix = mixture(spec)
    to_int = int_mapping(spec, mix)
    mix = {k: v.to(device) for k, v in mix.items()}
    out = []
    for count, s, part in ((n, spec["data_seed"], 0), (n_queries, spec["query_seed"], 1)):
        g = torch.Generator(device=device)
        g.manual_seed(int(np.random.SeedSequence([int(s), part]).generate_state(1, np.uint64)[0]))
        x = _draw(spec, mix, count, g, device)
        if to_int is not None:
            dtype, scale, offset, lo, hi = to_int
            x = x.mul_(scale).add_(offset).round_().clamp_(lo, hi).to(dtype)
        out.append(x)
    return out[0], out[1]
