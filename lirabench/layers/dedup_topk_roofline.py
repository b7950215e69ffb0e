"""dedup_topk_roofline: the replica-aware merge (``kernels.ops.dedup_topk``
→ ``csrc/dedup_topk.cu``) against the least time its work needs on the card.
The work is the pool it is handed: each (distance, id) of the [rows, pool]
candidates read once, and each row's top-k (distance, id) written once; its
comparisons are not counted, so the bound is by bytes. The time is every
device event whose name starts ``dedup_topk``."""
from lirabench import common

NAME = "dedup_topk"


def work(rows: int, pool: int, k: int):
    return rows * pool * 8 + rows * k * 8, 0


def hook(cache, dists, ids, k, **_):
    return {"rows": dists.shape[0], "pool": dists.shape[1], "k": int(k)}


def install(hooks):
    hooks.wrap(NAME, hook)


def read(r):
    return common.kernel_share(r, NAME, work)
