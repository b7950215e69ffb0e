"""l2_topk_qbuf_roofline: the f32 tier's fused L2 scan + top-k
(``kernels.ops.l2_topk_qbuf`` → ``csrc/l2_topk_qbuf.cu``) against the least
time its work needs on the card. The work is counted from the problem, not
from the kernel's operands: each live row of each partition the batch
probes, read once (its vector and its id); each query row, read once; the
top-k (distance and id) of each dispatched (query, partition) pair, written
once; and 2·d operations for each dispatched pair and each live row of its
partition, at the f32 rate outside the tensor cores. The time is every device
event whose name starts ``l2_topk_qbuf`` (the kernel, its count and its plan)."""
from lirabench import common

NAME = "l2_topk_qbuf"


def work(occ, live, d: int, itemsize: int, k: int, rows: int):
    """(bytes, operations) of one call: ``occ`` [B] dispatched queries and
    ``live`` [B] live rows per partition."""
    used = occ > 0
    nbytes = (live[used] * (d * itemsize + 4)).sum() + rows * d * itemsize + occ.sum() * k * 8
    return nbytes, (occ * live).sum() * 2 * d


def hook(cache, q_pad, qbuf, cands, cand_ids, k, **_):
    return {"occ": (qbuf < q_pad.shape[0] - 1).sum(1).double(),
            "live": common.live_rows(cache, cand_ids), "d": cands.shape[2],
            "itemsize": cands.element_size(), "k": int(k), "rows": q_pad.shape[0] - 1}


def install(hooks):
    hooks.wrap(NAME, hook)


def read(r):
    return common.kernel_share(r, NAME, work)
