"""l2u8_topk_qbuf_roofline: the u8 tier's exact integer L2 scan + top-k
(``kernels.ops.l2u8_topk_qbuf`` → ``csrc/l2u8_topk_qbuf.cu``) against the
least time its work needs on the card. The work is counted from the
problem, not from the kernel's operands: each live row of each partition the
batch probes, read once (its d bytes and its 4-byte ||x||²); each query row,
read once (d bytes); the top-k (distance and id) of each dispatched (query,
partition) pair, written once; and 2·d integer operations for each
dispatched pair and each live row of its partition. The peak is the card's
fastest path for this work, whatever the kernel uses: the data sheet's dense
INT8 tensor-core rate and the HBM rate. The time is every device event
whose name has a word starting ``l2u8_topk_qbuf`` (the kernel, its count and
its plan). On a program without the op it reads nothing."""
from lirabench import common, peaks

NAME = "l2u8_topk_qbuf"
INT8_OPS_PER_S = 1979e12         # H100 SXM, dense INT8 on the tensor cores


def work(occ, live, d: int, k: int, rows: int):
    """(bytes, operations) of one call: ``occ`` [B] dispatched queries and
    ``live`` [B] live rows per partition."""
    used = occ > 0
    nbytes = (live[used] * (d + 4)).sum() + rows * d + occ.sum() * k * 8
    return nbytes, (occ * live).sum() * 2 * d


def hook(cache, q_pad, qbuf, cands, sqnorm, cand_ids, k, **_):
    return {"occ": (qbuf < q_pad.shape[0] - 1).sum(1).double(),
            "live": common.live_rows(cache, cand_ids), "d": cands.shape[2], "k": int(k),
            "rows": q_pad.shape[0] - 1}


def install(hooks):
    from repro_torch.kernels import ops

    if hasattr(ops, NAME):
        hooks.wrap(NAME, hook)


def read(r):
    if r.reduced is None or r.hooks is None:
        return None
    calls = r.hooks.calls.get(NAME, [])
    ms = r.reduced.kernel_ms(NAME)
    if not calls or not ms > 0:
        return None
    nbytes = ops = 0.0
    for call in calls:
        b, o = work(**call)
        nbytes += float(b)
        ops += float(o)
    return 100.0 * max(nbytes / peaks.HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) / (ms / 1e3)
