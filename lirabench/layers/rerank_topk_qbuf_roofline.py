"""rerank_topk_qbuf_roofline: the quantized tiers' exact rerank of the ADC
shortlist (``kernels.ops.rerank_topk_qbuf`` → ``csrc/rerank_topk_qbuf.cu``)
against the least time its work needs on the card. The work is counted from
the problem: stage 1 shortlists, for each dispatched pair, the min(rk, live)
nearest live rows of its partition, so each partition the batch probes has
at least that many distinct rows to read once (its row of d values in the
store dtype and its 4-byte id); each dispatched pair reads its shortlist of
rk slot indices and its query row (d f32) and writes its top-k (distance,
id), once; and each shortlisted row of each pair costs 2·d operations, at
the f32 rate. The time is every device event whose name has a word starting
``rerank_topk_qbuf``. On a program without the op it reads nothing.

The partition's count is a lower bound of the rows its pairs' shortlists
name together: the exact union needs the occupied pairs listed
(``torch.nonzero``), which would make the host wait inside the serve step
and, at lira-ann-q's batch, add more device time under ``lira.scan`` than
half the kernel's own. This count reads ``qbuf`` only, without a wait."""
from lirabench import common

NAME = "rerank_topk_qbuf"


def work(occ, per, d: int, itemsize: int, rk: int, k: int):
    """(bytes, operations) of one call: ``occ`` [B] dispatched pairs and
    ``per`` [B] rows each pair's shortlist names, per partition."""
    nbytes = ((per * (occ > 0)).sum() * (d * itemsize + 4)
              + occ.sum() * (rk * 4 + d * 4 + k * 8))
    return nbytes, (occ * per).sum() * 2 * d


def hook(cache, q_pad, qbuf, vecs, ids, shortlist, k, **_):
    rk = shortlist.shape[2]
    return {"occ": (qbuf < q_pad.shape[0] - 1).sum(1).double(),
            "per": common.live_rows(cache, ids).clamp(max=rk), "d": vecs.shape[2],
            "itemsize": vecs.element_size(), "rk": rk, "k": int(k)}


def install(hooks):
    from repro_torch.kernels import ops

    if hasattr(ops, NAME):
        hooks.wrap(NAME, hook)


def read(r):
    return common.kernel_share(r, NAME, work)
