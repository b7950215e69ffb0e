"""pq_adc_topk_qbuf_roofline: the quantized tiers' ADC shortlist
(``kernels.ops.pq_adc_topk_qbuf`` → ``csrc/pq_adc_topk_qbuf.cu``) against the
least time its work needs on the card. The work is counted from the problem:
each live row of each partition the batch probes, read once (its m codes,
its slot id and, for residual codes, its cross term); each query's LUT
[m, ks] f32, read once; each dispatched pair's residual offset, read once,
and its shortlist of ``rk`` (distance, slot), written once; and, for each
dispatched pair and each live row of its partition, m − 1 additions plus
one for each offset, at the f32 rate. The time is every device event whose
name starts ``pq_adc_topk_qbuf``."""
from lirabench import common

NAME = "pq_adc_topk_qbuf"


def work(occ, live, m: int, ks: int, itemsize: int, k: int, rows: int, cand_off: bool,
         q_off: bool):
    """(bytes, operations) of one call: ``occ`` [B] dispatched queries and
    ``live`` [B] live rows per partition; ``k`` is the shortlist's depth."""
    used = occ > 0
    per_row = m * itemsize + 4 + 4 * cand_off
    nbytes = ((live[used] * per_row).sum() + rows * m * ks * 4
              + occ.sum() * (4 * q_off + k * 8))
    return nbytes, (occ * live).sum() * (m - 1 + cand_off + q_off)


def hook(cache, lut_pad, qbuf, codes, cand_ids, k, *, cand_off=None, q_off=None, **_):
    return {"occ": (qbuf < lut_pad.shape[0] - 1).sum(1).double(),
            "live": common.live_rows(cache, cand_ids), "m": codes.shape[2],
            "ks": lut_pad.shape[2], "itemsize": codes.element_size(), "k": int(k),
            "rows": lut_pad.shape[0] - 1, "cand_off": cand_off is not None,
            "q_off": q_off is not None}


def install(hooks):
    hooks.wrap(NAME, hook)


def read(r):
    return common.kernel_share(r, NAME, work)
