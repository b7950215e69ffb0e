"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity), which assume the card's full 700 W power limit. A run
prints the card's own limit beside every number it reports."""

HBM_BYTES_PER_S = 3.35e12        # 80 GB of HBM3
FP32_FLOPS = 67e12               # float32 outside the tensor cores


def roofline_share(nbytes: float, flops: float, seconds: float) -> float | None:
    """The least time the work could take on the card (the larger of its
    bytes at the HBM rate and its operations at the f32 rate) as a
    percentage of ``seconds``; None when there is no time or no work."""
    if not seconds > 0 or not (nbytes > 0 or flops > 0):
        return None
    return 100.0 * max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) / seconds
