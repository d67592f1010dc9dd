"""Published peaks of the cards the benchmark knows (dense rates, no
sparsity, at the full power limit): NVIDIA's H100 SXM data sheet."""

PEAKS = {
    'H100': dict(fp32_flops=67e12, hbm_bytes_per_s=3.35e12),
}


def of(kind):
    """The peaks of a card by its ``torch.cuda.get_device_name()``, or
    ``None`` for a card not in the table."""
    for key, peaks in PEAKS.items():
        if key in (kind or ''):
            return peaks
    return None
