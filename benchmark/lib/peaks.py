"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates, at the full 700 W power limit), keyed by the start
of ``torch.cuda.get_device_name()``."""

PEAKS = {
    "NVIDIA H100": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(kind: str):
    """The peaks of the card named ``kind``, or None for a card not listed."""
    for prefix, peaks in PEAKS.items():
        if kind.startswith(prefix):
            return peaks
    return None
