"""The work of the windowed-sinc resample stage, counted from what it has
to compute whatever kernel computes it: each real output sample is a sum
of ``2 nt`` taps, one multiply and one add each; each input sample is read
once and each output sample written once, in float32."""


def sinc_flops(outputs: int, nt: int) -> float:
    """Floating-point operations of ``outputs`` output samples."""
    return 2.0 * nt * 2.0 * outputs


def sinc_bytes(inputs: int, outputs: int) -> float:
    """Bytes moved: every input sample read once, every output written once."""
    return 4.0 * (inputs + outputs)


def least_seconds(flops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card could take: the larger of the operations
    at the float32 peak and the bytes at the memory bandwidth."""
    return max(flops / peaks["fp32_flops"], nbytes / peaks["hbm_bytes_per_s"])
