"""Device time of the convolutions (cuDNN's and ATen's forward,
transposed and depthwise kernels, cuDNN's FFT convolutions, and their
layout changes) per field of the traced window, found by the kernel names
below."""

LAYER = "stock ops"
UNIT = "us/field"
MOVES = "infer_fields_per_s"
PATTERNS = [r"(?i)conv", r"fprop", r"dgrad", r"implicit_gemm",
            r"nchwToNhwc", r"nhwcToNchw", r"(?i)cudnn", r"(?i)fft",
            r"pointwise_mult_and_sum_complex"]


def read(trace):
    fields = trace.units.get("fields", 0)
    seconds = trace.kernel_s(PATTERNS)
    if not fields or seconds <= 0:
        return None
    return 1e6 * seconds / fields
