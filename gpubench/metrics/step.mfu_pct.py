"""Model FLOPs a sample (counts/<model>.py: the tower, and the FM terms
for DeepFM, forward and backward) times the window's samples over its
seconds, as a share of the peak of the type the step's matmuls run in
(counts/peaks.py, from the compute dtype and the TF32 setting)."""

from counts import peaks


def read(ctx):
    win = ctx["window"]
    flops = ctx["flops_per_sample"] * win["samples"] / win["seconds"]
    peak = peaks.matmul_peak(ctx["compute_dtype"], ctx["allow_tf32"])
    return 100.0 * flops / peak
