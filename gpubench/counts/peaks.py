"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W limit)."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {
    "float32": 67e12,      # outside the tensor cores
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
}


def matmul_peak(compute_dtype: str, allow_tf32: bool) -> float:
    """The FLOP/s peak of the type the step's matmuls run in."""
    dtype = compute_dtype or "float32"
    if dtype in ("float32", "f32", "fp32"):
        return FLOPS_PER_S["tf32" if allow_tf32 else "float32"]
    if dtype in ("bfloat16", "bf16"):
        return FLOPS_PER_S["bfloat16"]
    if dtype in ("float16", "fp16", "f16"):
        return FLOPS_PER_S["float16"]
    raise ValueError(f"no peak for compute dtype {compute_dtype!r}")
