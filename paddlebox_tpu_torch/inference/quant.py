"""Quantized embedding-artifact helpers: per-row scales, int8/fp8 codecs
(reference: paddlebox_tpu/inference/quant.py).

The format, byte for byte the reference's:

  * head columns ``[show, clk, ..., embed_w]`` (``cvm_offset + 1`` of
    them) stay f32: the counters feed feature admission
    (``create_threshold``) and must compare exactly;
  * embedx columns quantize symmetrically with ONE f32 scale per row
    (``scale = amax(|row|) / dtype_max``; an all-zero row stores scale
    1.0), so a row always quantizes to the same bytes, whether a full
    export or a delta carries it;
  * dequant runs on the serving device, inside the serving program
    (export.py): f32 rows never materialize on the host.

int8 uses the symmetric [-127, 127] grid.  fp8 is ``float8_e4m3fn``
(finite max 448), encoded and decoded through ``torch.float8_e4m3fn``; the
port holds fp8 codes as raw ``uint8`` arrays, which is also their disk
form (the reference's), so the codes are saved as they are.  A value past
the format's range encodes as the reference's encoder does (NaN; torch's
cast saturates to 448 instead), which only a non-finite row reaches.
"""

from __future__ import annotations

import numpy as np
import torch

QUANT_DTYPES = ("fp32", "int8", "fp8")
FP8_MAX = 448.0  # float8_e4m3fn largest finite value
INT8_MAX = 127.0
# float8_e4m3fn rounds to nearest even: magnitudes above 464 (halfway
# between 448 and the missing 480) leave the format
_FP8_OVERFLOW = 464.0
_FP8_NAN = 0x7F


def validate_dtype(name: str) -> str:
    if name not in QUANT_DTYPES:
        raise ValueError(
            f"embedding_dtype must be one of {QUANT_DTYPES}, got {name!r}"
        )
    return name


def fp8_encode(x: np.ndarray) -> np.ndarray:
    """float32 -> float8_e4m3fn bytes as uint8, rounded to nearest even."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    q = torch.from_numpy(x).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    over = ~(np.abs(x) <= _FP8_OVERFLOW)  # NaN included
    if over.any():
        q = q.copy()
        q[over] = _FP8_NAN | (np.signbit(x[over]).astype(np.uint8) << 7)
    return q


def fp8_decode(q: np.ndarray) -> np.ndarray:
    """float8_e4m3fn bytes (uint8) -> float32."""
    q = np.ascontiguousarray(q, dtype=np.uint8)
    return torch.from_numpy(q).view(torch.float8_e4m3fn).float().numpy()


def quantize_rows(values: np.ndarray, cvm_offset: int,
                  embedding_dtype: str):
    """Split f32 rows ``[n, W]`` into ``(head f32 [n, co+1],
    embedx_q [n, W-co-1], scales f32 [n])``; embedx_q is int8, or the fp8
    codes as uint8.  Row-wise deterministic."""
    validate_dtype(embedding_dtype)
    if embedding_dtype == "fp32":
        raise ValueError("quantize_rows: fp32 rows need no quantization")
    values = np.asarray(values, dtype=np.float32)
    co = int(cvm_offset)
    if values.shape[1] <= co + 1:
        raise ValueError(
            f"rows of width {values.shape[1]} have no embedx columns past "
            f"cvm_offset {co}; nothing to quantize"
        )
    head = np.ascontiguousarray(values[:, : co + 1])
    embedx = values[:, co + 1:]
    amax = (np.abs(embedx).max(axis=1) if embedx.shape[0]
            else np.zeros((0,), np.float32))
    qmax = INT8_MAX if embedding_dtype == "int8" else FP8_MAX
    scales = np.where(amax > 0, amax / qmax, 1.0).astype(np.float32)
    scaled = embedx / scales[:, None]
    if embedding_dtype == "int8":
        q = np.clip(np.round(scaled), -INT8_MAX, INT8_MAX).astype(np.int8)
    else:
        q = fp8_encode(scaled)
    return head, q, scales


def dequantize_rows(head: np.ndarray, q: np.ndarray,
                    scales: np.ndarray) -> np.ndarray:
    """The host-side inverse (test oracle and tooling; serving dequantizes
    inside the exported program).  ``q``: int8 codes, or fp8 as uint8."""
    q = np.asarray(q)
    codes = fp8_decode(q) if q.dtype == np.uint8 else q.astype(np.float32)
    emb = codes * np.asarray(scales, np.float32)[:, None]
    return np.concatenate([np.asarray(head, np.float32), emb], axis=1)


def code_dtype(embedding_dtype: str) -> np.dtype:
    """The in-memory and on-disk dtype of a quantized dtype's codes."""
    validate_dtype(embedding_dtype)
    if embedding_dtype == "fp32":
        raise ValueError("fp32 artifacts carry no codes")
    return np.dtype(np.int8 if embedding_dtype == "int8" else np.uint8)


def load_q(raw: np.ndarray, embedding_dtype: str) -> np.ndarray:
    """Codes read from disk, viewed as the artifact's declared dtype's."""
    return np.asarray(raw).view(code_dtype(embedding_dtype))
