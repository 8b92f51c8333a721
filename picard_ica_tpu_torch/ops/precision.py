"""Dot-product precision tiers of the data passes, on torch tensors.

Counterpart of ``picard_ica_tpu/ops/precision.py``. A tier trades
passes for mantissa bits:

  * ``"bf16"``   — operands rounded to bf16, f32 accumulation;
  * ``"bf16x3"`` — hi/lo bf16 splits of both operands,
    ``hi*hi + lo*hi + hi*lo`` with f32 accumulation (~16 bits);
  * ``"f32"``    — exact f32.

Every tier is exact at f64, where bf16 splitting would lose precision.
A bf16-rounded value multiplied by another is exact in f32, so each
tier is written as f32 matrix products of rounded operands; "exact
f32" assumes TF32 is off (:func:`exact_f32` turns it off for the
duration of ``fit``, ``transform`` and the warm starts). The fused
kernel computes its f32 tier as six bf16 products of three-way splits
(``csrc/rotated_fused_tc.cu``); its plain version keeps these exact
f32 products.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_f32():
    """"f32" is exact f32: TF32 off in matmuls and convolutions for the
    duration of a call, and the caller's flags restored after it, also
    when it raises (the JAX package asks each product for HIGHEST and
    changes no global state). Usable as a decorator."""
    matmul = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def _bf16(v):
    """``v`` rounded to bf16, returned in f32."""
    return v.to(torch.bfloat16).to(torch.float32)


def _split_bf16(v):
    """(hi, lo) bf16 halves of an f32 operand, as f32 tensors:
    hi = bf16(v), lo = bf16(v - hi)."""
    hi = _bf16(v)
    lo = _bf16(v - hi)
    return hi, lo


def _split3_bf16(v):
    """(hi, mid, lo) bf16 thirds of an f32 operand, as f32 tensors: hi =
    bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid); hi + mid + lo
    is v (the f32 tier's split, ``csrc/mma_tiers.cuh`` split3_pair)."""
    hi = _bf16(v)
    rest = v - hi
    mid = _bf16(rest)
    return hi, mid, _bf16(rest - mid)


def _dot_bf16x3_presplit(a_pair, b_pair, acc=torch.float32):
    """The three bf16 products of already-split operands, summed in the
    JAX package's order: hi*hi + lo*hi + hi*lo."""
    a_hi, a_lo = a_pair
    b_hi, b_lo = b_pair
    return (a_hi @ b_hi + a_lo @ b_hi + a_hi @ b_lo).to(acc)


def _kernel_dot(a, b, acc, precision: str):
    """``a @ b`` at the requested tier, accumulated in f32 (or f64)."""
    if acc != torch.float64:
        if precision == "bf16x3":
            return _dot_bf16x3_presplit(_split_bf16(a.to(torch.float32)),
                                        _split_bf16(b.to(torch.float32)), acc)
        if precision == "bf16":
            return (_bf16(a) @ _bf16(b)).to(acc)
    return (a.to(acc) @ b.to(acc))


def matmul_tiered(a, b, acc, precision: str):
    """2-D ``a @ b`` at the requested tier — the torch path's data dot
    (models/core.data_fused_step).

    The JAX package maps bf16x3 to XLA's ``Precision.HIGH`` here; torch
    has no per-call equivalent, so the torch path runs the same hi/lo
    split as the kernels (three f32 products of rounded operands)."""
    return _kernel_dot(a, b, acc, precision)
