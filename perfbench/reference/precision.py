"""Precisions the reference computes in: ``float64`` (the reference itself),
``tf32`` (the control: float32 arithmetic whose matrix products take their
operands rounded to TF32's 10-bit mantissa and accumulate in float32, as
TF32 tensor cores do, emulated so that it reads the same on any device) and
``float32`` (a witness of float32 rounding: plain float32 products, with
TF32 off as ``harness/window.check`` sets it)."""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "tf32", "float32")


def dtype(prec: str) -> torch.dtype:
    if prec not in PRECISIONS:
        raise ValueError(f"unknown precision {prec!r}")
    return torch.float64 if prec == "float64" else torch.float32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (ties to even)."""
    bits = x.contiguous().view(torch.int32)
    bias = 0x0FFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        return rg @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ rg


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """Batched matrix product in the precision ``prec``."""
    if prec != "tf32":
        return a @ b
    return _TF32MatMul.apply(a, b)
