"""The table of peaks of one NVIDIA H100 SXM (80 GB HBM3) that the rooflines
are taken against, each with its source.

- ``FP32_FLOPS``: 67 TFLOP/s, float32 outside the tensor cores (NVIDIA H100
  data sheet, SXM, dense).
- ``TF32_FLOPS``: 495 TFLOP/s, TF32 on the tensor cores (data sheet, dense,
  without sparsity).  A float32-accurate product there takes three TF32
  products (the split big x big + big x small + small x big), so float32
  work can issue on the tensor cores at a third of it.
- ``EXP_PER_S``: the SFU (MUFU) rate of float32 exponentials.  The CUDA C++
  Programming Guide's table of arithmetic instruction throughput gives, for
  compute capability 9.0, 16 results per clock per multiprocessor for the
  32-bit ``exp2`` (and the other special functions) against 128 float32
  fused multiply-adds, two operations each.  So the SFU issues 16/256 of the
  float32 operation rate: 132 SMs x 16 x 1.98 GHz, the clock at which 132
  SMs give the data sheet's 67 TFLOP/s.  This is derived, not printed in
  the data sheet.
- ``BYTES_PER_S``: 3.35 TB/s of HBM3 (data sheet).

These assume the card's full 700 W power limit; the benchmark prints the
card's limit beside every roofline share.
"""

FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
EXP_PER_S = FP32_FLOPS * 16 / 256
BYTES_PER_S = 3.35e12

# the fastest rate at which float32-accurate arithmetic can issue: the FP32
# pipe and the tensor cores' three-product split side by side
FLOAT32_OPS_PER_S = FP32_FLOPS + TF32_FLOPS / 3


def terms_ms(ops: float, exps: float, nbytes: float) -> dict:
    """The least time of a piece of work (milliseconds), term by term:
    ``fp32_pipe`` its float32 operations on the FP32 pipe alone (the bound the
    kernel table of PERF.md gives), ``ops`` the same operations at
    ``FLOAT32_OPS_PER_S``, ``exp`` its exponentials at the SFU rate, and
    ``bytes`` its bytes at the memory rate."""
    return {"fp32_pipe": ops / FP32_FLOPS * 1e3,
            "ops": ops / FLOAT32_OPS_PER_S * 1e3,
            "exp": exps / EXP_PER_S * 1e3,
            "bytes": nbytes / BYTES_PER_S * 1e3}


def least_ms(ops: float, exps: float, nbytes: float) -> float:
    """The least time any implementation of the work can take on the card
    (ms): the largest of its operations at the float32-accurate rate of the
    FP32 pipe and the tensor cores together, its exponentials at the SFU rate
    and its bytes at the memory rate.  The FP32 pipe's term alone is not a
    floor: a route that moves the pair arithmetic onto the tensor cores (the
    port's ext backward's tables do) can beat it."""
    t = terms_ms(ops, exps, nbytes)
    return max(t["ops"], t["exp"], t["bytes"])
