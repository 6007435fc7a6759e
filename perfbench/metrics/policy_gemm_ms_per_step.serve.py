"""Device milliseconds a step of the matrix-product kernels (cuBLAS's and
CUTLASS's gemm, gemv and xmma kernels) in the traced stretch: the policy
nets' products."""

import re

GEMM = re.compile(r"gemm|gemv|xmma|cutlass", re.IGNORECASE)


def read(run):
    ms = sum(e - s for name, s, e in run.trace.kernels if GEMM.search(name)) * 1e3
    return ms / run.trace.steps if ms > 0 else None
