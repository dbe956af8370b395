"""Device ms a training step spends in matrix-product kernels, by kernel
name from the trace.  The name rule: cuBLAS, cuBLASLt and CUTLASS
products on Hopper are named with ``gemm``, ``xmma``, ``nvjet`` or
``cutlass``, or start with ``sm90_``."""

NEEDLES = ("gemm", "xmma", "nvjet", "cutlass")


def is_gemm(name: str) -> bool:
    low = name.lower()
    return low.startswith("sm90_") or any(k in low for k in NEEDLES)


def read(ctx):
    c, t = ctx.get("train"), ctx.get("trace")
    if not c or not t or c["steps"] <= 0:
        return None
    ns = sum(d for name, _, d in t["kernels"] if is_gemm(name))
    if ns <= 0:
        return None
    return ns / 1e6 / c["steps"]
