"""Kernel K1: its least time from the request's (R, C, P) over its mean
device time in the traced slice, in % (peaks at the 700 W power limit)."""

from portbench.k1_bound import k1_bound_ms

KERNEL = "table_interp_kernel"


def read(run):
    if run.slice is None:
        return None
    mean_s = run.slice.kernel_mean_s(KERNEL)
    if not mean_s:
        return None
    bound_ms, _, _ = k1_bound_ms(*run.k1_shape)
    return 100.0 * bound_ms / (mean_s * 1e3)
