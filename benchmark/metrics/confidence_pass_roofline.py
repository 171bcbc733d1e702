"""The traced steps' share of their roofline, in %: the least time the
card needs for the work these inputs need (work/confidence.py: the larger
of float32 operations over peak FLOP/s and bytes over peak HBM bandwidth)
over the summed device time of every kernel in the traced window."""


def read(run):
    t = run["trace"]
    kernel_s = (t or {}).get("by_kind", {}).get("kernel", 0.0)
    if not kernel_s or run["least_s"] is None:
        return None
    return 100.0 * run["least_s"] / kernel_s
