"""The card's idle share of the traced steps, in %: the traced window less
the union of every device operation in it, over the window
(torch.profiler's device trace)."""


def read(run):
    t = run["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
