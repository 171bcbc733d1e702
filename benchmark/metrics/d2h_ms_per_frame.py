"""Device milliseconds of card-to-host copies per frame of the traced
steps (torch.profiler's device trace)."""


def read(run):
    s = ((run["trace"] or {}).get("by_kind") or {}).get("d2h")
    if not s or not run["traced_units"]:
        return None
    return 1000.0 * s / run["traced_units"]
