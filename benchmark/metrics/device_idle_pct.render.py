"""The card's idle share of the traced sides, in %: the traced window less
the union of every device operation in it, over the window
(torch.profiler's device trace)."""

from benchmark.trace import idle_pct

read = idle_pct
