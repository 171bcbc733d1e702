"""The traced sides' share of their roofline, in %: the least time the card
needs for the work these inputs need (work/render.py: the larger of
float32 operations over peak FLOP/s and bytes over peak HBM bandwidth) over
the summed device time of every kernel in the traced window."""

from benchmark.trace import roofline_pct

read = roofline_pct
