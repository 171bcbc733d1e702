"""CSV reading without pandas, with the reference reader's float parsing.

The JAX build reads the capture's CSVs (depth descriptors, HMD poses) with
pandas, whose C parser converts decimals with its own `precise_xstrtod`:
at most 17 significant digits accumulate into a double, later digits are
dropped, and the result is scaled by a power of ten.  That is not always
the correctly rounded value Python's float() gives (for example
"-0.14999999999999994" reads as -0.1499999999999999).  `parse_float`
repeats that algorithm so both packages build bit-identical frame tables
from the same files.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List

_MAX_DIGITS = 17


def parse_float(text: str) -> float:
    """Decimal text -> float, as pandas' default C parser converts it."""
    s = text.strip()
    i, n = 0, len(s)
    negative = False
    if i < n and s[i] in "+-":
        negative = s[i] == "-"
        i += 1
    number = 0.0
    exponent = 0
    num_digits = 0
    while i < n and s[i].isdigit():
        if num_digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(s[i]) - 48)
            num_digits += 1
        else:
            exponent += 1
        i += 1
    if i < n and s[i] == ".":
        i += 1
        num_decimals = 0
        while num_digits < _MAX_DIGITS and i < n and s[i].isdigit():
            number = number * 10.0 + (ord(s[i]) - 48)
            i += 1
            num_digits += 1
            num_decimals += 1
        while i < n and s[i].isdigit():
            i += 1
        exponent -= num_decimals
    if num_digits == 0:
        return float(s)  # inf / nan spellings, or raise ValueError
    if negative:
        number = -number
    if i < n and s[i] in "eE":
        i += 1
        neg_exp = False
        if i < n and s[i] in "+-":
            neg_exp = s[i] == "-"
            i += 1
        e = 0
        while i < n and s[i].isdigit():
            e = e * 10 + (ord(s[i]) - 48)
            i += 1
        exponent += -e if neg_exp else e
    if i != n:
        raise ValueError(f"could not convert string to float: {text!r}")
    if exponent > 308:
        return float("-inf") if negative else float("inf")
    if exponent > 0:
        return number * float(f"1e{exponent}")
    if exponent < -308:
        if exponent < -616:
            return -0.0 if negative else 0.0
        return number / float(f"1e{-308 - exponent}") / 1e308
    return number / float(f"1e{-exponent}")


def read_rows(path: Path) -> List[Dict[str, str]]:
    """Rows of a headed CSV file as dicts of column -> text, in file order."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))
