"""A tab-separated table read as `pandas.read_table` reads it, without pandas.

MMBench ships its questions as a TSV (index, question, hint, A-D, answer,
image as base64, ...). The JAX harness reads it with `pd.read_table` and
prints what pandas gives back into the prompts, so two of pandas' default
rules change the prompt text:

- a field in pandas' default NA set (`""`, `NA`, `nan`, `None`, `NULL`,
  `N/A`, ...) reads as NaN, which the loader then drops as a missing
  option or hint;
- a column whose other fields are all integers reads as int64 (`1`), with
  a NaN among them as float64 (`1.0`); integers and decimals together as
  float64; all `True` / `False` (in any case) as bool. Any other column
  keeps its text as written.

`read_table` applies both and returns one dict a row, values as
`DataFrame.iterrows()` hands them out: Python str, int, float (NaN for a
missing field) and bool. Quoting follows the csv module's defaults, as
pandas' C parser does. Floats parse with Python's `float`, correctly
rounded; pandas' default parser may differ in the last bit for a value
written with more than 15 significant digits.
"""

from __future__ import annotations

import csv
import math
import os
import re

NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|(?i:inf|infinity))")
_BOOL = {"true": True, "false": False}  # in any case


def _column(fields: list[str]) -> list:
    """One column's fields as pandas types them (see the module's doc)."""
    present = [f.strip(" ") for f in fields if f not in NA_VALUES]
    missing = len(present) < len(fields)
    if not present:
        return [math.nan] * len(fields)
    if all(_INT.fullmatch(f) for f in present):
        cast = float if missing else int
        return [math.nan if f in NA_VALUES else cast(int(f.strip(" "))) for f in fields]
    if all(_FLOAT.fullmatch(f) for f in present):
        return [math.nan if f in NA_VALUES else float(f.strip(" ")) for f in fields]
    if all(f.lower() in _BOOL for f in present):
        return [math.nan if f in NA_VALUES else _BOOL[f.strip(" ").lower()] for f in fields]
    return [math.nan if f in NA_VALUES else f for f in fields]


def read_table(path: str) -> list[dict]:
    """The rows of a TSV with a header line, one dict a row (column name to
    value); blank lines are skipped and a short row is filled with NaN."""
    path = os.path.expanduser(path)
    # a base64 image is one field, often past the csv module's 128 KiB
    # limit; no field is longer than the file
    limit = csv.field_size_limit()
    csv.field_size_limit(max(limit, os.path.getsize(path)))
    try:
        with open(path, newline="") as f:
            rows = [r for r in csv.reader(f, delimiter="\t") if r]
    finally:
        csv.field_size_limit(limit)
    header, body = rows[0], rows[1:]
    for i, r in enumerate(body):
        if len(r) > len(header):
            raise ValueError(f"{path}: row {i + 1} has {len(r)} fields, the header {len(header)}")
    columns = [_column([r[j] if j < len(r) else "" for r in body]) for j in range(len(header))]
    return [{name: col[i] for name, col in zip(header, columns)} for i in range(len(body))]
