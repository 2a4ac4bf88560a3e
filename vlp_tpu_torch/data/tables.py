"""CSV tables read and written as pandas reads and writes them, with the
``csv`` module (the machine with the card has no pandas).

``read_csv`` gives each column the type ``pandas.read_csv`` infers for it:
integers where every non-missing cell is an integer and none is missing,
floats where every non-missing cell is a number (an integer column with a
missing cell becomes float, so ``str()`` of its 12 is ``"12.0"``), bools
where every cell is ``True``/``False`` in one of pandas' spellings (a
missing one leaves the bools and NaN side by side), else strings. A cell
that is empty or one of pandas' missing-value spellings (``NA``, ``nan``,
``NULL``, ...) is ``float("nan")``, so ``str()`` of it is ``"nan"``. Blank
lines are skipped and quoted fields may hold commas, quotes and newlines.
``Table.rows`` gives the rows as ``DataFrame.iterrows`` does: where every
column is an integer or float column, the integers of a row with a float
column come as floats. ``write_csv`` writes ``DataFrame.to_csv(index=
False)``'s bytes: minimal quoting, ``\\n`` line ends, NaN as an empty cell,
floats by ``repr``, bools as ``True``/``False``.
"""
from __future__ import annotations

import csv
import math
import os
import re
from typing import Dict, Iterator, List, Optional, Sequence

# pandas' default missing-value spellings (pandas._libs.parsers.STR_NA_VALUES)
NA_VALUES = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))
_TRUE = frozenset(("True", "TRUE", "true"))
_FALSE = frozenset(("False", "FALSE", "false"))
_INT = re.compile(r"^\s*[+-]?\d+\s*$")
_FLOAT = re.compile(r"^\s*[+-]?(\d+\.?\d*(e[+-]?\d+)?|\.\d+(e[+-]?\d+)?"
                    r"|inf|infinity)\s*$", re.IGNORECASE)


def isnan(value) -> bool:
    return isinstance(value, float) and math.isnan(value)


def _column(cells: List[Optional[str]]):
    """(kind, values) of one column's raw cells (None: missing)."""
    present = [c for c in cells if c is not None]
    nan = float("nan")
    if present and len(present) == len(cells) \
            and all(_INT.match(c) for c in present):
        return "int", [int(c) for c in cells]
    if all(_INT.match(c) or _FLOAT.match(c) for c in present):
        return "float", [nan if c is None else float(c) for c in cells]
    if all(c in _TRUE or c in _FALSE for c in present):
        kind = "bool" if len(present) == len(cells) else "object"
        return kind, [nan if c is None else c in _TRUE for c in cells]
    return "str", [nan if c is None else c for c in cells]


class Table:
    """Columns of Python values in the CSV's order; ``kinds`` gives each
    column's inferred type (int, float, bool, str, or object for bools with
    a missing cell)."""

    def __init__(self, columns: Dict[str, list], kinds: Dict[str, str]):
        self.columns = list(columns)
        self.data = columns
        self.kinds = kinds

    def __len__(self) -> int:
        return len(next(iter(self.data.values()))) if self.data else 0

    def __contains__(self, column: str) -> bool:
        return column in self.data

    def __getitem__(self, column: str) -> list:
        return self.data[column]

    def rows(self) -> Iterator[dict]:
        """``DataFrame.iterrows()``'s rows as dicts."""
        kinds = set(self.kinds.values())
        upcast = kinds <= {"int", "float"} and "float" in kinds
        for i in range(len(self)):
            yield {c: float(v) if upcast else v
                   for c, v in ((c, self.data[c][i]) for c in self.columns)}

    def lower(self, column: str) -> list:
        """``df[column].str.lower()``: NaN stays NaN; a column that is not
        of strings raises as pandas' ``.str`` accessor does."""
        if self.kinds[column] != "str":
            raise AttributeError("Can only use .str accessor with string "
                                 "values!")
        return [v if isnan(v) else v.lower() for v in self.data[column]]


def read_csv(path: str, names: Optional[Sequence[str]] = None) -> Table:
    """``pandas.read_csv(path)``, or with ``names`` given
    ``pandas.read_csv(path, header=None, names=names)``."""
    with open(path, newline="", encoding="utf-8-sig") as fh:
        records = [r for r in csv.reader(fh) if r]
    if names is None:
        if not records:
            raise ValueError(f"No columns to parse from file {path}")
        header, records = records[0], records[1:]
    else:
        header = list(names)
    for r in records:
        if len(r) > len(header):
            raise ValueError(f"{path}: a row has {len(r)} fields, the header "
                             f"{len(header)}")
    columns, kinds = {}, {}
    for j, name in enumerate(header):
        cells = [r[j] if j < len(r) and r[j] not in NA_VALUES else None
                 for r in records]
        kinds[name], columns[name] = _column(cells)
    return Table(columns, kinds)


def _cell(value, na_rep: str) -> str:
    if isinstance(value, float):  # numpy's float64 too, by Python's repr
        return na_rep if math.isnan(value) else float.__repr__(float(value))
    return str(value)


def write_csv(path: str, columns: Sequence[str], rows: Sequence[Sequence],
              na_rep: str = "") -> None:
    """``pandas.DataFrame(rows, columns=columns).to_csv(path, index=False,
    na_rep=na_rep)`` of Python values, through a temporary file and a
    rename."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", newline="", encoding="utf-8") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        if columns:
            writer.writerow(columns)
        else:
            fh.write("\n")
        writer.writerows([_cell(v, na_rep) for v in row] for row in rows)
    os.replace(tmp, path)
