"""Dataset utilities: compact BOP json dumping and simple ascii tables
(replacing terminaltables).  The port's copy of the part of
scflow_tpu/datasets/utils.py that evaluation and export use."""

import json
from typing import Any, List

import numpy as np


def dumps_json(content: Any) -> str:
    """Compact json like the reference's BOP export helper
    (datasets/utils.py:39-68): nested per-image lists on single lines."""

    def default(o):
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        raise TypeError(type(o))

    if isinstance(content, dict):
        lines = ["{"]
        keys = list(content.keys())
        for i, k in enumerate(keys):
            tail = "," if i < len(keys) - 1 else ""
            lines.append(
                f'  "{k}": {json.dumps(content[k], default=default)}{tail}'
            )
        lines.append("}")
        return "\n".join(lines)
    return json.dumps(content, default=default)


def ascii_table(table_data: List[List[Any]]) -> str:
    """Minimal AsciiTable replacement for metric printing."""
    cols = len(table_data[0])
    widths = [0] * cols
    rows = [[str(c) for c in row] for row in table_data]
    for row in rows:
        for i, c in enumerate(row):
            widths[i] = max(widths[i], len(c))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep]
    for j, row in enumerate(rows):
        out.append(
            "|" + "|".join(f" {c:<{widths[i]}} " for i, c in enumerate(row)) + "|"
        )
        if j == 0:
            out.append(sep)
    out.append(sep)
    return "\n".join(out)

