"""Reporting: the LaTeX tables of the metric rows (port of
``metrics_to_latex``, multimodal_supernovae_tpu/evaluation/reports.py:15,
without pandas; the reference's src/utils.py print_metrics_in_latex :693).

The text is the JAX package's (pandas' ``to_latex``) byte for byte: a
group's mean is a compensated (Kahan) sum over its count and its std the
square root of Welford's running variance with ddof 1, as pandas' grouped
``mean`` and ``std`` compute them; one row gives ``nan``. The plots of the
JAX module (confusion matrices, predicted against true redshift, radar
plots) need matplotlib and are not ported yet (ROADMAP.md item 18b).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

GROUP_KEYS = ("id", "Model", "Combination")


def _mean(values: Sequence[float]) -> float:
    total = comp = 0.0
    for v in values:
        y = v - comp
        t = total + y
        comp = t - total - y
        total = t
    return total / len(values)


def _std(values: Sequence[float]) -> float:
    if len(values) < 2:
        return math.nan
    mean = m2 = 0.0
    for n, v in enumerate(values, start=1):
        old = mean
        mean += (v - old) / n
        m2 += (v - mean) * (v - old)
    return math.sqrt(m2 / (len(values) - 1))


def _is_float(v: Any) -> bool:
    return isinstance(v, float) or (hasattr(v, "dtype") and v.dtype.kind == "f")


def _float_columns(rows: List[Dict[str, Any]], columns: List[str]) -> List[str]:
    """The columns a DataFrame of ``rows`` gives a float dtype: every value
    a float (or missing, which is NaN)."""
    out = []
    for c in columns:
        vals = [r[c] for r in rows if c in r and r[c] is not None]
        if vals and all(_is_float(v) for v in vals) and not all(
                isinstance(v, bool) for v in vals):
            out.append(c)
    return out


def _to_latex(header: List[str], body: List[List[str]]) -> str:
    """pandas' ``to_latex(escape=False, index=False)`` with a centred,
    ruled column format."""
    lines = ["\\begin{tabular}{" + "|c" * len(header) + "|}", "\\toprule",
             " & ".join(header) + " \\\\", "\\midrule"]
    lines += [" & ".join(row) + " \\\\" for row in body]
    lines += ["\\bottomrule", "\\end{tabular}", ""]
    return "\n".join(lines)


def metrics_to_latex(
    metrics_list: List[Dict[str, Any]],
    drop: Optional[List[str]] = None,
    sort: Optional[str] = None,
    max_cols_per_table: int = 4,
) -> List[str]:
    """Mean +- std tables grouped by (id, Model, Combination), as LaTeX."""
    columns: List[str] = []
    for r in metrics_list:
        columns += [c for c in r if c not in columns]
    numeric = _float_columns(metrics_list, columns)
    groups: Dict[tuple, List[Dict[str, Any]]] = {}
    for r in metrics_list:
        groups.setdefault(tuple(r[k] for k in GROUP_KEYS), []).append(r)
    keys = sorted(groups)
    tables = []
    for i in range(0, len(numeric), max_cols_per_table):
        cols = numeric[i:i + max_cols_per_table]
        header = ["Model", "Combination", *cols]
        body = []
        for key in keys:
            cells = [str(key[1]), str(key[2])]
            for c in cols:
                vals = [float(r[c]) if r.get(c) is not None else math.nan
                        for r in groups[key]]
                vals = [v for v in vals if not math.isnan(v)]
                mean = _mean(vals) if vals else math.nan
                cells.append("{:.3f}".format(mean) + " ± " + "{:.3f}".format(_std(vals)))
            body.append(cells)
        if drop:
            keep = [j for j, h in enumerate(header) if h not in drop]
            header = [header[j] for j in keep]
            body = [[row[j] for j in keep] for row in body]
        if sort and sort in header:
            j = header.index(sort)
            body = sorted(body, key=lambda row: row[j], reverse=True)
        tables.append(_to_latex(header, body))
    return tables
