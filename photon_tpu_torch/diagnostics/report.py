"""HTML and JSON fit report of the single-GLM training driver.

Port of ``photon_tpu/diagnostics/report.py``: the training configuration,
the per-λ metrics, the coefficient table with bootstrap CIs, the
calibration test and the feature importance, rendered on the host (stdlib
only); ``fit-report.json`` has the JAX report's keys.
"""
from __future__ import annotations

import html
import json
import os
from typing import Mapping, Optional, Sequence

from photon_tpu_torch.diagnostics.bootstrap import BootstrapResult
from photon_tpu_torch.diagnostics.hosmer_lemeshow import HosmerLemeshowResult
from photon_tpu_torch.diagnostics.importance import FeatureImportance

_STYLE = """
body { font-family: system-ui, sans-serif; margin: 2rem; color: #1a1a1a; }
h1 { font-size: 1.4rem; } h2 { font-size: 1.1rem; margin-top: 1.6rem; }
table { border-collapse: collapse; margin: 0.6rem 0; }
th, td { border: 1px solid #ccc; padding: 0.25rem 0.6rem; text-align: right; }
th { background: #f2f2f2; } td.name { text-align: left; font-family: monospace; }
.note { color: #555; font-size: 0.85rem; }
"""


def _table(headers: Sequence[str], rows: Sequence[Sequence[object]]) -> str:
    h = "".join(f"<th>{html.escape(str(c))}</th>" for c in headers)
    body = []
    for row in rows:
        tds = []
        for i, c in enumerate(row):
            cls = ' class="name"' if i == 0 and isinstance(c, str) else ""
            text = f"{c:.6g}" if isinstance(c, float) else html.escape(str(c))
            tds.append(f"<td{cls}>{text}</td>")
        body.append("<tr>" + "".join(tds) + "</tr>")
    return f"<table><tr>{h}</tr>{''.join(body)}</table>"


def write_fit_report(
    output_dir: str,
    *,
    task: str,
    feature_names: Sequence[str],
    coefficients,
    config_summary: Mapping[str, object],
    sweep_metrics: Sequence[Mapping[str, object]] = (),
    bootstrap: Optional[BootstrapResult] = None,
    hosmer_lemeshow: Optional[HosmerLemeshowResult] = None,
    importance: Optional[FeatureImportance] = None,
    top_k: int = 25,
    filename: str = "fit-report.html",
) -> str:
    """Render the fit report; returns the written path. A machine-readable
    twin (``fit-report.json``) is written alongside it."""
    parts = [
        f"<html><head><meta charset='utf-8'><title>GLM fit report</title>"
        f"<style>{_STYLE}</style></head><body>",
        f"<h1>GLM fit report — {html.escape(task)}</h1>",
        "<h2>Configuration</h2>",
        _table(["parameter", "value"], sorted(config_summary.items())),
    ]
    if sweep_metrics:
        headers = sorted({k for m in sweep_metrics for k in m})
        parts += [
            "<h2>Regularization sweep</h2>",
            _table(headers, [[m.get(k, "") for k in headers] for m in sweep_metrics]),
        ]

    coefs = [float(c) for c in coefficients]
    order = importance.order if importance is not None else range(len(coefs))
    rows = []
    for rank, j in enumerate(order):
        if rank >= top_k:
            break
        j = int(j)
        row: list[object] = [feature_names[j], coefs[j]]
        if bootstrap is not None:
            row += [float(bootstrap.lower[j]), float(bootstrap.upper[j]),
                    float(bootstrap.std_error[j])]
        if importance is not None:
            row.append(float(importance.importance[rank]))
        rows.append(row)
    headers = ["feature", "coefficient"]
    if bootstrap is not None:
        ci = f"{bootstrap.confidence:.0%}"
        headers += [f"CI low ({ci})", f"CI high ({ci})", "std err"]
    if importance is not None:
        headers.append("importance")
    parts += [f"<h2>Top coefficients (by importance)</h2>", _table(headers, rows)]
    if bootstrap is not None:
        parts.append(
            f"<p class='note'>Bootstrap: {bootstrap.n_replicates} multinomial "
            f"replicates fit as lanes of one batched solve; "
            f"{int(bootstrap.converged.sum())}/{bootstrap.n_replicates} "
            "converged.</p>"
        )

    if hosmer_lemeshow is not None:
        hl = hosmer_lemeshow
        parts += [
            "<h2>Hosmer–Lemeshow calibration</h2>",
            _table(
                ["statistic", "df", "p-value"],
                [[hl.statistic, hl.df, hl.p_value]],
            ),
            _table(
                ["bin", "n", "observed positives", "expected positives"],
                [[g, float(hl.bin_count[g]), float(hl.observed_positives[g]),
                  float(hl.expected_positives[g])] for g in range(hl.n_bins)],
            ),
            "<p class='note'>Small p-values reject calibration "
            "(decile-of-risk bins).</p>",
        ]

    parts.append("</body></html>")
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, filename)
    with open(path, "w") as f:
        f.write("\n".join(parts))

    machine = {
        "task": task,
        "config": {k: str(v) for k, v in config_summary.items()},
        "sweep_metrics": [dict(m) for m in sweep_metrics],
        "hosmer_lemeshow": None if hosmer_lemeshow is None else {
            "statistic": hosmer_lemeshow.statistic,
            "df": hosmer_lemeshow.df,
            "p_value": hosmer_lemeshow.p_value,
        },
        "n_bootstrap_replicates": None if bootstrap is None else bootstrap.n_replicates,
    }
    with open(os.path.join(output_dir, "fit-report.json"), "w") as f:
        json.dump(machine, f, indent=2)
    return path
