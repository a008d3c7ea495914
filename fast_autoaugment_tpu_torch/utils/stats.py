"""Small dependency-free statistics helpers for result reporting (the port's
own copy of ``fast_autoaugment_tpu/utils/stats.py``).

The reference reports phase-3 outcomes as bare means over 5 retrains
(``search.py:301-311``) — no spread, no significance.  The round-4
reporting upgrade (VERDICT r3, next-step 4) records per-seed values and
a paired t-test, so a headline "augmented beats default" claim carries
its own evidence.  SciPy is deliberately not required: the Student-t
survival function is computed by numerically integrating the density
(exact enough for reporting — agrees with scipy.stats.t.sf to ~1e-7
over the ranges we use; see tests/test_stats.py).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["t_sf", "paired_t_test"]


def t_sf(t: float, df: float) -> float:
    """One-sided survival function P(T > t) of Student's t with ``df``
    degrees of freedom, via numeric integration of the density on the
    compactified substitution x = t + u/(1-u)."""
    if df <= 0:
        raise ValueError("df must be positive")
    if t < 0:
        return 1.0 - t_sf(-t, df)
    log_norm = (
        math.lgamma((df + 1) / 2.0)
        - math.lgamma(df / 2.0)
        - 0.5 * math.log(df * math.pi)
    )

    u = np.linspace(0.0, 1.0, 20001, dtype=np.float64)
    ui = u[:-1]
    x = t + ui / (1.0 - ui)
    jac = 1.0 / (1.0 - ui) ** 2
    log_pdf = log_norm - ((df + 1) / 2.0) * np.log1p(x * x / df)
    vals = np.exp(log_pdf) * jac
    # endpoint u=1 analytically: pdf(x)*jac ~ C*(1-u)^(df-1) with
    # C = exp(log_norm)*df^((df+1)/2) — nonzero for df=1 (Cauchy), where
    # dropping it costs ~1.6e-5
    tail = math.exp(log_norm) * df ** ((df + 1) / 2.0) if df == 1 else 0.0
    vals = np.append(vals, tail)
    trapz = getattr(np, "trapezoid", None) or np.trapz  # numpy<2 name
    return float(trapz(vals, u))


def paired_t_test(a, b) -> dict:
    """Two-sided paired t-test of H0: mean(a - b) == 0.

    Returns a JSON-ready dict with the per-pair differences' mean/std,
    the t statistic, two-sided p-value and n.  With zero variance in
    the differences the p-value degenerates to 0.0 (all diffs equal,
    nonzero) or 1.0 (all zero)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape or a.ndim != 1:
        raise ValueError("paired_t_test needs two equal-length 1-D sequences")
    n = len(a)
    if n < 2:
        raise ValueError("need at least 2 pairs")
    d = a - b
    mean = float(d.mean())
    std = float(d.std(ddof=1))
    if std == 0.0:
        return {
            "mean_diff": mean, "std_diff": 0.0, "t_stat": None,
            "p_value": 1.0 if mean == 0.0 else 0.0, "n": n, "df": n - 1,
        }
    t = mean / (std / math.sqrt(n))
    p = 2.0 * t_sf(abs(t), n - 1)
    return {
        "mean_diff": mean, "std_diff": std, "t_stat": t,
        "p_value": min(1.0, p), "n": n, "df": n - 1,
    }
