"""Exact linear-sum assignment (Jonker-Volgenant shortest augmenting path,
e-maxx formulation), on the host, for the tracker's per-clip matching.

Counterpart of ``mdqe_cvpr2023_tpu/ops/hungarian.py`` with the same algorithm
and float32 arithmetic, so ties break as there (first minimum in column
order). The tracker's gated score matrices are full of exact zeros, so ties
are common, and ``scipy.optimize.linear_sum_assignment`` does not promise the
same choice among them. The matrices are small (<= 121 x 150); a
device-resident version is later work.
"""
from __future__ import annotations

import numpy as np

_INF = np.float32(1e30)


def lsa_maximize(scores, row_mask=None) -> np.ndarray:
    """Max-weight assignment of rows to columns, every row matched (R <= C).
    scores (R, C); row_mask (R,) bool skips the rows that are False (their
    entry is 0). Returns col4row (R,) int32."""
    return lsa_minimize(-np.asarray(scores, np.float32), row_mask)


def lsa_minimize(cost, row_mask=None) -> np.ndarray:
    """Min-cost assignment (R <= C). Returns col4row (R,) int32."""
    a = np.asarray(cost, np.float32)
    R, C = a.shape
    if R > C:
        raise ValueError(f"lsa requires R <= C, got {a.shape}")
    # columns 1..C real, column 0 virtual; p[j] = row (1-based) on column j
    u = np.zeros(R + 1, np.float32)
    v = np.zeros(C + 1, np.float32)
    p = np.zeros(C + 1, np.int64)
    for i in range(1, R + 1):
        if row_mask is not None and not row_mask[i - 1]:
            continue
        p[0] = i
        # deferred duals: M[j] = min_t (cur_t[j] + D_{t-1}); Dat[j] = D when
        # column j becomes used; duals are committed once per row
        M = np.full(C + 1, _INF, np.float32)
        way = np.zeros(C + 1, np.int64)
        used = np.zeros(C + 1, bool)
        dat = np.zeros(C + 1, np.float32)
        j0, D = 0, np.float32(0.0)
        while p[j0] != 0:
            used[j0] = True
            dat[j0] = D
            i0 = p[j0]
            cur = np.empty(C + 1, np.float32)
            cur[0] = _INF
            cur[1:] = a[i0 - 1] - u[i0] - v[1:]
            cur += D
            cur[used] = _INF
            upd = cur < M
            M[upd] = cur[upd]
            way[upd] = j0
            masked = np.where(used, _INF, M)
            j0 = int(np.argmin(masked))
            D = masked[j0]
        adj = np.where(used, D - dat, np.float32(0.0)).astype(np.float32)
        v -= adj
        np.add.at(u, p, adj)
        while j0 != 0:  # augment along the path back to the virtual column
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col4row = np.zeros(R, np.int32)
    rows = p[1:]
    col4row[rows[rows > 0] - 1] = np.nonzero(rows > 0)[0]
    return col4row
