"""Exact linear sum assignment (port of `devis_tpu/ops/hungarian.py`).

The JAX package solves the assignment on the device because its runtime has
no host callbacks. The matcher's cost matrix is small (targets x
trajectories), so the port copies it to the host and runs the same
shortest-augmenting-path algorithm with dual potentials there, O(n^2 m), in
float64 numpy. The optimum's total cost equals the JAX solver's and scipy's;
where several assignments tie, the choice may differ.

Convention: ``cost`` is (n_rows, n_cols) with n_rows <= n_cols; every row
gets a distinct column; returns ``col_for_row`` (n_rows,) int64.
"""
from __future__ import annotations

import numpy as np
import torch


def lsa_numpy(cost: np.ndarray) -> np.ndarray:
    cost = np.asarray(cost, np.float64)
    n, m = cost.shape
    if n > m:
        raise ValueError(f"lsa expects n_rows <= n_cols, got {cost.shape}")
    # 1-indexed columns with a virtual column 0; p[j] is the row assigned to
    # column j (0 = free)
    u = np.zeros(n + 1)
    v = np.zeros(m + 1)
    p = np.zeros(m + 1, np.int64)
    way = np.zeros(m + 1, np.int64)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(m + 1, np.inf)
        used = np.zeros(m + 1, bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            cur = cost[i0 - 1] - u[i0] - v[1:]
            free = ~used[1:]
            better = free & (cur < minv[1:])
            minv[1:][better] = cur[better]
            way[1:][better] = j0
            j1 = 1 + int(np.argmin(np.where(free, minv[1:], np.inf)))
            delta = minv[j1]
            u[p[used]] += delta
            v[used] -= delta
            minv[~used] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col_for_row = np.zeros(n, np.int64)
    cols = np.nonzero(p[1:])[0]
    col_for_row[p[1:][cols] - 1] = cols
    return col_for_row


def lsa(cost: torch.Tensor) -> torch.Tensor:
    """(n, m) cost, n <= m → (n,) int64 columns on the cost's device. The
    cost is read without gradient; the call waits for the device."""
    cols = lsa_numpy(cost.detach().double().cpu().numpy())
    return torch.from_numpy(cols).to(cost.device)
