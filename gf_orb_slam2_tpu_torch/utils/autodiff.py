"""Forward-mode Jacobians of row-wise batched functions.

`row_jacobian(fn, x, *args)` returns J[b] = ∂fn(x, *args)[b] / ∂x[b] for a
function whose row b of output depends on row b of x only: one forward-mode
product per input column (`torch.func.jvp`, batched over the columns with
`torch.func.vmap`), each evaluated on the whole batch. It replaces
`vmap(jacfwd(f))` over rows: under that form every per-row scalar is a 0-dim
tensor, and in the torch this was written against a forward-mode tangent of a
0-dim tensor combined with a Python number comes out float64 (then a matmul
of f32 and f64 tangents fails). Here no traced tensor is 0-dim.
"""
from __future__ import annotations

import torch


def row_jacobian(fn, x, *args):
    """x [B, n] → J [B, m, n] for fn(x, *args) → [B, m]."""
    n = x.shape[-1]
    basis = torch.eye(n, dtype=x.dtype, device=x.device)[:, None, :].expand(n, *x.shape)

    def column(v):
        return torch.func.jvp(lambda a: fn(a, *args), (x,), (v,))[1]

    return torch.func.vmap(column, out_dims=-1)(basis)
