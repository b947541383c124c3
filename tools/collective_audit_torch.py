#!/usr/bin/env python
"""Audit the port's distributed-BA collectives per LM iteration, per mesh axis.

The counterpart of tools/collective_audit.py (which reads the JAX program's
optimized HLO) for gf_orb_slam2_tpu_torch/parallel/dist_ba.py: it wraps the
torch.distributed collectives that the BA step calls (`all_reduce`,
`reduce_scatter_tensor`, `all_gather_into_tensor`), runs one LM iteration of
each layout, and records for every call the op, the mesh axis of its group
and the bytes of its result on one rank, the quantity the JAX audit sums
(SCALING.md's traffic table). Each table is held against the formula of the
step (`expected_per_iter`); the run fails if one differs.

  python tools/collective_audit_torch.py

runs an 8-rank gloo world on the CPU (gf_orb_slam2_tpu_torch.parallel.launch)
at K=64, P=32768, O=6 on a 1x8 mesh and a 2x4 hosts x devices mesh. Calls
and bytes depend on the shapes and the mesh only, not on the device.
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gf_orb_slam2_tpu_torch.parallel import dist_ba  # noqa: E402
from gf_orb_slam2_tpu_torch.parallel.mesh import HOST_AXIS, make_mesh, make_mesh2d  # noqa: E402

OPS = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor")
F32 = 4
CAM = (450.0, 450.0, 320.0, 240.0, 45.0)


def _result(op, args, kwargs):
    """The tensor a collective call writes: its only tensor for all_reduce,
    its output (first argument) for the other two."""
    return args[0] if args else kwargs["tensor" if op == "all_reduce" else "output_tensor"]


class CollectiveCounter:
    """While entered, every call of the BA step's collectives is recorded as
    (op, mesh axis of its group, result bytes). Axis labels are the mesh's
    axis names; a group spanning every axis is labelled 'a+b'."""

    def __init__(self, mesh):
        names = tuple(mesh.mesh_dim_names)
        self.labels = [(mesh.get_group(n), n) for n in names]
        self.all_label = "+".join(names)
        self.calls = []
        self._saved = {}

    def _label(self, group):
        for g, name in self.labels:
            if group is g:
                return name
        if group is None or group is dist.group.WORLD:
            return self.all_label
        return "other"

    def _wrap(self, op, fn):
        def wrapped(*args, **kwargs):
            t = _result(op, args, kwargs)
            self.calls.append((op, self._label(kwargs.get("group")),
                               t.numel() * t.element_size()))
            return fn(*args, **kwargs)
        return wrapped

    def __enter__(self):
        for op in OPS:
            self._saved[op] = getattr(dist, op)
            setattr(dist, op, self._wrap(op, self._saved[op]))
        return self

    def __exit__(self, *exc):
        for op, fn in self._saved.items():
            setattr(dist, op, fn)
        self._saved.clear()

    def table(self):
        """{"axis op": {"calls": n, "bytes": b}}."""
        out = {}
        for op, axis, nbytes in self.calls:
            row = out.setdefault(f"{axis} {op}", {"calls": 0, "bytes": 0})
            row["calls"] += 1
            row["bytes"] += nbytes
        return out


def expected_per_iter(kf_sharded, K, mesh_shape, axis_names, scatter_axis=None,
                      pcg_iters=dist_ba.PCG_ITERS):
    """Calls and result bytes per rank of one LM iteration, from the step's
    formula. Point-sharded: all-reduces of Hpp [K,6,6], bp [K,6],
    S_cross [K,K,6,6], bs_corr [K,6] and the two cost scalars over the whole
    mesh. KF-sharded: all-reduces of Hpp, bp, bs_corr and the two costs over
    the mesh, one of S over the other axes (if any), a reduce-scatter of S to
    [K/n,K,6,6] along the scatter axis and `pcg_iters` all-gathers of [K,6]."""
    names = tuple(axis_names)
    all_label = "+".join(names)
    if not kf_sharded:
        return {f"{all_label} all_reduce":
                {"calls": 6, "bytes": F32 * (36 * K + 6 * K + 36 * K * K + 6 * K + 2)}}
    scatter_axis = names[0] if scatter_axis is None else scatter_axis
    n = mesh_shape[names.index(scatter_axis)]
    out = {f"{all_label} all_reduce": {"calls": 5, "bytes": F32 * (36 * K + 6 * K + 6 * K + 2)}}
    other = [a for a in names if a != scatter_axis]
    if other:
        out[f"{'+'.join(other)} all_reduce"] = {"calls": 1, "bytes": F32 * 36 * K * K}
    out[f"{scatter_axis} reduce_scatter_tensor"] = {"calls": 1, "bytes": F32 * 36 * K * K // n}
    out[f"{scatter_axis} all_gather_into_tensor"] = {"calls": pcg_iters,
                                                     "bytes": pcg_iters * F32 * 6 * K}
    return out


def audit_step(mesh, prob, kf_sharded, scatter_axis=None):
    """One LM iteration of a layout on this rank's share of `prob` (the
    port's LocalBAProblem), counted; returns the measured and the expected
    table."""
    step = (dist_ba.build_pcg_ba_step(mesh, *CAM, scatter_axis=scatter_axis) if kf_sharded
            else dist_ba.build_distributed_ba_step(mesh, *CAM))
    local = dist_ba.local_problem(mesh, prob)
    lam = torch.tensor(dist_ba.LAM0, dtype=torch.float32, device=local.kf_R.device)
    with CollectiveCounter(mesh) as counter:
        step(local, lam)
    K = prob.kf_R.shape[0]
    names = tuple(mesh.mesh_dim_names)
    return {"layout": "kf_sharded_pcg" if kf_sharded else "point_sharded",
            "mesh": dict(zip(names, mesh.shape)), "scatter_axis": scatter_axis,
            "K": K, "P": int(prob.pt_pos.shape[0]), "O": int(prob.obs_kf.shape[1]),
            "measured": counter.table(),
            "expected": expected_per_iter(kf_sharded, K, tuple(mesh.shape), names, scatter_axis)}


def audit_rank(arrays, layouts, device="cpu"):
    """Rank target for `parallel.launch`: `audit_step` for each (mesh_shape,
    kf_sharded, scatter_axis) of `layouts` on the problem's arrays."""
    from gf_orb_slam2_tpu_torch.convert import ba_problem_from_arrays

    prob = ba_problem_from_arrays(arrays, "cpu")
    rows = []
    for mesh_shape, kf_sharded, scatter_axis in layouts:
        mesh = (make_mesh(device=device) if len(mesh_shape) == 1
                else make_mesh2d(*mesh_shape, device=device))
        rows.append(audit_step(mesh, prob, kf_sharded, scatter_axis))
    return rows


def audit_problem(K=64, P=32768, O=6, seed=0):
    """The JAX audit's problem (tools/collective_audit.py): identity poses,
    uniform points and pixels; only its shapes matter for the count."""
    rng = np.random.default_rng(seed)
    return [np.broadcast_to(np.eye(3, dtype=np.float32), (K, 3, 3)).copy(),
            np.zeros((K, 3), np.float32), np.zeros(K, bool), np.ones(K, bool),
            rng.uniform(-5, 5, (P, 3)).astype(np.float32), np.ones(P, bool),
            rng.integers(0, K, (P, O)).astype(np.int32),
            rng.uniform(0, 640, (P, O, 2)).astype(np.float32),
            np.full((P, O), -1.0, np.float32), np.ones((P, O), np.float32),
            np.ones((P, O), bool)]


LAYOUTS = (((8,), False, None), ((8,), True, None),
           ((2, 4), False, None), ((2, 4), True, HOST_AXIS))


def main():
    import importlib

    from gf_orb_slam2_tpu_torch.parallel.launch import launch

    # the ranks import this file by its module name, not as __main__
    me = importlib.import_module("tools.collective_audit_torch")
    rows = launch(me.audit_rank, (audit_problem(), LAYOUTS, "cpu"),
                  world_size=8, device="cpu", timeout=600)
    bad = 0
    for row in rows:
        print(f"\n== {row['layout']}, mesh {row['mesh']} (per LM iteration, per rank) ==")
        for key, v in sorted(row["measured"].items()):
            print(f"  {key:40s} x{v['calls']:3d}  {v['bytes'] / 1024:10.1f} KB")
        total = sum(v["bytes"] for v in row["measured"].values())
        print(f"  {'TOTAL':40s}       {total / 1024:10.1f} KB")
        print(json.dumps(row))
        bad += row["measured"] != row["expected"]
    if bad:
        sys.exit(f"{bad} layouts differ from the formula")


if __name__ == "__main__":
    main()
