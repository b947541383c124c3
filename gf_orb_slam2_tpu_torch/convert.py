"""State carried across from the JAX package, as plain numpy.

These functions build the port's objects from what a caller extracted from
the reference package's objects (dataclass instances, dicts of numpy
arrays). They import nothing of that package: the extraction happens on the
caller's side (the parity tests).

Descriptors: both packages keep 256-bit descriptors as 8 words of 32 bits.
Host state (MapStore, Frame) holds them as numpy uint32; torch tensors hold
the SAME BITS as int32 (`uint32.view(int32)` at the boundary), because torch
has no shift operators on uint32.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from gf_orb_slam2_tpu_torch import config as _config
from gf_orb_slam2_tpu_torch.features.extractor import Features
from gf_orb_slam2_tpu_torch.mapping.local_mapping import LocalMapper, MappingStats
from gf_orb_slam2_tpu_torch.slammap.device_mirror import DeviceMapMirror
from gf_orb_slam2_tpu_torch.slammap.store import MapStore
from gf_orb_slam2_tpu_torch.tracking.frame import Frame
from gf_orb_slam2_tpu_torch.tracking.tracker import chain_to_device
from gf_orb_slam2_tpu_torch.utils.transfer import desc_to_torch


def config_from_reference(ref_cfg):
    """Reference dataclass instance → the port's dataclass of the same class
    name, field by field by name (nested dataclasses and enums included)."""
    cls = getattr(_config, type(ref_cfg).__name__)
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = getattr(ref_cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = config_from_reference(v)
        elif isinstance(v, enum.Enum):
            v = getattr(_config, type(v).__name__)[v.name]
        kwargs[f.name] = v
    return cls(**kwargs)


def store_arrays(store) -> dict:
    """Every SoA array (and counter) of a MapStore-like object as a dict —
    works on either package's store, since it only reads attributes."""
    out = {}
    for k, v in vars(store).items():
        if isinstance(v, np.ndarray):
            out[k] = v.copy()
    for k in ("n_points", "n_keyframes", "next_point", "big_change_idx",
              "_free_head", "_n_free"):
        out[k] = int(getattr(store, k))
    out["kf_loop_edges"] = {k: set(v) for k, v in store.kf_loop_edges.items()}
    return out


def store_from_arrays(cap, n_kp: int, arrays: dict) -> MapStore:
    """Build the port's MapStore from `store_arrays` output. `cap` is the
    port's CapacityConfig (see `config_from_reference`)."""
    s = MapStore(cap, n_kp)
    for k, v in arrays.items():
        if isinstance(v, np.ndarray):
            cur = getattr(s, k)
            assert cur.shape == v.shape and cur.dtype == v.dtype, (k, cur.shape, v.shape)
            setattr(s, k, v.copy())
        else:
            setattr(s, k, v)
    return s


def store_with_mirror(cap, n_kp: int, arrays: dict, device="cuda") -> MapStore:
    """`store_from_arrays` with a device map mirror attached, built from the
    same arrays (what the pipelined tracker reads its pool from)."""
    s = store_from_arrays(cap, n_kp, arrays)
    with s.lock:
        s.mirror = DeviceMapMirror(s, device)
    return s


def chain_from_arrays(arrays: dict, device="cuda") -> dict:
    """The pipelined tracker's chain from host arrays keyed R1, t1, R2, t2,
    pt_pos, pt_oct, pt_valid, pt_desc (uint32 words), pt_ids — e.g. the
    JAX package's `Tracker.stream_bootstrap_chain()` fetched as numpy."""
    return chain_to_device(arrays, device)


def mapper_state(mapper) -> dict:
    """The host state a local mapper carries between keyframe events (the
    recently created points under probation and the per-event log) — works
    on either package's mapper, since it only reads attributes."""
    return {"recent_points": [(int(p), int(b)) for p, b in mapper.recent_points],
            "stats": [dataclasses.asdict(st) for st in mapper.stats]}


def load_mapper_state(mapper: LocalMapper, state: dict) -> LocalMapper:
    """Give the port's mapper the state `mapper_state` extracted, so that it
    continues from the same point as the mapper it came from."""
    mapper.recent_points = [tuple(r) for r in state["recent_points"]]
    mapper.stats = [MappingStats(**d) for d in state["stats"]]
    return mapper


def frame_from_arrays(arrays: dict) -> Frame:
    """Build a host Frame from a dict with frame_id, timestamp, the keypoint
    arrays (uv, octave, angle, desc uint32, response, u_right, depth, valid)
    and optionally R, t, mp_ids, is_outlier."""
    def get(k, dtype=None):
        v = arrays.get(k)
        return None if v is None else np.array(v, dtype=dtype)

    return Frame(
        frame_id=int(arrays["frame_id"]), timestamp=arrays["timestamp"],
        uv=get("uv", np.float32), octave=get("octave", np.int32),
        angle=get("angle", np.float32), desc=get("desc", np.uint32),
        response=get("response", np.float32), u_right=get("u_right", np.float32),
        depth=get("depth", np.float32), valid=get("valid", bool),
        R=get("R", np.float32), t=get("t", np.float32),
        mp_ids=get("mp_ids", np.int32), is_outlier=get("is_outlier", bool),
    )


def features_to_torch(arrays: dict, device="cuda") -> Features:
    """Dict of numpy feature arrays (uv, response, octave, angle, desc
    uint32, valid) → the port's Features on `device`."""
    def dev(k, dtype):
        return torch.from_numpy(np.ascontiguousarray(arrays[k], dtype=dtype)).to(device)

    return Features(
        uv=dev("uv", np.float32), response=dev("response", np.float32),
        octave=dev("octave", np.int32), angle=dev("angle", np.float32),
        desc=desc_to_torch(np.asarray(arrays["desc"], np.uint32), device),
        valid=dev("valid", bool),
    )
