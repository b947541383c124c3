#!/usr/bin/env python3
"""Hold every call that the port makes to its multi-index hash against the
plain hash of slambench/reference/mih.py: one whole run of a benchmark cell
(one NVIDIA GPU).

    python3 tools/mih_replay_torch.py [--workload tum_rgbd_gf_hash.camera_rate]
        [--seed N] [--seconds 51] [--out profile_out/mih_replay.json]

Runs the cell in process as `slambench/run.py --trace 0` does, with each
hash's native library (gf_orb_slam2_tpu_torch/csrc/mih.cpp, bound in
hashing/mih.py) seen through `Recorder`, which copies every call's inputs
and results in the order the calls were made (the program makes each one
under the map store's lock, from the tracking thread and the mapping worker
alike): insert (descriptors, ids, entries evicted), erase, clear, query
(descriptors, the table selection, `max_out`, the ids it gave) and the
table sizes that online table selection reads; at the run's end it reads the
tables' sizes once more. Then `replay` feeds the same calls, in order, to
the plain hash and compares: each query's ordered id list, each insert's
eviction count and every reading of the table sizes must be equal (integers:
exact). Prints one JSON line (calls compared by kind, mismatches, the run's
`correct`) and writes it with the first mismatches to `--out`; exits 0 only
when the run is correct, calls were compared and none differs.
"""
import argparse
import contextlib
import json
import os
import sys

if __name__ == "__main__":
    # a run of the cell, as slambench/run.py makes it: the repo on the path
    # and the host's thread pools held to one thread, before numpy loads
    # (importing this module, as the tests do, changes neither)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")

import numpy as np  # noqa: E402

WORDS = 8  # 32-bit words of a descriptor


def _array(ptr, shape, dtype):
    """A copy of the `shape` values behind a ctypes pointer."""
    if not ptr or 0 in shape:
        return np.zeros(shape, dtype)
    return np.ctypeslib.as_array(ptr, shape=shape).astype(dtype, copy=True)


class Recorder:
    """A hash's native library seen through a proxy that appends each call to
    `calls` as it returns, with copies of its inputs and results:
    ("insert", desc, ids, evicted), ("erase", id), ("clear",),
    ("query", desc, table_sel or None, n_active, max_out, seen_size, ids),
    ("sizes", sizes). Other functions pass through."""

    def __init__(self, lib, calls, n_tables):
        self._lib, self._calls, self._n_tables = lib, calls, n_tables

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def mih_insert(self, h, desc, ids, n):
        evicted = self._lib.mih_insert(h, desc, ids, n)
        self._calls.append(("insert", _array(desc, (n, WORDS), np.uint32),
                            _array(ids, (n,), np.int32), int(evicted)))
        return evicted

    def mih_erase(self, h, point_id):
        self._lib.mih_erase(h, point_id)
        self._calls.append(("erase", int(point_id)))

    def mih_clear(self, h):
        self._lib.mih_clear(h)
        self._calls.append(("clear",))

    def mih_query(self, h, desc, n, table_sel, n_active, out, max_out, seen, seen_size):
        k = self._lib.mih_query(h, desc, n, table_sel, n_active, out, max_out, seen, seen_size)
        sel = _array(table_sel, (n_active,), np.int32) if table_sel else None
        self._calls.append(("query", _array(desc, (n, WORDS), np.uint32), sel, int(n_active),
                            int(max_out), int(seen_size), _array(out, (k,), np.int32)))
        return k

    def mih_table_sizes(self, h, out):
        self._lib.mih_table_sizes(h, out)
        self._calls.append(("sizes", _array(out, (self._n_tables,), np.int64)))


@contextlib.contextmanager
def recording():
    """Inside, every `MultiIndexHashing` made records its native calls.
    Yields a list that gets (hash, calls) for each; the hashes are kept
    alive, so their tables can be read after their System is gone."""
    from gf_orb_slam2_tpu_torch.hashing.mih import MultiIndexHashing

    made = []
    orig = MultiIndexHashing.__init__

    def init(self, cfg, max_points):
        orig(self, cfg, max_points)
        calls = []
        self._lib = Recorder(self._lib, calls, cfg.n_tables)
        made.append((self, calls))

    MultiIndexHashing.__init__ = init
    try:
        yield made
    finally:
        MultiIndexHashing.__init__ = orig


def replay(plain_cls, cfg, calls, keep=10):
    """Feed `calls` in order to a fresh `plain_cls` hash of `cfg`'s geometry
    and compare every result. Returns {"calls": by kind, "compared": the
    inserts, queries and size readings held against the plain hash,
    "mismatches": how many differ, "first": the first `keep` of them}."""
    ref = plain_cls(cfg.n_tables, cfg.bits_per_substring, cfg.max_bucket_size)
    by_kind = dict.fromkeys(("insert", "erase", "clear", "query", "sizes"), 0)
    n_bad, first = 0, []
    for i, call in enumerate(calls):
        kind = call[0]
        by_kind[kind] += 1
        if kind == "erase":
            ref.erase(call[1])
            continue
        if kind == "clear":
            ref.clear()
            continue
        if kind == "insert":
            got, want = ref.insert(call[1], call[2]), call[3]
        elif kind == "query":
            got, want = ref.query(*call[1:6]), call[6].tolist()
        else:
            got, want = ref.table_sizes(), call[1].tolist()
        if got != want:
            n_bad += 1
            if len(first) < keep:
                first.append({"call": i, "kind": kind, "program": _brief(want),
                              "plain": _brief(got)})
    return {"calls": by_kind, "compared": by_kind["insert"] + by_kind["query"] + by_kind["sizes"],
            "mismatches": n_bad, "first": first}


def _brief(v):
    return v if not isinstance(v, list) or len(v) <= 16 else v[:16] + ["...", len(v)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="tum_rgbd_gf_hash.camera_rate")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 19)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("profile_out", "mih_replay.json"))
    args = ap.parse_args(argv)

    from slambench.core import bench
    from slambench.reference.mih import PlainMIH

    cell = bench.Cell(args.workload)
    with recording() as made:
        result, lines, loaded = bench.run_cell(cell, args.seed, args.seconds, False,
                                               args.device)
    if not made:
        raise SystemExit(f"{args.workload} made no hash: is hashing on in its configuration?")
    report = {"workload": args.workload, "seed": args.seed, "correct": result["correct"],
              "device": result["device"], "info": result["info"], "checks": result["checks"],
              "hashes": []}
    for mih, calls in made:
        mih.table_sizes()  # the tables at the run's end, recorded as the last call
        report["hashes"].append(replay(PlainMIH, mih.cfg, calls))
    n_cmp = sum(h["compared"] for h in report["hashes"])
    n_bad = sum(h["mismatches"] for h in report["hashes"])
    report.update(compared=n_cmp, mismatches=n_bad)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k != "checks"}), flush=True)
    return 0 if result["correct"] and not loaded and n_cmp and not n_bad else 1


if __name__ == "__main__":
    raise SystemExit(main())
