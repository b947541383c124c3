"""The hashed RGB-D cell (`tum_rgbd_gf_hash.camera_rate`): its files load
through `Cell` and give the port's configuration with the hash on; its two
readers of the program's spans (`hash_ms_per_frame.rt`,
`map_hash_ms_per_kf.rt`) on spans made up here, and nothing read where the
spans are missing; the step-3 faults planted in the true poses read as far
over its `ate_m` limit as at the handheld's cell (the same frames); the
plain hash (slambench/reference/mih.py) loads neither JAX nor the port."""
import json
import threading
from types import SimpleNamespace

import pytest

from slambench.core import bench, program, settings, trace
from slambench.tests.test_slambench_faults import fault_readings
from slambench.tests.test_slambench_harness import fresh

CELL = "tum_rgbd_gf_hash.camera_rate"
CONTROL = "tum_rgbd_gf.camera_rate"


def test_the_cell_loads_with_the_hash_on():
    from gf_orb_slam2_tpu_torch.config import LocalMapMode

    cell, control = bench.Cell(CELL), bench.Cell(CONTROL)
    assert cell.entry["traffic"] == control.entry["traffic"] and cell.entry["chips"] == 1
    assert cell.traffic == control.traffic and cell.limits == control.limits
    cfg, base = settings.system_config(cell.config), settings.system_config(control.config)
    assert cfg.hashing.enabled and cfg.tracking.local_map_mode == LocalMapMode.COMBINED
    assert not base.hashing.enabled and base.tracking.local_map_mode == LocalMapMode.COVIS_ONLY
    # the hash's geometry is the port's defaults, the upstream's
    h = cfg.hashing
    assert (h.n_tables, h.bits_per_substring, h.n_active_tables, h.max_bucket_size,
            h.map_size_trigger, h.online_table_selection) == (32, 8, 8, 20, 2000, True)
    # every other setting is the control's
    assert cfg.replace(hashing=base.hashing, tracking=base.tracking) == base
    # every key of the file but the hash's two and the words is the control's
    words = ("source", "deployment", "assumed")
    assert {k: v for k, v in cell.config.items() if k not in words + ("gf",)} == {
        k: v for k, v in control.config.items() if k not in words + ("gf",)}
    assert dict(cell.config["gf"], hashing=False, local_map_mode="COVIS_ONLY") == \
        control.config["gf"]


def test_the_cell_reports_the_new_metrics():
    names = {m["name"] for m in bench.Cell(CELL).metrics("per_layer")}
    assert {"hash_ms_per_frame.rt", "map_hash_ms_per_kf.rt"} <= names
    assert names - {"hash_ms_per_frame.rt", "map_hash_ms_per_kf.rt"} == {
        m["name"] for m in bench.Cell(CONTROL).metrics("per_layer")}


def sp(name, s, e, thread=None, **attrs):
    return SimpleNamespace(name=name, start_ns=s, end_ns=e, attrs=attrs,
                           thread=thread or threading.current_thread().name)


def made_spans():
    return [
        # frame A [0, 100]: a query under the local pool, and the scores
        sp("track.hash_scores", 20, 24), sp("track.hash", 60, 75), sp("track.local_pool", 55, 80),
        sp("frame", 0, 100, frame=7),
        # frame B [200, 300]: two queries (a frame off the fused path)
        sp("track.hash", 210, 215), sp("track.hash", 250, 256), sp("track.hash_scores", 230, 233),
        sp("frame", 200, 300, frame=8),
        # the mapping worker: events ending inside the traced part and not
        sp("map.hash", 40, 52, thread="mapping"), sp("map.hash", 120, 150, thread="mapping"),
        sp("map.hash", 995, 1010, thread="mapping"),
        # another thread's frame, and a frame past the traced part
        sp("track.hash", 510, 590, thread="other"), sp("frame", 500, 600, thread="other"),
        sp("track.hash", 1110, 1190), sp("frame", 1100, 1200, frame=9),
    ]


def traced_run(monkeypatch, spans):
    monkeypatch.setattr(program, "program_spans", lambda: spans)
    run = bench.Run()
    run.trace = trace.DeviceTrace([], 0, 1000)
    return run


def test_hash_readers_on_made_up_spans(monkeypatch):
    run = traced_run(monkeypatch, made_spans())
    # (15 + 4) + (5 + 6 + 3) ns over the two traced frames of this thread
    assert bench.reader("hash_ms_per_frame.rt")(run) == pytest.approx((19 + 14) / 2 / 1e6)
    # the worker's events that end inside [0, 1000]
    assert bench.reader("map_hash_ms_per_kf.rt")(run) == pytest.approx((12 + 30) / 2 / 1e6)


def test_hash_readers_read_nothing_without_their_spans(monkeypatch):
    no_query = [s for s in made_spans() if s.name != "track.hash"]
    run = traced_run(monkeypatch, no_query)
    # the scores alone do not make a reading: the hash did not run
    assert bench.reader("hash_ms_per_frame.rt")(run) is None
    assert bench.reader("map_hash_ms_per_kf.rt")(run) is not None
    run = traced_run(monkeypatch, [s for s in made_spans() if s.name != "map.hash"])
    assert bench.reader("map_hash_ms_per_kf.rt")(run) is None
    assert bench.reader("hash_ms_per_frame.rt")(run) is not None
    # only an event that ends outside the traced part
    run = traced_run(monkeypatch, [sp("map.hash", 995, 1010, thread="mapping")])
    assert bench.reader("map_hash_ms_per_kf.rt")(run) is None
    for spans in (None, []):
        run = traced_run(monkeypatch, spans)
        assert bench.reader("hash_ms_per_frame.rt")(run) is None
        assert bench.reader("map_hash_ms_per_kf.rt")(run) is None
    run = traced_run(monkeypatch, made_spans())
    run.trace = None  # an untraced run
    assert bench.reader("hash_ms_per_frame.rt")(run) is None
    assert bench.reader("map_hash_ms_per_kf.rt")(run) is None


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13])
def test_fault_readings_at_the_cells_size(seed):
    reading, limits = fault_readings(CELL, seed)
    assert reading == fault_readings(CONTROL, seed)[0]
    assert reading["sound"] < 1e-9
    assert min(reading["unchanged"], reading["altered"]) > 2 * limits["ate_m"]
    # the limits file's upper reading is the least fault's, over its limit
    with open(f"{bench.HERE}/limits/{CELL}.json") as f:
        lim = json.load(f)
    assert lim["ate_m"]["lower"] < lim["ate_m"]["limit"] < lim["ate_m"]["upper"]
    assert lim["ate_m"]["upper"] <= min(reading["unchanged"], reading["altered"]) + 1e-3


def test_the_plain_hash_loads_neither_jax_nor_the_port():
    tops = fresh("import json, sys\nimport slambench.reference.mih\n"
                 "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not tops & {"jax", "jaxlib", "flax", "gf_orb_slam2_tpu", "gf_orb_slam2_tpu_torch"}
