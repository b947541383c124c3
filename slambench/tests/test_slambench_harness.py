"""The harness finds every cell, configuration, mix, limit and metric by its
file; BENCHMARK.json keeps to the contract's shape; and neither the harness
nor the reference loads JAX or the JAX package (the reference loads nothing
of the port either)."""
import json
import os
import re
import subprocess
import sys

import pytest

from slambench.core import bench

ROOT = bench.ROOT
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["slambench"] and SPEC["command"][1] == "slambench/run.py"
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        # every cut is in the file, with its reason
        with open(os.path.join(ROOT, c["file"])) as f:
            assert set(c["reduced"]) == set(json.load(f)["reduced"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for w in m["workloads"]:
            cell = bench.Cell(w)
            # the cell reports the end-to-end metric this one moves
            assert m["moves"] in {x["name"] for x in cell.metrics("end_to_end")}
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cells_are_found_by_name(workload):
    cell = bench.Cell(workload)
    assert cell.entry["chips"] == 1 and len(cell.entry["why"]) <= 200
    assert cell.limits and set(cell.limits) <= {"ate_m", "rpe_p95_m", "kf_ate_m", "map_err_m"}
    assert cell.traffic["entry"] in ("track_stereo", "track_rgbd")
    assert cell.traffic["rate_hz"] > 0
    from slambench.core import settings

    cfg = settings.system_config(cell.config)
    assert cfg.camera.width == cell.config["Camera.width"]
    kinds = {m["name"] for m in cell.metrics("end_to_end")}
    assert "setup_s" in kinds and len(kinds) >= 2 and cell.metrics("per_layer")
    for m in cell.metrics("end_to_end") + cell.metrics("per_layer"):
        assert callable(bench.reader(m["name"]))


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        bench.Cell("no_such.cell")


def fresh(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_loads_jax_or_the_jax_package():
    tops = fresh(
        "import json, sys\n"
        "import slambench.core.bench as b, slambench.core.trace, slambench.core.readers\n"
        "import slambench.core.settings, slambench.scene.hall, slambench.scene.motion\n"
        "import slambench.reference.check\n"
        "import gf_orb_slam2_tpu_torch.system\n"
        "for w in json.load(open('BENCHMARK.json'))['workloads']:\n"
        "    c = b.Cell(w['name'])\n"
        "    for m in c.metrics('end_to_end') + c.metrics('per_layer'): b.reader(m['name'])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    # whole top-level names: the port's name begins with the JAX package's
    assert not tops & {"jax", "jaxlib", "flax", "gf_orb_slam2_tpu"}
    assert "gf_orb_slam2_tpu_torch" in tops


def test_the_reference_loads_nothing_of_the_port():
    tops = fresh("import json, sys\nimport slambench.reference.check\n"
                 "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not tops & {"jax", "jaxlib", "flax", "gf_orb_slam2_tpu", "gf_orb_slam2_tpu_torch",
                       "torch"}


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "slambench/run.py", "--workload",
                          SPEC["workloads"][0]["name"], "--seed", str(2 ** 31 + 7),
                          "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
