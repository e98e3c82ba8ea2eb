"""The port's BenchReport (`repro_torch.obs.report`) against the
reference's (`repro.obs.report`) on the same inputs."""
import json
import math

import numpy as np
import pytest
import torch

import repro_torch.obs as tobs
from repro.obs import report as ref
from repro_torch.obs import report as port

CONFIG = {"n": 1000, "theta": 0.8, "tags": ("a", "b"), "nan": math.nan}
METRICS = {"ms": np.float64(1.5), "count": np.int32(7),
           "nested": {"inf": math.inf, "vals": [1.0, -math.inf, 2]}}
PHASES = {"advance": 12.5, "finish": np.float32(40.0)}
COUNTERS = {"compiles": 3, "retraces": np.int64(0)}


def test_schema_and_exports():
    assert port.SCHEMA == ref.SCHEMA == "repro.bench/1"
    for name in ("SCHEMA", "bench_report", "validate_report",
                 "write_report", "phase_coverage", "json_safe"):
        assert getattr(tobs, name) is getattr(port, name)


def test_bench_report_equals_the_reference():
    got = port.bench_report("md_step", config=CONFIG, metrics=METRICS,
                            phases=PHASES, counters=COUNTERS)
    want = ref.bench_report("md_step", config=CONFIG, metrics=METRICS,
                            phases=PHASES, counters=COUNTERS)
    assert got == want
    assert json.dumps(got) == json.dumps(want)


@pytest.mark.parametrize("value", [
    math.nan, math.inf, 1.25, np.float32(2.5), np.float64(math.nan),
    np.int64(3), [math.nan, (1, math.inf)], {"a": {"b": -math.inf}},
    "text", None, True])
def test_json_safe_equals_the_reference(value):
    got, want = port.json_safe(value), ref.json_safe(value)
    assert json.dumps(got) == json.dumps(want)


@pytest.mark.parametrize("value,want", [
    (torch.tensor(1.5), 1.5), (torch.tensor(math.nan), None),
    (torch.tensor(7, dtype=torch.int32), 7),
    ({"x": torch.tensor(-math.inf)}, {"x": None})])
def test_json_safe_takes_zero_dim_tensors(value, want):
    assert port.json_safe(value) == want
    assert port.json_safe(value) == ref.json_safe(
        np.asarray(value) if isinstance(value, torch.Tensor)
        else {k: np.asarray(v) for k, v in value.items()})


BAD = [
    {"schema": "other/1", "bench": "", "config": [], "metrics": {},
     "phases": {}, "counters": {}},
    {"schema": "repro.bench/1", "bench": "x", "config": {}, "metrics": {},
     "phases": {"a": -1.0, "b": math.nan, "c": True}, "counters": {"n": 1.5}},
    {"schema": "repro.bench/1", "bench": "x", "config": {}, "metrics": {}},
]


@pytest.mark.parametrize("rep", BAD)
def test_validate_report_raises_the_reference_text(rep):
    with pytest.raises(ValueError) as got:
        port.validate_report(rep)
    with pytest.raises(ValueError) as want:
        ref.validate_report(rep)
    assert str(got.value) == str(want.value)


def test_write_report_and_phase_coverage(tmp_path):
    rep = port.bench_report("serve", config=CONFIG, metrics=METRICS,
                            phases=PHASES, counters=COUNTERS)
    a = port.write_report(str(tmp_path / "port.json"), rep)
    b = ref.write_report(str(tmp_path / "ref.json"), rep)
    assert open(a).read() == open(b).read()
    assert json.load(open(a))["metrics"]["nested"]["inf"] is None
    for wall in (0.0, 52.5, 105.0, 40.0):
        assert port.phase_coverage(rep, wall) == ref.phase_coverage(rep, wall)
    with pytest.raises(ValueError):
        port.write_report(str(tmp_path / "bad.json"), BAD[0])
