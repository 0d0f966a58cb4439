"""Configurations, traffic mixes, limits and metrics are found by name."""

import json
from pathlib import Path

import pytest

from harness import arith as A, bench
from harness.scheme import Config

from conftest import WORKLOADS

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_spec_loads_by_name(workload):
    spec = bench.Spec(workload)
    cell = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert spec.cfg.name == cell["config"]
    for attr in ("ARITY", "SPANS", "LEVELS_DROPPED", "switch_keys", "step", "expected",
                 "reference"):
        assert hasattr(spec.op, attr), attr
    for attr in ("NTT_FORM", "AGGREGATE", "messages", "encrypt", "numbers"):
        assert hasattr(spec.scheme, attr), attr
    assert set(spec.limits) == set(spec.scheme.AGGREGATE)
    names = {m["name"] for m in spec.metrics}
    assert "setup_s" in names and "ct_per_s" in names
    traced = {m["name"] for m in bench.Spec(workload, trace=True).metrics}
    assert {"ntt.device_ms", "keyswitch.device_ms", "device_idle_pct"} <= traced


@pytest.mark.parametrize("overrides", [
    ({"scheme": "BGV"}, {}),                      # no schemes/bgv.py
    ({}, {"op": "rotate_vector"}),                # no ops/rotate_vector.py
    ({"scheme": "CKKS"}, {}),                     # no ops/mul_relin.ckks.py
], ids=["scheme", "op", "mismatch"])
def test_what_has_no_file_fails_at_setup(overrides):
    with pytest.raises(SystemExit):
        bench.Spec(WORKLOADS[0], config_overrides=overrides[0], traffic_overrides=overrides[1])


def test_overrides_reach_config_and_traffic():
    spec = bench.Spec(WORKLOADS[0], config_overrides={"poly_modulus_degree": 1024},
                      traffic_overrides={"batch": 4})
    assert spec.cfg.n == 1024 and spec.traffic["batch"] == 4


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    cfg = Config.load(ROOT / conf["file"])
    assert cfg.name == conf["name"] and conf["reduced"] == []
    for p in cfg.primes:
        assert A.is_prime(p) and p % (2 * cfg.n) == 1
    assert sum(p.bit_length() for p in cfg.primes) == sum(cfg.raw["coeff_modulus_bits"])
    if cfg.scheme == "BFV":
        assert A.is_prime(cfg.plain_modulus) and cfg.plain_modulus % (2 * cfg.n) == 1


def test_every_metric_has_a_reader_and_every_cell_its_files():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(bench.reader(m["name"]))
    for w in BENCH["workloads"]:
        assert (bench.HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (bench.HERE / "limits" / f"{w['name']}.json").exists()


def test_benchmark_json_shape():
    assert BENCH["command"] == ["python3", "hebench/run.py"]
    assert BENCH["paths"] == ["hebench"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] == "ct_per_s"
    # a full check of 24 cells fits the driver's day
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
