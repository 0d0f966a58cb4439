"""The check against its control and the faults it must catch, on the CPU
at n = 1024 (a size a test run holds; control.py runs the same at the
cells' own size on the card)."""

import pytest
import torch

import control
import faults
from harness import bench

from conftest import SMALL_CONFIG, SMALL_TRAFFIC, WORKLOADS

SEED = 2 ** 33 + 17


def small_run(workload, fault=None):
    return bench.run(workload, SEED, 0.3, False, device="cpu", fault=fault,
                     config_overrides=SMALL_CONFIG, traffic_overrides=SMALL_TRAFFIC)[0]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    r = small_run(workload)
    assert r["correct"] and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) >= {"ct_per_s", "setup_s"}


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("side", ["reference", "control", "program"])
def test_control(workload, side):
    v = control.readings(workload, SEED, side, "cpu", None, SMALL_CONFIG, SMALL_TRAFFIC, 0.3)
    assert v.correct is (side != "control"), v.numbers
    per, batches = SMALL_TRAFFIC["judged_per_batch"], SMALL_TRAFFIC["judged_batches"] + 1
    # a run judges the kept batches its window reached, and its last
    assert v.judged == per * batches if side != "program" else per <= v.judged <= per * batches


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_faults_read_by_control(workload, fault):
    v = control.readings(workload, SEED, "program", "cpu", fault, SMALL_CONFIG, SMALL_TRAFFIC,
                         0.3)
    assert not v.correct, v.numbers


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_faults_are_caught(workload, fault):
    r = small_run(workload, faults.FAULTS[fault])
    assert r["correct"] is False and r["failed"] > 0


@pytest.mark.card
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = bench.run(WORKLOADS[0], SEED, 2.0, False, device="cuda")[0]
    assert r["correct"] and r["device"]["platform"] == "gpu"


def test_the_ntt_route_comes_from_the_traffic():
    from troy_tpu_torch.ops import ntt
    traffic = dict(SMALL_TRAFFIC, ntt_backend="pallas_mxu")
    r = bench.run(WORKLOADS[0], SEED, 0.3, False, device="cpu",
                  config_overrides=SMALL_CONFIG, traffic_overrides=traffic)[0]
    assert r["correct"] and ntt.get_ntt_backend() == "pallas_mxu"
    small_run(WORKLOADS[0])
    assert ntt.get_ntt_backend() == "sixstep"
