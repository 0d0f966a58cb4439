"""The benchmark's own tests, all on the CPU at n = 1024 (the card's run is
`python3 hebench/run.py ...`).  Run from the repository's root:

    python3 -m pytest hebench/tests -q
"""

import sys
from pathlib import Path

import pytest
import torch

HEBENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HEBENCH), str(HEBENCH.parent)]

SMALL_CONFIG = {"poly_modulus_degree": 1024, "security_level": "Nil"}
SMALL_TRAFFIC = {"batch": 4, "distinct_batches": 2, "min_batches": 3, "judged_batches": 2,
                 "judged_per_batch": 2}
WORKLOADS = ["bfv8k_q210.mul_relin.b64", "bfv8k_q210.rotate_rows.b64",
             "ckks8k_seal.mul_relin_rescale.b384"]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
