"""Two-process torch.distributed execution (the twin of
tests/parallel/test_multiproc.py): scripts/torch_multiproc_cpu_demo.py
starts two gloo processes of 4 CPU devices each; both shard one batch over
a (host=2, data=2, limb=2) mesh and check their own output shards bit for
bit against the unsharded step.  The process group meets through a
FileStore under the test's own directory (no TCP port); the demo kills its
workers at its one 90 s deadline, well inside this call's 120 s.  The unsharded step is held to the
JAX package's in tests/test_torch_step.py and test_torch_mesh.py."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_distributed_mul_relin(tmp_path):
    env = dict(os.environ)
    env.pop("TROY_MP_ROLE", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_multiproc_cpu_demo.py"),
         "--store", str(tmp_path / "store"), "--timeout", "90"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "multiproc demo OK" in proc.stdout
    assert proc.stdout.count("4 local shards verified bit-exact") == 2, proc.stdout
