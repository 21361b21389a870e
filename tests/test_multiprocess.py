"""True multi-process (multi-controller) validation on CPU.

Separate JAX processes form one cluster via ``jax.distributed.initialize``
with gloo CPU collectives -- the closest an unnetworked single host gets
to a multi-host pod. The worker (tests/_mp_worker.py) runs the production
sharded tile step over a process-spanning (tile=2, splat=2) mesh
(cross-process psum/all_gather/ppermute), checks it against the
single-device fused step, and round-trips the process-spanning sharded
state through the orbax checkpointer.

Covered cluster shapes:
- 2 processes x 2 local devices (tile axis crosses processes);
- 4 processes x 1 local device (BOTH mesh axes cross processes on every
  edge), saving a checkpoint that a 2-process cluster then restores and
  resumes from -- elastic resume across a process-count change.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_cluster(nproc, local_devices, ckdir, combine, phase, timeout=600):
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    worker = os.path.join(repo, "tests", "_mp_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(pid), str(nproc),
         str(local_devices), str(ckdir), combine, phase],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(nproc)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert "MP_WORKER_OK" in out, out[-4000:]
    # All controllers computed the same loss.
    mses = {out.split("mse=")[1].split()[0] for out in outs}
    assert len(mses) == 1, mses
    return outs


@pytest.mark.parametrize("combine", ["fold", "scan"])
def test_two_process_sharded_step(tmp_path, combine):
    """fold = all_gather prefix; scan = log-depth ppermute ring -- both
    cross PROCESS boundaries here."""
    _run_cluster(2, 2, tmp_path / "ck", combine, "fit_save")


def test_four_process_step_then_two_process_resume(tmp_path):
    """4 x 1-device controllers (tile AND splat axes both span processes)
    fit + checkpoint; a 2 x 2-device cluster restores that checkpoint onto
    its own mesh and resumes -- process-count elasticity via orbax."""
    ck = tmp_path / "ck"
    _run_cluster(4, 1, ck, "fold", "fit_save")
    _run_cluster(2, 2, ck, "fold", "restore_check")
