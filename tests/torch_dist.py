"""Start the ranks of a multi-process CPU run of the port and read their
results (``tests/torch_dist_worker.py``).

Each rank is a subprocess joined through a ``file://`` rendezvous under
the test's own directory (never a fixed port: several test workers run
at once), with one thread, a 60 s group timeout and a limit on its run.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dist_worker.py")
# Seconds a rank may run (the group's own timeout is 60 s).
RANK_LIMIT = 120


def rank_env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    return env


def wait_all(procs, limit: float = RANK_LIMIT) -> list:
    """Each process's output, failing with it when one exits non-zero;
    one still running after ``limit`` seconds is killed."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=limit)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} exited {p.returncode}:\n" + \
            out[-4000:]
    return outs


def run_ranks(case: str, spec: dict, tmp_path, world: int = 2,
              limit: float = RANK_LIMIT) -> list:
    """Run ``case`` on ``world`` ranks; returns each rank's results (a
    dict of numpy arrays and scalars), in rank order.  Fails with the
    ranks' output when one exits non-zero or outlives ``limit``."""
    d = tmp_path / f"ranks_{case}_{len(list(tmp_path.glob('ranks_*')))}"
    d.mkdir()
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, case, str(r), str(world),
             str(d / "rendezvous"), str(d / f"rank{r}.npz"),
             json.dumps(spec)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=rank_env(),
        )
        for r in range(world)
    ]
    wait_all(procs, limit)
    results = []
    for r in range(world):
        with np.load(d / f"rank{r}.npz", allow_pickle=False) as z:
            res = {k: z[k] for k in z.files}
        res["collectives"] = json.loads(str(res["collectives"]))
        results.append(res)
    return results


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def norm_rel(got, want) -> float:
    """||got - want|| / ||want|| in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))
