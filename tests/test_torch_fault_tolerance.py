"""Fault injection on the port's CLI: SIGKILL a training run, resume.

A mirror of tests/test_fault_tolerance.py for
``python -m pylda_tpu_torch.cli.train --device cpu``: a real training
process is killed (no cleanup, no atexit) after its first snapshot lands,
then a fresh run resumes from the latest snapshot and finishes with the
full set of artifacts.  Snapshots are published atomically, so the
latest one always loads.
"""

import glob
import os
import subprocess
import sys
import time

import torch

from pylda_tpu_torch.cli.train import main as train_main
from pylda_tpu_torch.corpus.datasets import make_denews_tiny
from pylda_tpu_torch.models import Inferencer

ARGS = ["--number_of_topics=5", "--snapshot_interval=2",
        "--inner_iterations=10", "--seed=1", "--device=cpu"]


def test_kill_and_resume(tmp_path):
    corpus_dir = str(tmp_path / "corpus")
    make_denews_tiny(corpus_dir, num_train=80, num_test=20,
                     mean_doc_length=25)
    out = str(tmp_path / "out")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)}
    # 200 iterations: far more than it is let finish.
    proc = subprocess.Popen(
        [sys.executable, "-m", "pylda_tpu_torch.cli.train",
         f"--input_directory={corpus_dir}", f"--output_directory={out}",
         "--training_iterations=200", *ARGS],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
    )
    try:
        deadline = time.time() + 240
        while time.time() < deadline:
            if glob.glob(os.path.join(out, "*", "*", "model-*")):
                break
            if proc.poll() is not None:
                raise AssertionError("training exited early:\n"
                                     + proc.stdout.read()[-2000:])
            time.sleep(0.2)
        else:
            raise AssertionError("no snapshot appeared before the deadline")
    finally:
        proc.kill()  # SIGKILL: no graceful shutdown
        proc.wait(timeout=60)
    assert proc.returncode == -9

    latest = max(glob.glob(os.path.join(out, "*", "*", "model-*")),
                 key=lambda p: int(p.rsplit("-", 1)[1]))
    n = int(latest.rsplit("-", 1)[1])
    assert Inferencer.load(latest, device="cpu")._counter == n

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rc = train_main([f"--input_directory={corpus_dir}",
                         f"--output_directory={out}",
                         f"--training_iterations={n + 2}",
                         f"--resume={latest}", *ARGS])
    finally:
        torch.set_num_threads(prev)
    assert rc == 0
    assert glob.glob(os.path.join(out, "*", "*", f"model-{n + 2}"))
    assert glob.glob(os.path.join(out, "*", "*", f"exp_beta-{n + 2}"))
    resumed = Inferencer.load(
        glob.glob(os.path.join(out, "*", "*", f"model-{n + 2}"))[0],
        device="cpu")
    assert resumed._counter == n + 2
