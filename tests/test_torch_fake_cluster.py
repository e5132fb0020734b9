"""The port's multi-process fake cluster (rust_robotics_tpu_torch/parallel/
fake_cluster.py): each worker runs as two OS processes, two ranks of a gloo
group joined through a `file://` init method under pytest's tmp dir (no
port, so parallel test runs cannot collide).

Held, for each of the three workers (the DP+TP training step, the
systolic pipeline and the SPIKE chain LM, JAX's 512-pose chain):
- both processes print the same numbers;
- they match the port's one-process run of the same program, made in
  this process while the pairs run: the training loss (f32, the global
  batch of 8) within rel 1e-6, where two ranks sum each share in another
  order than one (1e-7 apart); the pipeline against the two stages
  composed in one process, its error <= 1e-6 (JAX's test); the chain's
  RMSE below 3·max(one-process RMSE, 1e-4) (the dryrun's program 6 gate)
  after at least 3 iterations.
"""

import contextlib
import io
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from rust_robotics_tpu_torch.parallel import fake_cluster

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODES = ("train", "pipeline", "spike")
LINES = {"train": r"FAKECLUSTER proc=(\d) (loss=\S+)",
         "pipeline": r"FAKEPIPE proc=(\d) err=(\S+) sum=(\S+)",
         "spike": r"FAKESPIKE proc=(\d) rmse=(\S+) cost=(\S+) iters=(\d+)"}
TIMEOUT_S = 300


def _parse(mode, text):
    m = re.search(LINES[mode], text)
    assert m, text
    return m.groups()


def _one_process(worker, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        worker(*args, **kwargs)
    return out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mode: [(proc, numbers...) of each process]} and {mode: the one-process
    run's line}; the six processes run while the one-process runs do."""
    tmp = tmp_path_factory.mktemp("cluster")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = {mode: [subprocess.Popen(
        [sys.executable, "-m", "rust_robotics_tpu_torch.parallel.fake_cluster",
         f"file://{tmp}/{mode}_store", "2", str(pid)] + ([] if mode == "train" else [mode]),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for pid in (0, 1)] for mode in MODES}
    try:
        one = {"train": _one_process(fake_cluster.run_worker, f"file://{tmp}/one_train", 1, 0,
                                     batch_per_proc=8),
               "spike": _one_process(fake_cluster.run_spike_worker, f"file://{tmp}/one_spike",
                                     1, 0)}
        outs = {}
        for mode, ps in procs.items():
            outs[mode] = []
            for p in ps:
                text, _ = p.communicate(timeout=TIMEOUT_S)
                assert p.returncode == 0, text
                outs[mode].append(_parse(mode, text))
    finally:
        for p in (p for ps in procs.values() for p in ps):
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs, one


@pytest.mark.parametrize("mode", MODES)
def test_both_processes_print_the_same_numbers(runs, mode):
    (p0, *n0), (p1, *n1) = runs[0][mode]
    assert {p0, p1} == {"0", "1"}
    assert n0 == n1


def test_training_step_matches_the_one_process_run(runs):
    loss = float(runs[0]["train"][0][1].split("=")[1])
    want = float(_parse("train", runs[1]["train"])[1].split("=")[1])
    assert np.isfinite(loss)
    assert loss == pytest.approx(want, rel=1e-6)


def test_pipeline_matches_the_composed_stages(runs):
    _, err, total = runs[0]["pipeline"][0]
    xs = torch.arange(10.0 * 3).reshape(10, 3) / 7.0
    for s in range(2):
        xs = torch.tanh(xs * (s + 1.5)) + s
    assert float(err) <= 1e-6
    assert float(total) == pytest.approx(float(torch.sum(xs)), rel=1e-6)


def test_spike_chain_matches_the_one_process_run(runs):
    _, rmse, cost, iters = runs[0]["spike"][0]
    _, want_rmse, _, _ = _parse("spike", runs[1]["spike"])
    assert np.isfinite(float(cost))
    assert float(rmse) < 3 * max(float(want_rmse), 1e-4)
    assert int(iters) >= 3
