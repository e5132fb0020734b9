"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Each is checked in a fresh process,
by the top-level name of every module, compared whole: the port's name
begins with the JAX package's."""

import json
import subprocess
import sys

from benchmark import harness

GUARD = """
import json, sys, time
from pathlib import Path
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from benchmark import calibrate, harness, problems, tracing, workmodel
from benchmark.reference import se2_lm
from benchmark.tests import support
bench = harness.BENCH_DIR
for sub in ("configs", "traffic"):
    for path in sorted((bench / sub).glob("*.json")):
        json.loads(path.read_text())
for sub in ("kinds", "entries", "metrics"):
    for path in sorted((bench / sub).glob("*.py")):
        harness.load_module(path)
# a rehearsal of a run at a tiny size on the CPU, traced
import tempfile
tmp = Path(tempfile.mkdtemp())
bench_file, dirs = support.small_cell(tmp, "se2_chain_200", "fleet1024", graphs=2,
                                      check_requests=1)
result, _ = support.run(bench_file, dirs, seconds=0.1, trace=True)
assert result["correct"], result
print(json.dumps(sorted(set(m.split(".")[0] for m in sys.modules))))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import problems, workmodel
from benchmark.reference import se2_lm
print(json.dumps(sorted(set(m.split(".")[0] for m in sys.modules))))
"""


def _top_level_names(script):
    out = subprocess.run([sys.executable, "-c", script.format(root=str(harness.CHECKOUT))],
                         capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_a_run_load_no_jax():
    names = _top_level_names(GUARD)
    assert "rust_robotics_tpu_torch" in names  # the rehearsal ran the port
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = _top_level_names(REFERENCE)
    assert not names & {*harness.FORBIDDEN, "rust_robotics_tpu_torch"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rust_robotics_tpu_torch_extra", sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "rust_robotics_tpu", raising=False)
    assert "rust_robotics_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]
