"""The last four MPPI demos of the headless family (adaptive temperature,
constraint discount, track progress, ADAP-RPF) against the JAX package's,
as tests/test_torch_headless_mppi.py holds the first four: 3 steps in
both packages on JAX's draws, JAX at x64 on the CPU, torch in float64 on
the CPU, output dicts equal within 1e-9 (discrete values exactly).
"""

import pytest
import torch

from test_torch_headless_mppi import MPPI, check_mppi_demo

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)


@pytest.mark.parametrize("name,kw,draws", MPPI[4:], ids=[m[0] for m in MPPI[4:]])
def test_mppi_demo_matches_jax_for_three_steps(monkeypatch, name, kw, draws):
    check_mppi_demo(monkeypatch, name, kw, draws)
