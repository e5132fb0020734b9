"""The GPipe schedule (`parallel/pipeline.py`) and the windowed VIO
pipeline (`slam/vio_pp.py`) against the JAX package's, on
tests/fixture_gen.py's synthetic EuRoC layout cut to 0.8 s (three 3-frame
windows; tests/test_pipeline_pp.py runs JAX on the 2 s sequence in ~100 s):
JAX on the CPU at x64, torch in float64 on the CPU. The JAX pipeline runs
once per process (~24 s, most of this file's time).

Tolerances: `pipeline_schedule` equal to JAX's; `run_pipelined` against
`run_sequential` (a chain stage, dict and dataclass stage values moved
between devices) and the windowed pipeline pipelined against sequential:
bitwise; the windowed pipeline against JAX: within 1e-9 (~1e-15 measured).
"""

import dataclasses
import functools

import pytest
import numpy as np
import torch

from fixture_gen import make_euroc_fixture

from rust_robotics_tpu.data.euroc import EurocDataset as JEuroc
from rust_robotics_tpu.parallel.pipeline import pipeline_schedule as j_schedule
from rust_robotics_tpu.slam import vio_pp as jpp
from rust_robotics_tpu_torch.data.euroc import EurocDataset
from rust_robotics_tpu_torch.parallel.pipeline import (
    Stage,
    pipeline_schedule,
    run_pipelined,
    run_sequential,
)
from rust_robotics_tpu_torch.slam import vio_pp as tpp

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = torch.float64
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def euroc_short(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("euroc_short"))
    make_euroc_fixture(root, duration=0.8)
    return root


def test_pipeline_schedule_matches_jax():
    for w, s in ((4, 3), (1, 4), (5, 1), (67, 4)):
        assert pipeline_schedule(w, s) == j_schedule(w, s)


@dataclasses.dataclass(frozen=True)
class _Packet:
    x: torch.Tensor
    tag: str


def test_run_pipelined_equals_sequential_with_chain_stage():
    scale = Stage(lambda p: {"v": 2.0 * p["v"], "packet": p["packet"]})
    accum = Stage(lambda c, p: (c + torch.sum(p["v"]), {**p, "v": p["v"] + c}), chain=True,
                  init_carry=torch.zeros((), dtype=F64))
    square = Stage(lambda p: (p["v"] * p["v"], p["packet"].x + 1.0, p["packet"].tag))
    stages = [scale, accum, square]
    windows = [{"v": torch.arange(3.0, dtype=F64) + i,
                "packet": _Packet(torch.full((2,), float(i), dtype=F64), f"w{i}")}
               for i in range(5)]
    record = []
    got = run_pipelined(stages, windows, devices=[CPU, CPU], record=record)
    want = run_sequential(stages, windows)
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1]) and g[2] == w[2]
    assert record == pipeline_schedule(5, 3)


@functools.lru_cache(maxsize=None)
def _jax_windowed(root):
    ds = JEuroc.load(root)
    return jpp.run_vio_pipeline_windowed(ds, ds.load_feature_tracks(), window_frames=3,
                                         pipelined=False)


def test_windowed_vio_pipelined_equals_sequential_and_jax(euroc_short):
    ds = EurocDataset.load(euroc_short)
    tracks = ds.load_feature_tracks()
    seq = tpp.run_vio_pipeline_windowed(ds, tracks, window_frames=3, pipelined=False,
                                        device=CPU, dtype=F64)
    pipe = tpp.run_vio_pipeline_windowed(ds, tracks, window_frames=3, pipelined=True,
                                         device=CPU, dtype=F64)
    assert pipe.num_windows == seq.num_windows == 3
    for name in ("fused_poses", "dead_reckoned", "refined_body"):
        assert torch.equal(getattr(pipe, name), getattr(seq, name)), name
    assert pipe.schedule == pipeline_schedule(3, 4) and seq.schedule == []
    want = _jax_windowed(euroc_short)
    assert want.num_windows == 3
    for name in ("fused_poses", "dead_reckoned", "refined_body"):
        np.testing.assert_allclose(getattr(seq, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-9, err_msg=name)
