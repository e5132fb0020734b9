"""The playground generator and the dataflow runtime
(`demos/{playground,dataflow}.py`) against the JAX package's: JAX on the
CPU at x64, torch in float64 on the CPU.

The playground's tabs are JSON of values rounded to 3–5 decimals, so the
port's tabs must equal JAX's byte for byte: the grid tab (12 wavefront
plans) and the ADMM tab at their full size against the checked-in
artifact `docs/playground/data.json` (which this file only reads) and,
for the grid tab, JAX's `_grid_planners_tab()`; the localization, SLAM
and arena tabs against JAX's tab functions at a small `steps`/`n`. The
arena's speed lanes are bitwise their solo rollouts. Dataflow's reports
equal JAX's: integers and waypoints exactly, floats within 1e-9.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.demos import dataflow as jd
from rust_robotics_tpu.demos import playground as jp
from rust_robotics_tpu_torch.demos import dataflow as td
from rust_robotics_tpu_torch.demos import playground as tp

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "docs", "playground", "data.json")
CPU = dict(device="cpu", dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def artifact():
    with open(ARTIFACT) as f:
        return json.load(f)


def dumps(tab):
    return json.dumps(tab, separators=(",", ":"))


def test_grid_tab_equals_the_artifact_and_jax():
    got = dumps(tp._grid_planners_tab(**CPU))
    assert got == dumps(artifact()["grid_planners"])
    assert got == dumps(jp._grid_planners_tab())


def test_admm_tab_equals_the_artifact():
    assert dumps(tp._admm_tab(**CPU)) == dumps(artifact()["admm_formation"])


@pytest.mark.parametrize("tab,kw", [("_localization_tab", dict(steps=24)),
                                    ("_slam_tab", dict(n=12)),
                                    ("_arena_tab", dict(steps=20))])
def test_tab_equals_jax_at_small_size(tab, kw):
    assert dumps(getattr(tp, tab)(**kw, **CPU)) == dumps(getattr(jp, tab)(**kw))


@pytest.mark.parametrize("name", tp.ARENA_CONTROLLERS)
def test_arena_speed_lanes_are_bitwise_their_solo_rollouts(name):
    lanes = tp.arena_rollouts(name, steps=12, **CPU)
    for lane, v in enumerate(tp.ARENA_SPEEDS):
        solo = tp.arena_rollouts(name, speeds=(v,), steps=12, **CPU)
        assert torch.equal(lanes[:, lane], solo[:, 0]), (name, v)


def test_main_writes_only_where_told(tmp_path, monkeypatch):
    # the tabs are held above; here the files, from a stub's data
    monkeypatch.setattr(tp, "build_playground_data", lambda device, dtype: {"tab": [1, 2]})
    out = tmp_path / "site"
    assert tp.main(str(out), device="cpu") == str(out)
    assert sorted(os.listdir(out)) == ["data.json", "index.html"]
    assert json.loads((out / "data.json").read_text()) == {"tab": [1, 2]}
    page = (out / "index.html").read_text()
    for marker in ("URLSearchParams", "history.replaceState", "copy share link", "data.json"):
        assert marker in page
    with pytest.raises(TypeError):
        tp.main()  # no default directory


# ---------------------------------------------------------------------------
# dataflow


def close_json(got, want):
    """Parsed JSON reports: ints, bools, lists of ints exactly, floats 1e-9."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, float):
            np.testing.assert_allclose(got[k], w, atol=1e-9, rtol=0.0, err_msg=k)
        elif isinstance(w, list) and w and isinstance(w[0], float):
            np.testing.assert_allclose(got[k], w, atol=1e-9, rtol=0.0, err_msg=k)
        else:
            assert got[k] == w, k


def test_path_planning_dataflow_matches_jax():
    reports, metrics = td.run_path_planning_dataflow(5, **CPU)
    j_reports, j_metrics = jd.run_path_planning_dataflow(5)
    assert len(reports) == len(metrics) == 5
    for got, want in zip(reports + metrics, j_reports + j_metrics):
        close_json(got, want)
    for rep, met in zip(reports, metrics):
        assert rep["found"] and met["waypoint_count"] == len(rep["waypoints"])
        assert met["euclidean_length"] == pytest.approx(rep["cost"], rel=1e-5)
    again, _ = td.run_path_planning_dataflow(5, **CPU)
    assert again == reports


def test_ekf_dataflow_matches_jax_on_its_draws():
    ticks = 50
    key, draws = jax.random.PRNGKey(7), []
    for _ in range(ticks):
        key, k1, k2 = jax.random.split(key, 3)
        draws.append(np.concatenate([np.asarray(jax.random.normal(k1, (2,), jnp.float64)),
                                     np.asarray(jax.random.normal(k2, (2,), jnp.float64))]))
    flow, est = td.build_ekf_dataflow(draws=np.stack(draws), **CPU)
    log = flow.run(ticks)
    j_flow, j_est = jd.build_ekf_dataflow()
    j_flow.run(ticks)
    assert len(est) == len(log) == ticks
    for got, want in zip(est, j_est):
        close_json(got, want)
    assert [json.loads(e["data"]) for e in log] == est
    assert est[-1]["position_error"] < 0.5


def test_dataflow_validates_wiring():
    bad = td.DataflowSpec([td.NodeSpec("n", {"x": "ghost/out"}, [], lambda e: None)])
    with pytest.raises(ValueError):
        td.Dataflow(bad)
    undeclared = td.DataflowSpec([td.NodeSpec("n", {"tick": "timer/millis/100"}, [],
                                              lambda e: {"oops": 1})])
    with pytest.raises(ValueError):
        td.Dataflow(undeclared).step()
    dup = td.DataflowSpec([td.NodeSpec("n", {}, [], lambda e: None)] * 2)
    with pytest.raises(ValueError):
        td.Dataflow(dup)
