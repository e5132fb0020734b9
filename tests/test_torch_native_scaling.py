"""The native host runtime (`native/`), the scaling report
(`demos/scaling_report.py`) and `solve_device`'s LM step against the JAX
package's and the port's own plain paths, on the CPU.

- The native parsers equal the port's pure-Python parsers and JAX's
  native ones on tests/test_native_runtime.py's inputs, and reject its
  garbage; the port's `NativeGifWriter` writes JAX's bytes on the same
  RGB frames; `GifRecorder` streams through it.
- `run_scaling_report((1, 2), per_device_batch=4, steps=8, reps=2)` on
  the gloo fake cluster (tests/test_train.py:81-88): its one-rank loss is
  JAX's one-device loss on JAX's batch (given as `draws=`), at the f32
  rtol 1e-4 of tests/test_torch_train.py; the chain sweep's rows.
- `solve_device`'s loop (the step it replays as a CUDA graph on the card)
  is the eager loop of `device_lm_start`'s step on the CPU, bitwise.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from rust_robotics_tpu import native as jn
from rust_robotics_tpu.slam import g2o as jg2o
from rust_robotics_tpu_torch import native as tn
from rust_robotics_tpu_torch.data import moving_ai as tmai
from rust_robotics_tpu_torch.slam import g2o as tg2o
from test_native_runtime import G2O_TEXT, MAP_TEXT

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

SCEN_TEXT = ("version 1\n0\ta.map\t5\t4\t0\t0\t4\t0\t4.0\n"
             "1 a.map 5 4 1 1 3 3 2.828427\n")
BAD_MAPS = ["type hex\nheight 1\nwidth 1\nmap\n.",
            "type octile\nheight 2\nwidth 2\nmap\n..\n.X\n",
            "type octile\nheight 3\nwidth 2\nmap\n..\n..\n"]


def test_native_runtime_builds():
    assert tn.available() and jn.available()


def test_map_and_scenario_parsers_match():
    want = tmai._parse_map_py(MAP_TEXT)
    got = tmai.parse_map(MAP_TEXT)
    w, h, passable, tiles = tn.parse_map_native(MAP_TEXT)
    jw, jh, jpassable, jtiles = jn.parse_map_native(MAP_TEXT)
    assert (got.width, got.height) == (want.width, want.height) == (w, h) == (jw, jh)
    assert np.array_equal(got.tiles, want.tiles) and np.array_equal(tiles, jtiles)
    assert np.array_equal(passable, jpassable) and np.array_equal(got.passable(),
                                                                  want.passable())
    assert tmai.parse_scenarios(SCEN_TEXT) == tmai._parse_scenarios_py(SCEN_TEXT)
    for a, b in zip(tn.parse_scenarios_native(SCEN_TEXT), jn.parse_scenarios_native(SCEN_TEXT)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_g2o_parser_matches():
    got, want = tg2o.parse_g2o(G2O_TEXT), tg2o._parse_g2o_py(G2O_TEXT)
    assert tg2o.write_g2o(got) == tg2o.write_g2o(want) == jg2o.write_g2o(jg2o.parse_g2o(G2O_TEXT))
    for (af, at, am, ai), (bf, bt, bm, bi) in zip(got.edges_se2, want.edges_se2):
        assert (af, at) == (bf, bt)
        np.testing.assert_array_equal(am, bm)
        np.testing.assert_array_equal(ai, bi)
    for a, b in zip(got.edges_se3, want.edges_se3):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    nat, jnat = tn.parse_g2o_native(G2O_TEXT), jn.parse_g2o_native(G2O_TEXT)
    assert sorted(nat) == sorted(jnat)
    for k in nat:
        np.testing.assert_array_equal(nat[k], jnat[k])


@pytest.mark.parametrize("case", range(len(BAD_MAPS) + 1))
def test_native_parsers_reject_garbage(case):
    with pytest.raises(ValueError):
        if case == len(BAD_MAPS):
            tn.parse_g2o_native("EDGE_SE2 0 1 nope 0 0 1 0 0 1 0 1")
        else:
            tn.parse_map_native(BAD_MAPS[case])


def test_gif_writer_bytes_equal_jax_and_decode(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, size=(24, 32, 3), dtype=np.uint8) for _ in range(3)]
    paths = []
    for mod in (tn, jn):
        path = str(tmp_path / f"{mod.__name__}.gif")
        w = mod.NativeGifWriter(path, 32, 24)
        for fr in frames:
            w.add_frame(fr, delay_cs=7)
        assert w.close() == 3
        paths.append(path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    with Image.open(paths[0]) as im:
        for i, fr in enumerate(frames):
            im.seek(i)
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                          tn.quantize_rgb_native(fr))
    rgb = np.full((20, 30, 3), 255, np.uint8)
    pts = np.array([[2, 2], [27, 2], [27, 17], [-5, 40]], np.int32)
    assert tn.draw_polyline_native(rgb, pts, 1, (10, 20, 30))
    assert tuple(rgb[17, 27]) == (10, 20, 30) and tuple(rgb[0, 29]) == (255, 255, 255)


def test_gif_recorder_streams_natively(tmp_path):
    from rust_robotics_tpu_torch.viz.raster import CanvasConfig, Frame, GifRecorder

    cfg = CanvasConfig(width=40, height=40)
    rec = GifRecorder(tmp_path / "rec.gif", cfg)
    assert rec._native is not None
    fr = Frame(cfg)
    fr.draw_points_xy([0.0], [0.0], (216, 84, 60), 4)
    rec.add_frame(fr)
    assert open(rec.finish(), "rb").read()[:3] == b"GIF"


@functools.lru_cache(maxsize=None)
def jax_scaling():
    """JAX's one-device row and batch (tests/test_train.py:81-88's sizes)."""
    from rust_robotics_tpu.demos.scaling_report import run_scaling_report
    from rust_robotics_tpu.train import synthesize_batch

    batch = synthesize_batch(jax.random.PRNGKey(0), batch=4, steps=8, num_landmarks=16)
    return (run_scaling_report((1,), per_device_batch=4, steps=8, reps=2)[0],
            [np.array(x) for x in batch])


def test_scaling_report_on_the_fake_cluster_matches_jax():
    from rust_robotics_tpu_torch.demos.scaling_report import run_scaling_report

    want, batch = jax_scaling()
    rows = run_scaling_report((1, 2, 4096), per_device_batch=4, steps=8, reps=2,
                              device_type="cpu", draws={1: batch})
    assert [r["devices"] for r in rows] == [1, 2] and rows[0]["efficiency"] == 1.0
    assert sorted(rows[0]) == sorted(want)
    assert (rows[0]["mesh"], rows[0]["global_batch"]) == (want["mesh"], want["global_batch"])
    np.testing.assert_allclose(rows[0]["loss"], want["loss"], rtol=1e-4)
    for r in rows:
        assert r["global_batch"] == 4 * r["devices"] and np.isfinite(r["loss"])
        assert r["items_per_s"] > 0


def test_chain_weak_scaling_rows():
    from rust_robotics_tpu_torch.demos.scaling_report import run_chain_weak_scaling

    rows = run_chain_weak_scaling((1, 4096), poses_per_device=64, max_iterations=4, reps=1,
                                  device_type="cpu")
    assert [(r["devices"], r["poses"]) for r in rows] == [(1, 64)]
    assert rows[0]["efficiency"] == 1.0 and rows[0]["rmse"] < 5e-3


def test_solve_device_loop_is_the_eager_step_loop():
    """On the CPU `solve_device` runs `device_lm_start`'s step eagerly (the
    card replays its CUDA graph, held bitwise by chip_smoke.py phase 18):
    the loop, read cadence and result equal a hand-run loop bitwise."""
    from rust_robotics_tpu_torch.demos.pose_graph_bench import synthesize_se3_chain
    from rust_robotics_tpu_torch.nlls import solver
    from rust_robotics_tpu_torch.slam.pose_graph import pose_graph_3d_lm

    _, _, initial, ef, et, meas, info = synthesize_se3_chain(12)
    problem, config = pose_graph_3d_lm(initial, ef, et, meas, info, max_iterations=20,
                                       device="cpu", dtype=torch.float64)
    solved, summary = solver.solve_device(problem, config)
    state, step = solver.device_lm_start(problem, config)
    for k in range(config.max_iterations):
        if k and k % solver.DONE_READ_EVERY == 0 and bool(state.done):
            break
        state = step(state)
    assert torch.equal(solved.groups[0].values, state.values[0])
    assert summary.iterations == int(state.it) and summary.final_cost == float(state.cost)
    assert summary.termination != "numerical_failure" and not solver._STEPS
