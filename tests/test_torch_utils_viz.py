"""`utils/` and `viz/` of the port against the JAX package's (tests/test_aux.py
and tests/test_bench_gate.py's cases): the CSV gate, the experiments
harness and the rasterizer are plain Python or NumPy copies and must give
the same results exactly; `nan_report` keys each leaf as
`jax.tree_util.keystr` does; the checkpoint round trip restores a state's
values bitwise, on its template's device and dtype; the roofline is held
to hand arithmetic on the H100's data-sheet peaks."""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.utils import bench_gate as jgate
from rust_robotics_tpu.utils import experiments as jexp
from rust_robotics_tpu.utils import profiling as jprof
from rust_robotics_tpu.viz import raster as jraster
from rust_robotics_tpu_torch.utils import bench_gate as tgate
from rust_robotics_tpu_torch.utils import checkpoint as tckpt
from rust_robotics_tpu_torch.utils import experiments as texp
from rust_robotics_tpu_torch.utils import profiling as tprof
from rust_robotics_tpu_torch.utils import roofline as troof
from rust_robotics_tpu_torch.viz import raster as traster

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

BASE = "name,score,elapsed_ms\na,1.0,12.5\nb,2.0,90.1\n"
GENERATED = [
    "name,score,elapsed_ms\na,1.0000000001,99.9\nb,2.0,1.2\n",
    "name,score,elapsed_ms\na,1.1,12.5\nb,2.0,90.1\n",
    "name,value\na,1\n",
    "name,score,elapsed_ms\na,1.0,12.5\n",
    "name,score,elapsed_ms\na,x,12.5\nb,2.0,90.1\n",
    "name,score,elapsed_ms\na,1.0\nb,2.0,90.1\n",
    "",
]


@pytest.mark.parametrize("generated", GENERATED)
def test_compare_csv_is_the_jax_package_s(generated):
    assert tgate.compare_csv(BASE, generated) == jgate.compare_csv(BASE, generated)


def test_write_csv_writes_the_jax_package_s_bytes(tmp_path):
    header, rows = ["name", "v", "t_ms"], [["a", 1.23456789012, 5.0], ["b", 2, "x"]]
    a = open(jgate.write_csv(tmp_path / "j.csv", header, rows)).read()
    b = open(tgate.write_csv(tmp_path / "t.csv", header, rows)).read()
    assert a == b and tgate.compare_csv(a, b) == []


def test_experiments_harness_is_the_jax_package_s():
    def run(variants, plans, exp):
        def fn(v, seed, scenario):
            return seed + (1.0 if v.name == "fast" else 0.0) + (0.5 if scenario == "b" else 0.0)

        reports = exp.run_experiment(variants, plans, fn, {"mean": lambda xs: float(np.mean(xs)),
                                                          "max": lambda xs: float(max(xs))})
        return exp.annotate_against_reference(reports, "baseline")

    out = []
    for exp in (jexp, texp):
        variants = [exp.VariantDescriptor("baseline"),
                    exp.VariantDescriptor("fast", parameters={"gain": 2.0})]
        plan = exp.ExperimentSamplingPlan(seeds=[0, 1, 2], scenarios=["a", "b"])
        assert plan.total_runs == 6
        out.append([(r.variant.name, r.observations, r.summary, r.reference_deltas)
                    for r in run(variants, plan, exp)])
    assert out[0] == out[1]
    assert out[1][1][3]["mean"] == 1.0
    for wins, losses in ((0, 0), (5, 1), (9, 3), (3, 9)):
        assert texp.sign_test_p_value(wins, losses) == jexp.sign_test_p_value(wins, losses)


def test_assert_deterministic_passes_bitwise_and_catches_changes():
    gen_out = tprof.assert_deterministic(
        lambda s: {"x": torch.randn(8, generator=torch.Generator().manual_seed(s)),
                   "n": [torch.tensor(3), (torch.zeros(2, dtype=torch.bool), "label")]}, 7,
        runs=3)
    assert gen_out["x"].shape == (8,)
    state = {"n": 0}

    def impure():
        state["n"] += 1
        return np.full((3,), float(state["n"]))

    with pytest.raises(AssertionError):
        tprof.assert_deterministic(impure)
    # -0.0 and 0.0 compare equal but are not the same bits
    flips = iter([torch.tensor([0.0]), torch.tensor([-0.0])])
    with pytest.raises(AssertionError, match="bitwise"):
        tprof.assert_deterministic(lambda: next(flips))


def test_nan_report_keys_are_jax_keystr_and_guard_finite():
    import collections

    nt = collections.namedtuple("NT", "x y")

    def tree(lib, nan):
        return {"b": [lib.ones(2), (lib.asarray([1.0, nan, np.inf]), nt(lib.ones(1), nan))],
                "a": lib.asarray([nan, 0.0]), "c": None, "i": lib.asarray([1, 2])}

    want = jprof.nan_report(tree(jnp, np.nan))
    got = tprof.nan_report({"b": [torch.ones(2), (torch.tensor([1.0, np.nan, np.inf]),
                                                  nt(torch.ones(1), np.nan))],
                            "a": torch.tensor([np.nan, 0.0]), "c": None,
                            "i": torch.tensor([1, 2])})
    assert got == want == {"['a']": 1, "['b'][1][0]": 2, "['b'][1][1].y": 1}
    good = {"a": torch.ones(3), "b": torch.zeros((2, 2))}
    assert tprof.nan_report(good) == {} and tprof.guard_finite(good) is good
    with pytest.raises(FloatingPointError, match="belief"):
        tprof.guard_finite({"a": torch.tensor([1.0, np.nan])}, "belief")


def test_wall_time_ms_and_trace(tmp_path):
    assert tprof.wall_time_ms(lambda: torch.ones((64, 64)) @ torch.ones((64, 64)), runs=3) > 0.0
    with tprof.trace(str(tmp_path / "trace")):
        torch.ones(16).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_checkpoint_round_trip(tmp_path):
    state = {"mean": torch.arange(8.0, dtype=torch.float64), "cov": torch.eye(3),
             "step": torch.tensor(7), "bank": [torch.randn(2, 3), (torch.ones(1),)]}
    path = tckpt.save_checkpoint(tmp_path, 7, state)
    assert path.endswith("step_7") and tckpt.latest_step(tmp_path) == 7
    tckpt.save_checkpoint(tmp_path, 12, state)
    assert tckpt.latest_step(tmp_path) == 12 and tckpt.latest_step(tmp_path / "none") is None
    restored = tckpt.load_checkpoint(tmp_path, 7, state)
    for a, b in zip(tprof._leaves(restored), tprof._leaves(state)):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype and torch.equal(a[1], b[1])
    # the template sets dtype and device; its shape must match
    like = {**state, "mean": torch.zeros(8, dtype=torch.float32)}
    assert tckpt.load_checkpoint(tmp_path, 7, like)["mean"].dtype == torch.float32
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_checkpoint(tmp_path, 7, {**state, "cov": torch.eye(4)})
    with pytest.raises(ValueError, match="structure"):
        tckpt.load_checkpoint(tmp_path, 7, {"mean": state["mean"]})


def test_roofline_against_hand_arithmetic():
    peaks = troof.card_peaks("NVIDIA H100 80GB HBM3")
    assert peaks is troof.H100_PEAK and peaks["bytes_per_s"] == 3.35e12
    assert troof.card_peaks("NVIDIA H100 PCIe")["bytes_per_s"] == 2.0e12
    with pytest.raises(ValueError, match="no data-sheet peaks"):
        troof.card_peaks("NVIDIA A100-SXM4-40GB")
    rate = 1.0e11  # EKF updates/s
    out = troof.roofline_extras({"ekf_updates_per_s": rate, "resampled_particles_per_s": 2e10,
                                 "wavefront_pallas_cells_per_s": 1e12, "unknown": 5.0,
                                 "chain_lm_iterations_per_s": 0.0})
    assert set(out) == {"ekf_update", "resampled_particle", "wavefront_sweep_cell_pallas"}
    ekf = out["ekf_update"]
    assert ekf["achieved_flops_per_s"] == rate * 122
    assert math.isclose(ekf["pct_of_compute_peak"], 100 * rate * 122 / 67e12, rel_tol=1e-12)
    assert math.isclose(ekf["pct_of_hbm_peak"], 100 * rate * 16.8 / 3.35e12, rel_tol=1e-12)
    assert ekf["expected_bound"] == "bytes"
    # resampling at P=1024: 7 + log2(1024) operations, 40 bytes a particle
    res = out["resampled_particle"]
    assert math.isclose(res["pct_of_compute_peak"], 100 * 2e10 * 17 / 67e12, rel_tol=1e-12)
    assert math.isclose(res["achieved_hbm_bytes_per_s"], 2e10 * 40, rel_tol=1e-12)
    # the grid kernel: 20 operations a cell and sweep at half the peak
    wav = out["wavefront_sweep_cell_pallas"]
    assert math.isclose(wav["pct_of_compute_peak"], 100 * 1e12 * 20 / 33.5e12, rel_tol=1e-12)


def _draw(mod):
    cfg = mod.CanvasConfig(width=96, height=80, x_range=(-5.0, 5.0), y_range=(-4.0, 4.0))
    f = mod.Frame(cfg)
    t = np.linspace(0, 2 * np.pi, 40)
    f.draw_path_xy(3 * np.cos(t), 2 * np.sin(t), mod.GROUND_TRUTH, width=2.5)
    f.draw_points_xy([0.0, 1.0, -4.9], [0.0, 1.5, 3.9], mod.MEASUREMENT, size=3.0)
    f.draw_circle(1.0, -1.0, 0.8, mod.ESTIMATED)
    f.draw_ellipse(-2.0, 1.0, 1.2, 0.5, 0.4, mod.ESTIMATED)
    f.draw_robot(0.5, 0.5, 0.7, 0.6, (0, 128, 0))
    blocked = np.zeros((10, 8), bool)
    blocked[2:5, 3] = True
    f.draw_grid(blocked, -5.0, -4.0, 1.0)
    f.draw_path_xy([4.0], [0.0], mod.OBSTACLE)
    svg = mod.SvgCanvas(cfg)
    svg.draw_path([0, 1, 2], [0, 1, 0])
    svg.draw_circle(1.0, 1.0, 0.5, fill=True)
    svg.draw_points([0.5], [-0.5])
    svg.draw_robot(-1.0, 0.0, 0.3)
    return f, svg


def test_raster_pixels_and_svg_are_the_jax_package_s(tmp_path):
    jf, jsvg = _draw(jraster)
    tf, tsvg = _draw(traster)
    assert np.array_equal(tf.rgb, jf.rgb) and (tf.rgb != 255).any()
    a = open(jsvg.save(tmp_path / "j.svg")).read()
    b = open(tsvg.save(tmp_path / "t.svg")).read()
    assert a == b


def test_gif_recorder_writes_frames_with_pil(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    tf, _ = _draw(traster)
    rec = traster.GifRecorder(tmp_path / "a.gif", tf.cfg)
    with pytest.raises(ValueError, match="no frames"):
        rec.finish()
    rec.add_frame(tf)
    rec.add_frame_with_delay(traster.Frame(tf.cfg), 3)
    path = rec.finish()
    with Image.open(path) as im:
        assert im.size == (96, 80) and im.n_frames == 2
    png = traster.save_png(tf, tmp_path / "a.png")
    assert np.array_equal(np.asarray(Image.open(png).convert("RGB")), tf.rgb)
