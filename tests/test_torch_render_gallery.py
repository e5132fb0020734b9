"""The render family (`demos/render.py`) and the gallery (`demos/gallery.py`)
against the JAX package's: torch in float64 on the CPU, JAX on the CPU at
x64, the same scene drawn by both. An SVG has JAX's element count and its
numbers (pixel coordinates, radii, widths) within 1e-6; a GIF has JAX's
frame count and size. The renders that draw get JAX's own draws, rebuilt
here from the keys JAX's renders split. Both packages' GIFs go through
their native encoders where those are built.

Unmarked: three of tests/test_render_family.py's FAST renders, a short
EKF GIF, the registry and the gallery on two renders
(tests/test_gallery_embedded.py:47); every render has a `slow` test.
"""

import inspect
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.demos import render as jr
from rust_robotics_tpu_torch.demos import gallery as tg
from rust_robotics_tpu_torch.demos import render as tr

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F = jnp.float64
NUMBER = re.compile(r"-?\d+\.?\d*(?:e-?\d+)?")


def normals(k, shape):
    return np.asarray(jax.random.normal(k, shape, F))


def loop_normals(seed, steps, shape):
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(normals(sub, shape))
    return np.stack(out)


def rrt_uniforms(seed, n=300):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[0], (3,), F))(
        keys)[:n - 1])


def pf_draws(steps=90, particles=400):
    """render_gif_particle_filter's: k0 split off PRNGKey(3) for the cloud,
    then a subkey a step, split by `pf_step` into predict and resample."""
    key, k0 = jax.random.split(jax.random.PRNGKey(3))
    pred, unif = [], []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        k_pred, k_res = jax.random.split(sub)
        pred.append(normals(k_pred, (particles, 2)))
        unif.append(np.asarray(jax.random.uniform(k_res, (1,), F)))
    return normals(k0, (particles, 4)), np.stack(pred), np.stack(unif)


JAX_DRAWS = {
    "render_gif_particle_filter": pf_draws,
    "render_gif_rrt": lambda: rrt_uniforms(0),
    "render_svg_rrt": lambda: rrt_uniforms(0),
    "render_svg_mppi_value_grid": lambda: loop_normals(7, 50, (256, 25, 2)),
    "render_svg_mppi_track_progress": lambda: loop_normals(0, 55, (256, 25, 2)),
    "render_svg_mppi_racing_gate_progress": lambda: np.stack(
        [normals(k, (96, 12, 4)) for k in jax.random.split(jax.random.PRNGKey(0), 60)]),
    "render_svg_adap_rpf_mppi": lambda: loop_normals(5, 30, (256, 16, 2)),
}


def same_media(name, tmp_path, jax_kw=None, port_kw=None):
    """Render `name` with both packages into tmp_path; assert the SVGs'
    element counts and numbers (1e-6) or the GIFs' frame counts and sizes
    agree. Returns False where the render's source data is absent."""
    ext = ".gif" if "gif" in name else ".svg"
    a, b = str(tmp_path / f"jax_{name}{ext}"), str(tmp_path / f"torch_{name}{ext}")
    draws = {"draws": JAX_DRAWS[name]()} if name in JAX_DRAWS else {}
    if jr.RENDERS[name](a, **(jax_kw or {})) is None and not os.path.exists(a):
        assert tr.RENDERS[name](b, device="cpu") is None and not os.path.exists(b)
        return False
    tr.RENDERS[name](b, device="cpu", **draws, **(port_kw or {}))
    if ext == ".svg":
        with open(a) as fa, open(b) as fb:
            want, got = fa.read(), fb.read()
        assert got.count("<") == want.count("<"), name
        nw = np.array([float(x) for x in NUMBER.findall(want)])
        ng = np.array([float(x) for x in NUMBER.findall(got)])
        assert ng.shape == nw.shape, name
        np.testing.assert_allclose(ng, nw, atol=1e-6, rtol=0.0, err_msg=name)
    else:
        from PIL import Image

        with Image.open(a) as ia, Image.open(b) as ib:
            assert (ib.n_frames, ib.size) == (ia.n_frames, ia.size), name
    return True


def test_render_registry_matches_jax():
    assert set(tr.RENDERS) == set(jr.RENDERS) and len(tr.RENDERS) == 25
    assert sum(n.startswith("render_gif_") for n in tr.RENDERS) == 6
    drawing = {n for n, fn in tr.RENDERS.items() if "draws" in inspect.signature(fn).parameters}
    assert drawing == set(JAX_DRAWS)


@pytest.mark.parametrize("name", ["render_svg_branchout_multimodal_driving",
                                  "render_svg_safe_decode_nav",
                                  "render_svg_hierarchical_mapf_replanning"])
def test_fast_render_matches_jax(name, tmp_path):
    assert same_media(name, tmp_path)


def test_short_ekf_gif_matches_jax(tmp_path):
    assert same_media("render_gif_ekf_localization", tmp_path, dict(steps=12),
                      dict(steps=12))


def test_gallery_builds_subset(tmp_path):
    names = ["render_svg_path_planning", "render_svg_dubins"]
    index = tg.build_gallery(str(tmp_path), names=names, device="cpu")
    with open(index) as fh:
        page = fh.read()
    assert "render_svg_path_planning" in page and "FAILED" not in page
    assert sorted(os.listdir(tmp_path / "media")) == sorted(f"{n}.svg" for n in names)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(tr.RENDERS))
def test_every_render_matches_jax(name, tmp_path):
    if not same_media(name, tmp_path):
        pytest.skip(f"{name}: source data unavailable")
