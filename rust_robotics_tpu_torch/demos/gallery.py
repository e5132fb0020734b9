"""Static HTML gallery of the render family — the analog of the
reference's GitHub-Pages gallery site (.github/workflows/pages.yml builds
the egui/wasm playground + a media gallery from the render_* examples).

The port of rust_robotics_tpu/demos/gallery.py. `build_gallery(outdir)`
runs every entry of demos/render.RENDERS (or a subset) on `device`
(default cuda) into `outdir/media/` and writes `outdir/index.html`: a
dependency-free static page grouping the GIF demos and SVG figures, each
tile naming its reference example. `main(outdir)` has no default
directory: it writes only where it is told.
"""

from __future__ import annotations

import html
import os

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch.demos.render import RENDERS

_PAGE = """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<title>rust_robotics_tpu gallery</title>
<style>
body {{ font-family: system-ui, sans-serif; margin: 2rem; background: #fafafa; }}
h1 {{ font-size: 1.4rem; }} h2 {{ font-size: 1.1rem; margin-top: 2rem; }}
p.sub {{ color: #555; }}
.grid {{ display: grid; grid-template-columns: repeat(auto-fill, minmax(320px, 1fr)); gap: 1rem; }}
.tile {{ background: #fff; border: 1px solid #ddd; border-radius: 6px; padding: .6rem; }}
.tile img, .tile object {{ width: 100%; height: auto; background: #fff; }}
.tile figcaption {{ font-size: .85rem; color: #333; margin-top: .4rem; font-family: monospace; }}
</style></head><body>
<h1>rust_robotics_tpu — demo gallery</h1>
<p><a href="../playground/index.html">→ interactive playground (five tabs, shareable URL state)</a></p>
<p class="sub">Deterministic closed-loop sims rendered by the software
rasterizer (viz/raster.py). Each tile is the analog of the reference
example of the same name (crates/rust_robotics/examples/render_*).</p>
<h2>Animated (GIF)</h2>
<div class="grid">{gifs}</div>
<h2>Figures (SVG)</h2>
<div class="grid">{svgs}</div>
</body></html>
"""

_TILE = """<figure class="tile"><img src="media/{fname}" alt="{name}">
<figcaption>{name}</figcaption></figure>"""


def build_gallery(outdir, names=None, device=None):
    """Render `names` (default: all RENDERS) on `device` and write
    index.html.

    Returns the index path. Entries that raise are skipped with a note
    tile rather than failing the whole gallery build."""
    device = resolve_device(device)
    media = os.path.join(outdir, "media")
    os.makedirs(media, exist_ok=True)
    gifs, svgs, failures = [], [], []
    for name in sorted(names or RENDERS):
        fn = RENDERS[name]
        ext = "gif" if "gif" in name else "svg"
        fname = f"{name}.{ext}"
        try:
            fn(os.path.join(media, fname), device=device)
        except Exception as exc:  # noqa: BLE001 — record, keep building
            failures.append((name, str(exc)))
            continue
        tile = _TILE.format(fname=html.escape(fname), name=html.escape(name))
        (gifs if ext == "gif" else svgs).append(tile)
    for name, err in failures:
        svgs.append(
            f'<figure class="tile"><figcaption>{html.escape(name)}: '
            f'FAILED — {html.escape(err[:200])}</figcaption></figure>')
    index = os.path.join(outdir, "index.html")
    with open(index, "w") as f:
        f.write(_PAGE.format(gifs="\n".join(gifs), svgs="\n".join(svgs)))
    return index


def main(outdir, names=None, device=None):
    path = build_gallery(outdir, names, device=device)
    print(f"gallery: {path}")
    return path


if __name__ == "__main__":
    import sys

    if len(sys.argv) < 2:
        sys.exit("usage: python -m rust_robotics_tpu_torch.demos.gallery OUTDIR")
    main(sys.argv[1])
