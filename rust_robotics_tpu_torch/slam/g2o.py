"""g2o text I/O for SE(2) and SE(3):QUAT pose graphs.

The port of rust_robotics_tpu/slam/g2o.py. Reference: slam/src/g2o.rs —
parses and writes VERTEX_SE2, EDGE_SE2, VERTEX_SE3:QUAT and EDGE_SE3:QUAT
with upper-triangular information serialisation (:48, :137, :219-250).

Host code (numpy; the graph goes to the device through `se2_arrays` and
`convert.py`). `parse_g2o` runs the port's native C++ parser
(`rust_robotics_tpu_torch/native`) where it is built, as the JAX
package's does, and the pure-Python path (`_parse_g2o_py`, the reference
semantics) where it is not; the two give the same graph.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class G2oGraph:
    vertices_se2: dict  # id -> [x, y, theta]
    edges_se2: list  # (from, to, [dx, dy, dth], info [3, 3])
    vertices_se3: dict  # id -> (t [3], q [4] x, y, z, w)
    edges_se3: list  # (from, to, t [3], q [4], info [6, 6])


def _fill_upper(values, n):
    m = np.zeros((n, n))
    k = 0
    for i in range(n):
        for j in range(i, n):
            m[i, j] = values[k]
            m[j, i] = values[k]
            k += 1
    return m


def _upper_values(m):
    n = m.shape[0]
    return [m[i, j] for i in range(n) for j in range(i, n)]


def parse_g2o(text: str) -> G2oGraph:
    """Parse g2o text, natively where the host runtime is built; a
    malformed record raises ValueError."""
    from rust_robotics_tpu_torch import native

    if native.available():
        r = native.parse_g2o_native(text)
        return G2oGraph(
            vertices_se2={int(i): p for i, p in zip(r["v2_ids"], r["v2_pose"])},
            edges_se2=[
                (int(ij[0]), int(ij[1]), m, info)
                for ij, m, info in zip(r["e2_idx"], r["e2_meas"], r["e2_info"])
            ],
            vertices_se3={
                int(i): (p[:3].copy(), p[3:].copy())
                for i, p in zip(r["v3_ids"], r["v3_pose"])
            },
            edges_se3=[
                (int(ij[0]), int(ij[1]), m[:3].copy(), m[3:].copy(), info)
                for ij, m, info in zip(r["e3_idx"], r["e3_meas"], r["e3_info"])
            ],
        )
    return _parse_g2o_py(text)


def _parse_g2o_py(text: str) -> G2oGraph:
    """The pure-Python parser; a malformed record raises ValueError with
    its line."""
    g = G2oGraph({}, [], {}, [])
    for ln_no, ln in enumerate(text.splitlines(), 1):
        parts = ln.split()
        if not parts:
            continue
        tag = parts[0]
        try:
            if tag == "VERTEX_SE2":
                g.vertices_se2[int(parts[1])] = np.asarray(parts[2:5], float)
            elif tag == "EDGE_SE2":
                info = _fill_upper(np.asarray(parts[6:12], float), 3)
                g.edges_se2.append((int(parts[1]), int(parts[2]),
                                    np.asarray(parts[3:6], float), info))
            elif tag == "VERTEX_SE3:QUAT":
                g.vertices_se3[int(parts[1])] = (np.asarray(parts[2:5], float),
                                                 np.asarray(parts[5:9], float))
            elif tag == "EDGE_SE3:QUAT":
                info = _fill_upper(np.asarray(parts[10:31], float), 6)
                g.edges_se3.append((int(parts[1]), int(parts[2]),
                                    np.asarray(parts[3:6], float),
                                    np.asarray(parts[6:10], float), info))
        except (ValueError, IndexError) as e:
            raise ValueError(f"bad g2o record at line {ln_no}: {ln!r}") from e
    return g


def write_g2o(g: G2oGraph) -> str:
    out = []
    for vid in sorted(g.vertices_se2):
        x, y, th = g.vertices_se2[vid]
        out.append(f"VERTEX_SE2 {vid} {x} {y} {th}")
    for f, t, meas, info in g.edges_se2:
        vals = " ".join(str(v) for v in _upper_values(info))
        out.append(f"EDGE_SE2 {f} {t} {meas[0]} {meas[1]} {meas[2]} {vals}")
    for vid in sorted(g.vertices_se3):
        t, q = g.vertices_se3[vid]
        out.append(f"VERTEX_SE3:QUAT {vid} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}")
    for f, to, t, q, info in g.edges_se3:
        vals = " ".join(str(v) for v in _upper_values(info))
        out.append(f"EDGE_SE3:QUAT {f} {to} {t[0]} {t[1]} {t[2]} "
                   f"{q[0]} {q[1]} {q[2]} {q[3]} {vals}")
    return "\n".join(out) + "\n"


def se2_arrays(g: G2oGraph):
    """Dense arrays for `optimize_pose_graph_2d`: (poses [N, 3], ef, et,
    meas [E, 3], info [E, 3, 3]), the vertex ids re-indexed contiguously."""
    ids = sorted(g.vertices_se2)
    remap = {v: i for i, v in enumerate(ids)}
    poses = np.stack([g.vertices_se2[i] for i in ids])
    ef = np.array([remap[e[0]] for e in g.edges_se2], np.int32)
    et = np.array([remap[e[1]] for e in g.edges_se2], np.int32)
    meas = np.stack([e[2] for e in g.edges_se2])
    info = np.stack([e[3] for e in g.edges_se2])
    return poses, ef, et, meas, info
