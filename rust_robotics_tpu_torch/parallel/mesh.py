"""Device mesh, placement and collectives over `torch.distributed`.

The port of rust_robotics_tpu/parallel/mesh.py. The JAX package names two
mesh axes (SURVEY.md §2.12): `data` for independent batches (filter banks,
trajectories, particles) and `model` for split state (landmarks, factor
blocks). JAX writes a program once for the whole mesh (`shard_map`) and
XLA places the collectives; here every rank runs the `shard_map` body on
its own shard (SPMD), and the collectives are explicit calls on the axis's
process group:

| JAX | here |
|---|---|
| `Mesh` | `torch.distributed.device_mesh.DeviceMesh` (`make_mesh`) |
| `psum`, `pmax`, `pmin` | `all_reduce` (SUM, MAX, MIN) on the axis group |
| `all_gather` | `all_gather_into_tensor`, stacked [S, ...] in rank order |
| `axis_index` | `mesh.get_local_rank(axis)` |
| `ppermute` | paired sends and receives (`batch_isend_irecv`) |

A mesh on `cuda` runs NCCL, one rank per card; on `cpu` it runs gloo.
Nothing falls back from one to the other: a `cuda` mesh without NCCL or a
card raises. NCCL takes one rank per card, so one H100 holds a one-rank
mesh. Its all-reduces, all-gathers and broadcasts still go through the
backend (a one-rank NCCL collective is a device copy); a ring on a
one-rank axis is a local copy, as JAX's `ppermute` is there (gloo refuses
a send to one's own rank). `COLLECTIVES` counts the calls by kind.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

# calls of each collective since the last reset (set the entries to 0)
COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "broadcast": 0, "send_recv": 0,
               "local_copy": 0}


def _check_device_type(device_type: str) -> str:
    if device_type not in _BACKENDS:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device_type='cpu' to run "
                               "the mesh on the CPU (gloo)")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL; pass device_type='cpu' to run the "
                               "mesh on the CPU (gloo)")
    return _BACKENDS[device_type]


def init_process_group(rank: int = 0, world_size: int = 1, store=None, device_type: str = "cuda"):
    """Initialise the default process group: NCCL on `cuda` (this rank on
    card `rank % device_count`), gloo on `cpu`. `store` is a
    `torch.distributed.Store` all ranks share (a `FileStore` or a
    `TCPStore`); a one-rank group takes a `HashStore` by default."""
    backend = _check_device_type(device_type)
    if store is None:
        if world_size != 1:
            raise ValueError("a group of more than one rank needs a shared store")
        store = dist.HashStore()
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)


def make_mesh(n_devices: int | None = None, data_axis: int | None = None,
              axis_names=("data", "model"), device_type: str = "cuda") -> DeviceMesh:
    """A ('data', 'model') mesh over the ranks of the initialised default
    group, row-major as JAX's `devices.reshape(data, model)`. The model
    axis gets 2 when n is even and >= 4 (JAX mesh.py:37-41). With one axis
    name the mesh is flat. Raises if the default group's backend does not
    belong to `device_type`."""
    backend = _check_device_type(device_type)
    if not dist.is_initialized():
        raise RuntimeError("initialise the default process group first (init_process_group)")
    if dist.get_backend() != backend:
        raise RuntimeError(f"a {device_type} mesh needs the {backend} backend, "
                           f"the default group runs {dist.get_backend()}")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"the mesh spans every rank: n_devices={n}, world size {world}")
    axis_names = tuple(axis_names)
    if len(axis_names) == 1:
        return init_device_mesh(device_type, (n,), mesh_dim_names=axis_names)
    if data_axis is None:
        model = 2 if n % 2 == 0 and n >= 4 else 1
        data_axis = n // model
    model = n // data_axis
    if data_axis * model != n:
        raise ValueError(f"data axis {data_axis} does not divide {n} ranks")
    return init_device_mesh(device_type, (data_axis, model), mesh_dim_names=axis_names)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axes(axes):
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh: DeviceMesh, axes) -> int:
    """The number of ranks along one axis or the product over several."""
    n = 1
    for a in _axes(axes):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis` (JAX `lax.axis_index`)."""
    return mesh.get_local_rank(axis)


def psum(x: torch.Tensor, mesh: DeviceMesh, axes) -> torch.Tensor:
    """The sum of x over the ranks of one axis or of several (JAX
    `lax.psum`), on every rank. A new tensor; x is left as it was."""
    return _all_reduce(x, mesh, axes, dist.ReduceOp.SUM)


def _all_reduce(x, mesh, axes, op):
    out = x.clone()
    for a in _axes(axes):
        dist.all_reduce(out, op=op, group=mesh.get_group(a))
        COLLECTIVES["all_reduce"] += 1
    return out


def pmax(x: torch.Tensor, mesh: DeviceMesh, axes) -> torch.Tensor:
    """The elementwise maximum of x over the ranks of one axis or of several
    (JAX `lax.pmax`), on every rank."""
    return _all_reduce(x, mesh, axes, dist.ReduceOp.MAX)


def pmin(x: torch.Tensor, mesh: DeviceMesh, axes) -> torch.Tensor:
    """The elementwise minimum of x over the ranks of one axis or of several
    (JAX `lax.pmin`), on every rank."""
    return _all_reduce(x, mesh, axes, dist.ReduceOp.MIN)


_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """x of every rank along `axis`, stacked [S, *x.shape] in rank order
    (JAX `lax.all_gather`)."""
    s = axis_size(mesh, axis)
    flat = x.contiguous().reshape(-1)
    out = torch.empty((s * flat.numel(),), dtype=x.dtype, device=x.device)
    _all_gather_single(out, flat, group=mesh.get_group(axis))
    COLLECTIVES["all_gather"] += 1
    return out.reshape(s, *x.shape)


def ppermute(x: torch.Tensor, mesh: DeviceMesh, axis: str, perm) -> torch.Tensor:
    """JAX `lax.ppermute`: perm lists (source, destination) pairs of axis
    coordinates; a rank receives the x of the source that names it, or
    zeros if none does. A pair (i, i) is a local copy."""
    me = axis_index(mesh, axis)
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out = x.clone()
            COLLECTIVES["local_copy"] += 1
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), ranks[dst], group))
        elif dst == me:
            out = torch.empty_like(x, memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.irecv, out, ranks[src], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        COLLECTIVES["send_recv"] += 1
    return out


def broadcast(x: torch.Tensor, mesh: DeviceMesh, axis: str, src: int) -> torch.Tensor:
    """x of the rank at coordinate `src` along `axis`, on every rank of it."""
    group = mesh.get_group(axis)
    out = x.contiguous().clone()
    dist.broadcast(out, src=dist.get_global_rank(group, src), group=group)
    COLLECTIVES["broadcast"] += 1
    return out


def local_shard(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of x along `dim`, split evenly over
    `axis` (the placement of JAX's `shard_batch`/`shard_landmarks`)."""
    s = axis_size(mesh, axis)
    n = x.shape[dim]
    if n % s:
        raise ValueError(f"dim {dim} of size {n} does not split over {s} ranks")
    c = n // s
    return x.narrow(dim, axis_index(mesh, axis) * c, c)


def gather_shards(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The inverse of `local_shard`: the shards of every rank along `axis`
    concatenated along `dim`, on every rank."""
    parts = all_gather(x.movedim(dim, 0), mesh, axis)
    return parts.reshape(-1, *parts.shape[2:]).movedim(0, dim)
