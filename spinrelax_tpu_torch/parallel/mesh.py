"""The ("rep", "res") device mesh and its sharding helpers (port of
``spinrelax_tpu/parallel/mesh.py``).

The reference has no distributed computing (SURVEY section 2.5); its data
parallelism is replica trajectories analysed jointly and its sequence
parallelism the Palmer chunking of the frame axis.  Both map onto a 2-D
mesh, as in the JAX package:

    axis "rep" : Palmer chunks / replica trajectories  (data parallel)
    axis "res" : bond vectors / residues               (model parallel)

PyTorch runs one process per device (``parallel.launch``), so the mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` over the whole process
group, rank r at coordinate (r // res, r % res).  Each rank holds plain
local tensors, its block of every sharded array; the communication is
explicit collectives on the mesh's dim groups (``mesh.get_group("rep")``)
or, for an axis over both dims, on the whole group.  Every rank calls the
collectives in the same order, as the JAX package's multi-host paths do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import checked_device
from . import launch

_MESHES: dict = {}


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into the most balanced (a, b) with a*b == n, a >= b."""
    best = (n, 1)
    a = int(np.sqrt(n))
    while a > 1:
        if n % a == 0:
            best = (n // a, a)
            break
        a -= 1
    return best


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("rep", "res"), device="cuda"):
    """The 2-D mesh over every rank of the process group.

    With no group running, ``n_devices`` None or 1 starts a one-rank group
    on ``device`` (``launch.start_one_rank``), and under ``torchrun`` the
    group its environment describes.  ``n_devices`` other than the world
    size raises, as the JAX package refuses to truncate: a mesh over a
    subset of the ranks would leave the others in no collective."""
    dev = checked_device(device)
    if not dist.is_initialized():
        if launch.launched_by_torchrun():
            launch.init_from_env(dev)
        elif n_devices in (None, 1):
            launch.start_one_rank(dev)
        else:
            raise ValueError(
                f"requested a {n_devices}-device mesh but no process group is running: "
                f"start one process per device, e.g. `torchrun --nproc-per-node "
                f"{n_devices} -m spinrelax_tpu_torch ...`")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(
            f"requested a {n}-device mesh but the process group has {world} rank(s): "
            f"run `torchrun --nproc-per-node {n} ...`; a mesh over a subset of the "
            f"ranks is refused, since the ranks outside it would wait in no collective")
    want = launch.backend_for(dev)
    if dist.get_backend() != want:
        raise ValueError(
            f"a {dev.type} mesh needs a {want} process group; this one is "
            f"{dist.get_backend()}")
    key = (dist.group.WORLD, dev.type, tuple(axis_names), n)
    mesh = _MESHES.get(key)
    if mesh is None:
        from torch.distributed.device_mesh import DeviceMesh

        mesh = _MESHES[key] = DeviceMesh(
            dev.type, torch.arange(n).reshape(_factor2(n)),
            mesh_dim_names=tuple(axis_names))
    return mesh


def dims(mesh) -> Tuple[int, int]:
    """(rep, res) sizes of the mesh."""
    return tuple(int(s) for s in mesh.mesh.shape)


def coordinate(mesh) -> Tuple[int, int]:
    """This rank's (rep, res) coordinate."""
    return tuple(int(c) for c in mesh.get_coordinate())


def device_of(mesh) -> torch.device:
    """This rank's device on the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def group(mesh, axis: Optional[str] = None):
    """The process group of one mesh axis, or of the whole mesh."""
    return dist.group.WORLD if axis is None else mesh.get_group(axis)


def _block(n: int, parts: int, i: int) -> slice:
    if n % parts:
        raise ValueError(f"an axis of {n} does not split into {parts} blocks")
    m = n // parts
    return slice(i * m, (i + 1) * m)


def vecs_sharding(mesh, n_chunks: int, n_res: int) -> Tuple[slice, slice]:
    """(nRep, nFrames, nRes, 3): this rank's chunk block (over "rep") and
    residue block (over "res")."""
    (rep, res), (i, j) = dims(mesh), coordinate(mesh)
    return _block(n_chunks, rep, i), _block(n_res, res, j)


def residue_sharding(mesh, n: int) -> slice:
    """A leading residue axis over BOTH mesh axes: this rank's block."""
    return _block(n, dist.get_world_size(), dist.get_rank())


def replicated(mesh, n: int) -> slice:
    """An axis every rank holds whole."""
    return slice(0, n)


def pad_and_shard(mesh, arrays):
    """Pad every array's LEADING axis to a multiple of the rank count with
    copies of row 0 (well-conditioned dummies) and keep this rank's block
    (:func:`residue_sharding`) on its device.  Returns (local tensors,
    n_orig); :func:`fetch` gathers results back to ``n_orig`` rows.  numpy
    input keeps its dtype; a tensor keeps its dtype and moves to the
    rank's device."""
    dev = device_of(mesh)
    arrays = [a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a)) for a in arrays]
    if any(a.ndim == 0 for a in arrays):
        raise ValueError(
            "pad_and_shard pads the LEADING axis: 0-d inputs have none "
            "-- broadcast scalars to a (n,) residue axis first")
    n_orig = arrays[0].shape[0]
    pad = (-n_orig) % dist.get_world_size()
    out = []
    for a in arrays:
        if a.shape[0] != n_orig:
            raise ValueError(f"leading axes differ: {a.shape[0]} vs {n_orig}")
        sl = residue_sharding(mesh, n_orig + pad)
        if pad:
            a = torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))], dim=0)
        out.append(a[sl].to(dev).contiguous())
    return out, n_orig


def all_gather(local: torch.Tensor, grp=None, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``local`` (equal shapes) along ``dim``, in
    rank order of ``grp`` (the whole group by default).  A collective."""
    n = dist.get_world_size(grp)
    x = local.movedim(dim, 0).contiguous()
    flag = x.dtype == torch.bool
    if flag:
        x = x.to(torch.uint8)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    # torch 2.13 renames all_gather_into_tensor (a FutureWarning there) to
    # all_gather_single, which torch 2.11 does not have
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=grp)
    if flag:
        out = out.to(torch.bool)
    return out.movedim(0, dim)


def fetch(local: torch.Tensor, mesh, n_orig: Optional[int] = None) -> torch.Tensor:
    """Gather the residue blocks of :func:`pad_and_shard` from every rank
    and slice off the padding: the whole (n_orig, ...) tensor on every
    rank.  A collective: every rank calls it in the same order."""
    out = all_gather(local, group(mesh))
    return out if n_orig is None else out[:n_orig]


def all_reduce(t: torch.Tensor, mesh, axis: Optional[str] = None) -> torch.Tensor:
    """Sum ``t`` in place over one mesh axis (or the whole mesh); returns it."""
    dist.all_reduce(t, group=group(mesh, axis))
    return t


def is_writer(mesh) -> bool:
    """Whether this process writes artefacts: always without a mesh, rank
    0 with one."""
    return mesh is None or dist.get_rank() == 0


def barrier(mesh) -> None:
    """Wait for every rank of the mesh (nothing without one): follows each
    artefact write, so no rank reads a file before rank 0 has written it."""
    if mesh is not None:
        dist.barrier()
