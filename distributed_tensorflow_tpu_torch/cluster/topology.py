"""Mesh construction over ``torch.distributed`` — port of the mesh part
of ``distributed_tensorflow_tpu/cluster/topology.py``.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over every
rank of the default process group (one device a rank), with named dims.
Dim order is semantic as in JAX: earlier dims are outer (``"dcn"``, the
slow links), later dims inner. Each dim's process group carries that
axis's collectives (``mesh.get_group(name)``).

The default process group must exist first
(:func:`distributed_tensorflow_tpu_torch.cluster.bootstrap.initialize`).
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# Canonical logical axis names, in priority order (JAX :25-35).
DATA_AXIS = "dp"          # data parallel (gradient allreduce)
FSDP_AXIS = "fsdp"        # fully-sharded data parallel (param all-gather)
TENSOR_AXIS = "tp"        # tensor/model parallel (activation collectives)
SEQUENCE_AXIS = "sp"      # sequence/context parallel (ring attention)
PIPELINE_AXIS = "pp"      # pipeline parallel (ppermute between stages)
EXPERT_AXIS = "ep"        # expert parallel (all_to_all dispatch)

ALL_AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS, SEQUENCE_AXIS, PIPELINE_AXIS,
            EXPERT_AXIS)

DCN_AXIS = "dcn"

# Axes over which input batches shard, outermost first.
DATA_AXES = (DCN_AXIS, DATA_AXIS, FSDP_AXIS)


def _normalize_axes(axes, num_devices: int):
    """Resolve an axis spec into (names, sizes), filling one -1 wildcard."""
    if isinstance(axes, Mapping):
        names = tuple(axes.keys())
        sizes = list(axes.values())
    else:
        names, sizes = zip(*axes)
        sizes = list(sizes)
    wild = [i for i, s in enumerate(sizes) if s == -1]
    if len(wild) > 1:
        raise ValueError("At most one axis size may be -1")
    if wild:
        known = math.prod(s for s in sizes if s != -1)
        if num_devices % known:
            raise ValueError(
                f"{num_devices} devices not divisible by fixed axes {known}")
        sizes[wild[0]] = num_devices // known
    if math.prod(sizes) != num_devices:
        raise ValueError(
            f"Mesh axes {dict(zip(names, sizes))} need {math.prod(sizes)} "
            f"devices but {num_devices} are available")
    return names, tuple(sizes)


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call cluster.bootstrap.initialize(device=) "
            "before building a mesh")
    return dist.get_world_size()


def _device_type(device) -> str:
    return torch.device(device).type


def make_mesh(axes: Mapping[str, int] | None = None, *,
              device="cuda") -> DeviceMesh:
    """A mesh over every rank, e.g. ``{"dp": 4}``; one size may be -1
    (inferred). Defaults to pure data parallelism over the world.
    ``device`` names the device type of the ranks ("cuda" or "cpu")."""
    n = _world_size()
    if axes is None:
        axes = {DATA_AXIS: n}
    names, sizes = _normalize_axes(axes, n)
    return init_device_mesh(_device_type(device), sizes,
                            mesh_dim_names=names)


def make_hybrid_mesh(dcn_axes: Mapping[str, int],
                     ici_axes: Mapping[str, int], *,
                     device="cuda") -> DeviceMesh:
    """A mesh whose ``dcn_axes`` come first (outer, the slow links) and
    ``ici_axes`` after them, ranks grouped contiguously with the outer
    dims slowest-varying (JAX's layout off a multi-slice TPU)."""
    if -1 in dcn_axes.values() and -1 in ici_axes.values():
        raise ValueError("only one -1 wildcard allowed across "
                         "dcn_axes + ici_axes")
    n = _world_size()
    dcn_names, dcn_sizes = _normalize_axes(dcn_axes, math.prod(
        dcn_axes.values()) if -1 not in dcn_axes.values() else n
        // math.prod(ici_axes.values()))
    ici_names, ici_sizes = _normalize_axes(ici_axes, n // math.prod(dcn_sizes))
    return init_device_mesh(_device_type(device), dcn_sizes + ici_sizes,
                            mesh_dim_names=dcn_names + ici_names)


def mesh_shape(mesh) -> dict:
    """``{name: size}`` in dim order (JAX's ``mesh.shape``), of a
    ``DeviceMesh`` or of such a mapping itself."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def mesh_axis_size(mesh: DeviceMesh, *names: str) -> int:
    """Product of the sizes of ``names`` that exist on ``mesh``."""
    shape = mesh_shape(mesh)
    return math.prod(shape[n] for n in names if n in shape)


def data_axes(mesh) -> tuple:
    """The subset of DATA_AXES present on ``mesh``, in DATA_AXES order."""
    shape = mesh_shape(mesh)
    return tuple(a for a in DATA_AXES if a in shape)


def data_shard_index(mesh: DeviceMesh) -> int:
    """This rank's row-major index over :func:`data_axes` — its block of
    a batch sharded ``P(data_axes)`` (dcn-major on a hybrid mesh)."""
    shape = mesh_shape(mesh)
    idx = 0
    for a in data_axes(mesh):
        idx = idx * shape[a] + mesh.get_local_rank(a)
    return idx


def attention_shard_spec(mesh) -> tuple:
    """Which mesh axes shard each dim of a ``(B, H, S, hd)`` attention
    operand (JAX ``:200``): batch over the data axes (a tuple, or None
    without any), heads over ``tp`` (or None), sequence and head dim
    local. A rank holds the block ``(B / n_batch, H / tp, S, hd)``."""
    shape = mesh_shape(mesh)
    batch = data_axes(shape)
    return (batch or None, TENSOR_AXIS if TENSOR_AXIS in shape else None,
            None, None)


def tp_size(mesh) -> int:
    """The mesh's ``tp`` size, 1 without the axis."""
    return mesh_shape(mesh).get(TENSOR_AXIS, 1)


def tp_index(mesh: DeviceMesh) -> int:
    """This rank's index along ``tp``, 0 without the axis."""
    if TENSOR_AXIS not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(TENSOR_AXIS)


def sp_size(mesh) -> int:
    """The mesh's ``sp`` size, 1 without the axis."""
    return mesh_shape(mesh).get(SEQUENCE_AXIS, 1)


def sp_index(mesh: DeviceMesh) -> int:
    """This rank's index along ``sp`` (its sequence chunk), 0 without
    the axis."""
    if SEQUENCE_AXIS not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(SEQUENCE_AXIS)


def ep_size(mesh) -> int:
    """The mesh's ``ep`` size, 1 without the axis."""
    return mesh_shape(mesh).get(EXPERT_AXIS, 1)


def ep_index(mesh: DeviceMesh) -> int:
    """This rank's index along ``ep`` (its block of the experts), 0
    without the axis."""
    if EXPERT_AXIS not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(EXPERT_AXIS)


def fsdp_size(mesh) -> int:
    """The mesh's ``fsdp`` size, 1 without the axis."""
    return mesh_shape(mesh).get(FSDP_AXIS, 1)


def fsdp_index(mesh: DeviceMesh) -> int:
    """This rank's index along ``fsdp`` (its block of every ``embed``
    dim), 0 without the axis."""
    if FSDP_AXIS not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(FSDP_AXIS)


def pp_index(mesh: DeviceMesh) -> int:
    """This rank's worker index along ``pp`` (its pipeline stage without
    interleaving), 0 without the axis."""
    if PIPELINE_AXIS not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(PIPELINE_AXIS)


def pp_group_ranks(mesh: DeviceMesh) -> list:
    """The global ranks of this rank's ``pp`` group in worker order: its
    neighbours are the entries beside :func:`pp_index` (wrapping, as
    JAX's ``ppermute`` ring), ``[rank]`` without the axis."""
    if PIPELINE_AXIS not in (mesh.mesh_dim_names or ()):
        return [dist.get_rank()]
    return dist.get_process_group_ranks(mesh.get_group(PIPELINE_AXIS))


def pp_rows(mesh: DeviceMesh) -> list:
    """Every ``pp`` group of the mesh, as lists of global ranks in worker
    order, in one order on every rank."""
    dim = tuple(mesh.mesh_dim_names).index(PIPELINE_AXIS)
    return mesh.mesh.movedim(dim, -1).reshape(
        -1, mesh.size(dim)).tolist()
