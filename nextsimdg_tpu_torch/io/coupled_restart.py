"""Checkpoint and resume of the full coupled model state.

The port's copy of ``nextsimdg_tpu.io.coupled_restart``, with the same
on-disk schema, so that a checkpoint written by either package loads bit
for bit in the other. Structure type ``"coupled_dg"``: group ``structure``
(attrs ``type``, ``dg_dofs``, ``nlayers``, ``time``, ``velocity_type``)
and group ``state`` with one dataset per leaf of the state, at the state's
own dtype: the scalar leaves, then the velocity's (``cg1``: the flat
``velocity/{u,v,s11,s22,s12}`` planes; ``cg2_dg1``: the CG2 planes
``velocity/{u,v}/{v,b,l,c}`` and the (3, nx, ny) stresses).

``fetch_coupled_state`` brings a state to the host as numpy leaves
(``interop.coupled_state_to_numpy``'s nested dict) in one batched copy;
``save_coupled_state`` writes a state or such a dict. h5py is imported by
the functions that open a file, so the package imports where it is not
installed (the card machine has none).
"""

from __future__ import annotations

import numpy as np
import torch

from ..interop import coupled_state_from_numpy, coupled_state_to_numpy
from ..state import tree_leaves, tree_map

STRUCTURE_TYPE = "coupled_dg"

_SCALAR_LEAVES = ("hice", "cice", "hsnow", "sst", "sss", "tice", "new_ice")

#: The velocity's datasets per dynamics discretization; the CG1 names keep
#: the JAX package's flat layout.
_VELOCITY_LEAVES = {
    "cg1": (
        "velocity/u", "velocity/v",
        "velocity/s11", "velocity/s22", "velocity/s12",
    ),
    "cg2_dg1": tuple(
        f"velocity/{comp}/{plane}" for comp in ("u", "v") for plane in "vblc"
    ) + ("velocity/s11", "velocity/s22", "velocity/s12"),
}


def _get(tree: dict, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _velocity_type(host: dict) -> str:
    return "cg2_dg1" if isinstance(host["velocity"]["u"], dict) else "cg1"


def fetch_coupled_state(state) -> dict:
    """The state's leaves as host numpy arrays (the nested dict of
    ``interop.coupled_state_to_numpy``), in one batched copy: the leaves
    are flattened into one buffer on their device, which is copied to the
    host once (one sync), then viewed leaf by leaf. From a card the copy
    lands in pinned memory, which PyTorch's host allocator hands out again
    once the arrays are released: 23-24 ms for a 1.2 GB state on an H100
    where pageable memory took 604-813 ms (``benchmarks.host_copies``). The
    arrays are a copy: later steps that write into the state's tensors do
    not reach them."""
    leaves = tree_leaves(state)
    flat = torch.cat([leaf.detach().reshape(-1) for leaf in leaves])
    if flat.is_cuda:
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        flat = host.copy_(flat)
    views, offset = {}, 0
    for leaf in leaves:
        views[id(leaf)] = flat[offset: offset + leaf.numel()].view(leaf.shape)
        offset += leaf.numel()
    return coupled_state_to_numpy(tree_map(lambda leaf: views[id(leaf)], state))


def save_coupled_state(path: str, state, time: float = 0.0) -> None:
    """Write ``state`` (a ``CoupledState``, or its host leaves from
    ``fetch_coupled_state``) and its model time to ``path``."""
    import h5py

    host = state if isinstance(state, dict) else fetch_coupled_state(state)
    vel_type = _velocity_type(host)
    with h5py.File(path, "w") as handle:
        meta = handle.create_group("structure")
        meta.attrs.create("type", np.bytes_(STRUCTURE_TYPE))
        meta.attrs.create("dg_dofs", np.int64(host["hice"].shape[0]))
        meta.attrs.create("nlayers", np.int64(host["tice"].shape[0]))
        meta.attrs.create("time", float(time))
        meta.attrs.create("velocity_type", np.bytes_(vel_type))
        group = handle.create_group("state")
        for leaf in _SCALAR_LEAVES + _VELOCITY_LEAVES[vel_type]:
            group.create_dataset(leaf, data=np.asarray(_get(host, leaf)))


def load_coupled_state(path: str, *, device, dtype):
    """The ``CoupledState`` of a checkpoint, on ``device`` in ``dtype``."""
    import h5py

    with h5py.File(path, "r") as handle:
        attrs = handle["structure"].attrs
        stype = attrs["type"]
        stype = stype.decode() if isinstance(stype, bytes) else str(stype)
        if stype != STRUCTURE_TYPE:
            raise ValueError(f"not a coupled_dg checkpoint: {stype}")
        vel_type = attrs.get("velocity_type", b"cg1")
        vel_type = vel_type.decode() if isinstance(vel_type, bytes) else str(vel_type)
        group = handle["state"]
        data = {leaf: np.asarray(group[leaf]) for leaf in _SCALAR_LEAVES + _VELOCITY_LEAVES[vel_type]}
    host = {name: data[name] for name in _SCALAR_LEAVES}
    velocity = {name: data[f"velocity/{name}"] for name in ("s11", "s22", "s12")}
    for comp in ("u", "v"):
        if vel_type == "cg2_dg1":
            velocity[comp] = {plane: data[f"velocity/{comp}/{plane}"] for plane in "vblc"}
        else:
            velocity[comp] = data[f"velocity/{comp}"]
    host["velocity"] = velocity
    return coupled_state_from_numpy(host, device=device, dtype=dtype)


def load_time(path: str) -> float:
    import h5py

    with h5py.File(path, "r") as handle:
        return float(handle["structure"].attrs["time"])
