"""State and parameters across the boundary between the two packages.

Plain numpy dicts keyed by field name carry a ``CoupledState``, a
``DynamicsForcing``, the physics ``Forcing`` and ``PrognosticState``, the
``MEVPParams`` fields or a mesh description, so that the JAX model and
this port can be given identical inputs without either importing the
other. A state's velocity is a nested dict: {u, v, s11, s22, s12} of
planes for the CG1 solver, and for the CG2/dG1 solver
``{u: {v, b, l, c}, v: {v, b, l, c}, s11, s22, s12}`` with (3, nx, ny)
stresses. The ``*_to_numpy``
functions read any object with the fields whose leaves numpy can convert
(a torch tensor, or an array of the JAX package). The ``*_rank_blocks``
functions carry a global state or forcing into the rank blocks of a
``parallel.RankGrid`` and back. A restart (``io.RestartFields``, the
netCDF-4 file either package reads and writes) converts to and from the
port's ``PrognosticState`` with ``prognostic_from_restart`` and
``restart_from_prognostic``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .coupled import CoupledState
from .dynamics.mesh import EARTH_RADIUS, RectMesh, SphericalMesh
from .dynamics.mevp import DynamicsForcing, MEVPParams, VelocityState
from .dynamics.mevp_ho import HOField, HOVelocityState
from .grid.structure import prognostic_from_restart, restart_from_prognostic  # noqa: F401
from .state import Forcing, PrognosticState

_STATE_FIELDS = ("hice", "cice", "hsnow", "sst", "sss", "tice", "new_ice")
_VELOCITY_FIELDS = ("u", "v", "s11", "s22", "s12")
_HO_PLANES = ("v", "b", "l", "c")
_FORCING_FIELDS = ("u_atm", "v_atm", "u_ocean", "v_ocean")
_PHYS_FORCING_FIELDS = tuple(f.name for f in dataclasses.fields(Forcing))
_PROGNOSTIC_FIELDS = tuple(f.name for f in dataclasses.fields(PrognosticState))


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _require(d: dict, names, what: str) -> None:
    if set(d) != set(names):
        raise KeyError(f"{what} needs exactly the keys {sorted(names)}, got {sorted(d)}")


def velocity_to_numpy(velocity) -> dict:
    """{u, v, s11, s22, s12} of either package's ``VelocityState``, or of an
    ``HOVelocityState`` with u and v as {v, b, l, c} dicts."""
    out = {}
    for name in _VELOCITY_FIELDS:
        leaf = getattr(velocity, name)
        if name in ("u", "v") and hasattr(leaf, "c"):  # a CG2 field
            out[name] = {k: _to_numpy(getattr(leaf, k)) for k in _HO_PLANES}
        else:
            out[name] = _to_numpy(leaf)
    return out


def velocity_from_numpy(d: dict, *, device, dtype):
    """The inverse of ``velocity_to_numpy``: a ``VelocityState``, or an
    ``HOVelocityState`` when u is a dict of CG2 planes."""
    _require(d, _VELOCITY_FIELDS, "a velocity state")
    as_t = lambda a: torch.tensor(np.asarray(a), device=device, dtype=dtype)
    if not isinstance(d["u"], dict):
        return VelocityState(**{k: as_t(d[k]) for k in _VELOCITY_FIELDS})
    fields = {}
    for name in ("u", "v"):
        _require(d[name], _HO_PLANES, "an HOField")
        fields[name] = HOField(**{k: as_t(d[name][k]) for k in _HO_PLANES})
    return HOVelocityState(**fields, **{k: as_t(d[k]) for k in ("s11", "s22", "s12")})


def coupled_state_to_numpy(state) -> dict:
    """{field: ndarray}, with the velocity as a nested dict
    (``velocity_to_numpy``)."""
    out = {name: _to_numpy(getattr(state, name)) for name in _STATE_FIELDS}
    out["velocity"] = velocity_to_numpy(state.velocity)
    return out


def coupled_state_from_numpy(d: dict, *, device, dtype) -> CoupledState:
    """The inverse of ``coupled_state_to_numpy``, on ``device`` in ``dtype``."""
    _require(d, _STATE_FIELDS + ("velocity",), "a CoupledState")
    as_t = lambda a: torch.tensor(np.asarray(a), device=device, dtype=dtype)
    velocity = velocity_from_numpy(d["velocity"], device=device, dtype=dtype)
    return CoupledState(velocity=velocity, **{k: as_t(d[k]) for k in _STATE_FIELDS})


def dynamics_forcing_from_numpy(d: dict, *, device, dtype) -> DynamicsForcing:
    """A ``DynamicsForcing`` from {u_atm, v_atm, u_ocean, v_ocean} arrays."""
    _require(d, _FORCING_FIELDS, "a DynamicsForcing")
    return DynamicsForcing(**{
        k: torch.tensor(np.asarray(d[k]), device=device, dtype=dtype)
        for k in _FORCING_FIELDS
    })


def mevp_params_from_dict(d: dict) -> MEVPParams:
    """``MEVPParams`` from ``dataclasses.asdict`` of either package's params."""
    _require(d, [f.name for f in dataclasses.fields(MEVPParams)], "MEVPParams")
    return MEVPParams(**d)


def _from_numpy(cls, d: dict, names, *, device, dtype):
    _require(d, names, f"a {cls.__name__}")
    return cls(**{
        k: torch.tensor(np.asarray(d[k]), device=device, dtype=dtype) for k in names
    })


def forcing_from_numpy(d: dict, *, device, dtype) -> Forcing:
    """A physics ``Forcing`` from {tair, dew2m, pair, ...} arrays."""
    return _from_numpy(Forcing, d, _PHYS_FORCING_FIELDS, device=device, dtype=dtype)


def forcing_to_numpy(forcing) -> dict:
    """{field: ndarray} of either package's physics ``Forcing``."""
    return {name: _to_numpy(getattr(forcing, name)) for name in _PHYS_FORCING_FIELDS}


def prognostic_state_from_numpy(d: dict, *, device, dtype) -> PrognosticState:
    """A ``PrognosticState`` from {hice, cice, hsnow, sst, sss, tice} arrays."""
    return _from_numpy(PrognosticState, d, _PROGNOSTIC_FIELDS, device=device, dtype=dtype)


def prognostic_state_to_numpy(prog) -> dict:
    """{field: ndarray} of either package's ``PrognosticState``."""
    return {name: _to_numpy(getattr(prog, name)) for name in _PROGNOSTIC_FIELDS}


_MESH_KEYS = {
    "rect": {"kind", "nx", "ny", "dx", "dy"},
    "spherical": {"kind", "nx", "ny", "lon0", "lon1", "lat0", "lat1"},
}
_MESH_OPTIONAL = {
    "rect": {"periodic_x", "periodic_y"},
    "spherical": {"radius", "periodic_x"},
}


def mesh_from_description(d: dict):
    """The port's mesh of a description (plain numbers and numpy arrays).

    ``{"kind": "rect", "nx", "ny", "dx", "dy"}``: a ``RectMesh``, ``dx`` and
    ``dy`` scalars or per-column/per-row arrays;
    ``{"kind": "spherical", "nx", "ny", "lon0", "lon1", "lat0", "lat1"}``
    and optionally ``"radius"``: a ``SphericalMesh``. Optional
    ``"periodic_x"`` (both kinds) and ``"periodic_y"`` (rect) make an axis
    periodic; they default to closed.
    """
    kind = d.get("kind")
    if kind not in _MESH_KEYS:
        raise KeyError(f"a mesh description needs kind 'rect' or 'spherical', got {kind!r}")
    keys = set(d) - _MESH_OPTIONAL[kind]
    if keys != _MESH_KEYS[kind]:
        raise KeyError(
            f"a {kind} mesh needs exactly the keys {sorted(_MESH_KEYS[kind])} (and may take "
            f"{sorted(_MESH_OPTIONAL[kind])}), got {sorted(d)}"
        )
    if kind == "rect":
        return RectMesh(
            d["nx"], d["ny"], np.asarray(d["dx"]), np.asarray(d["dy"]),
            periodic_x=bool(d.get("periodic_x", False)),
            periodic_y=bool(d.get("periodic_y", False)),
        )
    return SphericalMesh(
        d["nx"], d["ny"], d["lon0"], d["lon1"], d["lat0"], d["lat1"],
        radius=d.get("radius", EARTH_RADIUS), periodic_x=bool(d.get("periodic_x", False)),
    )


# -- rank grids ---------------------------------------------------------------
def coupled_state_to_rank_blocks(d: dict, grid, *, dtype):
    """The rank blocks (one ``CoupledState`` per rank, on its device) of a
    global state given as numpy leaves (``coupled_state_to_numpy``)."""
    return grid.split_tree(coupled_state_from_numpy(d, device="cpu", dtype=dtype))


def coupled_state_from_rank_blocks(blocks, grid) -> dict:
    """The global state of a grid's rank blocks, as numpy leaves."""
    return coupled_state_to_numpy(grid.gather_tree(blocks, device="cpu"))


def forcing_to_rank_blocks(d: dict, grid, *, dtype):
    """The rank blocks of a global physics ``Forcing`` given as numpy."""
    return grid.split_tree(forcing_from_numpy(d, device="cpu", dtype=dtype))


def dynamics_forcing_to_rank_blocks(d: dict, grid, *, dtype):
    """The rank blocks of a global ``DynamicsForcing`` given as numpy."""
    return grid.split_tree(dynamics_forcing_from_numpy(d, device="cpu", dtype=dtype))
