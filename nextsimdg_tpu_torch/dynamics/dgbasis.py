"""Discontinuous-Galerkin basis and quadrature tables (numpy, float64).

A copy of the tables of ``nextsimdg_tpu.dynamics.dgbasis``: that module is
numpy-only, but importing it runs the JAX package's ``dynamics/__init__``,
which imports jax. The tests assert that every table equals the JAX one
exactly.

Basis on the reference square [0,1]^2, orthogonal (Legendre-type), with
1/3/6 local unknowns for dG0/dG1/dG2:

    phi0 = 1
    phi1 = x - 1/2                 phi2 = y - 1/2
    phi3 = (x-1/2)^2 - 1/12        phi4 = (y-1/2)^2 - 1/12
    phi5 = (x-1/2)(y-1/2)

Orthogonality makes the element mass matrix diagonal:
M = diag(1, 1/12, 1/12, 1/180, 1/180, 1/144) * |E|.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

#: Number of local unknowns per DG degree.
DG_DOFS = {0: 1, 1: 3, 2: 6}

#: Diagonal of the reference-square mass matrix per dof.
MASS_DIAG = np.array([1.0, 1 / 12, 1 / 12, 1 / 180, 1 / 180, 1 / 144])

# 3-point Gauss-Legendre on [0,1]: exact through degree 5 (dG2 integrands).
_GP = 0.5 * np.sqrt(3.0 / 5.0)
GAUSS_POINTS_1D = np.array([0.5 - _GP, 0.5, 0.5 + _GP])
GAUSS_WEIGHTS_1D = np.array([5.0 / 18.0, 8.0 / 18.0, 5.0 / 18.0])

# 2-point Gauss-Legendre on [0,1]: exact through degree 3, which covers
# every dG0/dG1 integrand with a bilinear CG1 velocity.
_GP2 = 0.5 / np.sqrt(3.0)
GAUSS_POINTS_1D_2 = np.array([0.5 - _GP2, 0.5 + _GP2])
GAUSS_WEIGHTS_1D_2 = np.array([0.5, 0.5])


def gauss_rule_1d(degree: int):
    """The 1-D rule matched to the DG degree (2 points up to dG1, else 3)."""
    if degree <= 1:
        return GAUSS_POINTS_1D_2, GAUSS_WEIGHTS_1D_2
    return GAUSS_POINTS_1D, GAUSS_WEIGHTS_1D


def _phi(k: int, x, y):
    xm, ym = x - 0.5, y - 0.5
    if k == 0:
        return np.ones_like(np.asarray(x, dtype=float) * np.asarray(y, dtype=float))
    if k == 1:
        return xm + 0.0 * ym
    if k == 2:
        return ym + 0.0 * xm
    if k == 3:
        return xm * xm - 1.0 / 12.0 + 0.0 * ym
    if k == 4:
        return ym * ym - 1.0 / 12.0 + 0.0 * xm
    if k == 5:
        return xm * ym
    raise ValueError(k)


def _dphi_dx(k: int, x, y):
    xm, ym = x - 0.5, y - 0.5
    zero = 0.0 * (np.asarray(x, dtype=float) + np.asarray(y, dtype=float))
    return [zero, zero + 1.0, zero, 2.0 * xm + 0.0 * ym, zero, ym + 0.0 * xm][k]


def _dphi_dy(k: int, x, y):
    xm, ym = x - 0.5, y - 0.5
    zero = 0.0 * (np.asarray(x, dtype=float) + np.asarray(y, dtype=float))
    return [zero, zero, zero + 1.0, zero, 2.0 * ym + 0.0 * xm, xm + 0.0 * ym][k]


@dataclass(frozen=True)
class DGBasis:
    """Precomputed quadrature tables for one DG degree.

    Shapes: K = n dofs, NQ volume points, NE edge points per face.
    """

    degree: int
    n_dofs: int
    mass_diag: np.ndarray  #: (K,) diagonal mass matrix entries
    inv_mass_diag: np.ndarray  #: (K,)
    w_vol: np.ndarray  #: (NQ,) tensor-product volume weights
    psi_vol: np.ndarray  #: (K, NQ) basis at volume points
    dpsi_dx_vol: np.ndarray  #: (K, NQ) reference-x derivative at volume points
    dpsi_dy_vol: np.ndarray  #: (K, NQ)
    xq_vol: np.ndarray  #: (NQ,) volume point reference x coords
    yq_vol: np.ndarray  #: (NQ,)
    w_edge: np.ndarray  #: (NE,) edge weights
    s_edge: np.ndarray  #: (NE,) edge point parameter along the face
    psi_x0: np.ndarray  #: (K, NE) trace on face x=0 (left)
    psi_x1: np.ndarray  #: (K, NE) trace on face x=1 (right)
    psi_y0: np.ndarray  #: (K, NE) trace on face y=0 (bottom)
    psi_y1: np.ndarray  #: (K, NE) trace on face y=1 (top)


@lru_cache(maxsize=None)
def dg_basis(degree: int) -> DGBasis:
    if degree not in DG_DOFS:
        raise ValueError(f"unsupported DG degree: {degree} (use 0, 1 or 2)")
    n = DG_DOFS[degree]

    pts, wts = gauss_rule_1d(degree)
    xq, yq = np.meshgrid(pts, pts, indexing="ij")
    xq, yq = xq.ravel(), yq.ravel()
    wq = np.outer(wts, wts).ravel()

    psi_vol = np.array([_phi(k, xq, yq) for k in range(n)])
    dpsi_dx = np.array([_dphi_dx(k, xq, yq) for k in range(n)])
    dpsi_dy = np.array([_dphi_dy(k, xq, yq) for k in range(n)])

    s = pts
    zeros, ones = np.zeros_like(s), np.ones_like(s)
    psi_x0 = np.array([_phi(k, zeros, s) for k in range(n)])
    psi_x1 = np.array([_phi(k, ones, s) for k in range(n)])
    psi_y0 = np.array([_phi(k, s, zeros) for k in range(n)])
    psi_y1 = np.array([_phi(k, s, ones) for k in range(n)])

    return DGBasis(
        degree=degree,
        n_dofs=n,
        mass_diag=MASS_DIAG[:n].copy(),
        inv_mass_diag=(1.0 / MASS_DIAG[:n]).copy(),
        w_vol=wq,
        psi_vol=psi_vol,
        dpsi_dx_vol=dpsi_dx,
        dpsi_dy_vol=dpsi_dy,
        xq_vol=xq,
        yq_vol=yq,
        w_edge=wts.copy(),
        s_edge=pts.copy(),
        psi_x0=psi_x0,
        psi_x1=psi_x1,
        psi_y0=psi_y0,
        psi_y1=psi_y1,
    )
