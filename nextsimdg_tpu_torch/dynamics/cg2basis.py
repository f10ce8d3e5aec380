"""CG2 (biquadratic) velocity basis tables for the higher-order dynamics.

A copy of ``nextsimdg_tpu.dynamics.cg2basis`` (numpy only; the tests
assert that every table equals the JAX one exactly). Velocity is
discretised with tensor-product quadratic Lagrange elements (9 nodes per
quad: 4 vertices, 4 edge midpoints, 1 centre), strain and stress with dG1.

Owned-plane layout (uniform (nx, ny) arrays, cf. ``dynamics.stencil``):
each element owns 4 of its 9 nodes:

    'v' vertex (0,0) | 'b' bottom edge midpoint (1/2,0)
    'l' left edge midpoint (0,1/2) | 'c' centre (1/2,1/2)

The other 5 local nodes belong to +1 neighbours and are reached with
shifts. Local node index n = 3*a + b for reference position (a/2, b/2),
a, b in {0,1,2}.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .dgbasis import GAUSS_POINTS_1D_2, GAUSS_WEIGHTS_1D_2, _phi, dg_basis

#: The 4 owned planes and, for each of the 9 local nodes, the owning plane
#: plus the (+x, +y) shift that reaches its value from the owned arrays.
#: local (a, b): a=0 x=0, a=1 x=1/2, a=2 x=1 (the same for b in y).
LOCAL_NODE_SOURCE = {
    (0, 0): ("v", 0, 0),
    (2, 0): ("v", 1, 0),
    (0, 2): ("v", 0, 1),
    (2, 2): ("v", 1, 1),
    (1, 0): ("b", 0, 0),
    (1, 2): ("b", 0, 1),
    (0, 1): ("l", 0, 0),
    (2, 1): ("l", 1, 0),
    (1, 1): ("c", 0, 0),
}

PLANES = ("v", "b", "l", "c")


def _lagrange_1d(index: int, x):
    """Quadratic Lagrange basis on nodes {0, 1/2, 1}."""
    if index == 0:
        return 2.0 * (x - 0.5) * (x - 1.0)
    if index == 1:
        return -4.0 * x * (x - 1.0)
    return 2.0 * x * (x - 0.5)


def _dlagrange_1d(index: int, x):
    if index == 0:
        return 4.0 * x - 3.0
    if index == 1:
        return -8.0 * x + 4.0
    return 4.0 * x - 1.0


def shape(n: int, x, y):
    """CG2 shape function n = 3a+b at reference (x, y)."""
    a, b = divmod(n, 3)
    return _lagrange_1d(a, x) * _lagrange_1d(b, y)


def dshape_dx(n: int, x, y):
    a, b = divmod(n, 3)
    return _dlagrange_1d(a, x) * _lagrange_1d(b, y)


def dshape_dy(n: int, x, y):
    a, b = divmod(n, 3)
    return _lagrange_1d(a, x) * _dlagrange_1d(b, y)


@dataclass(frozen=True)
class CG2Tables:
    """Precomputed tables. N = 9 local nodes, NQ = 4 Gauss points, C = 3
    dG1 coefficients."""

    n_vol: np.ndarray  #: (N, NQ) shape values at volume Gauss points
    dndx: np.ndarray  #: (N, NQ) reference d/dx at Gauss points
    dndy: np.ndarray  #: (N, NQ)
    w_vol: np.ndarray  #: (NQ,)
    phi_dg1: np.ndarray  #: (C, NQ) dG1 basis at Gauss points
    #: (C, N): projection of d(shape_n)/dx onto dG1 coeff c (mass-inverted).
    grad_x_to_dg1: np.ndarray
    grad_y_to_dg1: np.ndarray
    #: (C, N): divergence tables int phi_c dN_n/dx over the reference square
    #: (not mass-inverted; these weight the weak-form force assembly).
    div_x: np.ndarray
    div_y: np.ndarray
    #: (N,) lumped mass weights: integral of shape_n over the reference square.
    lumped_mass: np.ndarray


@lru_cache(maxsize=None)
def cg2_tables() -> CG2Tables:
    # 2x2 tensor Gauss, exact through degree 3 per direction: every linear
    # table below is exact; only the nonlinear VP-law projection of the
    # subcycle is a reduced integration (4 points onto 3 dG1 modes).
    xq, yq = np.meshgrid(GAUSS_POINTS_1D_2, GAUSS_POINTS_1D_2, indexing="ij")
    xq, yq = xq.ravel(), yq.ravel()
    wq = np.outer(GAUSS_WEIGHTS_1D_2, GAUSS_WEIGHTS_1D_2).ravel()

    n_nodes = 9
    n_vol = np.array([shape(n, xq, yq) for n in range(n_nodes)])
    dndx = np.array([dshape_dx(n, xq, yq) for n in range(n_nodes)])
    dndy = np.array([dshape_dy(n, xq, yq) for n in range(n_nodes)])

    dg1 = dg_basis(1)
    phi = np.array([_phi(k, xq, yq) for k in range(3)])  # (3, NQ)
    inv_mass = dg1.inv_mass_diag  # (3,)

    # L2 projection of gradients onto dG1 (reference coordinates).
    grad_x = inv_mass[:, None] * np.einsum("q,cq,nq->cn", wq, phi, dndx)
    grad_y = inv_mass[:, None] * np.einsum("q,cq,nq->cn", wq, phi, dndy)
    # Weak-form divergence tables.
    div_x = np.einsum("q,cq,nq->cn", wq, phi, dndx)
    div_y = np.einsum("q,cq,nq->cn", wq, phi, dndy)
    lumped = np.einsum("q,nq->n", wq, n_vol)

    return CG2Tables(
        n_vol=n_vol, dndx=dndx, dndy=dndy, w_vol=wq, phi_dg1=phi,
        grad_x_to_dg1=grad_x, grad_y_to_dg1=grad_y,
        div_x=div_x, div_y=div_y, lumped_mass=lumped,
    )


@lru_cache(maxsize=None)
def cg2_sampling_table(degree: int) -> np.ndarray:
    """(9, NQ) CG2 shape values at the transport basis's volume points
    (degree-matched: 2x2 for dG0/dG1, 3x3 for dG2)."""
    b = dg_basis(degree)
    return np.array([shape(n, b.xq_vol, b.yq_vol) for n in range(9)])
