"""The forms of the port's one-launch dynamics phase against the JAX package.

``CoupledModel.step`` of the port, on a model whose schedule on an H100 of
132 SMs is "fused" (``fused_dynamics``; the plain path here), against the
JAX model on ``mevp_backend="pallas-interpret"``, which runs
``fused_dynamics_pallas`` in interpret mode, in each form that kernel runs
beside the headline's: a periodic axis or both, A-weighted stresses,
adaptive alpha, dG0 (rk1), dG2 (rk3), the TVB limiter at dG1 (M = 0 and a
middle M whose tolerance M dx^2 is the slopes' size, so that the limiter
both cuts and keeps) and at dG2, and every form at once with a coastline.
Float64, 16 x 16 elements, 15 subcycles, two steps, k > 1; 1e-8 of each
plane's max, as the other parity tests of the dynamics phase. The kernel
itself runs on a card only: its tests are the ``cuda``-marked ones in
``test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from nextsimdg_tpu.coupled import CoupledModel as JaxCoupledModel
from nextsimdg_tpu.dynamics import RectMesh as JaxRectMesh
from nextsimdg_tpu.dynamics.mevp import MEVPParams as JaxMEVPParams
from nextsimdg_tpu.modules import ModuleRegistry as JaxModuleRegistry
from nextsimdg_tpu_torch import coupled, interop
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import RectMesh
from nextsimdg_tpu_torch.dynamics.kernels import fused_dynamics_cuda as fd
from nextsimdg_tpu_torch.dynamics.mevp import MEVPParams

from test_torch_coupled import (
    N, N_SUBCYCLES, DT, VELOCITY, assert_states_close, seeded_forcing, to_jax_forcing, to_jax_state,
)

torch.set_num_threads(1)

H100_SMS = 132
DX = 2000.0  # 2 km elements: the seeded velocity needs k > 1 substeps
ADAPTIVE = dict(adaptive_alpha=True, alpha_min=20.0)  # the stability bound sets alpha on calm nodes

#: Each form: the model's keywords (``periodic``: the axes; ``tvb_m``
#: "mid": the middle M of the state's slopes; ``coast``: a coastline;
#: ``dx``: narrower elements where the 2 km ones need one substep).
CASES = {
    "periodic_x": dict(periodic=(True, False)),
    "periodic_both": dict(periodic=(True, True)),
    "a_weighted": dict(params=dict(a_weighted_stress=True)),
    "adaptive": dict(params=ADAPTIVE, dx=500.0),
    "dg0": dict(degree=0, dx=500.0),
    "dg2": dict(degree=2),
    "tvb_dg1_m0": dict(tvb_m=0.0),
    "tvb_dg1_mid": dict(tvb_m="mid"),
    "tvb_dg2": dict(degree=2, tvb_m=0.0),
    "every_form": dict(periodic=(True, True), params=dict(a_weighted_stress=True, **ADAPTIVE), degree=2,
                       tvb_m=0.0, coast=True),
}


def seeded_state(n_dofs: int, seed: int = 0, speed: float = 0.5) -> dict:
    """A CoupledState as numpy leaves with ``n_dofs`` DG coefficients: seeded
    means, moments of ~5% of the mean's range, a moving velocity and nonzero
    stresses."""
    rng = np.random.default_rng(seed)
    coeffs = lambda lo, hi: np.concatenate([
        rng.uniform(lo, hi, (1, N, N)), rng.normal(0.0, 0.05 * hi, (n_dofs - 1, N, N))
    ])
    return dict(
        hice=coeffs(0.5, 2.0), cice=coeffs(0.3, 1.0), hsnow=coeffs(0.0, 0.2),
        sst=np.full((N, N), -1.6), sss=np.full((N, N), 32.0),
        tice=np.full((1, N, N), -1.0), new_ice=np.zeros((N, N)),
        velocity=dict(
            u=rng.normal(0.0, speed, (N, N)), v=rng.normal(0.0, speed, (N, N)),
            s11=rng.normal(0.0, 500.0, (N, N)), s22=rng.normal(0.0, 500.0, (N, N)),
            s12=rng.normal(0.0, 200.0, (N, N)),
        ),
    )


def middle_m(coeffs, dx: float) -> float:
    """The TVB constant at which about half of the elements keep both
    linear moments within M dx^2: the median of max(|psi1|, |psi2|) / dx^2."""
    ratio = np.maximum(np.abs(coeffs[1]), np.abs(coeffs[2])) / (dx * dx)
    return float(np.median(ratio))


def coastline() -> np.ndarray:
    ocean = np.ones((N, N))
    ocean[4:8, 9:13] = 0.0
    ocean[12:, :3] = 0.0
    return ocean


@pytest.mark.parametrize("name", list(CASES))
def test_each_fused_form_matches_the_jax_fused_kernel(monkeypatch, name):
    monkeypatch.setattr(coupled, "sm_count", lambda device: H100_SMS)
    case = CASES[name]
    degree, dx = case.get("degree", 1), case.get("dx", DX)
    periodic = case.get("periodic", (False, False))
    params = case.get("params", {})
    ocean = coastline() if case.get("coast") else None
    state_np, forcing_np = seeded_state({0: 1, 1: 3, 2: 6}[degree]), seeded_forcing()
    tvb_m = case.get("tvb_m")
    if tvb_m == "mid":
        tvb_m = middle_m(state_np["hice"], dx)

    port = CoupledModel(
        RectMesh(N, N, dx, dx, periodic_x=periodic[0], periodic_y=periodic[1]), degree=degree,
        n_subcycles=N_SUBCYCLES, ocean_mask=ocean, tvb_m=tvb_m, mevp_params=MEVPParams(**params),
    )
    assert port.schedule("cuda") == ("fused", "xla") and fd.form_refusal(port) is None
    assert not fd.form_of(port).headline
    JaxModuleRegistry.get_loader().reset()
    jmodel = JaxCoupledModel(
        JaxRectMesh(nx=N, ny=N, dx=dx, dy=dx, periodic_x=periodic[0], periodic_y=periodic[1]),
        degree=degree, n_subcycles=N_SUBCYCLES, mevp_backend="pallas-interpret", ocean_mask=ocean,
        tvb_m=tvb_m, mevp_params=JaxMEVPParams(**params),
    )
    assert jmodel._fused_dynamics_mode() == "interpret"

    got = interop.coupled_state_from_numpy(state_np, device="cpu", dtype=torch.float64)
    forcing = interop.dynamics_forcing_from_numpy(forcing_np, device="cpu", dtype=torch.float64)
    ref, jforcing = to_jax_state(state_np), to_jax_forcing(forcing_np)
    if port.transport.limits_slopes:
        limited = port.transport.limit_slopes(got.hice)[1:3]
        cut = (limited != got.hice[1:3]).any(dim=0).float().mean()
        assert cut > 0.0 and (tvb_m == 0.0 or cut < 1.0), f"the limiter cuts {float(cut)} of the slopes"
    ks = []
    for _ in range(2):
        consts = port.mevp.step_consts(
            got.velocity, got.hice[0], torch.clamp(got.cice[0], 0.0, 1.0), forcing,
            port.node_mask(device="cpu", dtype=torch.float64), DT,
        )
        carry = tuple(getattr(got.velocity, k) for k in VELOCITY)
        tracers = torch.stack([got.hice, got.cice, got.hsnow], dim=1)
        faces = port.face_masks(device="cpu", dtype=torch.float64)
        ks.append(fd.fused_dynamics_single(port, carry, tracers, consts, DT, N_SUBCYCLES, faces)[2][2].item())
        got = port.step(got, None, forcing, DT, do_thermo=False)
        ref = jmodel.step(ref, None, jforcing, dt=DT, do_thermo=False)
    assert min(ks) > 1
    assert_states_close(interop.coupled_state_to_numpy(got), interop.coupled_state_to_numpy(ref))
