"""Winton (2000) three-layer thermodynamics (snow + two ice layers).

Counterpart of ``nextsimdg_tpu.physics.thermo_winton``, the second
implementation of ``Nextsim::IThermodynamics``, as straight-line tensor
arithmetic with the branches as masks. Scheme after M. Winton, "A
reformulated three-layer sea ice model", J. Atmos. Ocean. Tech. 17 (2000):

Specific enthalpies (per kg, <= 0; Tm = -mu*S the sea-ice melting point):

    upper ice (brine):  u1(T) = c (T - Tm) - L (1 - Tm/T)
    lower ice:          u2(T) = c (T - Tm) - L
    snow:               us    = -L  (pure latent, no sensible content)

Step structure:
1. implicit diffusion: layer-2 equation and the linearized surface balance
   (F(Ts) = a - b Ts, from Qia and dQia/dT) are eliminated into one
   QUADRATIC in T1' (the L*Tm/T term makes u1 nonlinear); the physical root
   is the negative one;
2. if the diagnostic Ts exceeds the surface melting point, the solve is
   repeated with Ts clamped (Dirichlet) and the excess surface energy
   melts snow -> upper ice -> lower ice;
3. bottom: conduction k_b (Tf - T2') vs the ocean flux Qio decides growth
   (new ice at u2(Tf), enthalpy-mixed into layer 2) or melt (consuming
   -u per kg of removed mass, layer 2 -> layer 1 -> snow);
4. sublimation/snowfall, flooding, equal-thickness rebalancing with
   enthalpy-conserving mixing (inverting u1 is again a quadratic).

The budget closes: E' - E = dt (F_atm,applied + Qio,consumed) + snowfall
and sublimation enthalpy terms. Prognostic ``tice`` layout with this
module: [Ts, T1, T2] (3 layers). Config keys ``thermowinton.{ks,flooding}``.

Both quadratics take the square root of max(discriminant, 0), columns
without ice compute on a guard thickness, and temperatures are held below
the melting point before they divide; each branch is a ``torch.where``,
which takes nothing from the side a column does not select.
"""

from __future__ import annotations

import torch

from ..config import Configured
from ..constants import Ice, Water
from ..modules import register_implementation
from ..state import safe_div
from .thermo_ice0 import INTERFACE, SlabUpdate

_EPS_T = 1e-9


def enthalpy1(t, tm):
    """u1(T): brine-adjusted upper-ice specific enthalpy [J kg-1]."""
    t_safe = torch.clamp(t, max=-1e-6)
    return Ice.cp * (t - tm) - Water.Lf * (1.0 - tm / t_safe)


def enthalpy2(t, tm):
    """u2(T): lower-ice specific enthalpy [J kg-1]."""
    return Ice.cp * (t - tm) - Water.Lf


def invert_enthalpy1(q, tm):
    """Solve u1(T) = q for the physical (negative) root.

    c T^2 - (c Tm + q + L) T + L Tm = 0.
    """
    c, lf = Ice.cp, Water.Lf
    b = c * tm + q + lf
    disc = torch.sqrt(torch.clamp(b * b - 4.0 * c * lf * tm, min=0.0))
    return torch.clamp((b - disc) / (2.0 * c), max=tm - _EPS_T)


def invert_enthalpy2(q, tm):
    """Solve u2(T) = q: T = (q + L)/c + Tm."""
    return torch.clamp((q + Water.Lf) / Ice.cp + tm, max=tm - _EPS_T)


@register_implementation(INTERFACE, "Nextsim::ThermoWinton")
class ThermoWinton(Configured):
    #: Sea-ice bulk-salinity melting point [degC].
    T_MELT = -Water.mu * Ice.s

    def __init__(self) -> None:
        self.k_snow = 0.31  # snow conductivity [W m-1 K-1]
        self.do_flooding = True

    def configure(self) -> None:
        self.k_snow = Configured.get_configuration("thermowinton.ks", 0.31)
        self.do_flooding = Configured.get_configuration("thermowinton.flooding", True)

    def calculate(
        self, *, hice, cice, hi_true, hs_true, tice0, t_bot, q_ia, dq_dt,
        q_io, subl, snowfall, dt, min_thickness, tice1=None, tice2=None,
        **_unused,
    ) -> SlabUpdate:
        tm = self.T_MELT
        rho_i, rho_s = Ice.rho, Ice.rho_snow
        c_i, lf = Ice.cp, Water.Lf
        ki, ks = Ice.kappa, self.k_snow

        t1 = torch.clamp(tice0 if tice1 is None else tice1, max=tm - _EPS_T)
        t2 = torch.clamp(tice0 if tice2 is None else tice2, max=tm - _EPS_T)

        no_ice = (hice == 0.0) | (cice == 0.0)
        hi = torch.where(no_ice, 1e-3, hi_true)  # guard; outputs masked later
        hs = hs_true

        # -- conductances (surface->1 through snow + hi/4; 1->2; 2->bottom) --
        k12 = 4.0 * ki * ks / (4.0 * ki * hs + ks * hi)
        k23 = 2.0 * ki / hi
        k3b = 4.0 * ki / hi

        # Linearized downward atmospheric flux about the old surface temp:
        # F(Ts) = a_lin - b_lin Ts (b_lin = dQia/dT > 0 stabilizes).
        a_lin = -q_ia + dq_dt * tice0
        b_lin = dq_dt

        m1 = rho_i * hi * 0.5  # layer masses per unit area [kg m-2]
        m2 = rho_i * hi * 0.5

        # Layer 2 (linear, implicit):
        #   (m2 c/dt)(T2'-T2) = k23(T1'-T2') + k3b(Tf - T2')
        #   => T2' = (c2 + k23 T1')/d2
        d2 = m2 * c_i / dt + k23 + k3b
        c2 = m2 * c_i / dt * t2 + k3b * t_bot

        def solve_t1(k_surf, rhs_surf_const):
            """Implicit layer-1 solve given the surface coupling:
            conduction into layer 1 = rhs_surf_const - k_surf * T1'."""
            k23_eff = k23 * (1.0 - k23 / d2)
            rhs_const = rhs_surf_const + k23 * c2 / d2
            # m1/dt [c(T1'-T1) + L Tm (1/T1' - 1/T1)] = rhs_const
            #        - (k_surf + k23_eff) T1'   | * T1'  => quadratic:
            a_q = m1 * c_i / dt + k_surf + k23_eff
            b_q = -m1 / dt * (c_i * t1 + lf * tm / torch.clamp(t1, max=-1e-6)) - rhs_const
            c_q = m1 * lf * tm / dt
            disc = torch.sqrt(torch.clamp(b_q * b_q - 4.0 * a_q * c_q, min=0.0))
            return (-b_q - disc) / (2.0 * a_q)

        # Unclamped: Ts' = (k12 T1' + a_lin)/(k12 + b_lin); conduction into
        # layer 1 = k12(Ts'-T1') = k12 a_lin/(k12+b_lin) - k_eff T1'.
        k_eff = k12 * b_lin / (k12 + b_lin)
        t1_free = solve_t1(k_eff, k12 * a_lin / (k12 + b_lin))
        ts_free = (k12 * t1_free + a_lin) / (k12 + b_lin)

        # Clamped at the surface melting point (0 with snow, Tm bare ice).
        t_surf_melt = torch.where(hs > 0.0, 0.0, torch.full_like(hs, tm))
        t1_clamp = solve_t1(k12, k12 * t_surf_melt)
        melting = ts_free > t_surf_melt
        t1_new = torch.clamp(torch.where(melting, t1_clamp, t1_free), max=tm - _EPS_T)
        t2_new = torch.clamp((c2 + k23 * t1_new) / d2, max=tm - _EPS_T)
        ts_new = torch.where(melting, t_surf_melt, ts_free)
        # Excess surface energy for melting: (F(Tmelt) - k12(Tmelt - T1')) dt.
        e_surf_melt = torch.where(
            melting,
            torch.clamp(
                (a_lin - b_lin * t_surf_melt - k12 * (t_surf_melt - t1_new)) * dt, min=0.0
            ),
            0.0,
        )
        #: Atmospheric flux actually applied this step [W m-2] (diagnostic,
        #: used by the energy-conservation tests).
        self.last_f_atm = a_lin - b_lin * ts_new

        # -- bottom growth / melt --------------------------------------------
        f_cond_bot = k3b * (t_bot - t2_new)  # heat entering ice from bottom
        bottom_balance = (f_cond_bot - q_io) * dt  # >0: freezing
        u2_new_ice = enthalpy2(t_bot, tm)
        grow = torch.clamp(bottom_balance, min=0.0) / (rho_i * (-u2_new_ice))
        e_bot_melt = torch.clamp(-bottom_balance, min=0.0)

        # Enthalpy-mix the new bottom ice into layer 2.
        h2 = hi * 0.5
        h1 = hi * 0.5
        q2_grown = safe_div(
            h2 * enthalpy2(t2_new, tm) + grow * u2_new_ice, h2 + grow
        )
        t2_new = torch.where(grow > 0.0, invert_enthalpy2(q2_grown, tm), t2_new)
        h2 = h2 + grow

        # Volumetric melt energies [J m-3] (energy to remove 1 m^3).
        e1 = rho_i * (-enthalpy1(t1_new, tm))
        e2 = rho_i * (-enthalpy2(t2_new, tm))
        es = rho_s * lf

        # Bottom melt: layer 2, then layer 1, then snow.
        melt = torch.minimum(e_bot_melt / e2, h2)
        h2 = h2 - melt
        rem = e_bot_melt - melt * e2
        melt = torch.minimum(rem / e1, h1)
        h1 = h1 - melt
        rem = rem - melt * e1
        melt = torch.minimum(rem / es, hs)
        hs_new = hs - melt
        leftover = rem - melt * es

        # Surface melt: snow, then layer 1, then layer 2.
        melt = torch.minimum(e_surf_melt / es, hs_new)
        hs_new = hs_new - melt
        rem = e_surf_melt - melt * es
        melt = torch.minimum(rem / e1, h1)
        h1 = h1 - melt
        rem = rem - melt * e1
        melt = torch.minimum(rem / e2, h2)
        h2 = h2 - melt
        leftover = leftover + rem - melt * e2
        # Melt energy with nothing left to melt warms the ocean instead.
        extra_to_ocean = leftover / dt

        # -- sublimation (snow first, then upper ice) and snowfall -----------
        hs_new = hs_new - subl / rho_s * dt
        ice_subl = torch.clamp(-hs_new, min=0.0) * rho_s / rho_i
        hs_new = torch.clamp(hs_new, min=0.0)
        h1 = torch.clamp(h1 - ice_subl, min=0.0)
        hs_new = hs_new + snowfall * dt / rho_s

        # -- flooding (snow-ice), joining the upper layer at T1 --------------
        hi_new = h1 + h2
        draught = (hi_new * rho_i + hs_new * rho_s) / Water.rho_ocean
        flood = (draught > hi_new) & self.do_flooding
        h_flood = torch.where(flood, draught - hi_new, 0.0)
        h1 = h1 + h_flood
        hs_new = hs_new - h_flood * rho_i / rho_s
        hi_new = h1 + h2

        # -- rebalance to equal layers, conserving enthalpy ------------------
        half = 0.5 * hi_new
        move_12 = torch.clamp(h1 - half, min=0.0)  # layer-1 material -> layer 2
        move_21 = torch.clamp(h2 - half, min=0.0)  # layer-2 material -> layer 1
        f12 = safe_div(move_12, half)
        f21 = safe_div(move_21, half)
        q1_cur = enthalpy1(t1_new, tm)
        q2_cur = enthalpy2(t2_new, tm)
        q2_mix = (1.0 - f12) * q2_cur + f12 * q1_cur
        q1_mix = (1.0 - f21) * q1_cur + f21 * q2_cur
        t2_fin = torch.where(move_12 > 0.0, invert_enthalpy2(q2_mix, tm), t2_new)
        t1_fin = torch.where(move_21 > 0.0, invert_enthalpy1(q1_mix, tm), t1_new)

        # -- full melt below the minimum thickness ---------------------------
        full_melt = hi_new < min_thickness
        e_rest = (
            0.5 * hi_new * (e1 + e2) + hs_new * es
        ) / dt  # latent heat of the discarded remnants (reference semantics)
        q_io_out = q_io + extra_to_ocean
        q_io_out = torch.where(full_melt, q_io_out + e_rest, q_io_out)
        hi_out = torch.where(full_melt, 0.0, hi_new)
        hs_out = torch.where(full_melt, 0.0, hs_new)
        ts_out = torch.where(full_melt, tm, ts_new)
        t1_out = torch.where(full_melt, tm - _EPS_T, t1_fin)
        t2_out = torch.where(full_melt, tm - _EPS_T, t2_fin)

        return SlabUpdate(
            hi_true=torch.where(no_ice, 0.0, hi_out),
            hs_true=torch.where(no_ice, 0.0, hs_out),
            t_surf=torch.where(no_ice, tm, ts_out),
            q_io=torch.where(no_ice, q_io, q_io_out),
            h_ice_from_snow=torch.where(no_ice | full_melt, 0.0, h_flood),
            t_layers=(
                torch.where(no_ice, tm - _EPS_T, t1_out),
                torch.where(no_ice, tm - _EPS_T, t2_out),
            ),
        )


def total_enthalpy(hi, hs, t1, t2, tm=ThermoWinton.T_MELT):
    """Total ice+snow enthalpy per unit area [J m-2] of tensors (the energy
    budget's test helper)."""
    return (
        Ice.rho * 0.5 * hi * (enthalpy1(t1, tm) + enthalpy2(t2, tm))
        - Ice.rho_snow * Water.Lf * hs
    )