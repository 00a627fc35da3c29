"""Full-step differential test against an independent pure-NumPy oracle.

SURVEY.md section 4 prescribes differential testing of the jitted model
against an un-jitted NumPy/f64 reference. This oracle re-derives the simple
configuration (centered vector-invariant momentum, centered tracer advection,
linear EOS, explicit free surface, no closure) from the discrete equations
with plain loops/slices — sharing no code with the JAX implementation — and
must agree to f64 roundoff.
"""

import numpy as np
import jax
import jax.numpy as jnp

from gb25_tpu.grids import latitude_longitude_grid
from gb25_tpu.models import ExplicitFreeSurface, time_step
from gb25_tpu.models.config import HydrostaticConfig
from gb25_tpu.models.state import initial_state
from gb25_tpu.ops.eos import LinearEquationOfState

NX, NY, NZ = 16, 10, 5
OMEGA = 7.292115e-5
G = 9.80665


def _grid():
    return latitude_longitude_grid(
        NX, NY, NZ, latitude=(-60.0, 60.0), longitude=(0.0, 360.0),
        depth=1000.0, surface_dz=None, dtype=jnp.float64,
    )


class Oracle:
    """Dense-loop reimplementation of the discrete equations."""

    def __init__(self, grid, eos):
        h = grid.hy
        self.Nx, self.Ny, self.Nz = grid.Nx, grid.Ny, grid.Nz
        self.dxc = np.asarray(grid.dxc)[0, h : h + NY, 0]  # (Ny,)
        self.dxf = np.asarray(grid.dxf)[0, h : h + NY, 0]
        self.dyc = np.asarray(grid.dyc)[0, h : h + NY, 0]
        self.dyf = np.asarray(grid.dyf)[0, h : h + NY, 0]
        self.azc = np.asarray(grid.azc)[0, h : h + NY, 0]
        self.azf = np.asarray(grid.azf)[0, h : h + NY, 0]
        hz = grid.hz
        self.dzc = np.asarray(grid.dz_c)[0, 0, hz : hz + NZ]
        self.dzf = np.asarray(grid.dz_f)[0, 0, hz : hz + NZ]
        self.zc = np.asarray(grid.z_c)[0, 0, hz : hz + NZ]
        self.phi_f = np.asarray(grid.phi_f)[h : h + NY]
        self.phi_c = np.asarray(grid.phi_c)[h : h + NY]
        self.eos = eos
        # mirrored ghost metrics for the wall rows
        self.dxc_g_lo = self.dxc[0]
        self.dxc_g_hi = self.dxc[-1]

    # index helpers with BCs: x periodic; y walls (mirror scalars/u, v=0)
    def cval(self, a, i, j, k):  # cell-centered scalars and u in y
        i = i % self.Nx
        if j < 0:
            j = -1 - j
        elif j >= self.Ny:
            j = 2 * self.Ny - 1 - j
        return a[i, j, k]

    def vval(self, v, i, j, k):  # y-face velocity; wall faces/ghosts antisym
        i = i % self.Nx
        if j == 0:
            return 0.0  # wall face (masked prognostically)
        if j < 0:
            return -v[i, -j, k] if -j < self.Ny else 0.0
        if j == self.Ny:
            return 0.0  # north wall (virtual face)
        if j > self.Ny:
            jj = 2 * self.Ny - j
            return -v[i, jj, k] if 0 < jj < self.Ny else 0.0
        return v[i, j, k]

    def eta_val(self, eta, i, j):
        i = i % self.Nx
        j = min(max(j, -1 - j if j < 0 else j), 0) if False else j
        if j < 0:
            j = -1 - j
        elif j >= self.Ny:
            j = 2 * self.Ny - 1 - j
        return eta[i, j]

    def metric_c(self, arr, j):  # center-located y metric with mirror
        if j < 0:
            j = -1 - j
        elif j >= self.Ny:
            j = 2 * self.Ny - 1 - j
        return arr[j]

    def diagnose_w(self, u, v):
        w = np.zeros((self.Nx, self.Ny, self.Nz + 1))
        for i in range(self.Nx):
            for j in range(self.Ny):
                for k in range(self.Nz):
                    dU = (
                        self.cval(u, i + 1, j, k) * self.dyc[j]
                        - self.cval(u, i, j, k) * self.dyc[j]
                    )
                    dV = (
                        self.vval(v, i, j + 1, k) * self.metric_dxf(j + 1)
                        - self.vval(v, i, j, k) * self.dxf[j]
                    )
                    div = (dU + dV) / self.azc[j]
                    w[i, j, k + 1] = w[i, j, k] - div * self.dzc[k]
        return w

    def metric_dxf(self, j):
        if j >= self.Ny:
            return self.dxf[self.Ny - 1]  # mirrored face metric (wall)
        return self.dxf[j]

    def buoyancy(self, T, S):
        b = np.zeros_like(T)
        for k in range(self.Nz):
            b[:, :, k] = self.eos.g * (
                self.eos.alpha * (T[:, :, k] - self.eos.T0)
                - self.eos.beta * (S[:, :, k] - self.eos.S0)
            )
        return b

    def pressure(self, b):
        # dp/dz = b, p(surface) = 0, integrated downward (independent loop
        # derivation; must agree in sign with the physical regression test
        # in test_physics_regression.py)
        p = np.zeros_like(b)
        for k in reversed(range(self.Nz)):
            above = (
                p[:, :, k + 1] - 0.5 * b[:, :, k + 1] * self.dzc[k + 1]
                if k + 1 < self.Nz
                else 0.0
            )
            p[:, :, k] = above - 0.5 * b[:, :, k] * self.dzc[k]
        return p

    def tendencies(self, u, v, T, S, eta):
        Nx, Ny, Nz = self.Nx, self.Ny, self.Nz
        w = self.diagnose_w(u, v)
        b = self.buoyancy(T, S)
        p = self.pressure(b)
        f_f = 2 * OMEGA * np.sin(np.deg2rad(self.phi_f))

        def zeta(i, j, k):  # corner (f,f); mirrored metrics at walls
            dyu = self.dyf[j] if j < Ny else self.dyf[-1]
            circ = (
                self.vval(v, i, j, k) * dyu - self.vval(v, i - 1, j, k) * dyu
                + self.cval(u, i, j - 1, k) * self.metric_c(self.dxc, j - 1)
                - self.cval(u, i, j, k) * self.metric_c(self.dxc, j)
            )
            azf = self.azf[j] if j < Ny else self.azf[-1]
            return circ / azf

        Gu = np.zeros_like(u)
        Gv = np.zeros_like(v)
        GT = np.zeros_like(T)
        GS = np.zeros_like(S)

        for i in range(Nx):
            for j in range(Ny):
                for k in range(Nz):
                    # --- u tendency at (f,c) ---
                    q_lo = zeta(i, j, k) + f_f[j]
                    # v at corners (f,f): x-interp of v
                    vbar_lo = 0.5 * (self.vval(v, i, j, k) + self.vval(v, i - 1, j, k))
                    vbar_hi = 0.5 * (self.vval(v, i, j + 1, k) + self.vval(v, i - 1, j + 1, k))
                    if j + 1 < Ny:
                        q_hi = zeta(i, j + 1, k) + f_f[j + 1]
                    else:
                        # virtual face Ny sits ON the north wall: mirrored
                        # face-coordinate extension puts the wall latitude there
                        dphi = self.phi_f[1] - self.phi_f[0]
                        wall = self.phi_f[0] + Ny * dphi
                        q_hi = zeta(i, j + 1, k) + 2 * OMEGA * np.sin(np.deg2rad(wall))
                    vbar_fc = 0.5 * (vbar_lo + vbar_hi)
                    q_u = 0.5 * (q_lo + q_hi)
                    gu = q_u * vbar_fc
                    # KE gradient
                    def K(ii, jj):
                        u2 = 0.5 * (self.cval(u, ii, jj, k) ** 2 + self.cval(u, ii + 1, jj, k) ** 2)
                        v2 = 0.5 * (self.vval(v, ii, jj, k) ** 2 + self.vval(v, ii, jj + 1, k) ** 2)
                        return 0.5 * (u2 + v2)
                    gu -= (K(i, j) - K(i - 1, j)) / self.dxc[j]
                    # vertical advection -w du/dz (centered)
                    dudz_lo = (
                        (self.cval(u, i, j, k) - self.cval(u, i, j, k - 1)) / self.dzf[k]
                        if k > 0 else 0.0
                    )
                    dudz_hi = (
                        (self.cval(u, i, j, k + 1) - self.cval(u, i, j, k)) / self.dzf[k + 1]
                        if k + 1 < Nz else 0.0
                    )
                    w_lo = 0.5 * (w[i, j, k] + w[(i - 1) % Nx, j, k])
                    w_hi = 0.5 * (w[i, j, k + 1] + w[(i - 1) % Nx, j, k + 1])
                    gu -= 0.5 * (w_lo * dudz_lo + w_hi * dudz_hi)
                    # pressure + surface gradient
                    gu -= (p[i, j, k] - p[(i - 1) % Nx, j, k]) / self.dxc[j]
                    gu -= G * (eta[i, j] - eta[(i - 1) % Nx, j]) / self.dxc[j]
                    Gu[i, j, k] = gu

                    # --- tracers (centered flux form) ---
                    for (C, GC) in ((T, GT), (S, GS)):
                        fx_hi = (
                            self.cval(u, i + 1, j, k) * self.dyc[j]
                            * 0.5 * (self.cval(C, i, j, k) + self.cval(C, i + 1, j, k))
                        )
                        fx_lo = (
                            self.cval(u, i, j, k) * self.dyc[j]
                            * 0.5 * (self.cval(C, i - 1, j, k) + self.cval(C, i, j, k))
                        )
                        fy_hi = (
                            self.vval(v, i, j + 1, k) * self.metric_dxf(j + 1)
                            * 0.5 * (self.cval(C, i, j, k) + self.cval(C, i, j + 1, k))
                        )
                        fy_lo = (
                            self.vval(v, i, j, k) * self.dxf[j]
                            * 0.5 * (self.cval(C, i, j - 1, k) + self.cval(C, i, j, k))
                        )
                        fz_hi = w[i, j, k + 1] * (
                            0.5 * (C[i, j, k] + C[i, j, k + 1]) if k + 1 < Nz else C[i, j, k]
                        )
                        fz_lo = w[i, j, k] * (
                            0.5 * (C[i, j, k - 1] + C[i, j, k]) if k > 0 else 0.0
                        )
                        gc = -(fx_hi - fx_lo + fy_hi - fy_lo) / self.azc[j]
                        gc -= (fz_hi - fz_lo) / self.dzc[k]
                        GC[i, j, k] = gc

        # Gv loop (separate for clarity)
        for i in range(Nx):
            for j in range(1, Ny):  # wall face j=0 masked
                for k in range(Nz):
                    q_lo = zeta(i, j, k) + f_f[j]
                    q_hi = zeta(i + 1, j, k) + f_f[j]
                    # u at corners: y-interp of u with mirrored ghosts
                    ubar_lo = 0.5 * (self.cval(u, i, j - 1, k) + self.cval(u, i, j, k))
                    ubar_hi = 0.5 * (self.cval(u, i + 1, j - 1, k) + self.cval(u, i + 1, j, k))
                    ubar_cf = 0.5 * (ubar_lo + ubar_hi)
                    q_v = 0.5 * (q_lo + q_hi)
                    gv = -q_v * ubar_cf

                    def K(ii, jj):
                        u2 = 0.5 * (self.cval(u, ii, jj, k) ** 2 + self.cval(u, ii + 1, jj, k) ** 2)
                        v2 = 0.5 * (self.vval(v, ii, jj, k) ** 2 + self.vval(v, ii, jj + 1, k) ** 2)
                        return 0.5 * (u2 + v2)

                    gv -= (K(i, j) - K(i, j - 1)) / self.dyf[j]
                    dvdz_lo = (
                        (self.vval(v, i, j, k) - self.vval(v, i, j, k - 1)) / self.dzf[k]
                        if k > 0 else 0.0
                    )
                    dvdz_hi = (
                        (self.vval(v, i, j, k + 1) - self.vval(v, i, j, k)) / self.dzf[k + 1]
                        if k + 1 < Nz else 0.0
                    )
                    w_lo = 0.5 * (w[i, j, k] + w[i, j - 1, k])
                    w_hi = 0.5 * (w[i, j, k + 1] + w[i, j - 1, k + 1])
                    gv -= 0.5 * (w_lo * dvdz_lo + w_hi * dvdz_hi)
                    gv -= (p[i, j, k] - p[i, j - 1, k]) / self.dyf[j]
                    gv -= G * (eta[i, j] - eta[i, j - 1]) / self.dyf[j]
                    Gv[i, j, k] = gv

        # eta tendency: -div of depth-integrated transport
        U = (u * self.dzc[None, None, :]).sum(-1)
        V = (v * self.dzc[None, None, :]).sum(-1)
        Geta = np.zeros_like(eta)
        for i in range(Nx):
            for j in range(Ny):
                dU = U[(i + 1) % Nx, j] * self.dyc[j] - U[i, j] * self.dyc[j]
                v_hi = V[i, j + 1] if j + 1 < Ny else 0.0
                v_lo = V[i, j] if j > 0 else 0.0
                dV = v_hi * self.metric_dxf(j + 1) - v_lo * self.dxf[j]
                Geta[i, j] = -(dU + dV) / self.azc[j]
        return Gu, Gv, GT, GS, Geta


def test_full_step_matches_numpy_oracle():
    grid = _grid()
    eos = LinearEquationOfState()
    cfg = HydrostaticConfig(
        tracers=("T", "S"),
        momentum_advection="vector_invariant",
        tracer_advection="centered2",
        eos=eos,
        free_surface=ExplicitFreeSurface(),
        closure=None,
       
        # the oracle's K() hardcodes the plain C-grid form; the production
        # default is the Hollingsworth-corrected KE (ops/operators.py)
        ke_scheme="standard",
    )

    rng = np.random.default_rng(7)
    u0 = rng.standard_normal((NX, NY, NZ)) * 1e-2
    v0 = rng.standard_normal((NX, NY, NZ)) * 1e-2
    v0[:, 0, :] = 0.0
    T0 = 10.0 + rng.standard_normal((NX, NY, NZ)) * 0.1
    S0 = 35.0 + rng.standard_normal((NX, NY, NZ)) * 0.1
    eta0 = rng.standard_normal((NX, NY)) * 1e-3

    state = initial_state(grid, ("T", "S"), jnp.float64).replace(
        u=jnp.asarray(u0), v=jnp.asarray(v0), eta=jnp.asarray(eta0),
        tracers={"T": jnp.asarray(T0), "S": jnp.asarray(S0)},
    )

    dt = 30.0
    s1 = jax.jit(time_step)(cfg, grid, state, dt)

    # oracle: Euler first step (iteration 0 -> c1=1, c2=0)
    o = Oracle(grid, eos)
    Gu, Gv, GT, GS, Geta = o.tendencies(u0, v0, T0, S0, eta0)
    u1 = u0 + dt * Gu
    v1 = v0 + dt * Gv
    v1[:, 0, :] = 0.0
    T1 = T0 + dt * GT
    S1 = S0 + dt * GS
    eta1 = eta0 + dt * Geta

    np.testing.assert_allclose(np.asarray(s1.tracers["T"]), T1, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(np.asarray(s1.tracers["S"]), S1, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(np.asarray(s1.eta), eta1, rtol=1e-10, atol=1e-15)
    np.testing.assert_allclose(np.asarray(s1.v), v1, rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(np.asarray(s1.u), u1, rtol=1e-9, atol=1e-13)
