"""Physics source terms for the Hydro/MHD equations.

Parity target: the reference ``SourceTerms`` class
(reference: src/srcterms/srcterms.cpp:37-306, srcterms_newdt.cpp:25-111):
constant acceleration, optically-thin ISM cooling (SPEX curve of Schure et
al. 2009 + Koyama & Inutsuka 2002 low-T branch + CGOLS high-T fit),
relativistic cooling, and self-gravity momentum/energy sources.  Each fluid
owns its own instance (input blocks ``<hydro_srcterms>`` / ``<mhd_srcterms>``).

Design: every source is a pure vectorized update applied to the
whole active region at once; the data-dependent branches of the cooling
curve become ``jnp.where`` selects and the tabulated segment becomes a
static-constant gather.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .indices import IDN, IEN, IM1, IM2, IM3, IVX, IVY, IVZ
from .units import Units

_TINY = float(np.finfo(np.float32).tiny)
_HUGE = float(np.finfo(np.float32).max)

# log10(Lambda) SPEX cooling table, 4.12 <= log10(T) <= 8.16 in steps of
# 0.04 dex (Schure et al. 2009, Table 2 — published data, same values the
# reference tabulates in src/srcterms/ismcooling.hpp:21-34)
_SPEX_LOG_LAMBDA = np.array([
    -22.5977, -21.9689, -21.5972, -21.4615, -21.4789, -21.5497, -21.6211,
    -21.6595, -21.6426, -21.5688, -21.4771, -21.3755, -21.2693, -21.1644,
    -21.0658, -20.9778, -20.8986, -20.8281, -20.7700, -20.7223, -20.6888,
    -20.6739, -20.6815, -20.7051, -20.7229, -20.7208, -20.7058, -20.6896,
    -20.6797, -20.6749, -20.6709, -20.6748, -20.7089, -20.8031, -20.9647,
    -21.1482, -21.2932, -21.3767, -21.4129, -21.4291, -21.4538, -21.5055,
    -21.5740, -21.6300, -21.6615, -21.6766, -21.6886, -21.7073, -21.7304,
    -21.7491, -21.7607, -21.7701, -21.7877, -21.8243, -21.8875, -21.9738,
    -22.0671, -22.1537, -22.2265, -22.2821, -22.3213, -22.3462, -22.3587,
    -22.3622, -22.3590, -22.3512, -22.3420, -22.3342, -22.3312, -22.3346,
    -22.3445, -22.3595, -22.3780, -22.4007, -22.4289, -22.4625, -22.4995,
    -22.5353, -22.5659, -22.5895, -22.6059, -22.6161, -22.6208, -22.6213,
    -22.6184, -22.6126, -22.6045, -22.5945, -22.5831, -22.5707, -22.5573,
    -22.5434, -22.5287, -22.5140, -22.4992, -22.4844, -22.4695, -22.4543,
    -22.4392, -22.4237, -22.4087, -22.3928], dtype=np.float64)


def ism_cool_fn(temp):
    """Vectorized ISM cooling rate Lambda(T) in cgs.

    Branches (reference: src/srcterms/ismcooling.hpp:36-56):
      log T <= 4.2           Koyama & Inutsuka (2002) fit
      4.2 < log T <= 8.15    SPEX table, linear interp at 0.04 dex
      log T > 8.15           CGOLS power-law fit
    """
    temp = jnp.maximum(temp, _TINY)
    logt = jnp.log10(temp)

    low = (2.0e-19 * jnp.exp(-1.184e5 / (temp + 1.0e3))
           + 2.8e-28 * jnp.sqrt(temp) * jnp.exp(-92.0 / jnp.maximum(temp, _TINY)))
    high = 10.0 ** (0.45 * logt - 26.065)

    idx = jnp.clip((25.0 * logt).astype(jnp.int32) - 103, 0, 100)
    x0 = 4.12 + 0.04 * idx.astype(temp.dtype)
    dx = logt - x0
    tab = _SPEX_LOG_LAMBDA.astype(np.float64)
    logcool = (jnp.take(tab, idx + 1) * dx
               - jnp.take(tab, idx) * (dx - 0.04)) * 25.0
    mid = 10.0 ** logcool

    return jnp.where(logt <= 4.2, low, jnp.where(logt > 8.15, high, mid))


class SourceTerms:
    """Source terms enabled by flags in a ``<*_srcterms>`` input block."""

    def __init__(self, block: str, pin, mesh, eos) -> None:
        self.mesh = mesh
        self.eos = eos
        self.const_accel = pin.get_or_add_boolean(block, "const_accel", False)
        self.ism_cooling = pin.get_or_add_boolean(block, "ism_cooling", False)
        self.rel_cooling = pin.get_or_add_boolean(block, "rel_cooling", False)
        self.self_gravity = pin.get_or_add_boolean(block, "self_gravity",
                                                   False)
        self.shearing_box = False  # set by ShearingBox module

        if self.const_accel:
            self.const_accel_val = pin.get_real(block, "const_accel_val")
            self.const_accel_dir = pin.get_integer(block, "const_accel_dir")
            if not 1 <= self.const_accel_dir <= 3:
                raise ValueError("const_accel_dir must be 1, 2, or 3")

        if self.ism_cooling or self.rel_cooling:
            self.units = Units(pin)
        if self.ism_cooling:
            self.hrate = pin.get_real(block, "hrate")
        if self.rel_cooling:
            self.crate_rel = pin.get_real(block, "crate_rel")
            self.cpower_rel = pin.get_or_add_real(block, "cpower_rel", 1.0)

        # gravity potential provider, set when self-gravity module attaches:
        # fn() is not possible in pure functions — the caller passes phi
        self.any_enabled = (self.const_accel or self.ism_cooling
                            or self.rel_cooling or self.self_gravity)

    # ------------------------------------------------------------------
    def _cooling_units(self):
        u = self.units
        n_unit = u.density_cgs / u.mu / 1.660538921e-24
        cooling_unit = u.pressure_cgs / u.time_cgs / n_unit / n_unit
        heating_unit = u.pressure_cgs / u.time_cgs / n_unit
        return u.temperature_cgs, cooling_unit, heating_unit

    # ------------------------------------------------------------------
    def apply(self, u, w, beta_dt, flx=None, phi=None):
        """Add all enabled sources to conserved u using primitives w
        (reference: SourceTerms::ApplySrcTerms, srcterms.cpp:93-101).
        Ghost zones are updated too (harmless: refilled right after)."""
        eos = self.eos
        if self.const_accel:
            g = self.const_accel_val
            d = self.const_accel_dir  # 1,2,3 -> IM1,IM2,IM3
            src = beta_dt * g * w[:, IDN]
            u = u.at[:, d].add(src)
            if eos.is_ideal:
                u = u.at[:, IEN].add(src * w[:, d])

        if self.ism_cooling:
            gm1 = eos.gamma - 1.0
            temp_unit, cooling_unit, heating_unit = self._cooling_units()
            temp = temp_unit * w[:, IEN] / w[:, IDN] * gm1
            lam = ism_cool_fn(temp) / cooling_unit
            gam_heat = self.hrate / heating_unit
            u = u.at[:, IEN].add(
                -beta_dt * w[:, IDN] * (w[:, IDN] * lam - gam_heat))

        if self.rel_cooling:
            gm1 = eos.gamma - 1.0
            temp = w[:, IEN] / w[:, IDN] * gm1
            ux, uy, uz = w[:, IVX], w[:, IVY], w[:, IVZ]
            ut = jnp.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
            cool = (temp * self.crate_rel) ** self.cpower_rel
            fac = beta_dt * w[:, IDN] * cool
            u = u.at[:, IEN].add(-fac * ut)
            u = u.at[:, IM1].add(-fac * ux)
            u = u.at[:, IM2].add(-fac * uy)
            u = u.at[:, IM3].add(-fac * uz)

        if self.self_gravity and phi is not None:
            u = self._self_gravity(u, w, beta_dt, flx, phi)
        return u

    # ------------------------------------------------------------------
    def _self_gravity(self, u, w, beta_dt, flx, phi):
        """Momentum + Godunov-flux energy source from the potential
        (Mullen, Hanawa & Gammie 2020; reference: srcterms.cpp:215-306).
        phi is cell-centered [nmb, 1, n3, n2, n1] with valid ghosts."""
        ms = self.mesh.mesh_size
        mbi = self.mesh.mb_indcs
        p = phi[:, 0]
        if getattr(self.mesh, "multilevel", False):
            from .comm import local_blocks
            import numpy as _np

            def _dx(name):
                return local_blocks(
                    _np.asarray(self.mesh.mb_size[name]).reshape(
                        -1, 1, 1, 1), pad_edge=True)
            dx1, dx2, dx3 = _dx("dx1"), _dx("dx2"), _dx("dx3")
        else:
            dx1, dx2, dx3 = ms.dx1, ms.dx2, ms.dx3
        dirs = [(4, dx1, "x1", IM1)]
        if mbi.nx2 > 1:
            dirs.append((3, dx2, "x2", IM2))
        if mbi.nx3 > 1:
            dirs.append((2, dx3, "x3", IM3))
        for axis, dx, name, imom in dirs:
            a = axis - 1  # axis in 4D phi/channel arrays
            dpl = -(p - jnp.roll(p, 1, axis=a))       # phi(i) - phi(i-1)
            dpr = -(jnp.roll(p, -1, axis=a) - p)      # phi(i+1) - phi(i)
            hdtodx = 0.5 * beta_dt / dx
            u = u.at[:, imom].add(hdtodx * w[:, IDN] * (dpl + dpr))
            if self.eos.is_ideal and flx is not None:
                f = flx[name][:, IDN]
                fp = jnp.roll(f, -1, axis=a)
                u = u.at[:, IEN].add(hdtodx * (f * dpl + fp * dpr))
        return u

    # ------------------------------------------------------------------
    def new_dt(self, w):
        """Source-term dt limit (reference: srcterms_newdt.cpp:25-111)."""
        if not (self.ism_cooling or self.rel_cooling):
            return jnp.asarray(_HUGE, dtype=w.dtype)
        mbi = self.mesh.mb_indcs
        sl = (slice(None), slice(None),
              slice(mbi.ks, mbi.ke + 1),
              slice(mbi.js, mbi.je + 1),
              slice(mbi.is_, mbi.ie + 1))
        wa = w[sl]
        gm1 = self.eos.gamma - 1.0
        dt = jnp.asarray(_HUGE, dtype=w.dtype)
        if self.ism_cooling:
            temp_unit, cooling_unit, heating_unit = self._cooling_units()
            temp = temp_unit * wa[:, IEN] / wa[:, IDN] * gm1
            lam = ism_cool_fn(temp) / cooling_unit
            gam_heat = self.hrate / heating_unit
            ch = _TINY + jnp.abs(wa[:, IDN] * (wa[:, IDN] * lam - gam_heat))
            dt = jnp.minimum(dt, jnp.min(wa[:, IEN] / ch))
        if self.rel_cooling:
            temp = wa[:, IEN] / wa[:, IDN] * gm1
            ux, uy, uz = wa[:, IVX], wa[:, IVY], wa[:, IVZ]
            ut = jnp.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
            ch = _TINY + jnp.abs(
                wa[:, IDN] * ut
                * (temp * self.crate_rel) ** self.cpower_rel)
            dt = jnp.minimum(dt, jnp.min(wa[:, IEN] / ch))
        return dt
