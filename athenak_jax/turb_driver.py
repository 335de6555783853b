"""Ornstein-Uhlenbeck turbulence driving.

Parity target: the reference ``TurbulenceDriver``
(reference: src/srcterms/turb_driver.cpp:40-1206): solenoidal force built
from Gaussian Fourier amplitudes on shells nlow <= |n| <= nhigh with
spectrum |a_k| ~ k^-(expo+2)/2, net-momentum removal, amplitude
normalization to a fixed energy-injection rate dedt, OU time correlation
(white noise if tcorr=0), applied once per cycle.

Design: modes are host-precomputed wavevectors; per cycle the
force field is synthesized by a ``lax.scan`` over modes of
A_k cos(k.x) + B_k sin(k.x) with solenoidally-projected jax.random
Gaussian amplitudes — mathematically the same ensemble as the reference's
separable sin/cos products.  The RNG key and OU force live in the state
pytree, so checkpoints capture them (the reference stores its RNG state in
restart files the same way, reference: outputs/restart.cpp:262).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from .indices import IDN, IEN, IM1, IM2, IM3, IVX, IVY, IVZ


class TurbulenceDriver:
    def __init__(self, pin, mesh) -> None:
        self.mesh = mesh
        self.nlow = pin.get_or_add_integer("turb_driving", "nlow", 1)
        self.nhigh = pin.get_or_add_integer("turb_driving", "nhigh", 2)
        self.driving_type = pin.get_or_add_integer(
            "turb_driving", "driving_type", 0)
        self.expo = pin.get_or_add_real("turb_driving", "expo", 5.0 / 3.0)
        self.dedt = pin.get_or_add_real("turb_driving", "dedt", 0.0)
        self.tcorr = pin.get_or_add_real("turb_driving", "tcorr", 0.0)
        self.seed = pin.get_or_add_integer("turb_driving", "seed", 0)
        if self.driving_type != 0:
            raise NotImplementedError(
                "only isotropic driving (driving_type=0) is implemented")

        ms = mesh.mesh_size
        lx = ms.x1max - ms.x1min
        ly = ms.x2max - ms.x2min
        lz = ms.x3max - ms.x3min
        dk = (2.0 * math.pi / lx, 2.0 * math.pi / ly, 2.0 * math.pi / lz)

        # mode table: one entry per +/- pair (nk in a half-space)
        kvecs = []
        norms = []
        n2lo, n2hi = self.nlow ** 2, self.nhigh ** 2
        for nkx in range(0, self.nhigh + 1):
            for nky in range(-self.nhigh, self.nhigh + 1):
                for nkz in range(-self.nhigh, self.nhigh + 1):
                    if nkx == 0 and (nky < 0 or (nky == 0 and nkz <= 0)):
                        continue  # half-space: avoid double-counting
                    nsqr = nkx * nkx + nky * nky + nkz * nkz
                    if not (n2lo <= nsqr <= n2hi):
                        continue
                    k = (dk[0] * nkx, dk[1] * nky, dk[2] * nkz)
                    kiso = math.sqrt(k[0] ** 2 + k[1] ** 2 + k[2] ** 2)
                    kvecs.append(k)
                    norms.append(kiso ** (-(self.expo + 2.0) / 2.0))
        if not kvecs:
            raise ValueError("no driving modes in [nlow, nhigh]")
        self.kvec = np.array(kvecs)            # [nmode, 3]
        self.norm = np.array(norms)            # [nmode]
        self.nmode = len(kvecs)

        # broadcastable cell-center coordinates (host constants)
        mbi = mesh.mb_indcs
        nmb = mesh.nmb_total
        xc = np.empty((nmb, 1, 1, mbi.ncells1))
        yc = np.empty((nmb, 1, mbi.ncells2, 1))
        zc = np.empty((nmb, mbi.ncells3, 1, 1))
        for gid in range(nmb):
            x1v, x2v, x3v = mesh.cell_centers(gid)
            xc[gid, 0, 0, :] = x1v
            yc[gid, 0, :, 0] = x2v
            zc[gid, :, 0, 0] = x3v
        self.xc, self.yc, self.zc = xc, yc, zc
        self.shape = (nmb, 3, mbi.ncells3, mbi.ncells2, mbi.ncells1)

        # per-block fractional cell volume [nmb, 1, 1, 1]: the weight of
        # every volume integral below (constant 1/ncells-total on uniform
        # meshes; level-dependent on SMR/AMR — the reference integrates
        # with dx1*dx2*dx3 weights, turb_driver.cpp:717+)
        vol = (np.asarray(mesh.mb_size["dx1"])
               * np.asarray(mesh.mb_size["dx2"])
               * np.asarray(mesh.mb_size["dx3"]))
        self.wvol = (vol / (vol.sum() * mbi.nx1 * mbi.nx2 * mbi.nx3)
                     ).reshape(-1, 1, 1, 1)

    # ------------------------------------------------------------------
    def init_state_entries(self, dtype):
        return {
            "turb_force": jnp.zeros(self.shape, dtype=dtype),
            "turb_key": jax.random.PRNGKey(self.seed),
        }

    # ------------------------------------------------------------------
    def _synthesize(self, key, dtype):
        """New solenoidal Gaussian force field [nmb, 3, n3, n2, n1]."""
        ka, kb = jax.random.split(key)
        a = jax.random.normal(ka, (self.nmode, 3), dtype=dtype)
        b = jax.random.normal(kb, (self.nmode, 3), dtype=dtype)
        kv = jnp.asarray(self.kvec, dtype=dtype)
        nrm = jnp.asarray(self.norm, dtype=dtype)
        ksq = jnp.sum(kv * kv, axis=1, keepdims=True)
        # solenoidal projection: a -> a - (k.a) k / k^2
        a = (a - kv * jnp.sum(kv * a, axis=1, keepdims=True) / ksq) \
            * nrm[:, None]
        b = (b - kv * jnp.sum(kv * b, axis=1, keepdims=True) / ksq) \
            * nrm[:, None]

        # per-block coordinate tables: localized to the calling device
        # inside the shard cycle (pad slots clone block 0; their
        # contribution is killed by the zero-padded volume weights)
        from .comm import local_blocks
        xc = jnp.asarray(local_blocks(self.xc, pad_edge=True), dtype)
        yc = jnp.asarray(local_blocks(self.yc, pad_edge=True), dtype)
        zc = jnp.asarray(local_blocks(self.zc, pad_edge=True), dtype)

        def body(carry, inputs):
            kx, ky, kz, av, bv = inputs
            phase = kx * xc + ky * yc + kz * zc
            c = jnp.cos(phase)[:, None]
            s = jnp.sin(phase)[:, None]
            add = av[None, :, None, None, None] * c \
                + bv[None, :, None, None, None] * s
            return carry + add, None

        zero = jnp.zeros((xc.shape[0],) + self.shape[1:], dtype=dtype)
        force, _ = jax.lax.scan(
            body, zero, (kv[:, 0], kv[:, 1], kv[:, 2], a, b))
        return force

    # ------------------------------------------------------------------
    def apply(self, state, dt, phys):
        """One cycle of driving: synthesize -> de-mean -> normalize -> OU
        blend -> add momentum/energy -> remove net momentum.  Pure; runs
        inside the jitted cycle."""
        u = state["u"]
        w = state["w"]
        dtype = u.dtype
        mbi = self.mesh.mb_indcs
        act = (slice(None), slice(None),
               slice(mbi.ks, mbi.ke + 1),
               slice(mbi.js, mbi.je + 1),
               slice(mbi.is_, mbi.ie + 1))

        key, sub = jax.random.split(state["turb_key"])
        ftmp = self._synthesize(sub, dtype)

        den = u[:, IDN]
        dact = (slice(None), slice(mbi.ks, mbi.ke + 1),
                slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
        den_a = den[dact]
        # per-block volume weights; zero on pool-pad slots so the global
        # integrals ignore them (local_blocks zero-pads without pad_edge)
        from .comm import global_sum, local_blocks
        wv = jnp.asarray(local_blocks(self.wvol), dtype)

        # remove net momentum injection (reference: turb_driver.cpp:717-755;
        # the volume integrals psum over devices in the shard cycle, the
        # MPI_Allreduce analogue of turb_driver.cpp:742)
        t0 = global_sum(jnp.sum(wv * den_a))
        for c in range(3):
            tc = global_sum(jnp.sum(wv * den_a * ftmp[act][:, c]))
            ftmp = ftmp.at[:, c].add(-tc / t0)

        # normalize to dedt (reference: turb_driver.cpp:757-812)
        fa = ftmp[act]
        mom = u[act][:, IM1:IM3 + 1]
        t0 = global_sum(jnp.sum(wv * den_a * jnp.sum(fa * fa, axis=1)))
        t1 = global_sum(jnp.sum(wv * jnp.sum(mom * fa, axis=1)))
        m0 = jnp.maximum(0.5 * t0 * dt, 1.0e-20)
        m1 = t1
        # quadratic for s:  m0 s^2 + m1 s = dedt
        disc = jnp.sqrt(m1 * m1 / (4.0 * m0 * m0) + self.dedt / m0)
        s = jnp.where(m1 >= 0, -m1 / (2.0 * m0) + disc,
                      m1 / (2.0 * m0) + disc)
        ftmp = ftmp * s

        # OU blend (reference: turb_driver.cpp:830-872)
        if self.tcorr <= 1e-6:
            fcorr, gcorr = 0.0, 1.0
            force = ftmp
        else:
            fcorr = jnp.exp(-dt / self.tcorr)
            gcorr = jnp.sqrt(1.0 - fcorr * fcorr)
            force = fcorr * state["turb_force"] + gcorr * ftmp

        # apply forcing: dM = rho f dt, dE = f . M dt / rho ~ rho f.v dt
        vx, vy, vz = w[:, IVX], w[:, IVY], w[:, IVZ]
        fv = (force[:, 0] * vx + force[:, 1] * vy + force[:, 2] * vz)
        u = u.at[:, IM1].add(den * force[:, 0] * dt)
        u = u.at[:, IM2].add(den * force[:, 1] * dt)
        u = u.at[:, IM3].add(den * force[:, 2] * dt)
        if phys.eos.is_ideal:
            u = u.at[:, IEN].add(fv * den * dt)

        # remove residual net momentum (reference: turb_driver.cpp:1138-1200)
        t0 = global_sum(jnp.sum(wv * u[act][:, IDN]))
        for c, im in ((0, IM1), (1, IM2), (2, IM3)):
            tc = global_sum(jnp.sum(wv * u[act][:, im]))
            u = u.at[:, im].add(-den * tc / t0)

        out = dict(state)
        out.update({"u": u, "turb_force": force, "turb_key": key})
        return out
