"""General-relativistic radiation transport: frequency-integrated
intensities on the geodesic angular grid.

Parity target: the reference ``Radiation`` module
(reference: src/radiation/radiation.hpp:31-137, radiation_fluxes.cpp,
radiation_update.cpp, radiation_tetrad.cpp, radiation_source.cpp).

Formulation (matching the reference exactly):

  * evolved variable  i0(n) = n^0 n_0 I  per angle n of the geodesic
    grid, where n^mu = e_(a)^mu nh^(a) with the CKS orthonormal tetrad;
  * "primitive" intensity n_0 I = i0 / n^0, with n^0 = e_(0)^0 for all
    angles (the spatial tetrad legs have no time component);
  * spatial transport: upwind fluxes F^d = n^d (n_0 I) with n^d built
    from face tetrads; angular transport: edge speeds na from the Ricci
    rotation coefficients, divergence over the geodesic dual cells;
  * implicit radiation-fluid coupling in the comoving frame with the
    quartic equilibrium-temperature solve (radiation_source.cpp) lives
    in ``coupling.py`` and is driven by the composed RadiationFluid
    physics module.

Design: the angle axis is a channel axis [nmb, nangles, n3, n2, n1];
per-angle loops collapse into vectorized channel ops, the angular
divergence is a pair of gathers along the channel axis, and the tetrad
fields are closed-form functions of the (trace-time constant) cell
coordinates that XLA constant-folds or fuses.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from .geodesic_grid import GeodesicGrid

_HUGE = float(np.finfo(np.float32).max)


def _lb(tab):
    """Device-local rows of a per-block host table when tracing inside
    the shard_map cycle; identity otherwise (comm.local_blocks).  Pad
    slots clone block 0's geometry, matching shard_comm.pad_state; the
    reference's analogue is each rank holding only its own blocks' tetrad
    arrays (src/radiation/radiation.cpp per-pack allocations)."""
    from ..comm import local_blocks
    return local_blocks(tab, pad_edge=True)


class Radiation:
    is_mhd = False

    def __init__(self, pin, mesh, bvals) -> None:
        from ..coordinates import Coordinates

        self.mesh = mesh
        self.bvals = bvals
        nlevel = pin.get_or_add_integer("radiation", "nlevel", 2)
        self.multilevel = bool(getattr(mesh, "multilevel", False))
        self.grid = GeodesicGrid(nlevel)
        self.nvar = self.grid.nangles
        self.nangles = self.grid.nangles

        # coordinates: Minkowski unless <coord> requests GR/CKS
        self.coord = Coordinates(pin)
        cd = self.coord.coord_data
        self.is_gr = self.coord.is_general_relativistic
        self.minkowski = (not self.is_gr) or cd.is_minkowski
        self.spin = 0.0 if self.minkowski else cd.bh_spin
        self.excise = bool(getattr(cd, "bh_excise", False)) \
            and not self.minkowski

        # angular fluxes need edge tables (nlevel >= 1) and curvature
        default_af = (not self.minkowski) and self.grid.has_edges
        self.angular_fluxes = pin.get_or_add_boolean(
            "radiation", "angular_fluxes", default_af)
        if self.angular_fluxes and not self.grid.has_edges:
            raise ValueError("angular_fluxes requires nlevel >= 1")

        # opacities (gray; power-law opacities via power_opacity)
        self.kappa_a = pin.get_or_add_real("radiation", "kappa_a", 0.0)
        self.kappa_s = pin.get_or_add_real("radiation", "kappa_s", 0.0)
        self.kappa_p = pin.get_or_add_real("radiation", "kappa_p", 0.0)
        self.power_opacity = pin.get_or_add_boolean(
            "radiation", "power_opacity", False)
        self.arad = pin.get_or_add_real("radiation", "arad", 1.0)
        self.is_compton = pin.get_or_add_boolean(
            "radiation", "compton", False)
        if self.is_compton:
            # Compton needs the electron rest-mass temperature in code
            # units, so units must be enabled (reference:
            # src/radiation/radiation.cpp:81-86,
            # radiation_source.cpp:68-76)
            if not pin.does_block_exist("units"):
                raise ValueError(
                    "<radiation>/compton requires enabling units "
                    "(a <units> block)")
            from ..units import ELECTRON_REST_MASS_ENERGY_CGS, Units
            self.inv_t_electron = (Units(pin).temperature_cgs
                                   / ELECTRON_REST_MASS_ENERGY_CGS)
        self.fixed_fluid = pin.get_or_add_boolean(
            "radiation", "fixed_fluid", False)
        self.affect_fluid = pin.get_or_add_boolean(
            "radiation", "affect_fluid", True)
        self.n_0_floor = pin.get_or_add_real(
            "radiation", "n_0_floor", 0.05)
        self.recon_method = pin.get_or_add_string(
            "radiation", "reconstruct", "plm")

        mbi = mesh.mb_indcs
        self.shape = (mesh.nmb_total, self.nvar,
                      mbi.ncells3, mbi.ncells2, mbi.ncells1)

        def _dx(name):
            # per-block (level-dependent) spacing on refined meshes
            if self.multilevel:
                return mesh.mb_size[f"d{name}"].reshape(-1, 1, 1, 1, 1)
            return getattr(mesh.mesh_size, f"d{name}")

        self.dirs = [("x1", 4, 0, _dx("x1"))]
        if mbi.nx2 > 1:
            self.dirs.append(("x2", 3, 1, _dx("x2")))
        if mbi.nx3 > 1:
            self.dirs.append(("x3", 2, 2, _dx("x3")))

        # angle-direction constants [1, nangles, 1, 1, 1]
        nh4 = np.concatenate([np.ones((self.nangles, 1)), self.grid.nh],
                             axis=1)  # nh^(a), a=0..3
        self.nh4 = nh4
        self.wgt = self.grid.weights.reshape(1, -1, 1, 1, 1)
        self.sang = self.grid.solid_angles.reshape(1, -1, 1, 1, 1)

        # cell/face coordinates per block (host constants)
        nmb = mesh.nmb_total
        n1, n2, n3 = mbi.ncells1, mbi.ncells2, mbi.ncells3
        xv = np.empty((nmb, n1))
        yv = np.empty((nmb, n2))
        zv = np.empty((nmb, n3))
        xf = np.empty((nmb, n1 + 1))
        yf = np.empty((nmb, n2 + 1))
        zf = np.empty((nmb, n3 + 1))
        for g in range(nmb):
            c1, c2, c3 = mesh.cell_centers(g)
            f1, f2, f3 = mesh.face_edges(g)
            xv[g], yv[g], zv[g] = c1, c2, c3
            xf[g], yf[g], zf[g] = f1, f2, f3
        self._coords = (xv, yv, zv, xf, yf, zf)

        # geometry functions (pluggable: rad_snake overrides them with
        # its per-cell snake metric/tetrad via set_geometry, reference:
        # src/pgen/radiation/rad_snake.cpp:26-370)
        from .tetrad import norm_to_tet as _n2t
        from .tetrad import ricci_rotation as _ric
        from .tetrad import tetrad as _tet
        self._tet_fn = lambda X, Y, Z: _tet(X, Y, Z, self.spin,
                                            self.minkowski)
        self._ricci_fn = lambda X, Y, Z: _ric(X, Y, Z, self.spin,
                                              self.minkowski)
        self._n2t_fn = lambda X, Y, Z: _n2t(X, Y, Z, self.spin,
                                            self.minkowski)

        # precompute static tetrad-derived fields (numpy; XLA constants).
        # NOTE: all host-side tetrad math must run eagerly here — inside a
        # traced cycle the jnp ops in gr.cks.metric would become tracers
        self._build_tet_fields()
        self._n_mu = None
        self.tet_quantities()
        if self.angular_fluxes:
            self._build_angular_speeds()

        self.time_evolution = "dynamic"
        self.pturb = None
        self.ppart = None
        self.psbox = None
        self.eos = None
        self.srcterms_func = None
        self.user_hist_func = None
        # optional beam source: (dii0 [nmb, nang, n3, n2, n1], mask)
        self.beam_dii0 = None

    # ------------------------------------------------------------------
    def _bcast(self, xv, yv, zv):
        """[nmb, 1, n3, n2, n1] coordinate broadcast triplet."""
        X = xv[:, None, None, None, :]
        Y = yv[:, None, None, :, None]
        Z = zv[:, None, :, None, None]
        shp = (xv.shape[0], 1, zv.shape[1], yv.shape[1], xv.shape[1])
        return (np.broadcast_to(X, shp), np.broadcast_to(Y, shp),
                np.broadcast_to(Z, shp))

    def _build_tet_fields(self) -> None:
        xv, yv, zv, xf, yf, zf = self._coords
        X, Y, Z = self._bcast(xv, yv, zv)
        e, ecov = self._tet_fn(X, Y, Z)
        # n^0 = e_(0)^0 (angle-independent); n_mu per angle
        self.n0 = np.asarray(e[0][0])
        nh = self.nh4  # [nangles, 4]
        def ang(comp):
            # sum_a ecov[a][comp] * nh^(a) -> [nmb, nangles, n3, n2, n1]
            return sum(np.asarray(ecov[a][comp])
                       * nh[:, a].reshape(1, -1, 1, 1, 1)
                       for a in range(4))
        self.n_0 = ang(0)
        self._n_mu = None  # built lazily for moments (n_1..n_3)
        # face n^d: only the tetrad column d is needed
        self.nd_face = {}
        for name, _ax, d, _dx in self.dirs:
            if name == "x1":
                Xf, Yf, Zf = self._bcast(xf, yv, zv)
            elif name == "x2":
                Xf, Yf, Zf = self._bcast(xv, yf, zv)
            else:
                Xf, Yf, Zf = self._bcast(xv, yv, zf)
            ef, _ = self._tet_fn(Xf, Yf, Zf)
            nd = sum(np.asarray(ef[a][d + 1])
                     * nh[:, a].reshape(1, -1, 1, 1, 1)
                     for a in range(4))
            self.nd_face[name] = nd
        # excision mask (KS radius inside horizon)
        if self.excise:
            r2 = X * X + Y * Y + Z * Z
            a2 = self.spin * self.spin
            rks = np.sqrt((r2 - a2 + np.sqrt((r2 - a2) ** 2
                                             + 4.0 * a2 * Z * Z)) / 2.0)
            rh = 1.0 + math.sqrt(max(1.0 - a2, 0.0))
            self.excise_mask = (rks[:, 0] <= rh)  # [nmb, n3, n2, n1]
        else:
            self.excise_mask = None

    def _build_angular_speeds(self) -> None:
        """Edge advection speeds na[n, nb] from the Ricci rotation
        coefficients (reference: radiation_tetrad.cpp:180-220)."""
        g = self.grid
        xv, yv, zv = self._coords[:3]
        X, Y, Z = self._bcast(xv, yv, zv)
        X, Y, Z = X[:, 0], Y[:, 0], Z[:, 0]  # [nmb, n3, n2, n1]
        omega = self._ricci_fn(X, Y, Z)
        nmax = g.ind_neighbors.shape[1]
        na = np.zeros((self.mesh.nmb_total, self.nangles, nmax)
                      + X.shape[1:])
        for n in range(self.nangles):
            nn = int(g.num_neighbors[n])
            for nb in range(nn):
                nhf = np.concatenate([[1.0], g.cart_pos_mid[n, nb]])
                iszetaf = 1.0 / math.sqrt(1.0 - nhf[3] ** 2)
                na1 = 0.0
                na2 = 0.0
                for q in range(4):
                    for p in range(4):
                        nf_qp = nhf[q] * nhf[p]
                        na1 = na1 + nf_qp * (nhf[0] * omega[3][q][p]
                                             - nhf[3] * omega[0][q][p])
                        na2 = na2 + nf_qp * (nhf[2] * omega[1][q][p]
                                             - nhf[1] * omega[2][q][p])
                na[:, n, nb] = (iszetaf * na1 * g.unit_flux[n, nb, 0]
                                + na2 * g.unit_flux[n, nb, 1])
        self.na = na

    # ------------------------------------------------------------------
    def set_geometry(self, tet_fn, ricci_fn=None, n2t_fn=None) -> None:
        """Per-cell metric/tetrad override: rebuild every derived
        geometry table from user functions (reference: the rad_snake
        pgen overwrites tet_c/tetcov_c/na per cell,
        src/pgen/radiation/rad_snake.cpp:60-240).

        ``tet_fn(X, Y, Z) -> (e, ecov)`` like radiation.tetrad.tetrad;
        ``ricci_fn(X, Y, Z) -> omega[4][4][4]`` like ricci_rotation;
        ``n2t_fn`` like norm_to_tet (only needed with fluid coupling).
        """
        self._tet_fn = tet_fn
        if ricci_fn is not None:
            self._ricci_fn = ricci_fn
        if n2t_fn is not None:
            self._n2t_fn = n2t_fn
        self._build_tet_fields()
        self._n_mu = None
        if self.angular_fluxes:
            self._build_angular_speeds()

    def tet_quantities(self):
        """(n0 [nmb,1,...], n_0 [nmb,nang,...], n_mu list, norm_to_tet
        [4][4] arrays) for pgen / coupling use."""
        xv, yv, zv = self._coords[:3]
        X, Y, Z = self._bcast(xv, yv, zv)
        if self._n_mu is None:
            e, ecov = self._tet_fn(X, Y, Z)
            nh = self.nh4
            self._n_mu = [sum(np.asarray(ecov[a][c])
                              * nh[:, a].reshape(1, -1, 1, 1, 1)
                              for a in range(4)) for c in range(4)]
            # contravariant n^mu per angle (for the R^{munu} moments)
            self._n_up = [sum(np.asarray(e[a][c])
                              * nh[:, a].reshape(1, -1, 1, 1, 1)
                              for a in range(4)) for c in range(4)]
            # covariant tetrad components for frame projections
            # (drop the angle-broadcast axis; entries may be scalars)
            def _sq(v):
                v = np.asarray(v)
                return v[:, 0] if v.ndim == 5 else v

            self._ecov = [[_sq(ecov[a][c]) for c in range(4)]
                          for a in range(4)]
            n2t = self._n2t_fn(X[:, 0], Y[:, 0], Z[:, 0])
            self._n2t = [[np.asarray(n2t[a][nu]) for nu in range(4)]
                         for a in range(4)]
        # localized views inside the shard cycle (identity elsewhere)
        return (_lb(self.n0), _lb(self.n_0),
                [_lb(x) for x in self._n_mu],
                [[_lb(y) for y in row] for row in self._n2t])

    # ------------------------------------------------------------------
    def fluxes(self, i0):
        """Upwind transport fluxes F^d = n^d (n_0 I)
        (reference: radiation_fluxes.cpp:27-220)."""
        prim = i0 / _lb(self.n0)
        out = {}
        for name, axis, d, _dx in self.dirs:
            nd = self.nd_face[name]
            # face d has cell extent +1; flux stored cell-indexed (face i
            # = lower face of cell i) like the hydro fluxes
            ndc = _lb(np.take(nd, np.arange(nd.shape[axis] - 1),
                              axis=axis))
            im1 = jnp.roll(prim, 1, axis=axis)
            ip1 = jnp.roll(prim, -1, axis=axis)
            im2 = jnp.roll(prim, 2, axis=axis)
            # PLM states at face i (between cells i-1, i)
            dql = im1 - im2
            dqr = prim - im1
            dq2 = dql * dqr
            dqm = jnp.where(dq2 <= 0.0, 0.0,
                            2.0 * dq2 / (dql + dqr + 1e-300))
            il = im1 + 0.5 * dqm
            dql2 = prim - im1
            dqr2 = ip1 - prim
            dq22 = dql2 * dqr2
            dqm2 = jnp.where(dq22 <= 0.0, 0.0,
                             2.0 * dq22 / (dql2 + dqr2 + 1e-300))
            ir = prim - 0.5 * dqm2
            out[name] = jnp.where(ndc > 0.0, ndc * il, ndc * ir)
        return out

    def divfa(self, i0):
        """Angular flux divergence (reference:
        radiation_fluxes.cpp:225-246)."""
        g = self.grid
        prim = i0 / _lb(self.n0)
        nmax = g.ind_neighbors.shape[1]
        na_loc = _lb(self.na)
        out = 0.0
        for nb in range(nmax):
            na = na_loc[:, :, nb]
            nbr = jnp.take(prim, g.ind_neighbors[:, nb], axis=1)
            upw = jnp.where(na < 0.0, nbr, prim)
            arc = g.arc_lengths[:, nb].reshape(1, -1, 1, 1, 1)
            out = out + arc * na * upw
        return out / self.sang

    # ------------------------------------------------------------------
    def rk_update(self, i0, i1, flx, gam0, gam1, beta_dt):
        if self.multilevel:
            # conservative fine->coarse flux restriction at level
            # boundaries (reference: radiation SendFlux/RecvFlux path)
            from ..refinement import flux_correct_cc
            flx = flux_correct_cc(flx, self.mesh,
                                  [d[0] for d in self.dirs])
        divf = None
        for name, axis, _d, dx in self.dirs:
            f = flx[name]
            d = (jnp.roll(f, -1, axis=axis) - f) / _lb(dx)
            divf = d if divf is None else divf + d
        out = gam0 * i0 + gam1 * i1 - beta_dt * divf
        if self.angular_fluxes:
            out = out - beta_dt * self.divfa(i0)
        return out

    # ------------------------------------------------------------------
    def source(self, i0, beta_dt):
        """Standalone relaxation source for a fixed gray medium (the
        radiation-only limit of RadFluidCoupling; full fluid coupling
        lives in coupling.py)."""
        if self.kappa_a == 0.0 and self.kappa_s == 0.0:
            return i0
        n0 = _lb(self.n0)
        prim = i0 / n0               # n_0 I
        J = jnp.sum(self.wgt * prim, axis=1, keepdims=True)
        ka, ks = self.kappa_a, self.kappa_s
        denom = 1.0 + beta_dt * (ka + ks)
        return n0 * (prim + beta_dt * ks * J) / denom

    def _floor(self, i0):
        # n^0 n_0 I with I >= 0: n_0 < 0, so i0 must stay <= 0 where
        # n0 > 0; enforce via the primitive (reference update floor)
        nn = _lb(self.n0) * _lb(self.n_0)
        i0 = nn * jnp.maximum(i0 / nn, 0.0)
        if self.excise_mask is not None:
            m = _lb(self.excise_mask)[:, None]
            i0 = jnp.where(m, 0.0, i0)
            i0 = jnp.where(jnp.abs(_lb(self.n_0)) < self.n_0_floor,
                           0.0, i0)
        return i0

    # ------------------------------------------------- state-dict interface
    def make_state(self, i0):
        return {"u": i0, "w": i0}

    def save_state(self, state):
        return {"u1": state["u"]}

    def accumulate_rk4(self, saved, state, delta):
        return {"u1": saved["u1"] + delta * state["u"]}

    def init_ghosts(self, state):
        i0 = self.bvals.fill_ghosts(state["u"])
        return dict(state, u=i0, w=i0)

    def cons_to_prim(self, u):
        return u, u, {}

    def stage_update(self, state, saved, gam0, gam1, beta_dt):
        i0 = state["u"]
        flx = self.fluxes(i0)
        i0 = self.rk_update(i0, saved["u1"], flx, gam0, gam1, beta_dt)
        i0 = self.source(i0, beta_dt)
        if self.beam_dii0 is not None:
            i0 = i0 + beta_dt * _lb(self.beam_dii0)
        i0 = self._floor(i0)
        i0 = self.bvals.fill_ghosts(i0)
        return dict(state, u=i0, w=i0), {}

    def dt_from_state(self, state):
        """Light-speed CFL (reference: radiation_newdt.cpp)."""
        mbi = self.mesh.mb_indcs
        if self.multilevel:
            dt = float(np.min(self.mesh.mb_size["dx1"]))
            if mbi.nx2 > 1:
                dt = min(dt, float(np.min(self.mesh.mb_size["dx2"])))
            if mbi.nx3 > 1:
                dt = min(dt, float(np.min(self.mesh.mb_size["dx3"])))
        else:
            ms = self.mesh.mesh_size
            dt = ms.dx1
            if mbi.nx2 > 1:
                dt = min(dt, ms.dx2)
            if mbi.nx3 > 1:
                dt = min(dt, ms.dx3)
        return jnp.asarray(dt, dtype=state["u"].dtype)

    # ------------------------------------------------------------- moments
    def moments(self, i0):
        """Coordinate-frame (E, F^i) = (R^00, R^0i): R^0mu =
        int I n^0 n^mu dOmega = sum (i0/n_0) (n^mu/n^0) n^0 dOmega."""
        n0, n_0, n_mu, _ = self.tet_quantities()
        # R^00 = sum i0 / (n_0) * n^0 dOmega / n^0 ... use
        # I = i0/(n^0 n_0): R^00 = sum I (n^0)^2 dOmega
        II = i0 / (n0 * n_0)
        E = jnp.sum(self.sang * II * n0 * n0, axis=1)
        # n^i = (n_mu raised); for moments use n^i = n^0 * nh-projected:
        # in Minkowski n^i = nh^i; in GR reconstruct from tetrad columns
        F = []
        for name, _axis, d, _dx in self.dirs:
            nd = self.nd_face[name]
            # cell-centered n^d approx: average adjacent faces
            axis = _axis
            lo = np.take(nd, np.arange(nd.shape[axis] - 1), axis=axis)
            hi = np.take(nd, np.arange(1, nd.shape[axis]), axis=axis)
            ndc = 0.5 * (lo + hi)
            F.append(jnp.sum(self.sang * II * n0 * ndc, axis=1))
        while len(F) < 3:
            F.append(jnp.zeros_like(E))
        return E, F

    _SYM10 = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 2), (1, 3),
              (2, 2), (2, 3), (3, 3)]

    def coord_moments(self, state):
        """(labels, [nmb, 10, ...]) symmetric coordinate-frame moments
        R^{munu} for the rad_coord output variable (reference:
        derived_variables.cpp:1076-1143)."""
        i0 = state["u"] if "u" in state else state["i0"]
        R = self._moments10(i0)
        labels = [f"r{a}{b}" for a, b in self._SYM10]
        return labels, jnp.stack(R, axis=1)

    def _moments10(self, i0):
        """R^{munu} = sum_angles I n^mu n^nu dOmega, 10 sym channels."""
        n0, n_0, _, _ = self.tet_quantities()
        II = i0 / (n0 * n_0)
        return [jnp.sum(self.sang * II * self._n_up[a] * self._n_up[b],
                        axis=1) for a, b in self._SYM10]

    def _metric_cc_lower(self):
        """Cell-centered covariant metric (numpy, trace-time constant)."""
        if getattr(self, "_gl_cc", None) is None:
            from ..gr import cks
            xv, yv, zv = self._coords[:3]
            X, Y, Z = self._bcast(xv, yv, zv)
            gl, _ = cks.metric(X[:, 0], Y[:, 0], Z[:, 0],
                               self.spin, self.minkowski)
            self._gl_cc = [[np.asarray(gl[i][j]) for j in range(4)]
                           for i in range(4)]
        return self._gl_cc

    def fluid_moments(self, i0, w, gl=None):
        """(labels, [nmb, 10, ...]) fluid-frame moments: coordinate
        R^{munu} projected to the tetrad frame (tetcov, 0i sign flip)
        then Lorentz-boosted into the fluid rest frame (reference:
        derived_variables.cpp:1145-1260)."""
        from ..indices import IVX, IVY, IVZ

        Rs = self._moments10(i0)
        idx = {p: c for c, p in enumerate(self._SYM10)}

        def Rc(a, b):
            return Rs[idx[(a, b) if a <= b else (b, a)]]

        # tetrad-frame moments: R_tet[n1][n2] = ecov[n1].R.ecov[n2]
        ec = self._ecov
        Rt = {}
        for c, (a, b) in enumerate(self._SYM10):
            v = 0.0
            for m1 in range(4):
                for m2 in range(4):
                    v = v + ec[a][m1] * ec[b][m2] * Rc(m1, m2)
            if c in (1, 2, 3):
                v = -v
            Rt[(a, b)] = v

        def Rtet(a, b):
            return Rt[(a, b) if a <= b else (b, a)]

        # fluid velocity in the tetrad frame
        if gl is None:
            gl = self._metric_cc_lower()
        uu = (w[:, IVX], w[:, IVY], w[:, IVZ])
        q = (gl[1][1] * uu[0] ** 2 + gl[2][2] * uu[1] ** 2
             + gl[3][3] * uu[2] ** 2
             + 2.0 * (gl[1][2] * uu[0] * uu[1] + gl[1][3] * uu[0] * uu[2]
                      + gl[2][3] * uu[1] * uu[2]))
        u4 = (jnp.sqrt(1.0 + q),) + uu
        n2t = self._n2t
        ut = [sum(n2t[a][nu] * u4[nu] for nu in range(4))
              for a in range(4)]

        # Lorentz boost tetrad -> fluid rest frame
        L = [[None] * 4 for _ in range(4)]
        L[0][0] = ut[0]
        for a in range(1, 4):
            L[0][a] = L[a][0] = -ut[a]
            for b in range(a, 4):
                L[a][b] = L[b][a] = ut[a] * ut[b] / (1.0 + ut[0]) \
                    + (1.0 if a == b else 0.0)

        out = []
        for a, b in self._SYM10:
            v = 0.0
            for m1 in range(4):
                for m2 in range(4):
                    v = v + L[a][m1] * L[b][m2] * Rtet(m1, m2)
            out.append(v)
        labels = [f"fr{a}{b}" for a, b in self._SYM10]
        return labels, jnp.stack(out, axis=1)

    def coord_energy_density(self, state):
        E, _ = self.moments(state.get("i0", state.get("u")))
        return E
