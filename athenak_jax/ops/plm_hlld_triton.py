"""PLM + HLLD fluxes along x1 in one Pallas kernel through Triton.

One program handles ``block`` faces of one x1 row of one block: it loads
the four cells of each face's PLM stencil for every primitive and
field channel, reconstructs, runs the pointwise HLLD core
(rsolvers_mhd.hlld_core) in registers and writes the flux and the two
EMFs once.  XLA fuses the same chain (``plm_hlld_x1_plain``) into the
stack of the flux channels and, on one H100 at 256^3, takes 10 ms where
the kernel takes 1.0 ms (PERF.md).  The plain path
is the reference and runs on every other platform; faces outside
[2, n1-1) are garbage in both, as in recon.plm.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..indices import IDN, IEN, IVX, IVY, IVZ
from . import recon, rsolvers_mhd
from .eos import EOSData

# faces per program and warps per program, the fastest of the
# configurations measured on one H100 at 256^3 (PERF.md)
BLOCK = 64
NUM_WARPS = 2


def _plm_faces(load, n1, i):
    """Left/right PLM states at faces ``i`` from ``load(offsets)``."""
    qm2, qm1, q0, qp1 = (load(i + s, (i + s >= 0) & (i + s < n1))
                         for s in (-2, -1, 0, 1))

    def dqm(qa, qb, qc):
        dql = qb - qa
        dqr = qc - qb
        dq2 = dql * dqr
        return jnp.where(dq2 <= 0.0, 0.0, dq2 / (dql + dqr))

    return qm1 + dqm(qm2, qm1, q0), q0 - dqm(qm1, q0, qp1)


def plm_hlld_x1_plain(w, bcc, x1f, eos: EOSData):
    """The plain path: recon.plm + rsolvers_mhd.hlld along x1."""
    wl, wr = recon.plm(w, 4)
    bl, br = recon.plm(bcc, 4)
    return rsolvers_mhd.hlld(wl, wr, bl, br, x1f[..., :-1], eos, IVX)


def plm_hlld_x1_auto(w, bcc, x1f, eos: EOSData):
    """The kernel where the program is compiled for an NVIDIA GPU, the
    plain path everywhere else."""
    return lax.platform_dependent(
        w, bcc, x1f,
        cuda=lambda *a: plm_hlld_x1(*a, eos),
        default=lambda *a: plm_hlld_x1_plain(*a, eos))


def plm_hlld_x1(w, bcc, x1f, eos: EOSData, block: int = BLOCK,
                num_warps: int = NUM_WARPS, interpret: bool = False):
    """x1 fluxes of w [nmb,5,n3,n2,n1], bcc [nmb,3,n3,n2,n1] with the
    face field x1f [nmb,n3,n2,n1+1]; returns (flux [nmb,5,n3,n2,n1],
    ey, ez [nmb,n3,n2,n1]) as rsolvers_mhd.hlld does."""
    nmb, nv, n3, n2, n1 = w.shape
    nrow = n3 * n2
    ntile = pl.cdiv(n1, block)
    gm1 = eos.gamma - 1.0

    def kernel(w_ref, b_ref, x_ref, f_ref, ey_ref, ez_ref):
        # one grid axis: CUDA caps the second and third at 65535
        pid = pl.program_id(0)
        mr = pid // ntile
        m = mr // nrow
        r = mr % nrow
        i = (pid % ntile) * block + jnp.arange(block, dtype=jnp.int32)
        inside = i < n1

        def chan(ref, nch, c):
            base = ((m * nch + c) * nrow + r) * n1

            def load(off, mask):
                return plgpu.load(ref.at[base + off], mask=mask, other=1.0)
            return _plm_faces(load, n1, i)

        wl, wr = zip(*(chan(w_ref, nv, c) for c in range(5)))
        bl, br = zip(*(chan(b_ref, 3, c) for c in range(3)))
        bx = plgpu.load(x_ref.at[(m * nrow + r) * (n1 + 1) + i],
                        mask=inside, other=1.0)

        def state(q, b):
            return (q[IDN], q[IVX], q[IVY], q[IVZ], b[1], b[2],
                    gm1 * q[IEN])

        fd, fmx, fmy, fmz, fe, fby, fbz = rsolvers_mhd.hlld_core(
            state(wl, bl), state(wr, br), bx, eos)
        for c, f in ((IDN, fd), (IVX, fmx), (IVY, fmy), (IVZ, fmz),
                     (IEN, fe)):
            plgpu.store(f_ref.at[((m * nv + c) * nrow + r) * n1 + i], f,
                        mask=inside)
        plgpu.store(ey_ref.at[(m * nrow + r) * n1 + i], -fby, mask=inside)
        plgpu.store(ez_ref.at[(m * nrow + r) * n1 + i], fbz, mask=inside)

    n4 = nmb * nrow * n1
    f, ey, ez = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((nmb * nv * nrow * n1,), w.dtype),
                   jax.ShapeDtypeStruct((n4,), w.dtype),
                   jax.ShapeDtypeStruct((n4,), w.dtype)),
        grid=(nmb * nrow * ntile,),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="plm_hlld_x1",
    )(w.reshape(-1), bcc.reshape(-1), x1f.reshape(-1))
    return (f.reshape(w.shape), ey.reshape(nmb, n3, n2, n1),
            ez.reshape(nmb, n3, n2, n1))
