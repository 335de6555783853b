"""The Triton PLM + HLLD x1 flux kernel in interpret mode against the
plain path (recon.plm + rsolvers_mhd.hlld), and the MHD module's choice
of it.  On the card the kernel itself is compared by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build
from athenak_jax.ops.eos import EOSData
from athenak_jax.ops.plm_hlld_triton import (plm_hlld_x1, plm_hlld_x1_auto,
                                             plm_hlld_x1_plain)


def _states(dtype, shape=(2, 3, 4, 21), seed=0):
    """Random primitives (positive density and energy, signed velocity),
    cell-centred field and face field x1f."""
    rng = np.random.default_rng(seed)
    nmb, n3, n2, n1 = shape
    w = rng.uniform(0.5, 1.5, (nmb, 5, n3, n2, n1))
    w[:, 1:4] -= 1.0
    b = rng.uniform(-1.0, 1.0, (nmb, 3, n3, n2, n1))
    x1f = rng.uniform(-1.0, 1.0, (nmb, n3, n2, n1 + 1))
    return tuple(jnp.asarray(a, dtype) for a in (w, b, x1f))


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 2e-6),
                                       (jnp.float64, 1e-13)],
                         ids=["f32", "f64"])
def test_kernel_matches_plain_interpret(dtype, tol):
    """Every valid face [2, n1-1) of the flux and both EMFs; the block
    (8) does not divide n1 (21), so the masked tail tile is covered."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == jnp.float64)
    try:
        eos = EOSData(gamma=5.0 / 3.0)
        args = _states(dtype)
        got = plm_hlld_x1(*args, eos, block=8, interpret=True)
        ref = jax.jit(lambda *a: plm_hlld_x1_plain(*a, eos))(*args)
    finally:
        jax.config.update("jax_enable_x64", old)
    n1 = args[0].shape[-1]
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        g = np.asarray(g)[..., 2:n1 - 1]
        r = np.asarray(r)[..., 2:n1 - 1]
        assert np.abs(g - r).max() <= tol * np.abs(r).max()


@pytest.mark.gpu
def test_kernel_matches_plain_on_gpu(gpu):
    """The kernel as compiled for the card, default block, against the
    plain path on the same card."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        eos = EOSData(gamma=5.0 / 3.0)
        args = jax.device_put(_states(jnp.float32, shape=(2, 6, 5, 150)),
                              gpu)
        got = jax.jit(lambda *a: plm_hlld_x1(*a, eos))(*args)
        ref = jax.jit(lambda *a: plm_hlld_x1_plain(*a, eos))(*args)
    finally:
        jax.config.update("jax_enable_x64", old)
    n1 = args[0].shape[-1]
    for g, r in zip(got, ref):
        g = np.asarray(g)[..., 2:n1 - 1]
        r = np.asarray(r)[..., 2:n1 - 1]
        assert np.abs(g - r).max() <= 2e-6 * np.abs(r).max()


def test_auto_is_plain_off_the_gpu():
    """On the CPU the platform switch lowers the plain path only."""
    eos = EOSData()
    args = _states(jnp.float64)
    got = jax.jit(lambda *a: plm_hlld_x1_auto(*a, eos))(*args)
    ref = jax.jit(lambda *a: plm_hlld_x1_plain(*a, eos))(*args)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    txt = jax.jit(lambda *a: plm_hlld_x1_auto(*a, eos)).lower(
        *args).as_text()
    assert "triton" not in txt.lower()


DECK = """
<job>
basename = gate

<mesh>
nghost = 2
nx1 = 8
x1min = -0.5
x1max = 0.5
nx2 = 8
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 1.0

<mhd>
eos = ideal
reconstruct = plm
rsolver = hlld

<problem>
pgen_name = blast
inner_radius = 0.1
outer_radius = 0.25
prat = 100.0
b_amb = 0.1
"""


@pytest.mark.parametrize("override,uses", [
    ((), True),
    (("mhd/rsolver=hlle",), False),
    (("mhd/reconstruct=ppm4", "mesh/nghost=3"), False),
    (("mhd/nscalars=1",), False),
], ids=["plm_hlld", "hlle", "ppm4", "scalars"])
def test_mhd_chooses_x1_kernel(override, uses):
    pin = ParameterInput.from_string(DECK)
    pin.modify_from_cmdline(list(override))
    _, phys, _, _, _ = build(pin)
    assert phys.x1_kernel is uses
