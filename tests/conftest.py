"""Test configuration: CPU backend with 8 virtual devices + f64.

Mirrors the reference test strategy (reference: tst/run_test_suite.py) of
running the full production path on CPU; the 8-device virtual mesh exercises
the block-axis sharding the driver validates separately on real hardware.

Tests marked ``gpu`` need an NVIDIA GPU and take it from the ``gpu``
fixture, which skips them where JAX finds none.  On a machine with a card:
``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu``.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX finds none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest tests -m gpu)")


# ---------------------------------------------------------------------------
# Test tiers: the files below hold the long SMR/AMR/NR/multigrid/convergence
# -matrix regressions (mirroring the reference's split between quick checks
# and the full tst/ suite).  `pytest -m "not slow"` is the fast tier and
# keeps at least one test per SURVEY.md §2 component row.
_SLOW_FILES = {
    "test_ahf.py", "test_amr.py", "test_amr_pool_compiles.py",
    "test_cce.py", "test_dyngr.py", "test_gr_torus.py", "test_gravity.py",
    "test_lwave_hydro.py", "test_lwave_mhd.py", "test_mri3d.py",
    "test_multigrid.py", "test_rad_gr.py",
    "test_radiation.py", "test_shard_comm.py", "test_shearing_box_mhd.py",
    "test_smr.py", "test_smr_mhd.py", "test_turb.py",
    "test_z4c_boosted.py", "test_z4c_puncture.py", "test_z4c_smr.py",
    "test_z4c_weyl.py",
}


# Individually-slow tests in otherwise-fast files (measured >40s on the
# 1-core CI box).  Each component keeps a cheaper fast representative:
# Z4c -> test_minkowski_rhs_zero + test_z4c_amr; coalesce -> sod
# bitmatch; particle comm -> routes_to_destination; GR ->
# test_gr_bondi; load balance -> the three algorithm tests; importers ->
# BNS path.
_SLOW_TESTS = {
    "test_z4c_linear_wave_propagates",
    "test_z4c_constraints_small",
    "test_coalesce_mhd_blast_bitmatch",
    "test_exchange_respects_dead_slots",
    "test_exchange_overflow_keeps_particles",
    "test_particles_in_shard_cycle",
    "test_monopole_field_rotation_rate",
    "test_gr_mhd_bondi_stationary",
    "test_weighted_shard_cycle_bit_matches",
    "test_z4c_adm_import_matches_direct",
    "test_plot_slice_and_hst",
}
# parametrized cases that dwarf their siblings
_SLOW_CASES = {"test_cpaw_smr_convergence[2D-0.007-0.45]"}


def pytest_collection_modifyitems(config, items):
    import pytest as _pytest
    for it in items:
        if (it.fspath.basename in _SLOW_FILES
                or it.originalname in _SLOW_TESTS
                or it.name in _SLOW_CASES):
            it.add_marker(_pytest.mark.slow)
