"""chip_smoke.py: its phase logic at a small size on the CPU, its refusal
to run without a GPU, and (marked ``gpu``) its reference comparison on
the card."""

import jax
import numpy as np
import pytest

import chip_smoke


def test_phases_on_cpu_small(tmp_path, monkeypatch, capsys):
    """Phase 1 (hero checks, bin output) and phase 2 (f64 on two
    devices at 16^3, f32 against f64 at 32^3) in 8 blocks, every device
    the CPU.  (At 16^3 the blast shell is two cells wide and f32 against
    f64 exceeds the bound: see chip_smoke.TOL_F32_L1.)"""
    monkeypatch.setattr(chip_smoke, "RUN_DIR", str(tmp_path))
    cpu = jax.devices("cpu")[0]
    x64 = jax.config.jax_enable_x64
    hero = chip_smoke.phase_hero(cpu, nx=(32, 32, 32), mbx=16, ncycles=2)
    chip_smoke.phase_reference(cpu, cpu, hero, nx_small=(16, 16, 16),
                               mb_small=8, ncycles_small=2)
    assert jax.config.jax_enable_x64 == x64
    assert hero.final["u"].shape[0] == 8
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "Blast.mhd_w_bcc.00000.bin", "Blast.mhd_w_bcc.00001.bin"]
    out = capsys.readouterr().out
    assert "zone-cycles/cpu_second" in out and "compile_seconds" in out
    assert out.count("  ok: ") >= 8


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    cap = capsys.readouterr()
    assert "no GPU" in cap.err
    assert '"ok"' not in cap.out


def test_tolerance_check_fails_loudly():
    a = {"u": np.ones((1, 1, 5, 5, 5))}
    b = {"u": a["u"] * 1.01}
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.compare(a, b, 1, "max", 1e-3, "perturbed")


@pytest.mark.gpu
def test_reference_on_gpu(gpu, tmp_path, monkeypatch):
    """Phase 1 at 32^3 on the card, and phase 2 against the CPU at the
    script's own small size (64^3, where the share of branch flips is
    measured)."""
    monkeypatch.setattr(chip_smoke, "RUN_DIR", str(tmp_path))
    cpu = jax.devices("cpu")[0]
    hero = chip_smoke.phase_hero(gpu, nx=(32, 32, 32), mbx=16, ncycles=2)
    chip_smoke.phase_reference(gpu, cpu, hero)
