"""Every deck in inputs/ builds: mesh + physics + pgen + outputs with
no unused parameters (the CLI's -v validate mode, main.py:252-268).

Mirrors the reference's expectation that the canonical inputs/ tree is
always runnable.
"""

import glob
import os

import pytest

from athenak_jax.athinput import ParameterInput

ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "inputs")
DECKS = sorted(glob.glob(os.path.join(ROOT, "**", "*.athinput"),
                         recursive=True))


@pytest.mark.slow
@pytest.mark.parametrize(
    "deck", DECKS, ids=[os.path.relpath(d, ROOT) for d in DECKS])
def test_deck_validates(deck):
    from athenak_jax.main import build, setup_precision
    from athenak_jax.mesh import Mesh
    from athenak_jax.outputs import make_outputs

    pin = ParameterInput.from_file(deck)
    setup_precision(pin)
    mesh = Mesh(pin)
    _, phys, _, _, _ = build(pin)
    make_outputs(pin, mesh, phys)
    pin.check_unused_parameters()
