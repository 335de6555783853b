"""ParameterInput parser tests (reference semantics:
src/parameter_input.hpp)."""

from athenak_jax.athinput import ParameterInput

DECK = """
<comment>
problem = test

<job>
basename = Test   # comment here

<mesh>
nx1 = 64
x1min = -0.5
x1max = 0.5
ix1_bc = periodic

<hydro>
gamma = 1.4
"""


def test_parse_and_get():
    pin = ParameterInput.from_string(DECK)
    assert pin.get_string("job", "basename") == "Test"
    assert pin.get_integer("mesh", "nx1") == 64
    assert pin.get_real("mesh", "x1min") == -0.5
    assert pin.get_real("hydro", "gamma") == 1.4


def test_get_or_add():
    pin = ParameterInput.from_string(DECK)
    assert pin.get_or_add_integer("mesh", "nghost", 2) == 2
    assert pin.get_integer("mesh", "nghost") == 2
    assert pin.get_or_add_string("hydro", "rsolver", "llf") == "llf"


def test_cmdline_override():
    pin = ParameterInput.from_string(DECK)
    pin.modify_from_cmdline(["mesh/nx1=128", "time/tlim=0.5"])
    assert pin.get_integer("mesh", "nx1") == 128
    assert pin.get_real("time", "tlim") == 0.5


def test_dump_roundtrip():
    pin = ParameterInput.from_string(DECK)
    pin2 = ParameterInput.from_string(pin.dump())
    assert pin2.get_real("hydro", "gamma") == 1.4


def test_unused_parameters():
    pin = ParameterInput.from_string(DECK)
    pin.get_string("job", "basename")
    unused = pin.check_unused_parameters(stream=None)
    assert ("mesh", "nx1") in unused
    assert ("job", "basename") not in unused
