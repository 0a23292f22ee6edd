"""Each ctypes prototype ``ops/cuda_lib.py`` gives a kernel entry point
names as many arguments as the ``extern "C"`` function in ``csrc/`` takes.

ctypes does not check a prototype against the library: a call with one
argument more than its ``argtypes`` passes the extra one unconverted, so a
prototype left one short after the C function gained a parameter reads
the stream from garbage on the card. The counts are compared here, on the
sources, with no nvcc.
"""
import ctypes
import os
import re

import pytest

from dpr_scale_tpu_torch.ops import cuda_lib

_TYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "ll": ctypes.c_longlong,
          "u": ctypes.c_uint, "f": ctypes.c_float}


def _prototypes():
    """{name: argument count} of every ``lib.<name>.argtypes = ...`` line."""
    with open(cuda_lib.__file__) as f:
        src = f.read()
    return {name: len(eval(expr, {}, dict(_TYPES)))  # the file's own p, i, ll, u, f
            for name, expr in re.findall(r"lib\.(\w+)\.argtypes = (.+)", src)}


def _c_functions():
    """{name: parameter count} of every ``extern "C"`` function in csrc/."""
    out = {}
    for name in cuda_lib.SOURCES:
        with open(os.path.join(cuda_lib.SRC_DIR, name)) as f:
            src = f.read()
        for fn, params in re.findall(r'extern "C"[^(;]*?\b(\w+)\s*\(([^)]*)\)\s*\{', src):
            params = params.strip()
            out[fn] = 0 if params in ("", "void") else params.count(",") + 1
    return out


PROTOTYPES = _prototypes()


def test_every_entry_point_has_a_prototype():
    """Both sides name the same functions: a C entry point without a
    prototype would take ctypes' default int conversions."""
    assert len(PROTOTYPES) > 30
    assert set(PROTOTYPES) == set(_c_functions())


@pytest.mark.parametrize("name", sorted(PROTOTYPES))
def test_prototype_counts_the_c_parameters(name):
    assert PROTOTYPES[name] == _c_functions()[name]


def test_every_launching_entry_point_has_a_profile_class():
    """``cuda_lib.timed_launches`` times every entry point but the host-side
    queries (``HOST_QUERIES``), and ``tools.profile_serve`` files each timed
    one under ``PORT_CLASSES``: a launching entry point without a class is
    a KeyError on the card."""
    from dpr_scale_tpu_torch.tools.profile_serve import PORT_CLASSES

    launching = {n for n in PROTOTYPES if not n.endswith(cuda_lib.HOST_QUERIES)}
    assert launching - set(PORT_CLASSES) == set()
