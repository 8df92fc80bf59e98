"""The kernels' C entry points (physics_tpu_torch/csrc/*.cu) against the
ctypes argument lists _build.SIGNATURES gives them, on the CPU: each
entry is defined in one source, with as many parameters as its
signature lists (ctypes only checks the count at a call, on the card).
No JAX, no nvcc."""

import re

import pytest

from physics_tpu_torch import _build

_ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def _entries():
    found = {}
    for cu in sorted(_build.CSRC.glob("*.cu")):
        for name, params in _ENTRY.findall(cu.read_text()):
            found.setdefault(name, []).append(
                (cu.name, len([p for p in params.split(",") if p.strip()])))
    return found


ENTRIES = _entries()


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_its_entry(name):
    assert len(ENTRIES.get(name, [])) == 1, (name, ENTRIES.get(name))
    (_, count), = ENTRIES[name]
    assert count == len(_build.SIGNATURES[name]), name
