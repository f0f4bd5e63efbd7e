"""The ctypes signatures in ``srtpu_torch/ops/_build.py`` match the C
entry points in ``srtpu_torch/ops/csrc``: for each ``extern "C"`` function
the argument kinds (pointer, int, long long, float) in order, so that a
changed C signature cannot be called with the old argument list (ctypes
checks only the count it was given, on the card). Runs on the CPU: it
reads the sources, it builds nothing."""

import re

import pytest

from srtpu_torch.ops import _build

KINDS = {'float': _build._F, 'int': _build._I, 'long long': _build._L}


def entry_points() -> dict:
    """name -> argtypes parsed from every ``extern "C"`` definition."""
    found = {}
    for src in sorted(_build.CSRC.glob('*.cu')):
        text = re.sub(r'//[^\n]*', '', src.read_text())
        for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)\s*\{',
                             text):
            kinds = []
            for arg in m.group(2).split(','):
                arg = ' '.join(arg.split())
                if '*' in arg:
                    kinds.append(_build._P)
                else:
                    base = ' '.join(w for w in arg.split()[:-1]
                                    if w != 'const')
                    kinds.append(KINDS[base])
            found[m.group(1)] = kinds
    return found


ENTRIES = entry_points()


def test_every_signature_has_its_entry_point():
    assert set(_build.SIGNATURES) <= set(ENTRIES), (
        set(_build.SIGNATURES) - set(ENTRIES))


@pytest.mark.parametrize('name', sorted(_build.SIGNATURES))
def test_signature_matches_its_entry_point(name):
    assert _build.SIGNATURES[name] == ENTRIES[name], name
