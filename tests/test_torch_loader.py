"""The kernel loader's ctypes declarations against the C entry points of
``kernels/csrc``: every library, the stamps builds too, declares each
entry with as many arguments as its source takes under that build's
flags (a missing or extra argument would shift every later one)."""

from __future__ import annotations

import re
import types

import pytest

from poseidon_tpu_torch.kernels import loader


def _preprocess(src: str, defines: set[str]) -> str:
    """Keep the lines an ``#ifdef NAME`` / ``#else`` / ``#endif`` block
    keeps under ``defines`` (the only conditionals around entries)."""
    out, stack = [], []
    for line in src.splitlines():
        s = line.strip()
        if s.startswith("#ifdef "):
            stack.append(s.split()[1] in defines)
        elif s.startswith("#ifndef "):
            stack.append(s.split()[1] not in defines)
        elif s == "#else":
            stack[-1] = not stack[-1]
        elif s.startswith("#endif"):
            stack.pop()
        elif all(stack):
            out.append(line)
    return "\n".join(out)


def _entries(name: str) -> dict[str, int]:
    """Each extern "C" entry of the library's source: its argument count."""
    source, flags = loader._builds()[name]
    defines = {f[2:] for f in flags if f.startswith("-D")}
    src = _preprocess((loader._CSRC / f"{source}.cu").read_text(), defines)
    return {m[1]: len([a for a in m[2].split(",") if a.strip()])
            for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}


@pytest.mark.parametrize("name", sorted(loader._builds()))
def test_declarations_match_the_sources(name):
    entries = _entries(name)
    lib = types.SimpleNamespace(
        **{fn: types.SimpleNamespace() for fn in entries})
    loader._declare(name, lib)
    declared = {fn: len(f.argtypes) for fn, f in vars(lib).items()
                if hasattr(f, "argtypes")}
    assert declared == entries


def test_stamps_builds():
    """Two sources are built twice, the second with -DPHASE_STAMPS, and
    their stamped entries take one argument more."""
    builds = loader._builds()
    assert {n for n in builds if n.endswith("_stamps")} == {
        "top_will_stamps", "seat_sort_stamps"}
    for name in loader._STAMPED:
        plain, stamped = _entries(name), _entries(f"{name}_stamps")
        assert plain.keys() == stamped.keys()
        for fn in plain:
            more = 1 if fn in loader._STAMPED_ENTRIES else 0
            assert stamped[fn] == plain[fn] + more, fn
        assert "-DPHASE_STAMPS" in builds[f"{name}_stamps"][1]
        assert "-DPHASE_STAMPS" not in builds[name][1]
    assert loader._lib_path("seat_sort") != loader._lib_path(
        "seat_sort_stamps")
