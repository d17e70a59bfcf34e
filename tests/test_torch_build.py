"""The kernel build's two libraries (no nvcc needed): which sources and
entry points each holds, and the build-time tool's builds."""

from __future__ import annotations

import json
import re

import pytest

from vit_cnn_tpu_torch.ops import _build
from vit_cnn_tpu_torch.tools import build_time


def _defined(src):
    return set(re.findall(r'extern "C"[^(]*?\b(vct_\w+)\s*\(',
                          src.read_text()))


def test_every_source_is_in_one_library():
    every = sorted(_build.CSRC.glob("*.cu"))
    parts = [_build.sources(name) for name in _build.LIBRARIES]
    assert sorted(sum(parts, [])) == every
    assert not set(parts[0]) & set(parts[1])
    assert [s.name for s in _build.sources("probes")] == sorted(
        _build.PROBE_SOURCES)
    with pytest.raises(ValueError, match="no kernel library"):
        _build.sources("other")


@pytest.mark.parametrize("library", _build.LIBRARIES)
def test_each_library_defines_the_entry_points_bound_from_it(library):
    defined = set().union(*map(_defined, _build.sources(library)))
    bound = {name for table in (_build._SIGNATURES,
                                _build._WORKSPACE_SIGNATURES)
             for name in table
             if (name in _build._PROBE_ENTRIES) == (library == "probes")}
    assert bound and bound <= defined


def test_library_paths_are_apart_and_keyed_by_sources():
    paths = [_build.library_path(name) for name in _build.LIBRARIES]
    assert len(set(paths)) == 2
    assert all(p.parent == _build.BUILD_DIR for p in paths)
    assert all(name in p.name for name, p in zip(_build.LIBRARIES, paths))


def test_build_time_compiles_each_library_and_both(monkeypatch, capsys):
    calls = []

    def fake(groups, work_dir):
        (out, srcs), = groups.items()
        calls.append([s.name for s in srcs])
        return {out: float(len(srcs))}

    monkeypatch.setattr(_build, "compile_and_link", fake)
    assert build_time.main([str(_build.CSRC)]) == 0
    row = json.loads(capsys.readouterr().out)
    kernels, probes = ([s.name for s in _build.sources(name)]
                       for name in _build.LIBRARIES)
    assert calls == [kernels, probes, kernels + probes]
    assert row["kernels_s"] == len(kernels) and row["probes_s"] == 2
    assert row["all_s"] == len(kernels) + 2 and row["cpus"] >= 1
