"""Cold-build seconds of the port's kernel libraries.

  python -m vit_cnn_tpu_torch.tools.build_time [CSRC ...]

For each ``csrc`` directory (by default this package's; give another
checkout's, unpacked by ``git archive``, for a before-and-after), three
cold builds by :mod:`..ops._build`'s route and flags, each into a fresh
directory under ``build/``: the ``kernels`` library alone (what a
serving or training process waits for at its first launch), the
``probes`` library alone, and every source together in one library (what
building both takes, and what the port's first build took while it had
one library). Prints one JSON line a directory with the wall seconds of
each and the host's CPU count: the builds run on the host, not the card.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from pathlib import Path

from ..ops import _build

#: label -> the libraries whose sources one build compiles together
BUILDS = (("kernels_s", ("kernels",)), ("probes_s", ("probes",)),
          ("all_s", _build.LIBRARIES))


def cold_build(csrc: Path, libraries) -> float:
    """Wall seconds of one build of the named libraries' sources in csrc
    into one shared library, from nothing built."""
    srcs = [src for name in libraries for src in _build.sources(name, csrc)]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        out = Path(work) / "libvct_build_time.so"
        return _build.compile_and_link({out: srcs}, Path(work))[out]


def main(argv=None) -> int:
    dirs = [Path(a) for a in (sys.argv[1:] if argv is None else argv)]
    for csrc in dirs or [_build.CSRC]:
        row = {"csrc": str(csrc), "cpus": os.cpu_count()}
        for label, libraries in BUILDS:
            row[label] = cold_build(csrc, libraries)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
