"""Time the kernel library's build two ways, on the same sources and flags:

- serial: one nvcc call that compiles every ``csrc/*.cu`` in turn and links
  the shared library;
- parallel: ``_build.build_library`` (one nvcc per source, all started
  together, then one link).

Each build goes to a fresh temporary directory under ``_build/``, so nothing
is reused, and the two alternate (serial, parallel, parallel, serial, ...).
Last, each source is compiled alone, one after another: the parallel build
cannot beat the slowest of these. Run on a machine with the CUDA toolkit::

    python3 -m ssi_tpu_torch.time_build [--rounds 2]

Prints one line per build and a JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path

from ssi_tpu_torch import _build


def serial_build(work: Path) -> float:
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build._CSRC_DIR),
           "-o", str(work / "lib.so"), *map(str, _build._sources())]
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=1800)
    return time.perf_counter() - t0


def compile_alone(work: Path, src: Path) -> float:
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build._CSRC_DIR), "-c",
           "-o", str(work / f"{src.stem}.o"), str(src)]
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=1800)
    return time.perf_counter() - t0


def parallel_build(work: Path) -> float:
    default = _build._BUILD_DIR
    _build._BUILD_DIR = work
    try:
        _build.build_library()
    finally:
        _build._BUILD_DIR = default
    return _build.build_seconds


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    sources = [p.name for p in _build._sources()]
    times: dict[str, list[float]] = {"serial": [], "parallel": []}
    _build._BUILD_DIR.mkdir(exist_ok=True)
    for r in range(args.rounds):
        for kind in ("serial", "parallel") if r % 2 == 0 else ("parallel", "serial"):
            with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as work:
                secs = (serial_build if kind == "serial" else parallel_build)(Path(work))
            times[kind].append(secs)
            print(f"{kind:8s} build of {len(sources)} sources: {secs:.1f} s", flush=True)
    alone = {}
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as work:
        for src in _build._sources():
            alone[src.name] = compile_alone(Path(work), src)
            print(f"{src.name} alone: {alone[src.name]:.1f} s", flush=True)
    print(json.dumps({"sources": sources, "seconds": times, "alone": alone}))


if __name__ == "__main__":
    main()
