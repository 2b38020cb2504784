"""Build the port's CUDA sources into shared libraries and load them.

Each source under ``csrc/`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``build/`` at the root of the checkout, once
per content (the file name carries a hash of the source, of the ``*.cuh``
headers beside it, which sources include, and of the flags), and loaded with
``ctypes``. :func:`load` starts one ``nvcc`` for each source
not built yet, all at once, and waits for them together. A failed build
raises; nothing falls back to another route.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
# -split-compile=0: each source's kernels are optimised on every core (the
# flash kernel's template instances build in 52 s, not 159, on the H100
# machine's 8 cores; the same times and results)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-split-compile=0", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# a solve-side kernel's entry point for each scalar type: afl_<kernel>_<suffix>
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@dataclasses.dataclass(frozen=True)
class Build:
    """A loaded library, and what building it took (0 s when cached)."""

    lib: ctypes.CDLL
    path: Path
    seconds: float
    log: str


_LOADED: dict[Path, Build] = {}
# one load at a time: the shards of a mesh reach a kernel's first build
# from threads of their own
_LOADING = threading.Lock()


def _target(source: Path) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    tag = digest.hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}_{tag}.so"


def load(*sources: Path) -> list[Build]:
    """Build (where needed, in parallel) and load each source, in order."""
    with _LOADING:
        return _load(sources)


def _load(sources) -> list[Build]:
    todo = [Path(s) for s in sources if Path(s) not in _LOADED]
    started = []
    for source in todo:
        path = _target(source)
        if path.exists():
            continue
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is None:
            raise RuntimeError("the CUDA toolkit (nvcc) was not found")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS,
               "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started.append((source, path, tmp, proc, time.perf_counter()))
    built = {}
    failures = []
    for source, path, tmp, proc, t0 in started:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc {source.name} failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        built[source] = (seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    for source in todo:
        path = _target(source)
        seconds, log = built.get(source, (0.0, ""))
        _LOADED[source] = Build(ctypes.CDLL(str(path)), path, seconds, log)
    return [_LOADED[Path(s)] for s in sources]
