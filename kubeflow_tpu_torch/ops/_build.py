"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` holds kernels behind a plain ``extern "C"`` launcher,
so ``nvcc`` compiles it in seconds without PyTorch's headers. The shared
library lands in ``<repo>/build/kubeflow_tpu_torch/`` under a name keyed
by a hash of the source and the flags: an edited source builds anew, an
unchanged one is loaded as it is. :func:`build` starts one ``nvcc`` per
source, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kubeflow_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: nvcc's output (ptxas registers, shared memory, spills) per source built
#: by this process.
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    candidates += [Path(found)] if found else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def sources() -> list[str]:
    return sorted(p.name for p in CSRC.glob("*.cu"))


def build(names: list[str] | None = None) -> list[str]:
    """Compile each named source (default: all) that has no library yet,
    one ``nvcc`` each, started together. Returns the names it compiled.
    A failed compile raises with nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names or sources():
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in running:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode:
            failed.append(f"nvcc failed for {name}:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return [name for name, *_ in running]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, built first if need be."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib
