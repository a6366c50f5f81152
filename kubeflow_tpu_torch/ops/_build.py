"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` holds kernels behind a plain ``extern "C"`` launcher,
so ``nvcc`` compiles it in seconds without PyTorch's headers. The shared
library lands in ``<repo>/build/kubeflow_tpu_torch/`` under a name keyed
by a hash of the source, the headers beside it (``*.cuh``, which the
sources include) and the flags: an edited source or header builds anew,
an unchanged one is loaded as it is. :func:`build` starts one ``nvcc`` per
source, all at once, and waits for them together. A source may also be
built from another directory (an older checkout's, to compare two kernels
in one process); other bytes make another library.
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
_LIBS: dict[tuple[str, str], ctypes.CDLL] = {}  # by (name, csrc)


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


def library_path(source: str, csrc: Path = CSRC) -> Path:
    """Where the library built from ``<csrc>/<source>`` lives."""
    src = Path(csrc) / source
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(Path(csrc).glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def sources() -> list[str]:
    return sorted(p.name for p in CSRC.glob("*.cu"))


def build(items=None) -> list[str]:
    """Compile each source (default: all of ``csrc/``) that has no library
    yet, one ``nvcc`` each, started together. An item is a source name or
    a ``(name, csrc_dir)`` pair. Returns what it compiled: the names, or
    the paths of sources outside ``csrc/`` (also the keys of
    :data:`BUILD_LOG`). A failed compile raises with nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for item in sources() if items is None else items:
        name, csrc = (item, CSRC) if isinstance(item, str) else item
        csrc = Path(csrc)
        out = library_path(name, csrc)
        if out.exists() or any(out == r[3] for r in running):
            continue  # built, or being built from the same bytes
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name if csrc == CSRC else str(csrc / name), proc,
                        tmp, out))
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


def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """The loaded library of ``<csrc>/<name>``, built first if need be."""
    key = (name, str(csrc))
    lib = _LIBS.get(key)
    if lib is None:  # hash the source once, not on every launch
        build([key])
        lib = _LIBS[key] = ctypes.CDLL(str(library_path(*key)))
    return lib
