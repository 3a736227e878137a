"""Build the port's CUDA C++ sources at first use and load them with ctypes.

Every ``*.cu`` under ``src/repro_torch/csrc/`` compiles with ``nvcc`` into
its own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds, not minutes) under ``build/torch_kernels/`` of the
checkout.  The library's file name carries a hash of the source, the
headers beside it and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Stale sources compile in parallel, one
``nvcc`` process each.  A failed build raises with the compiler's output;
nothing falls back.  ``nvcc``'s ``-Xptxas -v`` report (registers, shared
memory, spills per kernel) is kept beside each library as ``<lib>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}   # a shared library loads once per process
_lock = threading.Lock()


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [Path(CUDA_HOME) / "bin" / "nvcc"] if CUDA_HOME else []
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError("nvcc not found (no CUDA toolkit): the port's CUDA "
                       "kernels cannot be built on this host")


def build_all() -> dict[str, Path]:
    """Compile every stale source (all at once); returns stem → library."""
    targets = {src.stem: (src, _target(src)) for src in sources()}
    stale = [(src, out) for src, out in targets.values() if not out.exists()]
    if stale:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for src, out in stale:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs.append((src, out, tmp, proc))
        errors = []
        for src, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"{src.name}: nvcc exited {proc.returncode}\n{log}")
                continue
            out.with_name(out.name + ".log").write_text(log)
            os.replace(tmp, out)    # atomic: a concurrent builder sees all or nothing
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return {stem: out for stem, (_, out) in targets.items()}


def library(stem: str, on_load=None) -> ctypes.CDLL:
    """The loaded shared library built from ``csrc/<stem>.cu``.  ``on_load``,
    if given, is called with the library once, when it first loads (to set
    its entry points' argument types)."""
    with _lock:
        if stem not in _loaded:
            libs = build_all()
            if stem not in libs:
                raise RuntimeError(f"no CUDA source csrc/{stem}.cu")
            lib = ctypes.CDLL(str(libs[stem]))
            if on_load is not None:
                on_load(lib)
            _loaded[stem] = lib
        return _loaded[stem]
