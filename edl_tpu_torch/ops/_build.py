"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with :mod:`ctypes`.  The build
happens at first use, under ``build/edl_tpu_torch/<hash>/`` at the repository
root, keyed by a hash of every file under ``csrc/`` and the compiler flags, so
an edited kernel or header is rebuilt and an unchanged one is reused.  All
sources compile in parallel, one ``nvcc`` each.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "edl_tpu_torch"
#: library name -> its one source file
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "group_norm": "group_norm.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def build_dir(csrc: Path = CSRC) -> Path:
    """Where this exact set of sources and flags builds to: a hash of the
    flags and of every file under ``csrc`` (name and bytes), so that any
    header a source includes keys the build too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(path.relative_to(csrc).as_posix().encode() + b"\0")
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(csrc: Path = CSRC, out: Optional[Path] = None,
          names: Iterable[str] = tuple(SOURCES)) -> float:
    """Compile every library of ``names`` from ``csrc`` that is not built in
    ``out`` yet (by default the package's sources into their hashed build
    directory); returns the seconds spent.  Raises with the compiler's
    output when a build fails.  The ptxas report (registers, shared memory,
    spills) of each build is kept beside its library as ``<name>.log``."""
    out = build_dir(csrc) if out is None else out
    todo = [n for n in names if not (out / f"lib{n}.so").exists()]
    if not todo:
        return 0.0
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-o", str(tmp),
               str(csrc / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log[-4000:]}")
            continue
        os.replace(tmp, out / f"lib{name}.so")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_report(name: str, out: Optional[Path] = None) -> list[dict]:
    """Per kernel of library ``name``, what ptxas reported when it was
    built (``<name>.log`` beside the library): the kernel's mangled name,
    registers a thread, static shared memory bytes, and spill store and
    load bytes."""
    out = build_dir() if out is None else out
    rows: list[dict] = []
    for line in (out / f"{name}.log").read_text().splitlines():
        if m := _PTXAS_ENTRY.search(line):
            rows.append(dict(kernel=m.group(1)))
        elif rows and (m := _PTXAS_USED.search(line)):
            smem = _PTXAS_SMEM.search(line)
            rows[-1].update(registers=int(m.group(1)),
                            static_smem_bytes=int(smem.group(1)) if smem
                            else 0)
        elif rows and (m := _PTXAS_SPILL.search(line)):
            rows[-1].update(spill_store_bytes=int(m.group(1)),
                            spill_load_bytes=int(m.group(2)))
    return rows


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building it first if needed), with the
    argument types of its entry points declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build()
            lib = _libs[name] = load(build_dir() / f"lib{name}.so", name)
        return lib


@contextlib.contextmanager
def substituted(name: str, lib: ctypes.CDLL):
    """Within the block, the kernel wrappers launch ``lib`` in place of the
    library ``name`` (how a fault planted in a copy of the sources is run
    through the wrappers)."""
    library(name)
    with _lock:
        kept, _libs[name] = _libs[name], lib
    try:
        yield
    finally:
        with _lock:
            _libs[name] = kept


def load(path: Path, name: str) -> ctypes.CDLL:
    """The library at ``path``, built from the source of ``name``, with the
    argument types of its entry points declared."""
    lib = ctypes.CDLL(str(path))
    _declare(lib, name)
    return lib


def _declare(lib: ctypes.CDLL, name: str) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "flash_fwd":
        fns = {"edl_flash_fwd": [p] * 5 + [i] * 6 + [f, p]}
    elif name == "group_norm":
        fns = {"edl_group_norm_fwd": [p] * 6 + [i] * 8 + [f, p],
               "edl_group_norm_bwd": [p] * 8 + [i] * 8 + [p],
               "edl_group_norm_active_clusters": [i] * 5 + [p]}
    else:
        fns = {"edl_flash_bwd_dq": [p] * 7 + [i] * 6 + [f, p],
               "edl_flash_bwd_dkv": [p] * 8 + [i] * 6 + [f, p]}
    for fn, argtypes in fns.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = i
