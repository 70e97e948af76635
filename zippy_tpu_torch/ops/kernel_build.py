"""Build the port's native libraries and count its kernel launches.

* csrc/checksums.cu (K1-K3), csrc/inflate.cu (K4 and K9), csrc/huffman.cu
  (K5), csrc/resolve.cu (K6), csrc/match.cu (K7) and csrc/pack.cu (K8):
  nvcc for sm_90a, never with --use_fast_math; each includes
  csrc/device_scope.cuh.
* csrc/zippy_native.cpp (the host engine, native.py, and the decode's host
  scan, ops/inflate_scan.py): the host C++ compiler with zippy_tpu's own
  flags (HOST_FLAGS), -march=native among them.

Each library is built at first use into build/kernels/ under a name keyed by
its source's hash and, for the host source, by its flags and by the CPU that
builds it (its instruction set, which -march=native targets); it is built
through a temporary file renamed into place, so that processes building at
once do not race. `build_all` starts every missing build at once and waits
for them. Importing this module builds nothing.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import platform
import shutil
import subprocess

from ..common import ZippyError

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"

CUDA_SOURCES = ("checksums.cu", "inflate.cu", "huffman.cu", "resolve.cu",
                "match.cu", "pack.cu")
CUDA_HEADERS = ("device_scope.cuh",)
HOST_SOURCES = ("zippy_native.cpp",)
# The host compiler's flags: zippy_tpu's (zippy_tpu/native/build.py), since
# the host engine's streams are held byte-identical to the reference's.
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-fno-exceptions",
              "-march=native", "-pthread", "-Wall")

# Kernel launches per wrapper: one per launch, counted nowhere else.
LAUNCHES = {"adler_chunks": 0, "crc_rows": 0, "crc_combine": 0,
            "inflate_extract": 0, "huffman_tables": 0, "lz_resolve": 0,
            "match_tokens": 0, "pack_tokens": 0, "block_tables": 0}


def _find(names, what: str) -> str:
    for cand in names:
        if cand and os.path.exists(cand):
            return cand
    raise ZippyError(f"{what} not found: the native libraries build on "
                     "first use")


def _command(src: pathlib.Path, out: pathlib.Path) -> list[str]:
    if src.suffix == ".cu":
        nvcc = _find((shutil.which("nvcc"), os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")),
            "nvcc")
        return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v", "-o", str(out), str(src)]
    cxx = _find((shutil.which("c++"), shutil.which("g++")), "c++")
    return [cxx, *HOST_FLAGS, "-o", str(out), str(src)]


def cpu_identity() -> str:
    """The instruction set of this host's CPU: the "flags" line of
    /proc/cpuinfo (the machine's name and processor where there is none).
    A library built with -march=native runs only on a CPU that has them."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return f"{platform.machine()} {platform.processor()}"


def library_path(name: str) -> pathlib.Path:
    """Where the library of csrc/`name` lives, keyed by the hash of its
    source and, for a .cu source, of the headers it may include; for a
    host source, of HOST_FLAGS and cpu_identity()."""
    src = CSRC / name
    digest = hashlib.sha1(src.read_bytes())
    if src.suffix == ".cu":
        for header in CUDA_HEADERS:
            digest.update((CSRC / header).read_bytes())
    else:
        digest.update(" ".join(HOST_FLAGS).encode())
        digest.update(cpu_identity().encode())
    tag = digest.hexdigest()[:12]
    return BUILD_DIR / f"libzt_{src.stem}-{tag}.so"


def build_all(names=CUDA_SOURCES + HOST_SOURCES) -> dict:
    """Build the libraries of csrc/`names` that are not built yet, all at
    once. Returns {name: library path}; each compiler's output (for nvcc,
    each kernel's registers and shared memory) is beside its library as
    .log."""
    libs = {name: library_path(name) for name in names}
    todo = {name: lib for name, lib in libs.items() if not lib.exists()}
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            _command(CSRC / name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    try:
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate(timeout=600)
            lib = todo[name]
            lib.with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, lib)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise ZippyError("build failed: " + "\n".join(failed))
    return libs


def build(name: str) -> pathlib.Path:
    """The library of csrc/`name`, built if needed."""
    return build_all((name,))[name]


def check_launch(rc: int, name: str) -> None:
    """Raise on the CUDA error a kernel's entry point returned."""
    if rc != 0:
        raise ZippyError(f"{name} kernel launch failed: cudaError {rc}")
