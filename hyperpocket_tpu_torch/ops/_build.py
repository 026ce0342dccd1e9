"""Build the package's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, and the objects are
linked into one shared library with a plain C interface, in
``hyperpocket_tpu_torch/_build/<hash>/`` where the hash covers the sources,
the headers beside them and the flags: a changed source builds anew, an
unchanged one loads the library already there. The sources include no
PyTorch header, so a build takes seconds rather than minutes. ptxas reports
each kernel's registers, shared memory and spills (``-Xptxas -v``); the
report is kept beside the library as ``LOG_NAME`` and read back by
``ptxas_report``.

A build failure raises; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libhpcd_torch_kernels.so"
LOG_NAME = "nvcc.log"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` or the default toolkit prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def build(out_dir: Path, nvcc: str | None = None) -> Path:
    """Compile every ``csrc/*.cu`` into ``out_dir/LIB_NAME``; raise on failure."""
    nvcc = nvcc or find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / LIB_NAME
    # objects and the library are written under per-process names, then the
    # library is renamed: concurrent builders never load a half-written one
    tag = os.getpid()
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources()]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(sources(), objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in compiles]
    failures, logs = [], []
    for cmd, proc in zip(compiles, procs):
        out, err = proc.communicate()
        logs.append(f"{' '.join(cmd)}\n{out}{err}")
        if proc.returncode != 0:
            failures.append(f"exit code {proc.returncode}:\n{' '.join(cmd)}\n{out}{err}")
    try:
        if failures:
            raise RuntimeError("nvcc failed with " + "\n".join(failures))
        link = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(o) for o in objs)]
        proc = subprocess.run(link, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                               f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    log_tmp = out_dir / f"{LOG_NAME}.{tag}.tmp"
    log_tmp.write_text("\n".join(logs))
    os.replace(log_tmp, out_dir / LOG_NAME)
    os.replace(tmp, lib_path)
    return lib_path


def ptxas_report(log: str, kernel: str) -> list[dict]:
    """Registers, shared memory and spills of every entry function whose
    (mangled) name holds ``kernel``, from an ``nvcc -Xptxas -v`` log."""
    report, current = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = None
            if kernel in entry.group(1):
                current = {"function": entry.group(1)}
                report.append(current)
        elif current is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill:
                current["spill_stores"], current["spill_loads"] = map(int, spill.groups())
            regs = re.search(r"Used (\d+) registers", line)
            if regs:
                current["registers"] = int(regs.group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                current["static_smem"] = int(smem.group(1)) if smem else 0
    return report


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call of the process."""
    lib_path = BUILD_ROOT / source_hash() / LIB_NAME
    if not lib_path.exists():
        build(lib_path.parent)
    return ctypes.CDLL(str(lib_path))
