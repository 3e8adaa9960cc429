"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface:
``int <name>_launch(...)`` returns the launch's ``cudaError_t`` and
``const char* <name>_error_string(int)`` names it.
``nvcc`` compiles it for ``sm_90a`` into a shared library under
``_build/`` (next to ``csrc/``, listed in ``.gitignore``) on first use,
and ``ctypes`` loads it.  Nothing here runs at import: this module is
imported on machines without ``nvcc``, where only the plain PyTorch
versions of the kernels run.

A library's file name carries a hash of its source, of every header
under ``csrc/`` that the source includes, and of the flags, so an
edited source or header rebuilds and a stale library is never loaded.
Libraries are written under a temporary name and renamed into place, so
processes that build at the same time never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "nvcc", "library_path",
           "build", "load", "launch", "build_logs", "no_grad_operands"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
_ENTRY: Dict[str, tuple] = {}     # name -> (launch function, its argtypes)
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built from source on first use")
    return found


def _sources(src: Path) -> List[Path]:
    """``src`` and every ``csrc`` header it includes with ``#include "..."``,
    directly or through another header, each once."""
    found: List[Path] = []
    todo = [src]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        if not path.is_file():
            raise FileNotFoundError(f"kernel source {path} is missing")
        found.append(path)
        todo.extend(path.parent / inc for inc in
                    _INCLUDE.findall(path.read_text()))
    return found


def library_path(name: str) -> Path:
    """The library built from ``csrc/<name>.cu``; its name hashes the
    source, the headers it includes and the compiler flags."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in _sources(CSRC / f"{name}.cu"):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns each compiled kernel's
    compiler output (``-Xptxas -v``: registers, shared memory, spills);
    raises ``RuntimeError`` with the output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (lib, tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)
        lib.with_suffix(".log").write_text(out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def build_logs(name: str) -> str:
    """The compiler output saved when ``name``'s library was built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def launch(name: str, argtypes, *args, device=None) -> None:
    """Call ``<name>_launch(*args)`` in kernel ``name``'s library (built
    first if needed); raise ``RuntimeError`` with CUDA's message when the
    launch returns an error (a refused launch never runs, and a later
    synchronize would not report it).  The function and its argument
    types are set up once per kernel, not on every launch.  With a CUDA
    ``device``, the launch runs with it current, entering
    ``torch.cuda.device`` only when another device is current (entering
    it costs the host more than the rest of a small launch)."""
    if device is not None:
        if device.index != torch.cuda.current_device():
            with torch.cuda.device(device):
                return launch(name, argtypes, *args)
    argtypes = tuple(argtypes)
    fn, types = _ENTRY.get(name, (None, None))
    if fn is None or types != argtypes:
        fn = getattr(load(name), f"{name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _ENTRY[name] = (fn, argtypes)
    err = fn(*args)
    if err:
        msg_fn = getattr(load(name), f"{name}_error_string")
        msg_fn.restype = ctypes.c_char_p
        msg_fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{msg_fn(err).decode()} ({err})")


def no_grad_operands(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` when grad mode is on and an operand of
    kernel ``name`` requires grad.  The kernels (and, for the same
    contract on the CPU, their wrappers' plain versions) have no
    backward, as the reference's ``pallas_call`` has none: a kernel's
    output is written through ``ctypes`` into a fresh tensor that
    autograd does not see, so a loss through it would silently get no
    gradient for its inputs.  Train on ``use_kernels=False``, the
    reference's training path."""
    if not torch.is_grad_enabled():
        return
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an operand requires grad, but the kernel has no "
            "backward (as the reference's pallas_call has none); run it "
            "under torch.no_grad(), or train with use_kernels=False")
