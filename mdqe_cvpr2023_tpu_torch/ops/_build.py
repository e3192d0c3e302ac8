"""Build and load the port's CUDA kernels.

Each source under ``ops/csrc`` (``ms_deform_attn.cu``, ``tc_kdepth.cu``) is
compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, loaded with ``ctypes``. The library
name carries a hash of the source, so an edited source is rebuilt and an
unchanged one is reused. Builds go to ``<repo>/build/kernels`` (listed in
``.gitignore``) at first use, never at import. The compiler's ``-Xptxas -v``
report (registers, shared memory, spills) is kept beside each library.

Host code in C++ (``<repo>/native/<name>.cc``, the RLE string codec) is built
the same way by the host C++ compiler into ``<repo>/build/host``
(``build_host``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NATIVE = Path(__file__).resolve().parents[2] / "native"
HOST_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "with the CUDA toolkit's nvcc")
    return str(path)


def _library(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names) -> dict:
    """Compile ``csrc/<name>.cu`` for each name that has no up-to-date
    library, one ``nvcc`` per source, all started together; return {name:
    library path}. Concurrent builds race harmlessly: each writes a private
    temporary file and renames it into place."""
    libs = {name: _library(name) for name in names}
    running = []
    for name, lib in libs.items():
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        src = CSRC / f"{name}.cu"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}) for {src}:\n{out}\n{err}")
            continue
        lib.with_suffix(".ptxas.txt").write_text(out + err)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists; return
    the library's path."""
    return build_all([name])[name]


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output of the last build of ``name``."""
    return build(name).with_suffix(".ptxas.txt").read_text()


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++, g++ or clang++) found")


def build_host(name: str) -> Path:
    """Compile ``<repo>/native/<name>.cc`` with the host C++ compiler into
    ``build/host/lib<name>_<source hash>.so`` unless it exists; return its
    path. A failed or missing compiler raises ``RuntimeError``."""
    src = NATIVE / f"{name}.cc"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    lib = HOST_BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=HOST_BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"c++ failed ({proc.returncode}) for {src}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def launch(fn, device, *args) -> int:
    """Call the launcher ``fn(*args, stream)`` with ``device`` current on this
    thread, on that device's current stream; returns its error code. The
    launcher runs on whatever device is current on the calling thread, so a
    launch for ``cuda:1`` from a thread where ``cuda:0`` is current would
    fail (one process that drives several cards: ``inference_vis(devices=)``)."""
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, with argtypes set for its
    launchers: every pointer and the stream as ``c_void_p``, sizes as
    ``c_int``; each launcher returns the ``cudaError_t`` of its launch."""
    if name in _LOADED:
        return _LOADED[name]
    lib = ctypes.CDLL(str(build(name)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "ms_deform_attn":
        for fn in (lib.msda_fwd_f32, lib.msda_fwd_bf16):
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr] + [i32] * 7 + [ptr]
            fn.restype = i32
        for fn in (lib.msda_fwd_f32_block, lib.msda_fwd_bf16_block):
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr] + [i32] * 8 + [ptr]
            fn.restype = i32
        for fn in (lib.msda_bwd_f32, lib.msda_bwd_bf16):
            fn.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
            fn.restype = i32
        lib.msda_error_string.argtypes = [i32]
        lib.msda_error_string.restype = ctypes.c_char_p
    elif name == "tc_kdepth":
        lib.tc_kdepth_bf16.argtypes = [ptr, ptr, ptr] + [i32] * 4 + [ptr]
        lib.tc_kdepth_bf16.restype = i32
        lib.tc_error_string.argtypes = [i32]
        lib.tc_error_string.restype = ctypes.c_char_p
    _LOADED[name] = lib
    return lib
