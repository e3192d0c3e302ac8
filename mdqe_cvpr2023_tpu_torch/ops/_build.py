"""Build and load the port's CUDA kernels.

Each source under ``ops/csrc`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The library
name carries a hash of the source, so an edited source is rebuilt and an
unchanged one is reused. Builds go to ``<repo>/build/kernels`` (listed in
``.gitignore``) at first use, never at import. The compiler's ``-Xptxas -v``
report (registers, shared memory, spills) is kept beside each library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists; return
    the library's path. Concurrent builds race harmlessly: each writes a
    private temporary file and renames it into place."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    lib.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output of the last build of ``name``."""
    return build(name).with_suffix(".ptxas.txt").read_text()


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, with argtypes set for its
    launchers: every pointer and the stream as ``c_void_p``, sizes as
    ``c_int``; each launcher returns the ``cudaError_t`` of its launch."""
    if name in _LOADED:
        return _LOADED[name]
    lib = ctypes.CDLL(str(build(name)))
    if name == "ms_deform_attn":
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.msda_fwd_f32, lib.msda_fwd_bf16):
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr] + [i32] * 7 + [ptr]
            fn.restype = i32
        lib.msda_error_string.argtypes = [i32]
        lib.msda_error_string.restype = ctypes.c_char_p
    _LOADED[name] = lib
    return lib
