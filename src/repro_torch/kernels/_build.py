"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, which is
loaded with ``ctypes``.  Sources may include the shared headers
``csrc/*.cuh`` (``-I csrc``).  Libraries land in ``build/kernels/`` at the
root of the checkout, named after a hash of their source, every shared
header and the flags, so an edited source or header is rebuilt and an
unchanged one is not.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: Why kernel launches are refused now (innermost last): see
#: :func:`refuse_launches`.
_refusals: List[str] = []
#: Seconds each kernel library took to compile in this process (0 when an
#: up-to-date build was found on disk), and what nvcc printed (ptxas's
#: registers, shared memory and spills per kernel).
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA toolkit is needed to build the port's kernels"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    out = library_path(name)
    if out.exists():
        build_seconds.setdefault(name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = proc.stdout + proc.stderr
    return out


def sources() -> List[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, Path]:
    """Build every kernel source at once, one nvcc process each."""
    names = sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


_sms: Dict[int, int] = {}


def sm_count(device: "torch.device") -> int:
    """The SM count of a CUDA device, read once."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def aligned(x: "torch.Tensor") -> "torch.Tensor":
    """``x`` itself where it starts on a 16-byte boundary, else a fresh
    copy of it (the caching allocator's blocks start on 512-byte
    boundaries).  Every kernel loads its inputs 16 bytes a thread, and a
    contiguous view at an odd storage offset (a slice, a rank's shard)
    would fault the CUDA context: this is a copy, not a change of body."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


@contextlib.contextmanager
def refuse_launches(why: str) -> Iterator[None]:
    """Inside it every kernel launch raises (:func:`load` does, and each
    wrapper loads its library before it launches): a count of a step's
    work (``repro_torch.launch.counter``) sees only what PyTorch
    dispatches, and a kernel called through ``ctypes`` would go uncounted."""
    _refusals.append(why)
    try:
        yield
    finally:
        _refusals.remove(why)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use;
    raises inside :func:`refuse_launches`."""
    if _refusals:
        raise RuntimeError(f"the {name} kernel may not launch here: {_refusals[-1]}")
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
