"""Build, load and launch the port's CUDA kernels; count the launches.

Every ``lariat_tpu_torch/csrc/*.cu`` compiles with its own ``nvcc`` process,
all started together, and one more links the objects into a shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds). The library lands in ``build/kernels/`` at the
repository root, named by a hash of the sources and flags, and is built at
first use: importing this module compiles nothing.

Each C entry launches one kernel on the stream it is given (PyTorch's
current stream of the device its tensors lie on) and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0, and otherwise
adds one to the kernel's launch count and keeps the largest launch's size.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# kernel name -> (C entry, argtypes; every entry ends with the stream)
KERNELS = {
    "sw_extend": ("lariat_sw_extend", [_P] * 6 + [_I] * 12 + [_P] * 4),
    "sw_global": ("lariat_sw_global", [_P] * 5 + [_I] * 10 + [_P] * 4),
    "traceback": ("lariat_traceback", [_P] * 5 + [_I] * 4 + [_P] * 3),
    "sw_local": ("lariat_sw_local", [_P] * 5 + [_I] * 10 + [_P] * 3),
    "extend_ablate": ("lariat_extend_ablate",
                      [_P] * 3 + [_I] * 14 + [_P] * 4),
    "smem_twoptr": ("lariat_smem_twoptr",
                    [_P] * 7 + [_L] * 2 + [_I] * 7 + [_P] * 4),
    "smem_planes": ("lariat_smem_twoptr_planes",
                    [_P] * 6 + [_L] * 2 + [_I] * 5 + [_P] * 7),
    "compact": ("lariat_compact_starts", [_P] * 9 + [_I] * 5 + [_P] * 11),
    "smem_exhaustive": ("lariat_smem_exhaustive",
                        [_P] * 6 + [_L] * 2 + [_I] * 3 + [_P] * 7),
    "smem_strategy1": ("lariat_smem_strategy1",
                       [_P] * 4 + [_L] * 3 + [_I] * 5 + [_P] * 3),
    "sa_walk": ("lariat_sa_walk", [_P] * 5 + [_L] * 3 + [_I] * 3 + [_P] * 2),
    "exact_match": ("lariat_exact_match",
                    [_P] * 5 + [_L] * 2 + [_I] * 5 + [_P] * 3),
    "fetch_window": ("lariat_fetch_window", [_P] * 2 + [_L] + [_I] * 2
                     + [_P] * 2),
}

# further C entries of a kernel above, counted under its name: entry ->
# (kernel name, argtypes)
ENTRIES = {
    "lariat_sw_extend_desc": ("sw_extend", [_P, _I, _P, _I, _I, _P, _L]
                              + [_I] * 12 + [_P] * 4),
    "lariat_sw_extend_step": ("sw_extend", [_P] * 5 + [_L] + [_I] * 14
                              + [_P] * 4),
    "lariat_occ1": ("exact_match", [_P] * 4 + [_L] * 2 + [_I] * 2 + [_P] * 2),
    "lariat_sa_lookup": ("sa_walk", [_P] * 3 + [_L] * 3 + [_I, _P, _L]
                         + [_I] * 2 + [_P] * 2),
}

LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)
ENTRY_LAUNCHES: Dict[str, int] = dict.fromkeys(ENTRIES, 0)
# the size of each kernel's largest launch, in its own unit (``launch``)
LARGEST: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_count_lock = threading.Lock()
_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        for k in ENTRY_LAUNCHES:
            ENTRY_LAUNCHES[k] = 0
        for k in LARGEST:
            LARGEST[k] = 0


def launches() -> Dict[str, int]:
    """Launches by kernel, every entry of a kernel included."""
    with _count_lock:
        return dict(LAUNCHES)


def entry_launches() -> Dict[str, int]:
    """Launches through each of ``ENTRIES`` (also counted in
    ``launches()`` under their kernel)."""
    with _count_lock:
        return dict(ENTRY_LAUNCHES)


def largest() -> Dict[str, int]:
    """The size of each kernel's largest launch since the last reset (0
    for a kernel not launched), in the unit its ``launch`` calls count."""
    with _count_lock:
        return dict(LARGEST)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"liblariat_kernels_{h.hexdigest()[:16]}.so")


def build(ptxas_report: bool = False) -> str:
    """Compile the kernels unless the library for these sources exists;
    returns nvcc's output ('' when nothing was built). ``ptxas_report``
    rebuilds regardless and adds ptxas's register and spill report."""
    path = library_path()
    if os.path.exists(path) and not ptxas_report:
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    extra = ["-Xptxas", "-v"] if ptxas_report else []
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in _sources()]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, *extra, "-c", "-o", obj,
                               src], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n{log}")
        r = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stdout}\n{r.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, path)
    return "".join(logs)


def load() -> ctypes.CDLL:
    """Build at first use and load the kernel library (once per process)."""
    global _lib
    with _build_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(library_path())
            entries = [*KERNELS.values(),
                       *((e, a) for e, (_, a) in ENTRIES.items())]
            for entry, argtypes in entries:
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.lariat_cuda_error_string.argtypes = [ctypes.c_int]
            lib.lariat_cuda_error_string.restype = ctypes.c_char_p
            lib.lariat_device_attributes.argtypes = [_I, _P]
            lib.lariat_device_attributes.restype = ctypes.c_int
            _lib = lib
        return _lib


DEVICE_ATTRIBUTES = ("sm_count", "sm_clock_khz", "mem_clock_khz",
                     "mem_bus_bits")


def device_attributes(index: int) -> Dict[str, int]:
    """The card's SM count, maximum SM clock, memory clock and memory bus
    width, from cudaDeviceGetAttribute (csrc/runtime.cu)."""
    lib = load()
    vals = (ctypes.c_int * len(DEVICE_ATTRIBUTES))()
    rc = lib.lariat_device_attributes(int(index), ctypes.addressof(vals))
    if rc != 0:
        msg = lib.lariat_cuda_error_string(rc).decode()
        raise RuntimeError(f"cudaDeviceGetAttribute failed: CUDA error {rc} "
                           f"({msg})")
    return dict(zip(DEVICE_ATTRIBUTES, vals))


CODE_DTYPES = (torch.uint8, torch.int32, torch.int64)
# query columns one warp of K2 or K3 covers at once (32 lanes x 6); past
# it they run in tiles, with a row-boundary scratch
TILE_COLS = 192
# the same for K1 (32 lanes x 8)
EXTEND_TILE_COLS = 256


def on_cuda(first: torch.Tensor) -> bool:
    """Route of a wrapper: True for a CUDA tensor (launch the kernel),
    False for a CPU tensor (run the plain version); raises otherwise."""
    if not isinstance(first, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(first)}")
    if first.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {first.device}")
    return first.device.type == "cuda"


def check(name: str, t, device: torch.device, shape,
          dtypes=(torch.int32,)) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` with one of
    ``dtypes`` on ``device``: what a kernel takes, and nothing else."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_byte_scores(**scores) -> None:
    """Raise unless every substitution score fits a signed byte: K2 and K3
    keep a query column's scores as four packed bytes."""
    bad = {k: v for k, v in scores.items() if not -128 <= int(v) <= 127}
    if bad:
        raise ValueError(f"substitution scores outside [-128, 127]: {bad}")


def launch(name: str, *args, size: int = 0,
           entry: Optional[str] = None) -> None:
    """Launch kernel ``name`` through its C entry or through ``entry`` (one
    of ``ENTRIES``, counted under ``name``) on the device its tensors lie
    on: on that device's current stream, under ``torch.cuda.device(dev)``
    when it is not the current device, so the entry's
    ``cudaFuncSetAttribute`` and launch target that card.

    ``args`` are tensors (passed by data pointer; the caller keeps them
    alive) and ints, in the C entry's order without the trailing stream.
    ``size`` is the launch's work in the kernel's own unit: tasks for the
    DP kernels (K1-K3, K2b, T1), lanes for K4a, K4b and K9, reads for K4c
    and K7 (lookups for its occ1 entry), rows for K5, windows for K8; the
    largest is kept (``largest``). Raises when the tensors span devices or
    lie on the CPU (or there is none). Launch counts are summed over
    devices."""
    # device indices, -1 for the CPU: cheaper than a torch.device a tensor
    devs = {a.get_device() for a in args if isinstance(a, torch.Tensor)}
    if len(devs) != 1 or -1 in devs:
        got = sorted("cpu" if d < 0 else f"cuda:{d}" for d in devs)
        raise ValueError(f"{name}: a launch takes tensors on one CUDA "
                         f"device, got {got or 'none'}")
    (dev,) = devs
    lib = load()
    if entry is None:
        entry = KERNELS[name][0]
    elif ENTRIES[entry][0] != name:
        raise ValueError(f"{entry} is not an entry of kernel {name}")
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
             for a in args]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev == torch.cuda.current_device():
        rc = getattr(lib, entry)(*cargs, stream)
    else:
        with torch.cuda.device(dev):
            rc = getattr(lib, entry)(*cargs, stream)
    if rc != 0:
        msg = lib.lariat_cuda_error_string(rc).decode()
        ints = [a for a in args if not isinstance(a, torch.Tensor)]
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg}); size {size}, int arguments {ints}")
    _count(name, entry, size)


def _count(name: str, entry: str, size: int) -> None:
    """A launch of ``name`` through ``entry`` of ``size``: counted, and
    kept when it is the kernel's largest."""
    with _count_lock:
        LAUNCHES[name] += 1
        LARGEST[name] = max(LARGEST[name], int(size))
        if entry in ENTRY_LAUNCHES:
            ENTRY_LAUNCHES[entry] += 1
