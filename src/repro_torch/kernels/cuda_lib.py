"""Build, load and count the port's CUDA kernels.

The sources under ``repro_torch/csrc/*.cu`` have a plain C interface.  At
first use they are compiled, one ``nvcc`` per source and all at once, for
``sm_90a`` and linked into one shared library under ``<repo>/.kernel_build/``
(keyed by a hash of the sources and flags, so an edited source rebuilds),
then loaded with ``ctypes``.  Nothing is built when the module is imported:
the CPU tests import every module and have no ``nvcc``.

Every C entry point takes device pointers and the current CUDA stream,
launches on that stream, allocates nothing, does not synchronise and
returns ``cudaGetLastError()``; :func:`check` raises on a non-zero code.

:data:`LAUNCHES` counts kernel launches per wrapper; each wrapper adds one
right after its launch and nowhere else, so a run can show which kernels
its main path went through.  B2 also counts the design it launched
(``ivf_scan_topk.by_tile`` or ``ivf_scan_topk.by_cluster``) beside its one
``ivf_scan_topk`` a call.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / ".kernel_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("ivf_scan_q8_topk", "kmeans_assign_update", "kmeans_mstep",
           "ivf_scan_topk", "ivf_scan", "pairwise_l2",
           "ivf_scan_clustermajor", "ivf_scan_q8", "kmeans_batched",
           "ivf_scan_topk.by_tile", "ivf_scan_topk.by_cluster")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ivf_scan_q8_topk_launch": [_P] * 13 + [_I] * 7 + [_P],
    "ivf_scan_q8_topk_smem_bytes": [_I, _I, _I],
    "ivf_scan_q8_topk_max_chunks": [_I, _I],
    "kmeans_assign_update_launch": [_P] * 13 + [_I] * 4 + [_P],
    "kmeans_mstep_launch": [_P] * 4 + [_I] * 6 + [_P],
    "ivf_scan_topk_launch": [_P] * 10 + [_I] * 6 + [_P],
    "ivf_scan_topk_smem_bytes": [_I, _I, _I],
    "ivf_scan_topk_max_chunks": [_I, _I],
    "ivf_scan_topk_by_cluster_launch": [_P] * 14 + [_I] * 7 + [_P],
    "ivf_scan_topk_by_cluster_smem_bytes": [_I],
    "ivf_scan_launch": [_P] * 5 + [_I] * 5 + [_P],
    "pairwise_l2_launch": [_P] * 4 + [_I] * 5 + [_P],
    "ivf_scan_clustermajor_launch": [_P] * 5 + [_I] * 5 + [_P],
    "ivf_scan_q8_legacy_launch": [_P] * 8 + [_I] * 6 + [_P],
    "kmeans_batched_launch": [_P] * 9 + [_I] * 3 + [_P],
    "launch_floor_launch": [_P],
    "repro_cuda_error_string": [_I],
}
_RESTYPES = {"ivf_scan_q8_topk_smem_bytes": ctypes.c_size_t,
             "ivf_scan_topk_smem_bytes": ctypes.c_size_t,
             "ivf_scan_topk_by_cluster_smem_bytes": ctypes.c_size_t,
             "repro_cuda_error_string": ctypes.c_char_p}


class LaunchCounts:
    """Thread-safe launch counters, one plain integer per kernel (the build
    launches kernels from several worker threads)."""

    def __init__(self, names=KERNELS):
        self._lock = threading.Lock()
        self._n = dict.fromkeys(names, 0)

    def add(self, name: str) -> None:
        with self._lock:
            self._n[name] += 1

    def reset(self) -> None:
        with self._lock:
            for k in self._n:
                self._n[k] = 0

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._n)


LAUNCHES = LaunchCounts()


@dataclasses.dataclass
class BuildInfo:
    path: str
    seconds: float          # 0.0 when a cached library was loaded
    log: str                # nvcc/ptxas output (registers, shared memory)


_lock = threading.Lock()
_lib = None
_info = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                       "are built from source on the machine with the card")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> BuildInfo:
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, objs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = out_dir / f"lib.{os.getpid()}.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    final = out_dir / "librepro_torch_kernels.so"
    os.replace(tmp, final)
    return BuildInfo(str(final), time.perf_counter() - t0, "\n".join(logs))


@contextlib.contextmanager
def build_lock(out_dir: Path):
    """An exclusive ``fcntl`` lock on ``<out_dir>/lock``, held across the
    check for a built library and the build: processes that load the
    library at once (the ranks of a mesh) build it once, one at a time,
    and never race on the object files.  The kernel drops the lock when
    its holder exits, so a killed build leaves none behind."""
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, _info
    with _lock:
        if _lib is None:
            out_dir = BUILD_ROOT / _digest()
            final = out_dir / "librepro_torch_kernels.so"
            with build_lock(out_dir):
                info = (BuildInfo(str(final), 0.0, "") if final.exists()
                        else _build(out_dir))
            lib = ctypes.CDLL(info.path)
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib, _info = lib, info
        return _lib


def build_info() -> BuildInfo:
    library()
    return _info


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = library().repro_cuda_error_string(rc)
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({msg.decode() if msg else '?'})")


def launch_floor(device) -> None:
    """Launch the empty kernel (``csrc/launch_floor.cu``) on ``device``'s
    current stream: the yardstick of the least time a launch takes.  It is
    no port of a TPU kernel, so it counts in no launch counter."""
    check(library().launch_floor_launch(stream_handle(device)),
          "launch_floor")


def stream_handle(device) -> int:
    """The raw handle of ``device``'s current CUDA stream.  Read through
    torch's own accessor of the raw pointer (the one Triton's launcher
    uses): ``torch.cuda.current_stream(device).cuda_stream`` builds a Stream
    object first, which costs several microseconds of a small kernel's
    host time."""
    import torch

    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
