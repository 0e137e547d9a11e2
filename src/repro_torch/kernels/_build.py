"""Build and load the CUDA kernels: ``nvcc`` into one shared library with a
plain C interface, bound with ``ctypes``.

Nothing happens at import. ``load()`` compiles ``csrc/*.cu`` at first use —
one ``nvcc -c`` per source, all started together, then one link — into
``build/`` at the root of the checkout (or ``$REPRO_TORCH_BUILD_DIR``), under
a name keyed by a hash of the sources and flags, and returns the loaded
library with every entry point's ``argtypes`` set. A second call, or a
second process on the same checkout, finds the finished library and skips
the compile.

The sources include no PyTorch header, so a build takes seconds. Tensors
cross the boundary as raw pointers (``tensor.data_ptr()``) and the stream
as ``torch.cuda.current_stream().cuda_stream``; every pointer is declared
``c_void_p`` so ctypes does not cut it to 32 bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"

# no --use_fast_math, and no contracted multiply-add: uct_select's scores
# must round exactly as the plain PyTorch version's separate ops do. The
# attention and norm kernels ask for a fused multiply-add where they want
# one, with an explicit fmaf.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
SIGNATURES = {
    # wins, visits, vloss, parent_total, valid, noise, lane_mask, cp, W, C,
    # out, stream
    "repro_uct_select": (_P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _P, _P),
    # boards, W, size, rounds, out, stream
    "repro_hex_winner": (_P, _I, _I, _I, _P, _P),
    # q, k, v, o, B, H, Hkv, S, D, scale, causal, dtype, then the (batch,
    # head, seq) element strides of q, k, v and o, stream
    "repro_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                              *(_L,) * 12, _P),
    # x, w, out, N, D, eps, x_dtype, w_dtype, order, stream
    "repro_rmsnorm": (_P, _P, _P, _I, _I, _F, _I, _I, _I, _P),
}

_lib: ctypes.CDLL | None = None
last_build_seconds: float | None = None  # None: nothing compiled in this process


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built here")


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _compile(srcs: list[Path], target: Path) -> None:
    nvcc = find_nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(srcs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{log}")
        out = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(out), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(out, target)  # atomic: a reader never sees a partial file


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib, last_build_seconds
    if _lib is not None:
        return _lib
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    target = build_dir() / f"librepro_torch_kernels_{_digest(srcs)}.so"
    if not target.exists():
        t0 = time.perf_counter()
        _compile(srcs, target)
        last_build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
