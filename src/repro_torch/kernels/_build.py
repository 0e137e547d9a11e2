"""Build and load the CUDA kernels: ``nvcc`` into one shared library with a
plain C interface, bound with ``ctypes``.

Nothing happens at import. ``load()`` compiles ``csrc/*.cu`` (which include
``csrc/*.cuh``) at first use —
one ``nvcc -c`` per source, all started together, then one link — into
``build/`` at the root of the checkout (or ``$REPRO_TORCH_BUILD_DIR``), under
a name keyed by a hash of the sources and flags, and returns the loaded
library with every entry point's ``argtypes`` set. A second call, or a
second process on the same checkout, finds the finished library and skips
the compile.

The sources include no PyTorch header, so a build takes seconds. Each
entry point takes ONE argument: a pointer to a packed struct of its
arguments (``ARGS`` gives each struct's layout as a ``struct`` format in the
platform's native alignment, which is C's). A wrapper packs the raw pointers
(``tensor.data_ptr()``), sizes and the stream into a ``bytes`` with
``Launcher`` and the C side copies it into its struct: one converted
argument instead of ten or twenty-five keeps the host's cost of a launch
low. ``load()`` checks every struct's size against the C side's
``<entry>_args_bytes()``.

``stream_on(t.get_device())`` is the one host prelude every wrapper
shares: PyTorch's current raw stream on ``t``'s device, which must be the
current device (the launch goes to the current CUDA context).

``nvcc`` runs with ``-Xptxas -v``; its report (registers, shared memory,
spill bytes per kernel) is kept beside the library and parsed by
``ptxas_report()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import struct
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"

# no --use_fast_math, and no contracted multiply-add: uct_select's scores
# must round exactly as the plain PyTorch version's separate ops do. The
# attention and norm kernels ask for a fused multiply-add where they want
# one, with an explicit fmaf.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# each entry point's argument struct, in the order of its C fields (P: a
# pointer, 0 for none; i: int; f: float; q: long long)
ARGS = {
    # wins, visits, vloss, parent_total, valid, noise, lane_mask, cp, W, C,
    # out, stream
    "repro_uct_select": "7PfiiPP",
    # boards, W, size, rounds, out, stream
    "repro_hex_winner": "PiiiPP",
    # children, n_children, wins, visits, vloss, move, to_move, root_board,
    # noise_keys, cp, noise_scale, max_depth, E, W, C, n, cap, paths,
    # depths, leaves, n_empty, boards, stream
    "repro_select_descent": "9Pff6i6P",
    # boards, to_move, keys, W, size, rounds, out, filled (0: none), stream
    "repro_hex_playout": "3P3i3P",
    # q, k, v, o, B, H, Hkv, S, D, scale, causal, dtype, then the (batch,
    # head, seq) element strides of q, k, v and o, stream; the CUDA-core
    # body and the tensor-core body take the same struct
    "repro_flash_attention": "4P5ifii12qP",
    "repro_flash_attention_tc": "4P5ifii12qP",
    # x, w, out, N, D, eps, x_dtype, w_dtype, order, stream
    "repro_rmsnorm": "3PiifiiiP",
}

_lib: ctypes.PyDLL | None = None
last_build_seconds: float | None = None  # None: nothing compiled in this process

# the current device and its current raw stream: the CUDA build of torch has
# the C entry points Inductor uses; a build without them takes the public API
_current_device = getattr(torch._C, "_cuda_getDevice", None) or (
    lambda: torch.cuda.current_device())
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


def stream_on(index: int) -> int:
    """The raw stream a kernel on a tensor of device ``index`` (its
    ``get_device()``) launches on: PyTorch's current stream of the current
    device, which must be that device."""
    if index < 0:
        raise ValueError("a CPU tensor has no CUDA stream: the kernels take "
                         "CUDA tensors")
    if index != _current_device():
        raise ValueError(
            f"tensor on cuda:{index}, but the current device is "
            f"cuda:{_current_device()}: the kernels launch on the current "
            "device (use torch.cuda.device)")
    return _raw_stream(index)


class Launcher:
    """Entry point ``name`` of the library: ``launcher.call(launcher.pack(
    *args))`` packs the arguments into its struct and calls it, returning
    its CUDA error code (0: launched). ``call`` resolves the function at the
    first call (which builds the library) and then is the ctypes function
    itself, so a launch adds no Python frame."""

    __slots__ = ("name", "pack", "call")

    def __init__(self, name: str):
        self.name = name
        self.pack = struct.Struct(ARGS[name]).pack
        self.call = self._first_call

    def _first_call(self, packed: bytes) -> int:
        self.call = getattr(load(), self.name)
        return self.call(packed)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    """The headers the sources include (``threefry.cuh``): part of the
    build's hash, so editing one rebuilds."""
    return sorted(CSRC.glob("*.cuh"))


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


def _ptxas_log(target: Path) -> Path:
    return target.with_suffix(".ptxas.txt")


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*srcs, *headers()]:
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
        _ptxas_log(target).write_text("".join(
            f"== {s.name}\n{log}" for s, log in zip(srcs, logs)))
        out = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(out), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(out, target)  # atomic: a reader never sees a partial file


def load() -> ctypes.PyDLL:
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
    # PyDLL: a launch is a few microseconds of host work that needs no
    # release of the interpreter lock
    lib = ctypes.PyDLL(str(target))
    for name, fmt in ARGS.items():
        size = getattr(lib, name + "_args_bytes")
        size.argtypes, size.restype = [], ctypes.c_int
        if size() != struct.calcsize(fmt):
            raise RuntimeError(
                f"{name}: the C argument struct has {size()} bytes, the "
                f"format {fmt!r} {struct.calcsize(fmt)}")
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [ctypes.c_char_p], ctypes.c_int
    for name in ("repro_flash_attention_tc_blocks_per_sm",
                 "repro_flash_attention_tc_smem_bytes"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    _lib = lib
    return lib


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def _demangle(names: list[str]) -> list[str]:
    tool = shutil.which("cu++filt") or os.path.join(
        os.path.dirname(find_nvcc()), "cu++filt")
    try:
        out = subprocess.run([tool, *names], capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return names
    return out if len(out) == len(names) else names


def ptxas_report() -> list[dict]:
    """Per kernel, from the built library's ``nvcc -Xptxas -v`` log: the
    source, the (demangled) function, registers per thread, static shared
    memory bytes, stack frame and spill bytes. Empty if no log is kept."""
    load()
    log = _ptxas_log(build_dir() / f"librepro_torch_kernels_{_digest(sources())}.so")
    if not log.exists():
        return []
    rows, source, cur = [], None, None
    for line in log.read_text().splitlines():
        if line.startswith("== "):
            source = line[3:]
        elif m := _PTXAS_ENTRY.search(line):
            cur = {"source": source, "function": m.group(1)}
            rows.append(cur)
        elif cur is not None and (m := _PTXAS_SPILL.search(line)):
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        elif cur is not None and (m := _PTXAS_USED.search(line)):
            smem = _PTXAS_SMEM.search(line)
            cur.update(registers=int(m.group(1)),
                       static_smem_bytes=int(smem.group(1)) if smem else 0)
    for row, name in zip(rows, _demangle([r["function"] for r in rows])):
        row["function"] = _short(name)
    return rows


def _short(name: str) -> str:
    """``void <unnamed>::tc::flash_tc_kernel<(int)64>(const ...)`` ->
    ``tc::flash_tc_kernel<64>``: the template arguments without the
    parameter list."""
    name = name.replace("<unnamed>::", "").replace("(int)", "")
    name = name.removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name
