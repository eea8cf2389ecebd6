"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for ``sm_90a`` into a shared library under ``build/whisper_tpu_torch/`` at
the repository root, at first use, and loaded with ``ctypes``. No PyTorch
header is included, so a build takes seconds. The library's file name
carries a hash of its source, so an edited source is never served by a
stale build. ``build_all`` starts one ``nvcc`` per source, all at once.

The module also keeps the launch ledger, ``LAUNCHES``: every wrapper adds
the kernels it launched to the count under its own name (``flash_attention``,
``flash_attention_f32``, ``decode_attention_hd``, ``decode_attention_hd_int8``,
``decode_attention_hd_grouped``, ``w8a16_dense``, ``moe_experts``,
``kv_quant_write``, ``mla_decode`` and the kbench wrappers' names). A wrapper runs once, at capture, for a step that a
CUDA graph replays; ``runtime/graph.py`` adds a capture's counts per replay.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "whisper_tpu_torch"
SOURCES = ("flash_attention", "flash_attention_f32", "decode_attention", "w8a16_dense", "moe_lanes",
           "kv_quant_write", "mla_decode", "kbench")
LAUNCHES: collections.Counter[str] = collections.Counter()   # kernel launches, by wrapper
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every stale library in ``names`` in parallel. Returns, per
    name, the build seconds (0 when already built) and nvcc's log (ptxas
    register and shared-memory use). Raises with the log when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    info = {name: {"seconds": 0.0, "log": ""} for name in names}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return info


def _kernel_name(mangled: str) -> str:
    """A kernel's mangled name without its file's anonymous namespace and
    its parameter list: 22decode_attention_kernelI13__nv_bfloat16aLi4ELi8EE
    is decode_attention_kernel<bf16, int8 (a), 4, 8>."""
    short = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", mangled)
    return short.split("Ev")[0]


def ptxas_report(log: str) -> list[str]:
    """One line per kernel of an nvcc ``-Xptxas -v`` log: its registers,
    spilled bytes and static shared memory (dynamic shared memory is the
    launch's and not in the log)."""
    out, name, spill = [], None, "0"
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = _kernel_name(entry.group(1))
        stores = re.search(r"(\d+) bytes spill stores", line)
        if stores:
            spill = stores.group(1)
        used = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if used and name:
            out.append(f"{name}: {used.group(1)} registers, {spill} B spilled, "
                       f"{used.group(2) or 0} B static smem")
            name, spill = None, "0"
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    build_all((name,))
    return ctypes.CDLL(str(library_path(name)))
