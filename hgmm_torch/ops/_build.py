"""Build and load the CUDA kernels of ``hgmm_torch/csrc``.

The sources are compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` per
``.cu`` file, all started together, and linked into one shared library with a
plain C interface, ``hgmm_torch/_build/libhgmm_kernels-<hash>.so``, at first
use; the hash covers the sources and the flags, so an edited source builds
anew. The compilers' output (``-Xptxas -v``: registers, shared memory and
spills of every kernel) is kept beside it as ``<library>.log``, and its
SASS (``cuobjdump --dump-sass``), read for the tensor-core instructions a
kernel holds, as ``<library>.sass`` at first use. The library is loaded with
``ctypes``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_SIGNATURES = {
    # name: argtypes (every pointer and the stream as c_void_p)
    "hgmm_em_stats": (_P, _I, _P, _I, _I, _I, _F, _P, _I, _P, _P),
    "hgmm_em_step": (_P, _I, _P, _I, _P, _P, _I, _I, _D, _I, _P, _P, _P, _P, _P, _I, _I, _P),
    "hgmm_em_stats_tiled": (_P, _I, _P, _I, _I, _I, _F, _P, _I, _P, _P),
    "hgmm_reg_stats": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _I, _P, _P),
    "hgmm_reg_step": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _D, _I, _P),
    "hgmm_em_stats_grouped": (_P, _I, _P, _I, _I, _P, _I, _P, _P, _P, _P),
    "hgmm_assign": (_P, _I, _P, _I, _P, _I, _I, _P, _P),
    "hgmm_knn": (_P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P),
    "hgmm_probe_logits": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    "hgmm_probe_stats": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "hgmm_probe_norm": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "hgmm_probe_addonly": (_P, _P, _I, _I, _I, _I, _P, _P),
    "hgmm_probe_vpu": (_P, _I, _I, _I, _I, _I, _I, _I, _P, _P),
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhgmm_kernels-{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise on the first that fails; return
    their output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{o}")
    return "".join(outs)


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        log = _run([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(src)]
                    for src, o in zip(srcs, objs)])
        # Link into a temporary name and rename, so a concurrent process never
        # loads a half-written library.
        lib = Path(tmp) / out.name
        log += _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]])
        Path(f"{out}.log").write_text(log)
        os.replace(lib, out)
    return out


def kernel_report(match: str = "") -> dict[str, dict[str, int]]:
    """Registers, stack frame and spill bytes of every compiled kernel whose
    (mangled) name contains `match`, read from the ``-Xptxas -v`` log that
    build() keeps beside the library: {name: {"registers", "stack_bytes",
    "spill_store_bytes", "spill_load_bytes"}}."""
    return parse_ptxas_log(Path(f"{build()}.log").read_text(), match)


def parse_ptxas_log(log: str, match: str = "") -> dict[str, dict[str, int]]:
    """As kernel_report, from the log's text; a kernel whose wgmma ptxas
    serialized (its "Potential Performance Loss" note names the kernel)
    also gets "wgmma_serialized": 1."""
    report: dict[str, dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        if "wgmma" in line and "serialized" in line:
            for fn in re.findall(r"'([^']+)'", line):
                if match in fn:
                    report.setdefault(fn, {})["wgmma_serialized"] = 1
            continue
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = entry.group(1) if match in entry.group(1) else None
            if name is not None:
                report.setdefault(name, {})
            continue
        if name is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if frame:
            report[name].update(stack_bytes=int(frame.group(1)), spill_store_bytes=int(frame.group(2)),
                                spill_load_bytes=int(frame.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            report[name]["registers"] = int(used.group(1))
    return report


TENSOR_OPS = ("HGMMA", "HMMA")  # warpgroup (wgmma) and warp (mma.sync, wmma) tensor-core ops


def _sass() -> str:
    """The library's SASS (``cuobjdump --dump-sass``, beside nvcc), kept as
    ``<library>.sass``."""
    lib = build()
    sass = Path(f"{lib}.sass")
    if not sass.exists():
        tool = Path(_nvcc()).parent / "cuobjdump"
        done = subprocess.run([str(tool), "--dump-sass", str(lib)], capture_output=True, text=True)
        if done.returncode != 0 or "Function" not in done.stdout:
            raise RuntimeError(f"cuobjdump failed ({done.returncode}):\n{done.stderr[-2000:]}")
        tmp = sass.with_suffix(f".sass.{os.getpid()}")
        tmp.write_text(done.stdout)
        os.replace(tmp, sass)
    return sass.read_text()


def sass_report(match: str = "") -> dict[str, dict[str, int]]:
    """How many tensor-core instructions of each kind the SASS of every
    compiled kernel whose (mangled) name contains `match` holds:
    {name: {"HGMMA": n, "HMMA": n}}."""
    return parse_sass(_sass(), match)


def sass_loops(match: str = "") -> dict[str, list[dict[str, int]]]:
    """The instructions of each loop in the SASS of every compiled kernel
    whose (mangled) name contains `match`, by opcode (parse_sass_loops)."""
    return parse_sass_loops(_sass(), match)


def parse_sass(text: str, match: str = "") -> dict[str, dict[str, int]]:
    report: dict[str, dict[str, int]] = {}
    name = None
    for line in text.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = fn.group(1) if match in fn.group(1) else None
            if name is not None:
                report.setdefault(name, dict.fromkeys(TENSOR_OPS, 0))
            continue
        if name is not None:
            for op in re.findall(r"\b(HGMMA|HMMA)\b", line):
                report[name][op] += 1
    return report


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)")
_BRANCH = re.compile(r"^\s+(0x[0-9a-f]+)")


def parse_sass_loops(text: str, match: str = "") -> dict[str, list[dict[str, int]]]:
    """For every function whose name contains `match`, one dict a loop, in
    address order: {opcode (with its modifiers): count} over the instructions
    from a backward branch's target to the branch itself (the branch
    included)."""
    report: dict[str, list[dict[str, int]]] = {}
    name, ins = None, []

    def close():
        if name is None:
            return
        loops = []
        for addr, op, rest in ins:
            target = _BRANCH.match(rest) if op == "BRA" else None
            if target and int(target.group(1), 16) < addr:
                lo, counts = int(target.group(1), 16), {}
                for a, o, _ in ins:
                    if lo <= a <= addr:
                        counts[o] = counts.get(o, 0) + 1
                loops.append(counts)
        report[name] = loops

    for line in text.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            close()
            name, ins = (fn.group(1) if match in fn.group(1) else None), []
            continue
        m = _SASS_LINE.search(line) if name is not None else None
        if m:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    close()
    return report


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.hgmm_error_string.argtypes = (ctypes.c_int,)
        lib.hgmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
