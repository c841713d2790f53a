"""What the ``*_turns.py`` tools share: the earlier tree's kernel library
and package, variant builds of this checkout's kernel sources, CUDA-event
timing (of calls and of CUDA graphs) and the profiler's device events.

The tools run as scripts (``python3 tools/<kernel>_turns.py``), which puts
this directory first on ``sys.path``; they import this module as
``turns``.
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.util
import re
import sys
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

HERE = Path(__file__).resolve().parents[1]


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()


def parent_build(parent: Path):
    """The earlier tree's ``kernels/build.py`` module, which builds that
    tree's kernels from its own sources into ``<parent>/build/kernels``."""
    spec = importlib.util.spec_from_file_location(
        "parent_kernels_build",
        parent.resolve() / "src" / "repro_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_as(tree: Path, name: str):
    """``tree``'s ``src/repro_torch`` imported as the package ``name``
    (``repro_torch`` itself for this checkout; another tree's through a
    symlink under ``<tree>/build/alias``), its kernel library built;
    returns the package."""
    if name == "repro_torch":
        sys.path.insert(0, str(tree / "src"))
    else:
        alias = tree / "build" / "alias"
        alias.mkdir(parents=True, exist_ok=True)
        link = alias / name
        if not link.exists():
            link.symlink_to(tree / "src" / "repro_torch",
                            target_is_directory=True)
        sys.path.insert(0, str(alias))
    importlib.import_module(name + ".kernels.build").library()
    return importlib.import_module(name)


def parent_library(parent: Path) -> ctypes.CDLL:
    """The earlier tree's kernel library (:func:`parent_build`'s)."""
    return parent_build(parent).library()


def ptxas_report(log: str, kernel: str) -> dict:
    """Registers, stack frame and spill bytes of each entry function whose
    mangled name holds ``kernel``, from a build's ``-Xptxas -v`` log."""
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        if kernel not in name:
            continue
        used = re.search(r"Used (\d+) registers", part)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", part)
        out[name] = {"registers": int(used.group(1)) if used else None,
                     "stack_frame_bytes": int(frame.group(1)) if frame
                     else None,
                     "spill_store_bytes": int(frame.group(2)) if frame
                     else None,
                     "spill_load_bytes": int(frame.group(3)) if frame
                     else None}
    return out


def edited(text: str, edits) -> str:
    """``text`` with each (old, new) of ``edits`` applied; every ``old``
    must occur exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"a variant's edit does not apply once: {old!r}")
        text = text.replace(old, new)
    return text


def start_variants(build, source: str, variants: dict) -> dict:
    """``nvcc`` of this checkout's ``csrc/<source>`` once per variant, all
    started at once, each into ``build/variants/<name>/``.  A variant is
    (``-D`` flags, (old, new) edits applied to a copy of the source).
    Returns {name: (process, library path)}."""
    procs = {}
    for name, (flags, edits) in variants.items():
        out = HERE / "build" / "variants" / name
        out.mkdir(parents=True, exist_ok=True)
        src = out / source
        src.write_text(edited((build.CSRC / source).read_text(), edits))
        lib = out / "libvariant.so"
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", *flags,
               "-I", str(build.CSRC), str(src), "-o", str(lib)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    return procs


def variant_entry(proc, path: Path, symbol: str, argtypes):
    """Entry point ``symbol`` of a variant build, once ``nvcc`` is done;
    the compiler's report goes to ``build.log`` beside the library."""
    text, _ = proc.communicate()
    (path.parent / "build.log").write_text(text)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on a variant build:\n{text}")
    fn = getattr(ctypes.CDLL(str(path)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def time_ms(fn, n: int = 20, warm: int = 3, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean ms per call across ``n``
    back-to-back calls, timed with CUDA events after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / n)
    return float(np.median(runs))


def graph_us(fn, args: list, n: int = 50) -> float:
    """Device µs per call from CUDA events around the replay of a CUDA
    graph of ``n`` calls, call i on ``args[i % len(args)]``, every output
    kept until the replay ends (so no call finds its input or output in L2
    once the arguments span more than it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args[0])
    torch.cuda.current_stream().wait_stream(side)
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for i in range(n):
            outs.append(fn(*args[i % len(args)]))
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3 / n


def device_events(fn, n: int, tries: int = 5) -> list[tuple[str, float]]:
    """(kernel or copy name, device µs) of every device-side event of
    ``n`` calls of ``fn`` under ``torch.profiler``.  A session can record
    no device activity at all, seemingly at random in a long-lived
    process; then the calls run again in a new session after a pause,
    ``tries`` sessions at most."""
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
        print("[turns] a profiler session recorded no device activity; "
              "again")
        time.sleep(1.0)
    raise RuntimeError(f"the profiler saw no device time in {tries} "
                       "sessions")
