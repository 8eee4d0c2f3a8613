#!/usr/bin/env python3
"""Overlap kernel A/B on one CUDA card: several builds of the overlap kernel,
timed in turns inside one process on the inputs of chip_smoke.py phase 3.

Builds:

- ``this``: ``fqtool_tpu_torch/csrc/overlap.cu`` as it stands (4-bit codes,
  eight bases a 32-bit compare, the warp's stop after 16 and 32 bases);
- ``no_stop``: the same without the stop, every group runs all 50 bases;
- ``bytes``: one byte a base, four a compare with ``__vcmpne4``, each word of
  read2 reversed with ``__byte_perm`` before its complement, the same stop;
- ``bytes_no_stop``: ``bytes`` without the stop;
- ``NAME=DIR`` for each ``--checkout``: the kernel and wrapper of another
  checkout of the port (``git archive <commit> | tar -x -C build/parent``),
  built into this checkout's ``build/overlap_ab/``.

The three variants are made from this checkout's source by exact text
substitutions, each of which must match once, so the tool fails instead of
measuring something else once the kernel changes.  Every build is first held
against the plain PyTorch version on the timing inputs and on the edge cases
of ``tests/torch_pairs.py`` (tolerance 0: integer outputs).  Then, per input,
the builds are timed in turns (in order, then in reverse), twice: the
wrapper's CUDA-event time per call over 20 calls first, then the kernel's
device-only time per launch (torch.profiler, ``overlap_kernel`` over 20
launches).  Prints the card, the ptxas lines of each build and one
JSON line per input.  Run from the repository root:
``python3 overlap_ab.py [--checkout parent=build/parent]``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import importlib.util
import json
import re
import sys
import types
from pathlib import Path

import torch

import chip_smoke as smoke
from fqtool_tpu_torch.ops import overlap
from tests.torch_pairs import OVERLAP_EDGE_CASES, edge_pairs

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "overlap_ab"
SRC = ROOT / "fqtool_tpu_torch" / "csrc" / "overlap.cu"
ROUNDS = 2  # each build is timed 2 * ROUNDS times per input
STOP = re.compile(r"    if \(j == \d+ \|\| j == \d+\) \{\n.*\n    \}\n")

# this kernel with one byte a base: (old, new), each old text found once
BYTES = [
    ("constexpr int kBasesPerWord = 8;     // 4-bit codes",
     "constexpr int kBasesPerWord = 4;     // bytes"),
    ("constexpr uint32_t kHighBits = 0x88888888u;  // bit 3 of each code",
     "constexpr uint32_t kHighBits = 0x80808080u;  // bit 7 of each byte"),
    ("case 'A': case 'a': return 3;", "case 'A': case 'a': return 'T';"),
    ("case 'T': case 't': return 0;", "case 'T': case 't': return 'A';"),
    ("case 'C': case 'c': return 2;", "case 'C': case 'c': return 'G';"),
    ("case 'G': case 'g': return 1;", "case 'G': case 'g': return 'C';"),
    ("    default: return 4;", "    default: return 'N';"),
    ("""  return valid >= 8 ? 0xffffffffu
                    : (valid <= 0 ? 0u : (1u << (4 * valid)) - 1u);""",
     "  return byte_mask(valid);"),
    ("""  const uint32_t t = a ^ b;
  return (((t & 0x77777777u) + 0x77777777u) | t) & kHighBits;""",
     "  return __vcmpne4(a, b) & kHighBits;"),
    ("  return __funnelshift_r(w[k >> 3], w[(k >> 3) + 1], 4 * (k & 7));",
     "  return bytes_at(w, k);"),
    ("""  const int q = min(k >> 3, max_q);
  const int shift = 4 * (k & 7);""",
     """  const int q = min(k >> 2, max_q);
  const int shift = 8 * (k & 3);"""),
    ("    if (j == 2 || j == 4) {", "    if (j == 4 || j == 8) {"),
    ("""    const int i = min(2 * w, wl1);
    const uint32_t lo = sm.raw1[i], hi = sm.raw1[i + 1];
    uint32_t c = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c |= (uint32_t)code1[(lo >> (8 * j)) & 0xffu] << (4 * j);
      c |= (uint32_t)code1[(hi >> (8 * j)) & 0xffu] << (4 * j + 16);
    }
    sm.c1[w] = c & code_mask(n1 - kBasesPerWord * w);""",
     "    sm.c1[w] = sm.raw1[min(w, wl1)] & code_mask(n1 - kBasesPerWord * w);"),
    ("""    const int s = max(n2 - 8 - 8 * w, -4 * kLeadWords) + 4 * kLeadWords;
    const uint32_t x0 = bytes_at(sm.raw2, s), x1 = bytes_at(sm.raw2, s + 4);
    uint32_t c = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c |= (uint32_t)rcode2[(x1 >> (24 - 8 * j)) & 0xffu] << (4 * j);
      c |= (uint32_t)rcode2[(x0 >> (24 - 8 * j)) & 0xffu] << (4 * j + 16);
    }""",
     """    const int s = max(n2 - 4 - 4 * w, -4 * kLeadWords) + 4 * kLeadWords;
    const uint32_t x = __byte_perm(bytes_at(sm.raw2, s), 0u, 0x0123);
    uint32_t c = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c |= (uint32_t)rcode2[(x >> (8 * j)) & 0xffu] << (8 * j);
    }"""),
]


def _substitute(src: str, subs) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"overlap_ab: {old.splitlines()[0]!r} found "
                             f"{src.count(old)} times in {SRC.name}")
        src = src.replace(old, new)
    return src


def _no_stop(src: str) -> str:
    out, n = STOP.subn("", src)
    if n != 1:
        raise SystemExit(f"overlap_ab: the warp's stop found {n} times")
    return out


def variant_sources() -> dict:
    """name -> source text of this checkout's kernel and its variants."""
    this = SRC.read_text()
    byte = _substitute(this, BYTES)
    return {"this": this, "no_stop": _no_stop(this), "bytes": byte,
            "bytes_no_stop": _no_stop(byte)}


def _load_wrapper(name: str, checkout: Path):
    """``ops/overlap_cuda.py`` of ``checkout``, imported as its own package
    ``ab_<name>``, building into ``build/overlap_ab/``."""
    ops = checkout / "fqtool_tpu_torch" / "ops"
    spec = importlib.util.spec_from_file_location(
        f"ab_{name}", ops / "__init__.py", submodule_search_locations=[str(ops)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = pkg
    spec.loader.exec_module(pkg)
    mod = importlib.import_module(f"ab_{name}.overlap_cuda")
    if hasattr(mod, "library"):
        mod.library.build_root = OUT / "kernels"
    else:  # a checkout from before ops/kernel_lib.py
        mod.BUILD_ROOT = OUT / "kernels"
        mod.library = types.SimpleNamespace(load=mod.build, path=mod.library_path)
    return mod


def wrappers(checkouts) -> dict:
    """name -> overlap_cuda module whose library.load() builds that kernel."""
    mods = {}
    for name, text in variant_sources().items():
        src = OUT / name / "overlap.cu"
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(text)
        mods[name] = _load_wrapper(name, ROOT)
        mods[name].library.src = src
    for name, path in checkouts:
        mods[name] = _load_wrapper(name, path.resolve())
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        list(pool.map(lambda m: m.library.load(), mods.values()))  # nvcc in parallel
    return mods


def _check(name: str, mod, args, dl: int, req: int) -> None:
    got = mod.analyze_cuda(*args, dl, req)
    ref = overlap.analyze(*args, dl, req)
    for field, a, b in zip(ref._fields, got, ref):
        if not torch.equal(a.long(), b.long()):
            raise SystemExit(f"overlap_ab: {name} disagrees with the plain "
                             f"version on {field} (L={args[0].shape[1]}/"
                             f"{args[2].shape[1]}, diff_limit={dl}, require={req})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkout", action="append", default=[],
                    metavar="NAME=DIR", help="another checkout of the port")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("overlap_ab: torch sees no CUDA device\n")
        return 1
    checkouts = [(c.split("=", 1)[0], Path(c.split("=", 1)[1]))
                 for c in args.checkout]
    smoke.phase_card()
    mods = wrappers(checkouts)
    for name, mod in mods.items():
        for line in mod.library.path().with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"{name}: {line.strip()}", flush=True)

    inputs = {"phase-3 input (16384 x 151, seed 7)":
              smoke._case(smoke.PE_CHUNK, 151, 151, seed=7),
              "30% empty rows (16384 x 151, seed 8)":
              smoke._case(smoke.PE_CHUNK, 151, 151, seed=8, zero_frac=0.3)}
    edges = [(tuple(torch.as_tensor(a).cuda() for a in
                    edge_pairs(4096, L1, L2, seed=200 + k, garbage=garbage)), dl, req)
             for k, (L1, L2, dl, req, garbage) in enumerate(OVERLAP_EDGE_CASES)]
    for name, mod in mods.items():
        for case, dl, req in [(a, 5, 30) for a in inputs.values()] + edges:
            _check(name, mod, case, dl, req)
    print(f"every build equals the plain version on the {len(inputs)} timing "
          f"inputs and {len(edges)} edge cases (tolerance 0)", flush=True)

    order = list(mods) + list(reversed(mods))
    for label, case in inputs.items():
        fns = {name: (lambda m=mod: m.analyze_cuda(*case, 5, 30))
               for name, mod in mods.items()}
        events = {name: [] for name in mods}
        device = {name: [] for name in mods}
        for _ in range(ROUNDS):  # events first: the profiler slows launches
            for name in order:
                events[name].append(round(smoke._time_ms(fns[name]) * 1e3, 3))
        for _ in range(ROUNDS):
            for name in order:
                ms = smoke._kernel_device_ms(fns[name])
                device[name].append(None if ms is None else round(ms * 1e3, 3))
        print(json.dumps({"input": label, "device_us_per_launch": device,
                          "events_us_per_call": events}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
