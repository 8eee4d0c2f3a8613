"""The benchmark of fqtool_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<config>.json``: the CLI argv and the reference's parameters) and
its own file (``workloads/<cell>.json``: the traffic's parameters, the pairs a
job reads and whether a job is a call of ``fqtool_tpu_torch.main.main`` in
this process or a fresh process through ``child.py``).  The run makes the
job's input from the seed and runs one warm job on it (set-up), then runs
jobs back to back until ``--seconds`` have passed and the job under way has
ended (the window).  With ``--trace 0`` it reports the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, each read by ``metrics/<name>.py`` from
the run's record.  After the window it checks the jobs' outputs against the
plain reference (``check.py``) and prints, as the last line of standard
output, one JSON object with the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PORT = "fqtool_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "fqtool_tpu")
PEAK_HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, NVIDIA's data sheet

sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))


class BenchError(RuntimeError):
    """A run that cannot give a result."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ----------------------------------------------------------------------
# the cell, as BENCHMARK.json and its files describe it

def load_cell(name: str, bench_json: Path = ROOT / "BENCHMARK.json") -> dict:
    spec = json.loads(bench_json.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in {bench_json.name}")
    entry = cells[name]
    cell = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    config = json.loads((BENCH / "configs" / f"{entry['config']}.json").read_text())

    def listed(m):
        return name in m["workloads"] if "workloads" in m else True
    return {"name": name, "entry": entry, "cell": cell, "config": config,
            "end_to_end": [m for m in spec["end_to_end"] if listed(m)],
            "per_layer": [m for m in spec["per_layer"] if listed(m)]}


def reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"metric_{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def traffic_of(cell_file: dict):
    """The generator module that the cell's traffic names
    (``traffic/<generator>.py``) and its law, from the traffic's parameters."""
    t = dict(cell_file["traffic"])
    gen = importlib.import_module(f"traffic.{t.pop('generator')}")
    return gen, gen.law(t)


def reference_of(config: dict):
    """The reference module that the configuration names
    (``reference/<reference>.py``)."""
    return importlib.import_module(f"reference.{config['reference']}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def work_dir(cell: str) -> Path:
    """Where the jobs read and write: under ``TMPDIR``, or inside the
    checkout when it is unset; a fixed path, emptied before and after."""
    base = Path(os.environ["TMPDIR"]) if os.environ.get("TMPDIR") \
        else ROOT / "build" / "bench_tmp"
    return base / "fqtool_bench" / cell


def set_environment(trace: bool, device: str) -> None:
    """Before the program is imported: its device, its stage trace, and the
    CUDA driver's kernel cache inside the checkout at a fixed path (the
    program builds its own kernel into ``build/torch_kernels``)."""
    os.environ["FQTOOL_TPU_TORCH_DEVICE"] = device
    if trace:
        os.environ["FQTOOL_TPU_TRACE"] = "1"
    else:
        os.environ.pop("FQTOOL_TPU_TRACE", None)
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")


# ----------------------------------------------------------------------
# jobs

class Jobs:
    """Runs a cell's jobs, each on hard links of the same input files."""

    def __init__(self, cell: dict, work: Path, inputs, device: str, profile: bool):
        self.cell = cell
        self.work = work
        self.inputs = inputs
        self.device = device
        self.profile = profile
        self.mode = cell["cell"]["mode"]

    def argv(self, d: Path, r1: Path, r2: Path) -> list:
        return [a.format(r1=r1, r2=r2, dir=d) for a in self.cell["config"]["argv"]]

    def run(self, tag: str) -> dict:
        d = self.work / tag
        d.mkdir(parents=True)
        r1, r2 = d / "r1.fq.gz", d / "r2.fq.gz"
        os.link(self.inputs[0], r1)
        os.link(self.inputs[1], r2)
        argv = self.argv(d, r1, r2)
        if self.mode == "inprocess":
            rec = self._inprocess(argv)
        else:
            rec = self._process(d, argv)
        rec["dir"] = d
        return rec

    def _inprocess(self, argv) -> dict:
        import torch
        from fqtool_tpu_torch.main import main as port_main

        t0 = time.perf_counter()
        rc = port_main(argv)
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()
        return {"rc": rc, "t0": t0, "t1": time.perf_counter()}

    def _process(self, d: Path, argv) -> dict:
        stamp = d / "child.json"
        cmd = [sys.executable, str(BENCH / "child.py"), "--stamp", str(stamp)]
        if self.profile:
            cmd.append("--profile")
        cmd += ["--", *argv]
        t0 = time.perf_counter()
        spawn = time.time()
        with open(d / "child.err", "wb") as err:
            rc = subprocess.run(cmd, stdin=subprocess.DEVNULL,
                                stdout=subprocess.DEVNULL, stderr=err,
                                env=os.environ.copy()).returncode
        t1 = time.perf_counter()
        rec = {"rc": rc, "t0": t0, "t1": t1}
        if stamp.exists():
            child = json.loads(stamp.read_text())
            rec["child"] = child
            rec["startup_s"] = child["t_main"] - spawn
        return rec


def cpu_seconds() -> float:
    """CPU seconds of this process and of its children that have ended."""
    import resource
    me = resource.getrusage(resource.RUSAGE_SELF)
    kids = resource.getrusage(resource.RUSAGE_CHILDREN)
    return me.ru_utime + me.ru_stime + kids.ru_utime + kids.ru_stime


def output_bytes(d: Path) -> int:
    return sum(p.stat().st_size for p in d.iterdir()
               if p.is_file() and p.name not in ("r1.fq.gz", "r2.fq.gz"))


# ----------------------------------------------------------------------
# the device trace

def reduce_events(events) -> dict:
    """Busy seconds of the card (the union of its kernel, copy and set
    intervals), device seconds by name, the summed time of the overlap
    kernel, and the longest idle gaps; ``events`` are (name, start_us,
    end_us) of device activity."""
    events = sorted(events, key=lambda e: e[1])
    by_name: dict = {}
    busy, end, last = 0.0, None, ""
    gaps = []
    for name, a, b in events:
        key = name[:60]
        by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e6
        if end is not None and a > end:
            gaps.append((f"after {last[:50]}", (a - end) / 1e6))
        if end is None or b > end:
            busy += b - (a if end is None else max(a, end))
            end, last = b, name
    kernel = sum(s for n, s in by_name.items() if "overlap_kernel" in n)
    return {"busy_s": busy / 1e6,
            "overlap_kernel_s": kernel,
            "launches": sum(1 for e in events if "overlap_kernel" in e[0]),
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:10]}


def device_events(prof) -> list:
    """(name, start_us, end_us) of every device activity in a
    ``torch.profiler`` session."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():  # raw, without the tree
        if e.device_type() == DeviceType.CUDA:
            a = e.start_ns() / 1e3
            out.append((e.name(), a, a + e.duration_ns() / 1e3))
    return out


def merge_child_traces(children: list) -> dict:
    """The device record of a window of child processes, each traced on its
    own: busy and kernel seconds summed, ops and gaps merged."""
    ops: dict = {}
    gaps = []
    busy = kernel = 0.0
    launches = 0
    for c in children:
        dev = c.get("device")
        if not dev:
            continue
        busy += dev["busy_s"]
        kernel += dev["overlap_kernel_s"]
        launches += dev["launches"]
        for n, s in dev["device_ops"]:
            ops[n] = ops.get(n, 0.0) + s
        gaps += [tuple(g) for g in dev["idle_gaps"]]
    if busy <= 0:
        return {}
    return {"busy_s": busy, "overlap_kernel_s": kernel, "launches": launches,
            "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:10]}


def add_stages(total: dict, snap: dict) -> None:
    for k, v in snap.items():
        total[k] = total.get(k, 0.0) + float(v["seconds"])


def overlap_scans(config: dict) -> int:
    """Overlap scans a pair takes on the main path: one, and one more on the
    merged reads with ``-m``."""
    return 2 if config["reference_params"]["merge"] else 1


def overlap_bytes(pairs: int, read_len: int, scans: int) -> int:
    """The least bytes the scan moves (``ops/overlap.py::analyze``'s
    contract): both reads' uint8 [B, L] planes and int32 lengths read once;
    ``found`` (bool) and the offset, overlap length and diff (int32)
    written once."""
    return pairs * scans * (2 * read_len + 2 * 4 + 1 + 3 * 4)


# ----------------------------------------------------------------------

def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda:0", job_pairs=None) -> dict:
    """One run of a cell: set-up, warm job, window, check.  Returns the
    result object; ``job_pairs`` shrinks the jobs (tests)."""
    import numpy as np
    import torch

    import check

    on_card = device.startswith("cuda")
    # the card is traced in a traced run, and in every run of a cell that
    # has an end-to-end metric from the device trace
    profile = on_card and (trace or any(m["source"] == "device_trace"
                                        for m in cell["end_to_end"]))
    job = cell["cell"]
    config = cell["config"]
    n_pairs = job_pairs or job["job_pairs"]
    gen, law = traffic_of(job)
    work = work_dir(cell["name"])
    shutil.rmtree(work, ignore_errors=True)
    (work / "in").mkdir(parents=True)
    try:
        inputs = (work / "in" / "r1.fq.gz", work / "in" / "r2.fq.gz")
        t_in = time.perf_counter()
        pairs, written = gen.make_and_write(law, n_pairs, seed, *map(str, inputs))
        jobs = Jobs(cell, work, inputs, device, profile)
        # a whole job, so that the window's first job finds the process (or
        # the disk's caches, for a job in a process of its own) as the others do
        t_warm = time.perf_counter()
        warm = jobs.run("warm")
        if warm["rc"] != 0:
            raise BenchError(f"the warm job exited {warm['rc']}")
        written += output_bytes(warm["dir"])
        shutil.rmtree(warm["dir"])

        from fqtool_tpu_torch.host import tracing
        prof = None
        if trace and jobs.mode == "inprocess":
            tracing.reset()
        if profile and jobs.mode == "inprocess":
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        if on_card and jobs.mode == "inprocess":
            torch.cuda.reset_peak_memory_stats(0)

        # the window
        cpu0 = cpu_seconds()
        t_w0 = time.perf_counter()
        setup_s = t_w0 - T_START
        done = []
        while True:
            rec = jobs.run(f"job{len(done)}")
            done.append(rec)
            if rec["t1"] - t_w0 >= seconds:
                break
        t_w1 = done[-1]["t1"]
        window_s = t_w1 - t_w0
        cpu_s = cpu_seconds() - cpu0
        if prof is not None:
            prof.__exit__(None, None, None)

        leaked = forbidden_modules()
        if leaked:
            raise BenchError("loaded in this process: " + ", ".join(leaked))
        for r in done:
            leaked = r.get("child", {}).get("forbidden")
            if leaked:
                raise BenchError("loaded in a job's process: " + ", ".join(leaked))
        failed = sum(1 for r in done if r["rc"] != 0)
        for r in done:
            written += output_bytes(r["dir"])
        if jobs.mode == "inprocess":
            peak = torch.cuda.max_memory_allocated(0) if on_card else 0
        else:
            peak = max(r.get("child", {}).get("memory_peak_bytes", 0) for r in done)

        # the record the per-layer readers read
        stages: dict = {}
        if jobs.mode == "inprocess":
            add_stages(stages, tracing.snapshot())
            dev = reduce_events(device_events(prof)) if prof is not None else {}
            del prof
        else:
            for r in done:
                add_stages(stages, r.get("child", {}).get("stages", {}))
            dev = merge_child_traces([r.get("child", {}) for r in done])
        pairs_done = n_pairs * len(done)
        bases = pairs_done * 2 * law.read_len
        record = {
            "mode": jobs.mode, "trace": trace, "jobs": len(done),
            "pairs": pairs_done, "bases": bases, "gbp": bases / 1e9,
            "window_s": window_s, "setup_s": setup_s, "stages": stages,
            "startup_s": [r["startup_s"] for r in done if "startup_s" in r],
            "device": dev,
            "overlap_bytes": overlap_bytes(pairs_done, law.read_len,
                                           overlap_scans(config)),
            "peak_hbm_bytes_per_s": PEAK_HBM_BYTES_PER_S,
        }
        metrics = {}
        for m in cell["per_layer"] if trace else cell["end_to_end"]:
            value = reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        # the check: every job against the checked one, which is drawn from
        # the seed, and that one against the plain reference
        if on_card:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        pick = int(np.random.default_rng([seed % (1 << 64), 7]).integers(len(done)))
        streams = config["streams"]
        sigs = [check.job_signature(r["dir"], streams) if r["rc"] == 0 else None
                for r in done]
        jobs_differ = sum(1 for s in sigs if s != sigs[pick])
        checks = {"jobs_differ": jobs_differ}
        if sigs[pick] is None:
            checks.update(records_differ=pairs.count, counters_differ=1)
        else:
            ref = reference_of(config).expected(pairs, config, device)
            checks.update(check.against_reference(done[pick]["dir"], streams, ref))
        correct = failed == 0 and all(checks[k] <= check.LIMITS[k]
                                      for k in check.LIMITS)

        result = {"correct": correct, "attempted": len(done), "failed": failed,
                  "metrics": metrics}
        if on_card:
            result["device"] = {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}
        else:
            result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                                "memory_peak_bytes": 0}
        if trace and dev:
            result["device"]["busy_s"] = dev["busy_s"]
            result["device"]["window_s"] = window_s
            result["breakdown"] = {
                "device_ops": [[n, s] for n, s in dev["device_ops"]],
                "idle_gaps": [[n, s] for n, s in dev["idle_gaps"]]}
        result["run"] = {"jobs": len(done), "pairs": pairs_done,
                         "bytes_written": written, "window_s": window_s,
                         "overshoot_s": window_s - seconds,
                         "checked_job": pick,
                         "imports_s": t_in - T_START, "input_s": t_warm - t_in,
                         "warm_s": t_w0 - t_warm,
                         "check_s": time.perf_counter() - t_check,
                         "job_s": [r["t1"] - r["t0"] for r in done],
                         "cpu_s": cpu_s,
                         "overlap_launches": dev.get("launches")}
        result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                            for k, v in checks.items()}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = load_cell(args.workload)
        set_environment(bool(args.trace), "cuda:0")
        import torch
        if not torch.cuda.is_available():
            raise BenchError("torch sees no CUDA device: this benchmark runs "
                             "only on the card")
        chips = int(cell["entry"].get("chips", 1))
        if torch.cuda.device_count() < chips:
            raise BenchError(f"the cell asks for {chips} card(s), torch sees "
                             f"{torch.cuda.device_count()}")
        if importlib.util.find_spec(PORT) is None:
            raise BenchError(f"{PORT} is not in this checkout")
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except (BenchError, OSError, json.JSONDecodeError, KeyError) as e:
        log(f"error: {e}")
        return 2
    leaked = forbidden_modules()
    if leaked:
        log("error: loaded in this process: " + ", ".join(leaked))
        return 2
    # the program's stage trace prints at exit; print it now, so that the
    # checks stay the last lines of standard error
    import atexit
    from fqtool_tpu_torch.host import tracing
    atexit.unregister(tracing.dump)
    tracing.dump()
    run = dict(result["run"], card=card_line(),
               device_count=torch.cuda.device_count())
    print(json.dumps({"run": run}), flush=True)
    log(f"correct {result['correct']}")
    for k, v in result["checks"].items():
        log(f"check {k} {v['value']} limit {v['limit']}")
    result.pop("run")
    checks = result.pop("checks")
    result["card"] = run["card"]
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
