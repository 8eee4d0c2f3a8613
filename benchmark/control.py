"""The control of ``correct``, at a cell's own size: the plain reference
with one guarantee of the configuration broken (the cell file's
``control``) put in the program's place, compared with the reference as a
run compares the program's outputs.  It has to come out not correct; its
readings are the upper ends from which the limits in ``check.py`` were set.
The benchmark's own runs do not run it.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    import check
    from reference.records import records_differ

    cell = run.load_cell(args.workload)
    job, config = cell["cell"], cell["config"]
    gen, law = run.traffic_of(job)
    expected = run.reference_of(config).expected
    for seed in args.seeds:
        t0 = time.perf_counter()
        records = gen.make(law, job[f"job_{gen.UNIT}"], seed)
        ref = expected(records, config, args.device)
        ctl = expected(records, config, args.device, broken=job["control"])
        recs = sum(records_differ(ctl.stream_bytes(s), ref.stream_bytes(s))
                   for s in config["streams"])
        counters = check.counters_differ(check.flatten(ctl.report()),
                                         check.flatten(ref.report()))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": job["control"], "records_differ": recs,
                          "counters_differ": counters,
                          "correct": recs <= check.LIMITS["records_differ"]
                          and counters <= check.LIMITS["counters_differ"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
