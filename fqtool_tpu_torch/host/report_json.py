# Copy of fqtool_tpu/host/report_json.py, unchanged: its relative imports reach
# the port's own ops/filters.py, where the original's reach JAX.
"""JSON report generation.

Key-for-key port of ``JsonReporter::report`` (reference:
src/jsonreporter.cpp:23-162).  Output is serialized with sorted keys and
4-space indentation, matching nlohmann::json's std::map ordering and
``dump(4)`` layout.
"""

from __future__ import annotations

import json
from typing import Optional

from ..config.options import Options
from .filterresult import FilterResultAccumulator
from .stats import StatsAccumulator


def build_report(opt: Options,
                 fresult: FilterResultAccumulator,
                 pre1: StatsAccumulator,
                 post1: StatsAccumulator,
                 pre2: Optional[StatsAccumulator] = None,
                 post2: Optional[StatsAccumulator] = None,
                 dup_hist=None, dup_mean_gc=None, dup_rate: float = 0.0,
                 insert_hist=None, insert_peak: int = 0) -> dict:
    pre_reads = pre1.get_reads()
    pre_bases = pre1.get_bases()
    pre_q20 = pre1.get_q20()
    pre_q30 = pre1.get_q30()
    pre_gc = pre1.get_gc_number()
    pre_r1_len = pre1.get_mean_length()
    pre_r2_len = 0
    post_reads = post1.get_reads()
    post_bases = post1.get_bases()
    post_q20 = post1.get_q20()
    post_q30 = post1.get_q30()
    post_gc = post1.get_gc_number()
    post_r1_len = post1.get_mean_length()
    post_r2_len = 0
    if pre2 is not None and post2 is not None:
        pre_reads += pre2.get_reads()
        pre_bases += pre2.get_bases()
        pre_q20 += pre2.get_q20()
        pre_q30 += pre2.get_q30()
        pre_gc += pre2.get_gc_number()
        post_reads += post2.get_reads()
        post_bases += post2.get_bases()
        post_q20 += post2.get_q20()
        post_q30 += post2.get_q30()
        post_gc += post2.get_gc_number()
        pre_r2_len = pre2.get_mean_length()
        post_r2_len = post2.get_mean_length()

    def rate(n, d):
        return 0.0 if d == 0 else n / d

    report: dict = {}
    pre_qc = {
        "TotalReads": pre_reads,
        "TotalBases": pre_bases,
        "Q20Bases": pre_q20,
        "Q30Bases": pre_q30,
        "Q20BaseRate": rate(pre_q20, pre_bases),
        "Q30BaseRate": rate(pre_q30, pre_bases),
        "Read1Length": pre_r1_len,
        "GCRate": rate(pre_gc, pre_bases),
    }
    post_qc = {
        "TotalReads": post_reads,
        "TotalBases": post_bases,
        "Q20Bases": post_q20,
        "Q30Bases": post_q30,
        "Q20BaseRate": rate(post_q20, post_bases),
        "Q30BaseRate": rate(post_q30, post_bases),
        "Read1Length": post_r1_len,
        "GCRate": rate(post_gc, post_bases),
    }
    if opt.is_paired():
        pre_qc["Read2Length"] = pre_r2_len
        post_qc["Read2Length"] = post_r2_len
    report["Summary"] = {"BeforeFiltering": pre_qc, "AfterFiltering": post_qc}

    report["FilterResult"] = fresult.report_json_basic()

    if opt.duplicate.enabled:
        report["Duplication"] = {
            "Rate": dup_rate,
            "Histogram": [int(x) for x in dup_hist],
            "MeanGC": [float(x) for x in dup_mean_gc],
        }

    if opt.is_paired():
        report["InsertSize"] = {
            "Peak": insert_peak,
            "Unknown": int(insert_hist[opt.insert_size_max]),
            "Histogram": [int(x) for x in insert_hist[: opt.insert_size_max]],
        }

    if opt.adapter.enable_trimming:
        report["AdapterTrim"] = fresult.report_adapters_json()

    if opt.polyx_trim.enabled or opt.polyg_trim.enabled:
        report["PolyxTrimming"] = fresult.report_polyx_json()

    report["Read1BeforeFiltering"] = pre1.report_json()
    if pre2 is not None:
        report["Read2BeforeFiltering"] = pre2.report_json()
    name = "MergedAndFiltered" if opt.merge_pe.enabled else "Read1AfterFiltering"
    report[name] = post1.report_json()
    if post2 is not None and not opt.merge_pe.enabled:
        report["Read2AfterFiltering"] = post2.report_json()

    report["Software"] = {
        "CWD": opt.cwd,
        "Command": opt.command,
        "Version": opt.version,
    }
    return report


def write_report(path: str, report: dict) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=4, sort_keys=True)
