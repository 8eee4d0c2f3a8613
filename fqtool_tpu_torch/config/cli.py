# Copy of fqtool_tpu/config/cli.py, unchanged: the port keeps its own copy so that
# it imports nothing of fqtool_tpu.
"""Command-line interface mirroring the reference flag set.

Every flag, default, range check, needs/excludes constraint from the reference
CLI definition (reference: src/main.cpp:18-120) is reproduced here on top of
argparse.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence, Tuple

from .options import Options


class CLIError(SystemExit):
    pass


def _range_check(name: str, lo, hi, cast):
    def check(value: str):
        try:
            v = cast(value)
        except ValueError:
            raise argparse.ArgumentTypeError(f"{name}: invalid value {value!r}")
        if not (lo <= v <= hi):
            raise argparse.ArgumentTypeError(f"{name}: value {v} not in [{lo}, {hi}]")
        return v

    return check


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fqtool-tpu",
        description="TPU-native FASTQ preprocessor (feature-parity rebuild of fqtool)",
        add_help=True,
    )
    # IO (main.cpp:18-30)
    g = p.add_argument_group("IO")
    g.add_argument("-i", dest="in1", required=True, help="read1 input file name")
    g.add_argument("-o", dest="out1", required=True, help="read1 output file name")
    g.add_argument("-I", dest="in2", default="", help="read2 input file name")
    g.add_argument("-O", dest="out2", default="", help="read2 output file name")
    g.add_argument("--unpaired_read1", dest="unpaired1", default="", help="output read1 whose mate failed QC")
    g.add_argument("--unpaired_read2", dest="unpaired2", default="", help="output read2 whose mate failed QC")
    g.add_argument("--failed_out", dest="failed_out", default="", help="output failed QC reads")
    g.add_argument("--phred64", action="store_true", help="input fastq is phred64")
    g.add_argument("-z", dest="compression", type=_range_check("-z", 1, 9, int), default=3,
                   help="gzip output compress level")
    g.add_argument("--in_fq_interleaved", dest="interleaved_input", action="store_true",
                   help="input fastq interleaved")
    # Merge (main.cpp:25-27)
    g = p.add_argument_group("Merge")
    g.add_argument("-m", dest="merge_enabled", action="store_true", help="merge overlapped readpair")
    g.add_argument("--discard_unmerged", action="store_true", help="discard unmerged reads")
    g.add_argument("--merge_output", dest="merge_out", default="", help="merged output")
    # Duplication (main.cpp:32-34)
    g = p.add_argument_group("Duplication")
    g.add_argument("-d", dest="dup_enabled", action="store_true", help="enable duplication analysis")
    g.add_argument("--dup_ana_key_len", dest="dup_keylen", type=_range_check("--dup_ana_key_len", 12, 31, int),
                   default=12, help="duplication analysis key length")
    g.add_argument("--dup_ana_hist_size", dest="dup_hist_size",
                   type=_range_check("--dup_ana_hist_size", 1, 10000, int), default=32,
                   help="duplicate analysis hist size")
    # Adapter (main.cpp:36-39)
    g = p.add_argument_group("Adapter")
    g.add_argument("-a", dest="adapter_trimming", action="store_true", help="enable adapter trimming")
    g.add_argument("--adapter_of_read1", default="", help="adapter of read1")
    g.add_argument("--adapter_of_read2", default="", help="adapter of read2")
    g.add_argument("--detect_pe_adapter", action="store_true", help="detect PE adapters")
    # Trim (main.cpp:41-46)
    g = p.add_argument_group("Trim")
    g.add_argument("-f", dest="front1", type=_range_check("-f", 0, 1000, int), default=0,
                   help="bases trimmed in read1 front")
    g.add_argument("-t", dest="tail1", type=_range_check("-t", 0, 1000, int), default=0,
                   help="bases trimmed in read1 tail")
    g.add_argument("-b", dest="max_len1", type=_range_check("-b", 0, 1000, int), default=0,
                   help="read1 max length allowed")
    g.add_argument("-F", dest="front2", type=_range_check("-F", 0, 1000, int), default=0,
                   help="bases trimmed in read2 front")
    g.add_argument("-T", dest="tail2", type=_range_check("-T", 0, 1000, int), default=0,
                   help="bases trimmed in read2 tail")
    g.add_argument("-B", dest="max_len2", type=_range_check("-B", 0, 1000, int), default=0,
                   help="read2 max length allowed")
    # PolyX (main.cpp:48-57)
    g = p.add_argument_group("PolyX")
    g.add_argument("-g", dest="polyg_enabled", action="store_true", help="enable polyG trim")
    g.add_argument("--min_len_detect_polyG", dest="polyg_min_len", type=int, default=10)
    g.add_argument("--max_mismatches_polyG", dest="polyg_max_mismatch", type=int, default=1)
    g.add_argument("--one_mismatch_each_polyG", dest="polyg_each", type=int, default=10)
    g.add_argument("-x", dest="polyx_enabled", action="store_true", help="enable polyX trim")
    g.add_argument("--base_to_trim", dest="polyx_trim_chr", default="ATCGN")
    g.add_argument("--min_len_detect_polyX", dest="polyx_min_len", type=int, default=10)
    g.add_argument("--max_mismatches_polyX", dest="polyx_max_mismatch", type=int, default=1)
    g.add_argument("--one_mismatch_each_polyX", dest="polyx_each", type=int, default=10)
    # Cut (main.cpp:60-70)
    g = p.add_argument_group("Cut")
    g.add_argument("--enable_cut_front", action="store_true", help="slide and drop from 5'->3'")
    g.add_argument("--enable_cut_tail", action="store_true", help="slide and drop from 3'->5'")
    g.add_argument("--enable_cut_right", action="store_true",
                   help="slide from 5'->3' and drop window and right part")
    g.add_argument("-W", dest="window_size_shared", type=_range_check("-W", 0, 1000, int), default=4,
                   help="window size for cut sliding (NOTE: dead flag in the reference, kept for parity)")
    g.add_argument("-M", dest="quality_shared", type=_range_check("-M", 1, 36, int), default=20,
                   help="min mean quality to drop window/bases (NOTE: dead flag in the reference)")
    g.add_argument("--cut_front_window", type=_range_check("--cut_front_window", 0, 1000, int), default=None)
    g.add_argument("--cut_tail_window", type=_range_check("--cut_tail_window", 0, 1000, int), default=None)
    g.add_argument("--cut_right_window", type=_range_check("--cut_right_window", 0, 1000, int), default=None)
    g.add_argument("--cut_front_mean_qual", type=_range_check("--cut_front_mean_qual", 1, 36, int), default=None)
    g.add_argument("--cut_tail_mean_qual", type=_range_check("--cut_tail_mean_qual", 1, 36, int), default=None)
    g.add_argument("--cut_right_mean_qual", type=_range_check("--cut_right_mean_qual", 1, 36, int), default=None)
    # Qual (main.cpp:72-76)
    g = p.add_argument_group("Qual")
    g.add_argument("-q", dest="qual_filter_enabled", action="store_true", help="enable quality filter")
    g.add_argument("-Q", dest="low_quality_limit", type=_range_check("-Q", 0, 60, int), default=20,
                   help="minimum quality for qualified bases")
    g.add_argument("-U", dest="low_quality_ratio", type=_range_check("-U", 0, 1, float), default=0.15,
                   help="maximum low quality ratio allowed in one read")
    g.add_argument("-N", dest="n_base_limit", type=int, default=5,
                   help="maximum N bases allowed in one read")
    g.add_argument("-e", dest="average_quality_limit", type=float, default=0.0,
                   help="average quality needed for one read")
    # Length (main.cpp:78-80)
    g = p.add_argument_group("Length")
    g.add_argument("-l", dest="length_filter_enabled", action="store_true", help="enable length filter")
    g.add_argument("--min_length", dest="min_read_length", type=_range_check("--min_length", 0, 1000, int),
                   default=15)
    g.add_argument("--max_length", dest="max_read_length", type=_range_check("--max_length", 0, 1000, int),
                   default=0)
    # Complexity (main.cpp:82-83)
    g = p.add_argument_group("Complexity")
    g.add_argument("-y", dest="complexity_filter_enabled", action="store_true",
                   help="enable low complexity filter")
    g.add_argument("-Y", dest="complexity_threshold", type=_range_check("-Y", 0, 1, float), default=0.3,
                   help="min complexity required for a read")
    # Index (main.cpp:85-88)
    g = p.add_argument_group("Index")
    g.add_argument("--enable_index_filter", action="store_true")
    g.add_argument("--index1_file", default="")
    g.add_argument("--index2_file", default="")
    g.add_argument("--max_diff_for_match", type=_range_check("--max_diff_for_match", 0, 10, int), default=0)
    # Correction (main.cpp:90-92)
    g = p.add_argument_group("Correction")
    g.add_argument("-c", dest="correction_enabled", action="store_true",
                   help="enable base correction in PE reads")
    g.add_argument("--min_overlap_len", dest="overlap_require",
                   type=_range_check("--min_overlap_len", 0, 1000, int), default=30)
    g.add_argument("--max_diff_for_overlap", dest="overlap_diff_limit",
                   type=_range_check("--max_diff_for_overlap", 0, 10, int), default=5)
    # UMI (main.cpp:94-99)
    g = p.add_argument_group("UMI")
    g.add_argument("-u", dest="umi_enabled", action="store_true", help="enable UMI preprocess")
    g.add_argument("--umi_location", type=_range_check("--umi_location", 1, 6, int), default=0)
    g.add_argument("--umi_length", type=_range_check("--umi_length", 0, 1000, int), default=0)
    g.add_argument("--umi_skip_length", dest="umi_skip", type=_range_check("--umi_skip_length", 0, 1000, int),
                   default=0)
    g.add_argument("--umi_drop_comment", action="store_true")
    g.add_argument("--umi_not_trim", action="store_true")
    # ORA (main.cpp:101-102)
    g = p.add_argument_group("ORA")
    g.add_argument("--ora", dest="ora_enabled", action="store_true", help="enable ORA")
    g.add_argument("--ora_sample", type=_range_check("--ora_sample", 1, 10000, int), default=20)
    # KMer (main.cpp:104-105)
    g = p.add_argument_group("KMer")
    g.add_argument("--kmer", dest="kmer_enabled", action="store_true", help="enable kmer analysis")
    g.add_argument("--kmer_length", type=_range_check("--kmer_length", 4, 16, int), default=0)
    # Report (main.cpp:107-108)
    g = p.add_argument_group("Report")
    g.add_argument("-J", dest="json_file", default="report.json", help="json format report file")
    g.add_argument("-H", dest="html_file", default="report.html", help="html format report file")
    # System (main.cpp:110, 118-120)
    g = p.add_argument_group("System")
    g.add_argument("-w", dest="thread", type=_range_check("-w", 1, 16, int), default=4,
                   help="worker thread number")
    g.add_argument("--max_packs_in_repo", type=_range_check("--max_packs_in_repo", 1, 1000000, int),
                   default=1000)
    g.add_argument("--max_item_in_pack", type=_range_check("--max_item_in_pack", 1, 1000000, int),
                   default=100000)
    g.add_argument("--max_packs_in_mem", type=_range_check("--max_packs_in_mem", 1, 1000000, int),
                   default=5)
    # Split (main.cpp:112-116)
    g = p.add_argument_group("Split")
    g.add_argument("-s", dest="split_by_file_number", action="store_true",
                   help="split output by file number")
    g.add_argument("--split_file_number", type=int, default=0)
    g.add_argument("-S", dest="split_by_file_lines", action="store_true",
                   help="max line of each output file")
    # yes, the reference misspells this flag (main.cpp:115)
    g.add_argument("--splie_file_line", dest="split_file_line", type=int, default=0)
    g.add_argument("--digits_file_name", dest="digits", type=_range_check("--digits_file_name", 1, 10, int),
                   default=4)
    return p


# needs/excludes constraints from main.cpp; each entry: (dependent, prerequisite)
_NEEDS: Sequence[Tuple[str, str, str, str]] = (
    # (dest, human flag, prerequisite dest, human prerequisite flag)
    ("out2", "-O", "in2", "-I"),
    ("merge_enabled", "-m", "in2", "-I"),
    ("discard_unmerged", "--discard_unmerged", "merge_enabled", "-m"),
    ("merge_out", "--merge_output", "merge_enabled", "-m"),
    ("detect_pe_adapter", "--detect_pe_adapter", "in2", "-I"),
    ("adapter_of_read1", "--adapter_of_read1", "adapter_trimming", "-a"),
    ("adapter_of_read2", "--adapter_of_read2", "adapter_trimming", "-a"),
    ("index1_file", "--index1_file", "enable_index_filter", "--enable_index_filter"),
    ("index2_file", "--index2_file", "enable_index_filter", "--enable_index_filter"),
    ("umi_location", "--umi_location", "umi_enabled", "-u"),
    ("umi_length", "--umi_length", "umi_enabled", "-u"),
    ("umi_skip", "--umi_skip_length", "umi_enabled", "-u"),
    ("umi_drop_comment", "--umi_drop_comment", "umi_enabled", "-u"),
    ("umi_not_trim", "--umi_not_trim", "umi_enabled", "-u"),
    ("split_file_number", "--split_file_number", "split_by_file_number", "-s"),
    ("split_file_line", "--splie_file_line", "split_by_file_lines", "-S"),
    # duplication (main.cpp:33-34)
    ("dup_keylen", "--dup_ana_key_len", "dup_enabled", "-d"),
    ("dup_hist_size", "--dup_ana_hist_size", "dup_enabled", "-d"),
    # polyG / polyX (main.cpp:49-57)
    ("polyg_min_len", "--min_len_detect_polyG", "polyg_enabled", "-g"),
    ("polyg_max_mismatch", "--max_mismatches_polyG", "polyg_enabled", "-g"),
    ("polyg_each", "--one_mismatch_each_polyG", "polyg_enabled", "-g"),
    ("polyx_trim_chr", "--base_to_trim", "polyx_enabled", "-x"),
    ("polyx_min_len", "--min_len_detect_polyX", "polyx_enabled", "-x"),
    ("polyx_max_mismatch", "--max_mismatches_polyX", "polyx_enabled", "-x"),
    ("polyx_each", "--one_mismatch_each_polyX", "polyx_enabled", "-x"),
    # quality cuts (main.cpp:65-70) -- note --cut_right_mean_qual needs
    # --enable_cut_tail in the reference (main.cpp:70), not cut_right
    ("cut_front_window", "--cut_front_window", "enable_cut_front", "--enable_cut_front"),
    ("cut_tail_window", "--cut_tail_window", "enable_cut_tail", "--enable_cut_tail"),
    ("cut_right_window", "--cut_right_window", "enable_cut_right", "--enable_cut_right"),
    ("cut_front_mean_qual", "--cut_front_mean_qual", "enable_cut_front", "--enable_cut_front"),
    ("cut_tail_mean_qual", "--cut_tail_mean_qual", "enable_cut_tail", "--enable_cut_tail"),
    ("cut_right_mean_qual", "--cut_right_mean_qual", "enable_cut_tail", "--enable_cut_tail"),
    # quality filter (main.cpp:73-76)
    ("low_quality_limit", "-Q", "qual_filter_enabled", "-q"),
    ("low_quality_ratio", "-U", "qual_filter_enabled", "-q"),
    ("n_base_limit", "-N", "qual_filter_enabled", "-q"),
    ("average_quality_limit", "-e", "qual_filter_enabled", "-q"),
    # length filter (main.cpp:79-80)
    ("min_read_length", "--min_length", "length_filter_enabled", "-l"),
    ("max_read_length", "--max_length", "length_filter_enabled", "-l"),
    # complexity (main.cpp:83)
    ("complexity_threshold", "-Y", "complexity_filter_enabled", "-y"),
    # index filter (main.cpp:88)
    ("max_diff_for_match", "--max_diff_for_match", "enable_index_filter",
     "--enable_index_filter"),
    # ORA / kmer (main.cpp:102, 105)
    ("ora_sample", "--ora_sample", "ora_enabled", "--ora"),
    ("kmer_length", "--kmer_length", "kmer_enabled", "--kmer"),
)

_EXCLUDES: Sequence[Tuple[str, str, str, str]] = (
    ("interleaved_input", "--in_fq_interleaved", "in2", "-I"),
    ("split_by_file_number", "-s", "merge_enabled", "-m"),
    ("split_by_file_lines", "-S", "split_by_file_number", "-s"),
    ("split_by_file_lines", "-S", "merge_enabled", "-m"),
)


def _truthy(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return len(v) > 0
    if isinstance(v, (int, float)):
        return bool(v)
    return v is not None


def parse_args(argv: Optional[List[str]] = None) -> Options:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    ns = parser.parse_args(argv)

    given = _flags_given(argv)
    for dest, flag, pre_dest, pre_flag in _NEEDS:
        if flag in given and not (_truthy(getattr(ns, pre_dest)) or pre_flag in given):
            parser.error(f"{flag} requires {pre_flag}")
    for dest, flag, other_dest, other_flag in _EXCLUDES:
        if flag in given and (_truthy(getattr(ns, other_dest)) or other_flag in given):
            parser.error(f"{flag} excludes {other_flag}")

    if not os.path.exists(ns.in1):
        parser.error(f"-i: file does not exist: {ns.in1}")
    if ns.in2 and not os.path.exists(ns.in2):
        parser.error(f"-I: file does not exist: {ns.in2}")

    opt = namespace_to_options(ns)
    opt.update(argv=["fqtool-tpu"] + argv)
    opt.validate()
    return opt


def _flags_given(argv: Sequence[str]) -> set:
    out = set()
    for a in argv:
        if a.startswith("--"):
            out.add(a.split("=", 1)[0])
        elif a.startswith("-") and len(a) >= 2 and not a[1].isdigit():
            out.add(a[:2])
    return out


def namespace_to_options(ns: argparse.Namespace) -> Options:
    opt = Options()
    opt.in1 = ns.in1
    opt.in2 = ns.in2
    opt.out1 = ns.out1
    opt.out2 = ns.out2
    opt.unpaired1 = ns.unpaired1
    opt.unpaired2 = ns.unpaired2
    opt.failed_out = ns.failed_out
    opt.json_file = ns.json_file
    opt.html_file = ns.html_file
    opt.compression = ns.compression
    opt.phred64 = ns.phred64
    opt.interleaved_input = ns.interleaved_input
    opt.thread = ns.thread
    opt.overlap_require = ns.overlap_require
    opt.overlap_diff_limit = ns.overlap_diff_limit
    opt.digits = ns.digits

    opt.merge_pe.enabled = ns.merge_enabled
    opt.merge_pe.discard_unmerged = ns.discard_unmerged
    opt.merge_pe.out = ns.merge_out

    # CLI11 add_flag() resets the bound bool to false at registration, so the
    # struct defaults of true for -q/-d (options.h:97,205) never survive CLI
    # parsing in the reference; flags are plain opt-ins here too.
    opt.duplicate.enabled = ns.dup_enabled
    opt.duplicate.keylen = ns.dup_keylen
    opt.duplicate.hist_size = ns.dup_hist_size

    opt.adapter.enable_trimming = ns.adapter_trimming
    opt.adapter.input_adapter_seq_r1 = ns.adapter_of_read1
    opt.adapter.input_adapter_seq_r2 = ns.adapter_of_read2
    opt.adapter.enable_detect_for_pe = ns.detect_pe_adapter

    opt.correction.enabled = ns.correction_enabled

    opt.trim.front1 = ns.front1
    opt.trim.tail1 = ns.tail1
    opt.trim.max_len1 = ns.max_len1
    opt.trim.front2 = ns.front2
    opt.trim.tail2 = ns.tail2
    opt.trim.max_len2 = ns.max_len2

    opt.polyg_trim.enabled = ns.polyg_enabled
    opt.polyg_trim.min_len = ns.polyg_min_len
    opt.polyg_trim.max_mismatch = ns.polyg_max_mismatch
    opt.polyg_trim.allowed_one_mismatch_for_each = ns.polyg_each
    opt.polyx_trim.enabled = ns.polyx_enabled
    opt.polyx_trim.trim_chr = ns.polyx_trim_chr
    opt.polyx_trim.min_len = ns.polyx_min_len
    opt.polyx_trim.max_mismatch = ns.polyx_max_mismatch
    opt.polyx_trim.allowed_one_mismatch_for_each = ns.polyx_each

    opt.quality_cut.enable_front = ns.enable_cut_front
    opt.quality_cut.enable_tail = ns.enable_cut_tail
    opt.quality_cut.enable_right = ns.enable_cut_right
    opt.quality_cut.quality_shared = ns.quality_shared
    opt.quality_cut.window_size_shared = ns.window_size_shared
    opt.quality_cut.quality_front = ns.cut_front_mean_qual
    opt.quality_cut.quality_tail = ns.cut_tail_mean_qual
    opt.quality_cut.quality_right = ns.cut_right_mean_qual
    opt.quality_cut.window_size_front = ns.cut_front_window
    opt.quality_cut.window_size_tail = ns.cut_tail_window
    opt.quality_cut.window_size_right = ns.cut_right_window

    opt.qual_filter.enabled = ns.qual_filter_enabled
    opt.qual_filter.low_quality_limit = ns.low_quality_limit
    opt.qual_filter.low_quality_ratio = ns.low_quality_ratio
    opt.qual_filter.n_base_limit = ns.n_base_limit
    opt.qual_filter.average_quality_limit = ns.average_quality_limit

    opt.length_filter.enabled = ns.length_filter_enabled
    opt.length_filter.min_read_length = ns.min_read_length
    opt.length_filter.max_read_length = ns.max_read_length

    opt.complexity_filter.enabled = ns.complexity_filter_enabled
    opt.complexity_filter.threshold = ns.complexity_threshold

    opt.index_filter.enabled = ns.enable_index_filter
    opt.index_filter.index1_file = ns.index1_file
    opt.index_filter.index2_file = ns.index2_file
    opt.index_filter.threshold = ns.max_diff_for_match

    opt.umi.enabled = ns.umi_enabled
    opt.umi.location = ns.umi_location
    opt.umi.length = ns.umi_length
    opt.umi.skip = ns.umi_skip
    opt.umi.drop_other_comment = ns.umi_drop_comment
    opt.umi.not_trim_read = ns.umi_not_trim

    opt.over_rep.enabled = ns.ora_enabled
    opt.over_rep.sampling = ns.ora_sample

    opt.kmer.enabled = ns.kmer_enabled
    opt.kmer.kmer_len = ns.kmer_length

    opt.split.by_file_number = ns.split_by_file_number
    opt.split.number = ns.split_file_number
    opt.split.by_file_lines = ns.split_by_file_lines
    opt.split.size = ns.split_file_line
    # NOTE: --digits_file_name binds to the top-level digits field in the
    # reference (main.cpp:116) while split naming reads split.digits, which
    # stays at its default of 4 -- the flag is effectively dead; replicated.

    opt.buf_size.max_packs_in_repo = ns.max_packs_in_repo
    opt.buf_size.max_reads_in_pack = ns.max_item_in_pack
    opt.buf_size.max_packs_in_memory = ns.max_packs_in_mem
    return opt
