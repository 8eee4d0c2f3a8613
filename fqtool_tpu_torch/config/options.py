# Copy of fqtool_tpu/config/options.py, unchanged: the port keeps its own copy so that
# it imports nothing of fqtool_tpu.
"""Configuration model for the TPU-native fqtool.

Mirrors the reference option structs (reference: src/options.h:15-308) and the
derivation passes ``update()`` / ``validate()`` (src/options.cpp:24-71) with the
same defaults, including behavioral quirks that downstream record-equality
depends on (e.g. ``low_quality_base_limit`` derived from the *default* estimated
read length of 151, src/options.cpp:44).

Two layers:
  * mutable per-run dataclasses (this file) holding the full CLI state;
  * :meth:`Options.kernel_params` produces a hashable, frozen snapshot of the
    fields the jitted device pipeline depends on, so it can be used as a static
    jit argument.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

VERSION = "0.0.0"

# UMI locations (reference: src/umiprocessor.h:33-38)
UMI_LOC_NONE = 0
UMI_LOC_INDEX1 = 1
UMI_LOC_INDEX2 = 2
UMI_LOC_READ1 = 3
UMI_LOC_READ2 = 4
UMI_LOC_PER_INDEX = 5
UMI_LOC_PER_READ = 6


class OptionError(ValueError):
    """Raised when option validation fails (reference: util::errorExit)."""


@dataclass
class BufferSizeOptions:
    """reference: src/options.h:15-24"""

    max_packs_in_repo: int = 1000
    max_reads_in_pack: int = 100000
    max_packs_in_memory: int = 5


@dataclass
class MergePEOptions:
    """reference: src/options.h:27-36"""

    enabled: bool = False
    discard_unmerged: bool = False
    out: str = ""


@dataclass
class PolyGOptions:
    """reference: src/options.h:39-51"""

    enabled: bool = False
    min_len: int = 10
    max_mismatch: int = 1
    allowed_one_mismatch_for_each: int = 10


@dataclass
class PolyXOptions:
    """reference: src/options.h:54-68"""

    enabled: bool = False
    trim_chr: str = "ATCGN"
    min_len: int = 10
    max_mismatch: int = 1
    allowed_one_mismatch_for_each: int = 10


@dataclass
class UMIOptions:
    """reference: src/options.h:71-87"""

    enabled: bool = False
    location: int = 0
    length: int = 0
    skip: int = 0
    drop_other_comment: bool = False
    not_trim_read: bool = False


@dataclass
class DuplicationOptions:
    """reference: src/options.h:91-101 (enabled by default)."""

    enabled: bool = True
    keylen: int = 12
    hist_size: int = 32


@dataclass
class QualityCutOptions:
    """reference: src/options.h:104-131"""

    enable_front: bool = False
    enable_tail: bool = False
    enable_right: bool = False
    quality_shared: int = 20
    window_size_shared: int = 4
    quality_front: Optional[int] = None
    quality_tail: Optional[int] = None
    quality_right: Optional[int] = None
    window_size_front: Optional[int] = None
    window_size_tail: Optional[int] = None
    window_size_right: Optional[int] = None

    def resolved(self) -> Tuple[int, int, int, int, int, int]:
        """(qual_front, qual_tail, qual_right, win_front, win_tail, win_right).

        The reference copies the shared values into the per-cut fields at
        *construction* time (options.h:124-129), before CLI parsing writes into
        the shared fields -- so ``-W``/``-M`` never actually propagate and the
        effective defaults are always 4 / 20 unless the per-cut flag is given
        explicitly.  Replicated here: unset (None) falls back to the
        construction-time defaults, not to the CLI-set shared values.
        """
        qf = self.quality_front if self.quality_front is not None else 20
        qt = self.quality_tail if self.quality_tail is not None else 20
        qr = self.quality_right if self.quality_right is not None else 20
        wf = self.window_size_front if self.window_size_front is not None else 4
        wt = self.window_size_tail if self.window_size_tail is not None else 4
        wr = self.window_size_right if self.window_size_right is not None else 4
        return qf, qt, qr, wf, wt, wr


@dataclass
class IndexFilterOptions:
    """reference: src/options.h:134-147"""

    enabled: bool = False
    threshold: int = 0
    index1_file: str = ""
    index2_file: str = ""
    blacklist1: List[str] = field(default_factory=list)
    blacklist2: List[str] = field(default_factory=list)


@dataclass
class ORAOptions:
    """reference: src/options.h:150-160"""

    enabled: bool = False
    sampling: int = 20
    # seq -> count from the evaluator pre-pass (overRepSeqCountR1/R2)
    over_rep_seq_count_r1: dict = field(default_factory=dict)
    over_rep_seq_count_r2: dict = field(default_factory=dict)


@dataclass
class CorrectionOptions:
    """reference: src/options.h:163-169"""

    enabled: bool = False


@dataclass
class LowComplexityOptions:
    """reference: src/options.h:172-180"""

    enabled: bool = False
    threshold: float = 0.3


@dataclass
class LengthFilterOptions:
    """reference: src/options.h:183-194"""

    enabled: bool = False
    min_read_length: int = 15
    max_read_length: int = 0


@dataclass
class QualityFilterOptions:
    """reference: src/options.h:197-213 (enabled by default)."""

    enabled: bool = True
    low_quality_limit: int = 20  # becomes +33 ASCII in update()
    low_quality_base_limit: int = 40
    n_base_limit: int = 5
    low_quality_ratio: float = 0.15
    average_quality_limit: float = 0.0


@dataclass
class AdapterOptions:
    """reference: src/options.h:216-236"""

    cutable: bool = False
    enable_trimming: bool = True
    enable_detect_for_pe: bool = True
    adapter_seq_r1_provided: bool = False
    adapter_seq_r2_provided: bool = False
    input_adapter_seq_r1: str = ""
    input_adapter_seq_r2: str = ""
    detected_adapter_seq_r1: str = ""
    detected_adapter_seq_r2: str = ""
    report_threshold: float = 0.01


@dataclass
class ForceTrimOptions:
    """reference: src/options.h:239-255"""

    front1: int = 0
    tail1: int = 0
    front2: int = 0
    tail2: int = 0
    max_len1: int = 0
    max_len2: int = 0


@dataclass
class SplitOptions:
    """reference: src/options.h:258-276"""

    enabled: bool = False
    number: int = 0
    size: int = 0
    digits: int = 4
    need_evaluation: bool = False
    by_file_number: bool = False
    by_file_lines: bool = False


@dataclass
class KmerOptions:
    """reference: src/options.h:279-287"""

    enabled: bool = False
    kmer_len: int = 0


@dataclass
class EstimateOptions:
    """reference: src/options.h:290-308"""

    seq_len1: int = 151
    seq_len2: int = 151
    reads_num: int = 0
    two_color_system: bool = False
    adapter: str = ""
    illumina_adapter: bool = False
    estimated: bool = False


@dataclass
class Options:
    """Master options object (reference: src/options.h:311-386)."""

    version: str = VERSION
    in1: str = ""
    in2: str = ""
    out1: str = ""
    out2: str = ""
    unpaired1: str = ""
    unpaired2: str = ""
    failed_out: str = ""
    json_file: str = "report.json"
    html_file: str = "report.html"
    report_title: str = "Fastq Report"
    digits: int = 4
    compression: int = 3
    phred64: bool = False
    interleaved_input: bool = False
    thread: int = 4
    insert_size_max: int = 512
    overlap_require: int = 30
    overlap_diff_limit: int = 5

    trim: ForceTrimOptions = field(default_factory=ForceTrimOptions)
    qual_filter: QualityFilterOptions = field(default_factory=QualityFilterOptions)
    quality_cut: QualityCutOptions = field(default_factory=QualityCutOptions)
    length_filter: LengthFilterOptions = field(default_factory=LengthFilterOptions)
    adapter: AdapterOptions = field(default_factory=AdapterOptions)
    correction: CorrectionOptions = field(default_factory=CorrectionOptions)
    over_rep: ORAOptions = field(default_factory=ORAOptions)
    complexity_filter: LowComplexityOptions = field(default_factory=LowComplexityOptions)
    index_filter: IndexFilterOptions = field(default_factory=IndexFilterOptions)
    split: SplitOptions = field(default_factory=SplitOptions)
    kmer: KmerOptions = field(default_factory=KmerOptions)
    est: EstimateOptions = field(default_factory=EstimateOptions)
    duplicate: DuplicationOptions = field(default_factory=DuplicationOptions)
    umi: UMIOptions = field(default_factory=UMIOptions)
    polyg_trim: PolyGOptions = field(default_factory=PolyGOptions)
    polyx_trim: PolyXOptions = field(default_factory=PolyXOptions)
    merge_pe: MergePEOptions = field(default_factory=MergePEOptions)
    buf_size: BufferSizeOptions = field(default_factory=BufferSizeOptions)

    command: str = ""
    cwd: str = ""
    _updated: bool = field(default=False, repr=False)

    # ------------------------------------------------------------------
    def is_paired(self) -> bool:
        """reference: src/options.cpp:73-75"""
        return len(self.in2) > 0 or self.interleaved_input

    def update(self, argv: Optional[List[str]] = None) -> None:
        """Derivation pass (reference: src/options.cpp:24-58).

        Must be called exactly once, BEFORE read-length evaluation, so that the
        ``low_quality_base_limit`` derivation sees the *default* ``est.seq_len1``
        of 151 (quirk Q5; reference: src/options.cpp:44 vs src/main.cpp:124-129).
        """
        if self._updated:
            return
        self._updated = True
        # convert to internal Phred33-based ASCII quality (options.cpp:26)
        self.qual_filter.low_quality_limit = self.qual_filter.low_quality_limit + 33
        # adapter flags (options.cpp:28-33)
        self.adapter.adapter_seq_r1_provided = bool(self.adapter.input_adapter_seq_r1)
        self.adapter.adapter_seq_r2_provided = bool(self.adapter.input_adapter_seq_r2)
        self.adapter.cutable = self.adapter.enable_trimming and (
            self.is_paired() or len(self.adapter.input_adapter_seq_r1) > 0
        )
        if (
            self.adapter.enable_trimming
            and not self.adapter.adapter_seq_r1_provided
            and not self.adapter.adapter_seq_r2_provided
            and self.is_paired()
        ):
            self.adapter.enable_detect_for_pe = True
        # index filter blacklists (options.cpp:35-40, 77-94)
        if self.index_filter.enabled:
            self._init_index_filter()
        # split (options.cpp:42)
        self.split.enabled = self.split.by_file_lines or self.split.by_file_number
        # quality filter derived limit -- computed from est.seq_len1 which is
        # still the default (151) at this point: int(0.15 * 151) == 22 (Q5)
        self.qual_filter.low_quality_base_limit = int(
            self.qual_filter.low_quality_ratio * self.est.seq_len1
        )
        # umi validation (options.cpp:46-48)
        if (
            self.umi.enabled
            and self.umi.location in (UMI_LOC_READ1, UMI_LOC_READ2, UMI_LOC_PER_READ)
            and self.umi.length == 0
        ):
            raise OptionError("umi length can not be zero if it's in read1/2")
        # polyx uppercased (options.cpp:50)
        self.polyx_trim.trim_chr = self.polyx_trim.trim_chr.upper()
        # command line + cwd (options.cpp:52-57)
        if argv is not None:
            self.command = " ".join(argv) + " "
        self.cwd = os.getcwd()

    def validate(self) -> None:
        """reference: src/options.cpp:60-71"""
        if self.merge_pe.enabled and not self.merge_pe.out:
            raise OptionError("merged file output must be provided!")
        if any(c not in "ATCGN" for c in self.polyx_trim.trim_chr):
            raise OptionError("Can only trim nucleotides ATCGN")

    # ------------------------------------------------------------------
    def _init_index_filter(self) -> None:
        """reference: src/options.cpp:77-94"""
        f1, f2 = self.index_filter.index1_file, self.index_filter.index2_file
        if not f1 and not f2:
            return
        if f1:
            self.index_filter.blacklist1 = _read_index_list(f1)
        if f2:
            self.index_filter.blacklist2 = _read_index_list(f2)
        if not self.index_filter.blacklist1 and not self.index_filter.blacklist2:
            return
        self.index_filter.enabled = True

    # ------------------------------------------------------------------
    def kernel_params(self, is_r2: bool = False) -> "KernelParams":
        """Freeze the device-pipeline-relevant options into a hashable snapshot."""
        qc = self.quality_cut
        qf, qt, qr, wf, wt, wr = qc.resolved()
        return KernelParams(
            front=self.trim.front2 if is_r2 else self.trim.front1,
            tail=self.trim.tail2 if is_r2 else self.trim.tail1,
            max_len=self.trim.max_len2 if is_r2 else self.trim.max_len1,
            cut_front=qc.enable_front,
            cut_tail=qc.enable_tail,
            cut_right=qc.enable_right,
            cut_front_window=wf,
            cut_tail_window=wt,
            cut_right_window=wr,
            cut_front_qual=qf,
            cut_tail_qual=qt,
            cut_right_qual=qr,
            qual_filter_enabled=self.qual_filter.enabled,
            low_quality_limit=self.qual_filter.low_quality_limit,
            low_quality_base_limit=self.qual_filter.low_quality_base_limit,
            n_base_limit=self.qual_filter.n_base_limit,
            average_quality_limit=self.qual_filter.average_quality_limit,
            length_filter_enabled=self.length_filter.enabled,
            min_read_length=self.length_filter.min_read_length,
            max_read_length=self.length_filter.max_read_length,
            complexity_filter_enabled=self.complexity_filter.enabled,
            complexity_threshold=self.complexity_filter.threshold,
            polyg_enabled=self.polyg_trim.enabled,
            polyg_min_len=self.polyg_trim.min_len,
            polyg_max_mismatch=self.polyg_trim.max_mismatch,
            polyg_each=self.polyg_trim.allowed_one_mismatch_for_each,
            polyx_enabled=self.polyx_trim.enabled,
            polyx_trim_chr=self.polyx_trim.trim_chr,
            polyx_min_len=self.polyx_trim.min_len,
            polyx_max_mismatch=self.polyx_trim.max_mismatch,
            polyx_each=self.polyx_trim.allowed_one_mismatch_for_each,
            overlap_require=self.overlap_require,
            overlap_diff_limit=self.overlap_diff_limit,
            insert_size_max=self.insert_size_max,
            correction_enabled=self.correction.enabled,
            merge_enabled=self.merge_pe.enabled,
            adapter_trimming_enabled=self.adapter.enable_trimming,
            kmer_len=self.kmer.kmer_len if self.kmer.enabled else 0,
            dup_enabled=self.duplicate.enabled,
            dup_keylen=self.duplicate.keylen,
        )


@dataclass(frozen=True)
class KernelParams:
    """Hashable static parameters for the jitted device pipeline."""

    front: int
    tail: int
    max_len: int
    cut_front: bool
    cut_tail: bool
    cut_right: bool
    cut_front_window: int
    cut_tail_window: int
    cut_right_window: int
    cut_front_qual: int
    cut_tail_qual: int
    cut_right_qual: int
    qual_filter_enabled: bool
    low_quality_limit: int
    low_quality_base_limit: int
    n_base_limit: int
    average_quality_limit: float
    length_filter_enabled: bool
    min_read_length: int
    max_read_length: int
    complexity_filter_enabled: bool
    complexity_threshold: float
    polyg_enabled: bool
    polyg_min_len: int
    polyg_max_mismatch: int
    polyg_each: int
    polyx_enabled: bool
    polyx_trim_chr: str
    polyx_min_len: int
    polyx_max_mismatch: int
    polyx_each: int
    overlap_require: int
    overlap_diff_limit: int
    insert_size_max: int
    correction_enabled: bool
    merge_enabled: bool
    adapter_trimming_enabled: bool
    kmer_len: int
    dup_enabled: bool
    dup_keylen: int

    def with_(self, **kw) -> "KernelParams":
        return dataclasses.replace(self, **kw)


def _read_index_list(filename: str) -> List[str]:
    """reference: src/options.cpp:96-108"""
    out: List[str] = []
    with open(filename, "r") as fr:
        for line in fr:
            line = line.strip()
            if any(c not in "ATCG" for c in line):
                raise OptionError(
                    f"processing {filename}, each line should be one index, "
                    "which can only contain A/T/C/G"
                )
            out.append(line)
    return out
