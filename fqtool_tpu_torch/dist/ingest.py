# Copy of fqtool_tpu/dist/ingest.py, unchanged: the port keeps its own copy so that
# it imports nothing of fqtool_tpu.
"""Parallel multi-host input ingestion.

Round 3 striped packs across ranks but made EVERY rank inflate and
boundary-scan the ENTIRE input (dist/multihost.py round-3 path) -- O(world)
duplicated work, the measured multi-host scaling tail.  This module removes
it: each rank touches only ~1/world of each input file.

The reference's analogous axis is one reader pthread feeding N workers
(reference: src/seprocessor.cpp:59-180); the multi-host equivalent here is a
two-phase plan over byte regions:

1. **Count pass** (parallel): each rank scans only its region of each file --
   a contiguous compressed byte range starting at a gzip member boundary
   (plain files split at arbitrary byte offsets).  The native line scanner
   (native/fastq_core.cpp fq_scan_*) counts newlines and PROVES the region is
   strict 4-line FASTQ (name '@' / seq / '+' / qual with matching lengths,
   no '\\r', no blank lines) under every possible line phase.  The per-region
   summaries are tiny and compose exactly.
2. **Plan** (collective): rank 0 prefix-sums the line counts, picks each
   region's true phase, re-verifies the stitched boundary lines, frames the
   global record stream into fixed-size packs IDENTICAL to the
   single-process framing (so rank-side deflate + concat merge stays
   byte-identical), and assigns each rank the contiguous pack range whose
   records live in its regions.
3. **Materialize** (parallel): each rank re-reads from its region start,
   skips whole lines to its first pack boundary, and tokenizes/packs only
   its own packs, continuing past its region end for the final pack's tail.

Any deviation from strict 4-line FASTQ (CR line endings, blank lines,
mid-file garbage, stdin, a .gz with no member boundary near the split
points) makes the plan invalid and the caller falls back to the round-3
serial-scan path, whose record semantics match the reference reader exactly
(src/fqreader.cpp:90-195).
"""

from __future__ import annotations

import os
import sys
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..io import native
from ..io.fastq import pack_from_spans

_READ_CHUNK = 4 << 20
_INFLATE_CAP = 8 << 20
_GZ_MAGIC = b"\x1f\x8b\x08"
_MIN_REGION_LINES = 8  # below this the stitched verification has no interior


# ---------------------------------------------------------------------------
# region boundaries
# ---------------------------------------------------------------------------

def _probe_member(fh, off: int, file_size: int) -> bool:
    """Validate a candidate gzip member header at ``off`` by inflating up to
    1 MiB from it with a fresh gzip-only inflater."""
    import zlib

    fh.seek(off)
    data = fh.read(min(1 << 20, file_size - off))
    if len(data) < 10 or not data.startswith(_GZ_MAGIC):
        return False
    if data[3] & 0xE0:  # reserved FLG bits must be zero (RFC 1952)
        return False
    d = zlib.decompressobj(31)
    try:
        out = d.decompress(data, 1 << 20)
    except zlib.error:
        return False
    return bool(out) or d.eof


def _gz_boundaries(path: str, world: int) -> Optional[List[int]]:
    """Per-rank region start offsets (compressed): for each target offset
    r*size/world, the first validated gzip member header at/after it.
    Deterministic, so every rank computes the same list locally."""
    size = os.path.getsize(path)
    bounds = [0]
    with open(path, "rb") as fh:
        for r in range(1, world):
            target = r * size // world
            pos = max(target, bounds[-1])
            limit = min(size, target + 2 * (size // world) + _READ_CHUNK)
            found = None
            while pos < limit:
                fh.seek(pos)
                win = fh.read(_READ_CHUNK + len(_GZ_MAGIC) - 1)
                if not win:
                    break
                j = 0
                while True:
                    j = win.find(_GZ_MAGIC, j)
                    if j < 0 or pos + j >= size:
                        break
                    if _probe_member(fh, pos + j, size):
                        found = pos + j
                        break
                    j += 1
                if found is not None:
                    break
                pos += _READ_CHUNK
            bounds.append(found if found is not None else size)
    bounds.append(size)
    # empty regions (members sparser than the split grid) skew load balance;
    # when most regions are empty the serial fallback spreads work better
    nonempty = sum(1 for r in range(world) if bounds[r] < bounds[r + 1])
    if world > 1 and nonempty < max(2, -(-world // 2)):
        return None
    return bounds


def _plain_boundaries(path: str, world: int) -> List[int]:
    size = os.path.getsize(path)
    return [r * size // world for r in range(world)] + [size]


# ---------------------------------------------------------------------------
# count pass
# ---------------------------------------------------------------------------

_SPOOL_CAP = int(os.environ.get("FQTOOL_TPU_INGEST_SPOOL_CAP",
                                str(4 << 30)))


def _scan_region(path: str, gz: bool, lo: int, hi: int,
                 spool_dir: Optional[str] = None) -> dict:
    """Scan region bytes [lo, hi) with the native line scanner.  For gzip the
    region must start at a member boundary and end exactly on one (``clean``
    in the result); the member-stop inflater verifies that.

    For gzip regions the inflated bytes are also SPOOLED to a scratch file
    (up to _SPOOL_CAP) so the materialize pass reads plain bytes instead of
    inflating the region a second time; ``spool`` in the result names the
    file (caller owns cleanup), None when spooling was disabled or overflowed
    the cap."""
    import tempfile

    res: dict
    sc = native.LineScanner(at_stream_start=(lo == 0))
    if lo >= hi:
        res = sc.finish()
        res["clean"] = True
        res["spool"] = None
        return res
    spool = None
    spool_path = None
    spooled = 0
    # cap the spool at the expected inflated size (~8x the compressed
    # region is generous for FASTQ) and at half the spool dir's free space,
    # so a RAM-backed /dev/shm is never pinned to the 4 GiB global cap by a
    # small input or squeezed when the fs is nearly full
    cap = min(_SPOOL_CAP, 8 * max(hi - lo, 1))
    if spool_dir is not None:
        try:
            st = os.statvfs(spool_dir)
            cap = min(cap, st.f_bavail * st.f_frsize // 2)
        except OSError:
            pass

    def spool_write(data: bytes) -> None:
        # spool failure (ENOSPC, cap overflow) only loses the optimization:
        # the materializer falls back to re-inflating the region
        nonlocal spool, spool_path, spooled
        if spool is None or not data:
            return
        spooled += len(data)
        try:
            if spooled > cap:
                raise OSError("spool cap")
            spool.write(data)
        except OSError:
            try:
                spool.close()
            except OSError:
                pass
            os.unlink(spool_path)
            spool = None
            spool_path = None

    with open(path, "rb") as fh:
        fh.seek(lo)
        remaining = hi - lo
        if not gz:
            while remaining:
                data = fh.read(min(_READ_CHUNK, remaining))
                if not data:
                    break
                remaining -= len(data)
                sc.feed(data)
            res = sc.finish()
            res["clean"] = remaining == 0
            res["spool"] = None
            return res
        if spool_dir is not None and os.environ.get(
                "FQTOOL_TPU_INGEST_SPOOL", "1") == "1":
            try:
                fd, spool_path = tempfile.mkstemp(
                    prefix="fq_ingest_", suffix=".spool", dir=spool_dir)
                spool = os.fdopen(fd, "wb", buffering=1 << 20)
            except OSError:
                spool = spool_path = None
        inf = native.MemberInflater()
        clean = True
        at_member_end = False
        try:
            while True:
                if inf.has_pending:
                    data = b""
                elif remaining:
                    data = fh.read(min(_READ_CHUNK, remaining))
                    remaining -= len(data)
                else:
                    break
                out, member_end = inf.inflate(data, _INFLATE_CAP)
                if out:
                    sc.feed(out)
                    spool_write(out)
                at_member_end = member_end
                if member_end:
                    if inf.has_pending or remaining:
                        inf.reset()
                    else:
                        break
            # a region ending mid-member means the next rank's start
            # candidate was NOT a true member boundary
            clean = at_member_end and not inf.has_pending and remaining == 0
        except RuntimeError:
            clean = False
        finally:
            inf.close()
            if spool is not None:
                try:
                    spool.close()
                except OSError:
                    os.unlink(spool_path)
                    spool_path = None
    res = sc.finish()
    res["clean"] = clean
    res["spool"] = spool_path if clean else _drop_spool(spool_path)
    return res


# malformed-input messages observed by this rank's materializer, for the
# end-of-stream gather (one rank's trailing-record error must reach rank 0's
# stderr, not scroll past in a worker's log)
_stream_errors: List[str] = []


def drain_stream_errors() -> List[str]:
    errs = _stream_errors[:]
    _stream_errors.clear()
    return errs


def _drop_spool(path: Optional[str]):
    if path is not None:
        try:
            os.unlink(path)
        except OSError:
            pass
    return None


# ---------------------------------------------------------------------------
# plan composition (rank 0)
# ---------------------------------------------------------------------------

def _compose_file_plan(scans: List[dict]) -> Optional[dict]:
    """Compose per-region scans of ONE file into {nl_prefix, total_lines},
    or None when strictness could not be proven."""
    world = len(scans)
    nl_prefix = [0]
    for s in scans:
        if not s["clean"] or s["seen_cr"]:
            return None
        nl_prefix.append(nl_prefix[-1] + s["n_nl"])
    total_nl = nl_prefix[-1]
    tail = scans[-1]["tail_len"]
    total_lines = total_nl + (1 if tail > 0 else 0)
    if total_lines < 4:
        return None

    # interior strictness under each region's true phase
    for r, s in enumerate(scans):
        if s["n_nl"] == 0 and s["head_len"] == 0 and s["tail_len"] == 0:
            continue  # empty region
        if s["n_nl"] < _MIN_REGION_LINES:
            return None
        if not s["ok"][nl_prefix[r] % 4]:
            return None

    # stitched boundary verification: for each region boundary, rebuild the
    # ~9-line window around the split line and re-check the roles the
    # scanners had to skip
    def check_window(lines: List[Tuple[int, int]], g_base: int) -> bool:
        # lines: (length, first_byte) at global indices g_base + i
        n = len(lines)
        for i, (ln, fb) in enumerate(lines):
            if ln < 0:
                return False
            role = (g_base + i) % 4
            if role == 0 and (ln <= 0 or fb != ord("@")):
                return False
            if role == 2 and (ln <= 0 or fb != ord("+")):
                return False
            if role == 3 and i >= 2 and (g_base + i - 2) % 4 == 1:
                if ln != lines[i - 2][0]:
                    return False
        return True

    def is_empty(s: dict) -> bool:
        return s["n_nl"] == 0 and s["head_len"] == 0 and s["tail_len"] == 0

    prev_idx = 0
    for r in range(1, world):
        cur = scans[r]
        if is_empty(cur):
            continue
        # stitch against the nearest non-empty earlier region (empty regions
        # contribute no bytes, so the split line continues from there)
        prev = scans[prev_idx]
        prev_idx = r
        g_split = nl_prefix[r]          # line continuing across the split
        split_len = prev["tail_len"] + cur["head_len"]
        split_first = (prev["tail_first"] if prev["tail_len"] > 0
                       else cur["head_first"])
        window: List[Tuple[int, int]] = []
        # prev's last <=4 checked lines sit at g_split-4..g_split-1
        prev_last = [(l, b) for l, b in zip(prev["last_lens"],
                                            prev["last_bytes"]) if l >= 0]
        g_base = g_split - len(prev_last)
        window.extend(prev_last)
        window.append((split_len, split_first))
        nf = cur["n_first"]
        window.extend((cur["first_lens"][k], cur["first_bytes"][k])
                      for k in range(nf))
        if not check_window(window, g_base):
            return None

    # an unterminated final line: only its role-3 length check is open; the
    # materializer's tokenizer verifies it (and reproduces the reference's
    # error-stop if it mismatches)
    return dict(nl_prefix=nl_prefix, total_lines=total_lines)


class Plan:
    """Global pack plan shared by all ranks (broadcast from rank 0)."""

    def __init__(self, paths: List[str], gzs: List[bool],
                 bounds: List[List[int]], nl_prefix: List[List[int]],
                 pack_counts: List[int], owners: List[Tuple[int, int]],
                 pack_records: int, rec_per_unit: int,
                 spools: Optional[List[Optional[str]]] = None):
        self.paths = paths
        self.gzs = gzs
        self.bounds = bounds            # per file: world+1 byte offsets
        self.nl_prefix = nl_prefix      # per file: world+1 line prefixes
        self.pack_counts = pack_counts  # records (units) per pack
        self.owners = owners            # per rank: (p_lo, p_hi)
        self.pack_records = pack_records
        self.rec_per_unit = rec_per_unit
        # per file: THIS rank's local scratch file of its region's inflated
        # bytes (from the count pass), or None -> re-inflate from the source
        self.spools = spools or [None] * len(paths)


def build_plan(mh, paths: List[str], pack_records: int,
               rec_per_unit: int = 1) -> Optional[Plan]:
    """Run the count pass + collective composition.  All ranks call this in
    lockstep; returns the same Plan on every rank, or None (fallback) --
    the decision is made on rank 0 and broadcast, so it is always globally
    consistent."""
    world, rank = mh.world, mh.rank

    capable = (native.get_lib() is not None
               and os.environ.get("FQTOOL_TPU_NO_PARALLEL_INGEST") != "1")
    bounds: List[List[int]] = []
    gzs: List[bool] = []
    if capable:
        for path in paths:
            if path == "/dev/stdin" or not os.path.isfile(path):
                capable = False
                break
            gz = path.endswith(".gz")
            gzs.append(gz)
            b = _gz_boundaries(path, world) if gz else _plain_boundaries(path, world)
            if b is None:
                capable = False
                break
            bounds.append(b)

    scans: List[Optional[dict]] = []
    if capable:
        spool_dir = os.environ.get("FQTOOL_TPU_INGEST_SPOOL_DIR") or None
        if spool_dir is None:
            # prefer RAM-backed scratch (no writeback stalls) when present
            if os.path.isdir("/dev/shm") and os.access("/dev/shm", os.W_OK):
                spool_dir = "/dev/shm"
            else:
                import tempfile
                spool_dir = tempfile.gettempdir()
        for f, path in enumerate(paths):
            lo, hi = bounds[f][rank], bounds[f][rank + 1]
            scans.append(_scan_region(path, gzs[f], lo, hi,
                                      spool_dir=spool_dir))

    spools = [s.get("spool") if s else None for s in scans]
    gathered = mh.gather(dict(capable=capable, scans=scans, bounds=bounds))
    if rank == 0:
        plan_msg = None
        if all(g["capable"] for g in gathered) and \
                all(g["bounds"] == bounds for g in gathered):
            nl_prefix = []
            totals = []
            ok = True
            for f in range(len(paths)):
                fp = _compose_file_plan([g["scans"][f] for g in gathered])
                if fp is None:
                    ok = False
                    break
                nl_prefix.append(fp["nl_prefix"])
                totals.append(fp["total_lines"])
            if ok:
                plan_msg = dict(nl_prefix=nl_prefix, totals=totals)
        mh.broadcast(plan_msg)
    else:
        plan_msg = mh.broadcast()
    if plan_msg is None:
        for s in spools:
            _drop_spool(s)
        return None

    from ..host import tracing
    tracing.mark("plan_done")
    nl_prefix = plan_msg["nl_prefix"]
    totals = plan_msg["totals"]
    lines_per_unit = 4 * rec_per_unit
    units = min(t // lines_per_unit for t in totals)
    if units <= 0:
        for s in spools:
            _drop_spool(s)
        return None
    npacks = -(-units // pack_records)
    pack_counts = [min(pack_records, units - p * pack_records)
                   for p in range(npacks)]

    # rank r's record territory starts at the first unit fully at/after every
    # file's region-r start line; pack ownership is the contiguous range of
    # packs starting inside the territory
    unit_start = [max(-(-nl_prefix[f][r] // lines_per_unit)
                      for f in range(len(paths)))
                  for r in range(world)] + [units]
    owners = []
    for r in range(world):
        p_lo = min(-(-unit_start[r] // pack_records), npacks)
        p_hi = min(-(-unit_start[r + 1] // pack_records), npacks)
        owners.append((p_lo, max(p_hi, p_lo)))

    return Plan(paths, gzs, bounds, nl_prefix, pack_counts, owners,
                pack_records, rec_per_unit, spools=spools)


# ---------------------------------------------------------------------------
# materialize pass
# ---------------------------------------------------------------------------

class _RegionByteStream:
    """Raw (inflated) byte stream starting at a region boundary and running
    to end-of-file -- the final owned pack may spill past the region end.

    When the count pass spooled this rank's region (``spool``), the region's
    bytes are read back from the plain scratch file (no second inflate);
    the stream then continues from the NEXT region's start in the source
    file for the spill tail."""

    def __init__(self, path: str, gz: bool, lo: int,
                 spool: Optional[str] = None, resume_at: int = 0):
        self._spool_fh = None
        self._spool_path = spool
        if spool is not None:
            try:
                self._spool_fh = open(spool, "rb", buffering=1 << 20)
            except OSError:
                self._spool_fh = None
        self._fh = open(path, "rb", buffering=1 << 20)
        self._fh.seek(lo if self._spool_fh is None else resume_at)
        self._gz = gz
        self._inf = native.make_inflater() if gz else None

    def read_chunk(self) -> bytes:
        if self._spool_fh is not None:
            d = self._spool_fh.read(_READ_CHUNK)
            if d:
                return d
            # spool drained: continue inflating the source from the next
            # region start (a gzip member boundary) for the spill tail
            self._spool_fh.close()
            self._spool_fh = None
            _drop_spool(self._spool_path)
            self._spool_path = None
        if self._inf is None:
            return self._fh.read(_READ_CHUNK)
        out = []
        total = 0
        while total < _READ_CHUNK:
            if self._inf.has_pending:
                d = self._inf.inflate(b"", _READ_CHUNK - total)
            else:
                raw = self._fh.read(1 << 20)
                if not raw:
                    break
                d = self._inf.inflate(raw, _READ_CHUNK - total)
            if d:
                out.append(d)
                total += len(d)
        return b"".join(out)

    def close(self) -> None:
        if self._spool_fh is not None:
            self._spool_fh.close()
        _drop_spool(self._spool_path)
        self._spool_path = None
        if self._inf is not None:
            self._inf.close()
        self._fh.close()


class _PackMaterializer:
    """Tokenize exactly the owned packs of one file from its region stream."""

    def __init__(self, plan: Plan, file_idx: int, rank: int, phred64: bool,
                 width_multiple: int = 8):
        self.plan = plan
        self.phred64 = phred64
        self.width_multiple = width_multiple
        p_lo, p_hi = plan.owners[rank]
        self.p_lo, self.p_hi = p_lo, p_hi
        self._stream: Optional[_RegionByteStream] = None
        self._buf = bytearray()
        self._eof = False
        if p_lo >= p_hi:
            _drop_spool(plan.spools[file_idx])
            plan.spools[file_idx] = None
            return
        path = plan.paths[file_idx]
        lo = plan.bounds[file_idx][rank]
        self._stream = _RegionByteStream(
            path, plan.gzs[file_idx], lo, spool=plan.spools[file_idx],
            resume_at=plan.bounds[file_idx][rank + 1])
        lines_per_unit = 4 * plan.rec_per_unit
        self._to_skip = (p_lo * plan.pack_records * lines_per_unit
                         - plan.nl_prefix[file_idx][rank])
        assert self._to_skip >= 0

    def _fill(self, want: int) -> None:
        while not self._eof and len(self._buf) < want:
            chunk = self._stream.read_chunk()
            if not chunk:
                self._eof = True
                return
            self._buf += chunk

    def _skip_lines(self) -> None:
        while self._to_skip:
            self._fill(_READ_CHUNK)
            if not self._buf:
                raise RuntimeError("parallel ingest: input ended during skip")
            consumed, skipped = native.skip_newlines(bytes(self._buf),
                                                     self._to_skip)
            del self._buf[:consumed]
            self._to_skip -= skipped
            if skipped == 0 and self._eof:
                raise RuntimeError("parallel ingest: input ended during skip")

    def next_pack_spans(self, n_records: int):
        """(buf, spans) for the next ``n_records`` records.  The final
        records of the stream may come up short only on a trailing
        quality-length error, which is reported like the reference."""
        self._skip_lines()
        want = n_records * 300
        while True:
            self._fill(want)
            buf = bytes(self._buf)
            n, spans, consumed, err = native.parse_buffer(
                buf, n_records, final=self._eof)
            if n >= n_records or self._eof or err:
                if err:
                    msg = ("Error: base sequnce and quality sequence have "
                           "different length")
                    sys.stderr.write(msg + "\n")
                    # in multi-host runs only the rank owning the final pack
                    # sees this; record it so the end-of-stream gather can
                    # surface it on rank 0 too (drain_stream_errors)
                    _stream_errors.append(msg)
                if n < n_records and not err:
                    raise RuntimeError(
                        "parallel ingest: plan/stream record mismatch "
                        f"(wanted {n_records}, got {n})")
                del self._buf[:consumed]
                return buf, spans
            want = int(want * 1.5) + (1 << 20)

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None


def _batches(p_lo: int, p_hi: int, batch_units: int):
    """Consecutive unit ranges [lo, hi) of up to ``batch_units`` units."""
    lo = p_lo
    while lo < p_hi:
        hi = min(lo + max(1, batch_units), p_hi)
        yield lo, hi
        lo = hi


def iter_planned_se(plan: Plan, rank: int, phred64: bool,
                    width_multiple: int = 8,
                    batch_units: int = 1) -> Iterator[Tuple[int, object]]:
    """Yield ``(unit_idx, pack)``; each pack covers up to ``batch_units``
    consecutive owned write units (one full device batch), starting at global
    unit ``unit_idx``."""
    m = _PackMaterializer(plan, 0, rank, phred64, width_multiple)
    try:
        for lo, hi in _batches(m.p_lo, m.p_hi, batch_units):
            n = sum(plan.pack_counts[lo:hi])
            buf, spans = m.next_pack_spans(n)
            yield lo, pack_from_spans(buf, spans, phred64, width_multiple)
    finally:
        m.close()


def iter_planned_pe(plan: Plan, rank: int, phred64: bool,
                    width_multiple: int = 8, batch_units: int = 1):
    """Two-file PE: unit p of each side pairs up by construction (both sides
    are framed at the same global record boundaries)."""
    m1 = _PackMaterializer(plan, 0, rank, phred64, width_multiple)
    m2 = _PackMaterializer(plan, 1, rank, phred64, width_multiple)
    try:
        for lo, hi in _batches(m1.p_lo, m1.p_hi, batch_units):
            n = sum(plan.pack_counts[lo:hi])
            buf1, spans1 = m1.next_pack_spans(n)
            buf2, spans2 = m2.next_pack_spans(n)
            yield (lo, pack_from_spans(buf1, spans1, phred64, width_multiple),
                   pack_from_spans(buf2, spans2, phred64, width_multiple))
    finally:
        m1.close()
        m2.close()


def iter_planned_interleaved(plan: Plan, rank: int, phred64: bool,
                             width_multiple: int = 8, batch_units: int = 1):
    """Interleaved PE: each unit covers 2*pack_records records of the single
    stream; even records form side 1, odd records side 2."""
    m = _PackMaterializer(plan, 0, rank, phred64, width_multiple)
    try:
        for lo, hi in _batches(m.p_lo, m.p_hi, batch_units):
            pairs = sum(plan.pack_counts[lo:hi])
            buf, spans = m.next_pack_spans(2 * pairs)
            got = len(spans["seq_len"])
            even = {k: v[0:got:2] for k, v in spans.items()}
            odd = {k: v[1:got:2] for k, v in spans.items()}
            n = min(len(even["seq_len"]), len(odd["seq_len"]))
            even = {k: v[:n] for k, v in even.items()}
            odd = {k: v[:n] for k, v in odd.items()}
            yield (lo, pack_from_spans(buf, even, phred64, width_multiple),
                   pack_from_spans(buf, odd, phred64, width_multiple))
    finally:
        m.close()
