# Copy of fqtool_tpu/host/report_html.py, unchanged: its relative imports reach
# the port's own ops/filters.py, where the original's reach JAX.
"""HTML report generation.

Reproduces the reference HTML report structure (reference:
src/htmlreporter.cpp, src/stats.cpp:432-813): self-contained page with CSS,
show/hide JS, Plotly CDN charts for quality/content curves and duplication,
summary tables, adapter/polyX sections, and kmer/ORA tables when enabled.
"""

from __future__ import annotations

import time
from typing import List, Optional

from ..config.options import Options
from .filterresult import FilterResultAccumulator
from .stats import StatsAccumulator

_CSS = """td {border:1px solid #dddddd;padding:5px;font-size:12px;}
table {border:1px solid #999999;padding:2x;border-collapse:collapse; width:800px}
.col1 {width:240px; font-weight:bold;}
.adapter_col {width:500px; font-size:10px;}
img {padding:30px;}
#menu {font-family:Consolas, 'Liberation Mono', Menlo, Courier, monospace;}
a:visited {color: #999999}
.alignleft {text-align:left;}
.alignright {text-align:right;}
.figure {width:800px;height:600px;}
.header {color:#ffffff;padding:1px;height:20px;background:#000000;}
.section_title {color:#ffffff;font-size:20px;padding:5px;text-align:left;background:#663355; margin-top:10px;}
.subsection_title {font-size:16px;padding:5px;margin-top:10px;text-align:left;color:#663355}
#container {text-align:center;padding:3px 3px 3px 10px;}
.menu_item {text-align:left;padding-top:5px;font-size:18px;}
.highlight {text-align:left;padding-top:30px;padding-bottom:30px;font-size:20px;line-height:35px;}
#helper {text-align:left;border:1px dotted #fafafa;color:#777777;font-size:12px;}
#footer {text-align:left;padding:15px;color:#ffffff;font-size:10px;background:#663355;}
.kmer_table {text-align:center;font-size:8px;padding:2px;}
.kmer_table td{text-align:center;font-size:8px;padding:0px;color:#ffffff}
.sub_section_tips {color:#999999;font-size:10px;padding-left:5px;padding-bottom:3px;}
"""

_JS = """function showOrHide(divname) {
  div = document.getElementById(divname);
  if(div.style.display == 'none')
     div.style.display = 'block';
  else
     div.style.display = 'none';
}
"""


def _esc(s) -> str:
    return (str(s).replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;"))


def _row(key, val) -> str:
    return f"<tr><td class='col1'>{_esc(key)}</td><td class='col2'>{_esc(val)}</td></tr>"


def _pct(n, d) -> str:
    return f"{(n * 100.0 / d) if d else 0.0:.6f}"


def _section(title: str, div_id: str, body: str) -> str:
    return (f"<div class='section_div'><div class='section_title' "
            f"onclick=\"showOrHide('{div_id}')\"><a name='summary'>{_esc(title)}</a></div>"
            f"<div id='{div_id}'>{body}</div></div>")


def _g(v) -> str:
    """C++ ``ostream << double`` formatting (6 significant digits, %g) --
    the reference serializes every curve value this way
    (stats.h:214-224 list2string)."""
    return f"{float(v):.6g}"


def _curves_plot(div: str, x: List[int], series: List[tuple], yaxis: str,
                 long_read: bool, cycles: int, y_extra: str = "") -> str:
    """reference: src/stats.cpp:669-693 (quality) / 795-808 (content):
    traces as {x, y, name, mode, line}, xaxis nticks = cycles/5, yaxis
    nticks = 20."""
    traces = []
    for name, ys, color in series:
        ys_str = ",".join(_g(v) for v in ys)
        traces.append(
            "{x:[" + ",".join(map(str, x)) + "],y:[" + ys_str + "],"
            f"name:'{name}',mode:'lines',line:{{color:'{color}',width:1}}}}")
    logx = ",type:'log'" if long_read else ""
    return ("<script type='text/javascript'>var data=[" + ",".join(traces) + "];"
            "var layout={title:'',xaxis:{title:'position'"
            f", tickmode: 'auto', nticks: '{cycles // 5}'" + logx + "},"
            "yaxis:{title:'" + yaxis + "', tickmode: 'auto', nticks: '20'"
            + y_extra + "}};"
            f"Plotly.newPlot('{div}', data, layout);</script>")


def _downsample_x(cycles: int, long_read: bool) -> List[int]:
    """reference: src/stats.cpp:642-669 log-scale downsampling for long reads."""
    if not long_read:
        return list(range(1, cycles + 1))
    xs = list(range(1, min(40, cycles) + 1))
    if cycles > 40:
        pos = 40.0
        while True:
            pos *= 1.05
            if pos >= cycles:
                break
            xs.append(int(pos))
        if xs[-1] != cycles:
            xs.append(cycles)
    return xs


def _stats_sections(st: StatsAccumulator, filtering: str, read_name: str) -> str:
    sm = st.summarize()
    cycles = sm["cycles"]
    long_read = cycles > 300
    xs = _downsample_x(cycles, long_read)
    # reference quirk: y is the FIRST len(xs) curve values, not the curve
    # sampled at the downsampled x positions (list2string(curve, total),
    # stats.cpp:675,680 -- long-read plots pair x[i] with curve[cycle i+1])
    idx = list(range(len(xs)))
    out = []

    # quality curves
    sub = f"{filtering}: {read_name}: quality"
    div = sub.replace(" ", "_").replace(":", "_")
    colors = ["rgba(128,128,0,1.0)", "rgba(128,0,128,1.0)", "rgba(0,255,0,1.0)",
              "rgba(0,0,255,1.0)", "rgba(20,20,20,1.0)"]
    series = [(b, [sm["quality_curves"][b][i] for i in idx], c)
              for b, c in zip(["A", "T", "C", "G", "Mean"], colors)]
    out.append(
        f"<div class='section_div'><div class='subsection_title'>"
        f"<a title='click to hide/show' onclick=\"showOrHide('{div}')\">{_esc(sub)}</a></div>"
        f"<div id='{div}'><div class='sub_section_tips'>Value of each position will be shown on mouse over</div>"
        f"<div class='figure' id='plot_{div}'></div></div>"
        + _curves_plot(f"plot_{div}", xs, series, "quality", long_read, cycles)
        + "</div>")

    # content curves
    sub = f"{filtering}: {read_name}: base contents"
    div = sub.replace(" ", "_").replace(":", "_")
    colors6 = colors[:4] + ["rgba(255, 0, 0, 1.0)", "rgba(20,20,20,1.0)"]
    bases_total = sm["bases"]
    series = []
    from .stats import BIN_OF
    for b, c in zip(["A", "T", "C", "G", "N", "GC"], colors6):
        if len(b) == 1:
            count = int(sm["base_contents"][BIN_OF[b]])
        else:
            count = int(sm["base_contents"][BIN_OF["G"]] + sm["base_contents"][BIN_OF["C"]])
        if bases_total == 0:
            # reference: std::to_string(0*100.0/0).substr(0,5) == "-nan"
            # (x86 0.0/0.0 yields the sign-bit-set quiet NaN)
            pct = "-nan"
        else:
            pct = f"{count * 100.0 / bases_total:.6f}"[:5]
        series.append((f"{b}({pct}%)", [sm["content_curves"][b][i] for i in idx], c))
    out.append(
        f"<div class='section_div'><div class='subsection_title'>"
        f"<a title='click to hide/show' onclick=\"showOrHide('{div}')\">{_esc(sub)}</a></div>"
        f"<div id='{div}'><div class='sub_section_tips'>Value of each position will be shown on mouse over</div>"
        f"<div class='figure' id='plot_{div}'></div></div>"
        + _curves_plot(f"plot_{div}", xs, series, "base content ratios", long_read,
                       cycles, ", range: ['0.0', '1.0']") + "</div>")

    # kmer table (stats.cpp:550-629)
    if st.kmer_len:
        out.append(_kmer_section(st, filtering, read_name))
    # ORA table (stats.cpp:445-548)
    if st.over_rep_sampling:
        out.append(_ora_section(st, filtering, read_name))
    return "".join(out)


def _kmer_section(st: StatsAccumulator, filtering: str, read_name: str) -> str:
    from .evaluator import int2seq

    k = st.kmer_len
    sub = f"{filtering}: {read_name}: KMER counting"
    div = sub.replace(" ", "_").replace(":", "_")
    half = 1 << k
    mean = (st.get_bases() + 1) / len(st.kmer)
    rows = ["<tr><td></td>" + "".join(f"<td style='color:#333333'>{h+1}</td>"
                                      for h in range(half)) + "</tr>"]
    n = 0
    for i in range(half):
        cells = [f"<td style='color:#333333'>{i+1}</td>"]
        for j in range(half):
            seq = int2seq(n, k)
            count = int(st.kmer[n])
            prop = count / mean
            if prop > 2.0:
                frac = (prop - 2.0) / 20.0 + 0.5
            elif prop < 0.5:
                frac = prop
            else:
                frac = 0.5
            frac = max(0.01, min(1.0, frac))
            r = int((1.0 - frac) * 255)
            color = f"{r:02x}{r:02x}{r:02x}"
            cells.append(f"<td style='background:#{color}' "
                         f"title='{seq}: {count}&#10;{prop:.6f} times as mean value'>{seq}</td>")
            n += 1
        rows.append("<tr>" + "".join(cells) + "</tr>")
    return (f"<div class='section_div'><div class='subsection_title'>"
            f"<a title='click to hide/show' onclick=\"showOrHide('{div}')\">{_esc(sub)}</a></div>"
            f"<div id='{div}'><div class='sub_section_tips'>Darker background means larger counts. "
            f"The count will be shown on mouse over</div>"
            f"<table class='kmer_table' style='width:680px;'>" + "".join(rows)
            + "</table></div></div>")


def _ora_section(st: StatsAccumulator, filtering: str, read_name: str) -> str:
    sub = f"{filtering}: {read_name}: overrepresented sequences"
    div = sub.replace(" ", "_").replace(":", "_")
    d_bases = st.get_bases() or 1
    rows = ["<tr style='font-weight:bold;'><td>overrepresented sequence</td>"
            "<td>count (% of bases)</td>"
            f"<td>distribution: cycle 1 ~ cycle {st.evaluated_seq_len}</td></tr>"]
    found = 0
    js_entries = []
    for seq in sorted(st.over_rep_count):
        count = st.over_rep_count[seq]
        if not st.over_rep_passed(seq, count):
            continue
        found += 1
        percent = 100.0 * count * len(seq) * st.over_rep_sampling / d_bases
        rows.append(
            f"<tr><td width='400' style='word-break:break-all;font-size:8px;'>{seq}</td>"
            f"<td width='200'>{count}({percent:.6f}%)</td>"
            # CTML emits attributes in map order (height < width) and no
            # closing tag for the childless canvas node (ctml.hpp ToString)
            f'<td width=\'250\'><canvas id="{div}_{seq}" height="20" width="240"></td></tr>')
        dist = ",".join(str(int(v)) for v in st.over_rep_dist[seq][: st.evaluated_seq_len])
        js_entries.append(f'"{div}_{seq}":[{dist}]')
    if found == 0:
        rows.append("<tr><td style='text-align:center' colspan='3'>not found</td></tr>")
    js = ("<script language='javascript'>var seqlen = "
          f"{st.evaluated_seq_len};\nvar orp_dist = {{" + ",\n".join(js_entries) + "};\n"
          "for (seq in orp_dist) {var cvs = document.getElementById(seq);"
          "var ctx = cvs.getContext('2d');var data = orp_dist[seq];var w=240;var h=20;"
          "ctx.fillStyle='#cccccc';ctx.fillRect(0,0,w,h);ctx.fillStyle='#0000FF';"
          "var maxVal=0;for(d=0;d<seqlen;d++){if(data[d]>maxVal) maxVal=data[d];}"
          "var step=(seqlen-1)/(w-1);for(x=0;x<w;x++){var target=step*x;"
          "var val=data[Math.floor(target)];var y=Math.floor((val/maxVal)*h);"
          "ctx.fillRect(x,h-1,1,-y);}}</script>")
    return (f"<div class='section_div'><div class='subsection_title'>"
            f"<a title='click to hide/show' onclick=\"showOrHide('{div}')\">{_esc(sub)}</a></div>"
            f"<div id='{div}'><div class='sub_section_tips'>Sampling rate: 1/{st.over_rep_sampling}</div>"
            f"<table class='summary_table'>" + "".join(rows) + "</table></div>" + js + "</div>")


def _duplication_section(opt: Options, dup_hist, dup_mean_gc, dup_rate: float) -> str:
    """reference: src/htmlreporter.cpp:250-319"""
    total = opt.duplicate.hist_size - 2
    xs = list(range(1, total + 1))
    all_count = float(sum(int(dup_hist[i + 1]) for i in range(total)))
    percents = [(int(dup_hist[i + 1]) * 100.0 / all_count) if all_count > 0 else 0.0
                for i in range(total)]
    gc = [float(dup_mean_gc[i + 1]) * 100.0 for i in range(total)]
    max_gc = total
    for i in range(total):
        if percents[i] <= 0.05 and max_gc == total:
            max_gc = i
    # curve values serialize via list2string (ostream %g), the rate via
    # std::to_string (%f) -- htmlreporter.cpp:276-292
    js = ("<script type='text/javascript'>var data=[{x:[" + ",".join(map(str, xs)) + "],"
          "y:[" + ",".join(_g(p) for p in percents) + "],name:'Read percent (%)  ',"
          "type:'bar',line:{color:'rgba(128,0,128,1.0)',width:1}},"
          "{x:[" + ",".join(map(str, xs[:max_gc])) + "],"
          "y:[" + ",".join(_g(g) for g in gc[:max_gc]) + "],name:'Mean GC ratio (%)  ',"
          "mode:'lines',line:{color:'rgba(255,0,128,1.0)',width:2}}];"
          f"var layout={{title:'duplication rate ({dup_rate*100.0:.6f}%)',"
          "xaxis:{title:'duplication level'},yaxis:{title:'Read percent (%) & GC ratio'}};"
          "Plotly.newPlot('plot_duplication', data, layout);</script>")
    return _section("Duplication", "duplication",
                    "<div id='duplication_figure'><div class='figure' id='plot_duplication' "
                    "style='height:400px;'></div></div>") + js


def write_report(opt: Options, fresult: FilterResultAccumulator,
                 pre1: StatsAccumulator, post1: StatsAccumulator,
                 pre2: Optional[StatsAccumulator], post2: Optional[StatsAccumulator],
                 dup_hist, dup_mean_gc, dup_rate: float,
                 insert_hist, insert_peak: int) -> None:
    paired = opt.is_paired()

    pre_reads = pre1.get_reads() + (pre2.get_reads() if pre2 else 0)
    pre_bases = pre1.get_bases() + (pre2.get_bases() if pre2 else 0)
    pre_q20 = pre1.get_q20() + (pre2.get_q20() if pre2 else 0)
    pre_q30 = pre1.get_q30() + (pre2.get_q30() if pre2 else 0)
    pre_gc = pre1.get_gc_number() + (pre2.get_gc_number() if pre2 else 0)
    post_reads = post1.get_reads() + (post2.get_reads() if post2 else 0)
    post_bases = post1.get_bases() + (post2.get_bases() if post2 else 0)
    post_q20 = post1.get_q20() + (post2.get_q20() if post2 else 0)
    post_q30 = post1.get_q30() + (post2.get_q30() if post2 else 0)
    post_gc = post1.get_gc_number() + (post2.get_gc_number() if post2 else 0)

    seq_info = "paired end" if paired else "single end"
    if paired and pre2 is not None:
        seq_info += f" ({pre1.get_cycles()} cycles + {pre2.get_cycles()} cycles)"
    else:
        seq_info += f" ({pre1.get_cycles()} cycles)"

    general = [_row("Sequencing", seq_info)]
    if paired:
        general.append(_row("Insert Size Peak", insert_peak))
    if opt.adapter.enable_trimming:
        if opt.adapter.detected_adapter_seq_r1:
            general.append(_row("Detected Read1 Adapter", opt.adapter.detected_adapter_seq_r1))
        if opt.adapter.detected_adapter_seq_r2:
            general.append(_row("Detected Read2 Adapter", opt.adapter.detected_adapter_seq_r2))

    def qc_table(reads, bases, q20, q30, gcn, r1len, r2len):
        rows = [_row("Total Reads", reads), _row("Total Bases", bases),
                _row("Q20 Bases", f"{q20}({_pct(q20, bases)}%)"),
                _row("Q30 Bases", f"{q30}({_pct(q30, bases)}%)"),
                _row("GC Content", f"{_pct(gcn, bases)}%"),
                _row("Read1 Mean Length", r1len)]
        if paired:
            rows.append(_row("Read2 Mean Length", r2len))
        return rows

    pre_table = qc_table(pre_reads, pre_bases, pre_q20, pre_q30, pre_gc,
                         pre1.get_mean_length(), pre2.get_mean_length() if pre2 else 0)
    if opt.adapter.enable_trimming:
        # rate = count / preTotalReads, then DOUBLED when paired
        # (htmlreporter.cpp:197,205: `readWithAdapter * 1.0 / preTotalReads * 2`)
        mult = 2 if paired else 1
        rwa = sum(fresult.adapter1_count.values())
        pre_table.append(_row("Read1 Adapters Left",
                              f"{rwa}({_pct(rwa * mult, pre_reads)}%)"))
        if paired:
            rwa2 = sum(fresult.adapter2_count.values())
            pre_table.append(_row("Read2 Adapters Left",
                                  f"{rwa2}({_pct(rwa2 * mult, pre_reads)}%)"))
    post_table = qc_table(post_reads, post_bases, post_q20, post_q30, post_gc,
                          post1.get_mean_length(), post2.get_mean_length() if post2 else 0)

    fr = fresult
    # QUIRK: the reference calls reportHtmlBasic(preTotalBases, preTotalReads)
    # against signature (totalReads, totalBases) -- SWAPPED arguments
    # (htmlreporter.cpp:231 vs filterresult.cpp:223).  So the rows written
    # "/totalBases" actually divide by preTotalReads and vice versa.
    filt_rows = [
        _row("Reads Passed Filters",
             f"{int(fr.filter_read_stats[0])}({_pct(int(fr.filter_read_stats[0]), pre_reads)}%)"),
        _row("Low Quality Reads",
             f"{int(fr.filter_read_stats[20])}({_pct(int(fr.filter_read_stats[20]), pre_reads)}%)"),
        _row("Too Many N Reads",
             f"{int(fr.filter_read_stats[12])}({_pct(int(fr.filter_read_stats[12]), pre_reads)}%)"),
    ]
    if opt.correction.enabled:
        filt_rows.append(_row("Corrected Reads",
                              f"{fr.corrected_reads}({_pct(fr.corrected_reads, pre_bases)}%)"))
        filt_rows.append(_row("Corrected Bases",
                              f"{fr.total_corrected_bases}({_pct(fr.total_corrected_bases, pre_reads)}%)"))
    if opt.complexity_filter.enabled:
        filt_rows.append(_row("Low Complexity Reads",
                              f"{int(fr.filter_read_stats[24])}({_pct(int(fr.filter_read_stats[24]), pre_bases)}%)"))
    if opt.length_filter.enabled:
        filt_rows.append(_row("Too Short Reads",
                              f"{int(fr.filter_read_stats[16])}({_pct(int(fr.filter_read_stats[16]), pre_bases)}%)"))
        if opt.length_filter.max_read_length > 0:
            filt_rows.append(_row("Too Long Reads",
                                  f"{int(fr.filter_read_stats[17])}({_pct(int(fr.filter_read_stats[17]), pre_bases)}%)"))

    summary_body = (
        "<div class='subsection_title' onclick=\"showOrHide('general')\">General</div>"
        "<div id='general'><table class='summary_table'>" + "".join(general) + "</table></div>"
        "<div class='subsection_title' onclick=\"showOrHide('before_filtering_summary')\">Before Filtering</div>"
        "<div id='before_filtering_summary'><table class='summary_table'>" + "".join(pre_table) + "</table></div>"
        "<div class='subsection_title' onclick=\"showOrHide('after_filtering_summary')\">After filtering</div>"
        "<div id='after_filtering_summary'><table class='summary_table'>" + "".join(post_table) + "</table></div>"
        "<div class='subsection_title' onclick=\"showOrHide('filtering_result')\">Filtering Results</div>"
        "<div id='filtering_result'><table class='summary_table'>" + "".join(filt_rows) + "</table></div>")

    parts = [
        "<html><head><meta http-equiv='content-type' content='text/html;charset=utf-8'>",
        f"<title>Fastq Preprocess Report</title>",
        "<script src='https://cdn.plot.ly/plotly-latest.min.js'></script>",
        f"<script type='text/javascript'>{_JS}</script>",
        f"<style type='text/css'>{_CSS}</style>",
        f"<h1 style='text-align:left'><a style='color:#663355;text-decoration:none;'>{_esc(opt.report_title)}</a></h1>",
        "</head><body>",
        _section("Summary", "summary", summary_body),
    ]

    if opt.adapter.enable_trimming:
        parts.append(_adapters_section(opt, fresult))
    if opt.polyg_trim.enabled or opt.polyx_trim.enabled:
        parts.append(_polyx_section(fresult))
    if opt.duplicate.enabled and dup_hist is not None:
        parts.append(_duplication_section(opt, dup_hist, dup_mean_gc, dup_rate))

    pre_body = _stats_sections(pre1, "Before filtering", "read1")
    if pre2 is not None:
        pre_body += _stats_sections(pre2, "Before filtering", "read2")
    parts.append(_section("Before filtering", "before_filtering", pre_body))

    post_body = _stats_sections(post1, "After filtering", "read1")
    # emitted in merge mode too (unmerged-kept r2 reads are statted into
    # postStats2; htmlreporter.cpp:65-69 has no merge guard)
    if post2 is not None:
        post_body += _stats_sections(post2, "After filtering", "read2")
    parts.append(_section("After filtering", "after_filtering", post_body))

    parts.append(_section("Software Environment", "software",
                          "<table class='summary_table'>"
                          + _row("Version", opt.version)
                          + _row("Command", opt.command)
                          + _row("CWD", opt.cwd) + "</table>"))
    parts.append(f"<div id='footer'>Fqtool Report @ {time.strftime('%Y-%m-%d %H:%M:%S')}</div>")
    parts.append("</body></html>")

    with open(opt.html_file, "w") as f:
        f.write("".join(parts))


def _adapters_section(opt: Options, fr: FilterResultAccumulator) -> str:
    def details(counts):
        total = sum(counts.values())
        rows = ["<tr><td class='adapter_col' style='font-size:14px;color:#ffffff;background:#556699'>Sequence</td>"
                "<td class='col2' style='font-size:14px;color:#ffffff;background:#556699'>Occurences</td></tr>"]
        if total == 0:
            return "<table class='summary_table'>" + "".join(rows) + "</table>"
        reported = 0
        # lexicographic order: the reference iterates a std::map<string>
        # (filterresult.cpp:268-296)
        for seq in sorted(counts):
            cnt = counts[seq]
            if cnt / total < opt.adapter.report_threshold:
                continue
            rows.append(f"<tr><td class='adapter_col'>{seq}</td>"
                        f"<td class='col2'>{cnt}({cnt*100.0/total:.6f}%)</td></tr>")
            reported += cnt
        unreported = total - reported
        if unreported > 0:
            tag = "other adapter sequences" if reported else "all adapter sequences"
            rows.append(_row(tag, f"{unreported}({unreported*100.0/total:.6f}%)"))
        return "<table class='summary_table'>" + "".join(rows) + "</table>"

    body = ("<div class='subsection_title' onclick=\"showOrHide('read1_adapters')\">"
            "Adapter or bad ligation of read1</div><div id='read1_adapters'>"
            + details(fr.adapter1_count) + "</div>")
    if opt.is_paired():
        body += ("<div class='subsection_title' onclick=\"showOrHide('read2_adapters')\">"
                 "Adapter or bad ligation of read2</div><div id='read2_adapters'>"
                 + details(fr.adapter2_count) + "</div>")
    return _section("Adapters", "adapters", body)


def _polyx_section(fr: FilterResultAccumulator) -> str:
    rows = [_row("TotalPolyXTrimmedReads", int(fr.trimmed_polyx_reads.sum())),
            _row("TotalPolyXTrimmedBases", int(fr.trimmed_polyx_bases.sum()))]
    for b, c in enumerate("ATCGN"):
        rows.append(_row(f"ReadsTrimmedByPoly{c}", int(fr.trimmed_polyx_reads[b])))
    for b, c in enumerate("ATCGN"):
        rows.append(_row(f"BasesTrimmedByPoly{c}", int(fr.trimmed_polyx_bases[b])))
    return _section("PolyX Trimming", "polyx",
                    "<table class='summary_table'>" + "".join(rows) + "</table>")
