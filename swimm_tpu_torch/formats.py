"""Hit-list output formats (counterpart of swimm_tpu/formats.py, copied).

``m8`` is the BLAST tabular format (``blastp -outfmt 6`` / legacy ``-m 8``),
12 tab-separated columns per (query, hit):
    qseqid sseqid pident length mismatch gapopen
    qstart qend sstart send evalue bitscore
Coordinates are 1-based inclusive. The alignment columns come from the
traceback of each reported hit (ops/align.py: on the card, or
ops/traceback.py on the CPU). evalue and
bitscore are the empirical fit's (utils/stats.py: bits = surprise / ln 2
where E = n_db * exp(-surprise)); without E-values both print ``*``. The
identifier columns are the first whitespace-delimited token of each FASTA
title, as BLAST's.
"""

from __future__ import annotations


def _seqid(title: str) -> str:
    tok = title.split()
    return tok[0] if tok else title


def _count_gap_opens(aln: str) -> int:
    """Number of gap RUNS in one aligned string ('-' runs)."""
    n = 0
    prev = False
    for c in aln:
        g = c == "-"
        if g and not prev:
            n += 1
        prev = g
    return n


def m8_rows(result, aligns) -> list:
    """Format one QueryResult + its per-hit Alignments as m8 rows.

    Args:
      result: engine.QueryResult (hits carry .evalue/.bits under
        SearchConfig(evalue=True): utils/stats.attach_evalues).
      aligns: list of ops.traceback.Alignment, parallel to result.hits.
    """
    rows = []
    qid = _seqid(result.query_title)
    for h, a in zip(result.hits, aligns):
        length = a.length
        mism = length - a.n_identity - a.n_gaps
        gapopen = (_count_gap_opens(a.q_aln)
                   + _count_gap_opens(a.d_aln))
        pident = 100.0 * a.n_identity / max(length, 1)
        ev = f"{h.evalue:.2g}" if h.evalue is not None else "*"
        bit_s = f"{h.bits:.1f}" if h.bits is not None else "*"
        rows.append("\t".join([
            qid, _seqid(h.title), f"{pident:.2f}", str(length),
            str(mism), str(gapopen),
            str(a.q_start + 1), str(a.q_end),
            str(a.d_start + 1), str(a.d_end),
            ev, bit_s]))
    return rows
