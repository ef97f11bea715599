"""The controls of sp_serve_m8's m8 check, at the cell's size, on one NVIDIA
GPU:

    python3 tools/m8_controls.py --seeds 2240024101,2240024102 [--sw-align 4]

For each seed it makes the cell's queries and database as a run does, takes
the queries the run's checks hold (the seed's draw of 128, with the
longest), gives each its top 16 by the plain reference (over the candidate
set the score check uses, the whole database for the shortest query), and
makes their m8 rows five ways, each judged as a run judges the program's
(drivers/server_m8.m8_mismatches, then check.judge with a differing
response passed on as an empty hit list):

  reference    the plain reference's own rows (swbench/align_reference.py)
  kernel       the program's alignments on the card (ops/align.align_pairs,
               sw_align_kernel) through its formats.m8_rows
  sw_align     the program's host traceback (ops/traceback.sw_align) for
               the first --sw-align responses only (~5 us a cell on the
               host), the others left out
  tie_flipped  the reference with E taken before the diagonal on a tie
  off_by_one   the reference's rows with qstart one too far

It prints one JSON line per (seed, control): ``correct``, the rows that
differ, the check's counts and the seconds each took. The first three
must read 0 everywhere; the last two must fail.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from swbench import align_reference, check, dbgen, workload  # noqa: E402
from swbench.drivers.server_m8 import m8_mismatches  # noqa: E402
from swbench.run import _check_queries, _full_queries  # noqa: E402
from swbench.spec import Spec  # noqa: E402

CELL = "sp_serve_m8"


def _off_by_one(row: str) -> str:
    c = row.split("\t")
    c[6] = str(int(c[6]) + 1)
    return "\t".join(c)


def _program_rows(queries, answers, db, device, kind: str) -> dict:
    """{query: rows} from the program's alignments (``kind`` kernel:
    ops.align on ``device``; sw_align: the host traceback)."""
    from swimm_tpu_torch.alphabet import encode
    from swimm_tpu_torch.formats import m8_rows
    from swimm_tpu_torch.models.engine import Hit, QueryResult
    from swimm_tpu_torch.ops import align
    from swimm_tpu_torch.ops.traceback import sw_align
    pairs, owner = [], []
    for qi, hits in answers:
        for _, t in hits:
            pairs.append((encode(queries[qi].tobytes()),
                          encode(db.seq(dbgen.orig_index(t)).tobytes())))
            owner.append(qi)
    got = (align.align_pairs(pairs, device=device) if kind == "kernel"
           else [sw_align(q, d) for q, d in pairs])
    out, k = {}, 0
    for qi, hits in answers:
        al = got[k:k + len(hits)]
        k += len(hits)
        res = QueryResult(f"Q{qi:04d}", len(queries[qi]), [
            Hit(r + 1, a.score, 0, 0, t) for r, ((_, t), a) in
            enumerate(zip(hits, al))])
        out[qi] = m8_rows(res, al)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 tools/m8_controls.py")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sw-align", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = Spec()
    cell = spec.cell(CELL)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    s = cfg["search"]
    go, ge, k = s["gap_open"], s["gap_extend"], mix["request"]["top_k"]
    for seed in (int(x) for x in args.seeds.split(",")):
        traffic = workload.make(mix, seed, spec.bench["run_seconds"])
        db = dbgen.make_db(cfg["db"], traffic.queries, seed)
        picks = _check_queries(mix, traffic, seed)
        full = _full_queries(traffic, picks)
        answers = check.control_answers(traffic.queries, db, k, go, ge, seed,
                                        picks, full=full, device=args.device)
        t = time.perf_counter()
        counts = align_reference.align(
            [traffic.queries[qi] for qi, _ in answers],
            [[db.seq(dbgen.orig_index(x)) for _, x in h] for _, h in answers],
            go, ge, device=args.device)
        ref_s = time.perf_counter() - t
        exact = {qi: [align_reference.m8_row(f"Q{qi:04d}", x, c)
                      for (_, x), c in zip(h, cc)]
                 for (qi, h), cc in zip(answers, counts)}
        rows = {"reference": lambda: exact}
        rows["kernel"] = lambda: _program_rows(
            traffic.queries, answers, db, args.device, "kernel")
        rows["sw_align"] = lambda: _program_rows(
            traffic.queries, answers[:args.sw_align], db, args.device,
            "sw_align")
        rows["tie_flipped"] = lambda: {
            qi: [align_reference.m8_row(f"Q{qi:04d}", x, c)
                 for (_, x), c in zip(h, cc)]
            for (qi, h), cc in zip(answers, align_reference.align(
                [traffic.queries[qi] for qi, _ in answers],
                [[db.seq(dbgen.orig_index(x)) for _, x in h]
                 for _, h in answers], go, ge, device=args.device,
                e_first=True))}
        rows["off_by_one"] = lambda: {qi: [_off_by_one(r) for r in v]
                                      for qi, v in exact.items()}
        for name, make in rows.items():
            t = time.perf_counter()
            got = make()
            make_s = time.perf_counter() - t
            ans = [(qi, h) for qi, h in answers if qi in got]
            recs = [{"id": qi, "resp": json.dumps({
                "id": qi, "results": [{"hits": [{"score": sc, "title": x}
                                                for sc, x in h]}],
                "m8": got[qi]})} for qi, h in ans]
            t = time.perf_counter()
            bad = m8_mismatches(recs, [qi for qi, _ in ans],
                                traffic.queries, db, go, ge, args.device)
            judged = check.judge([(qi, [] if qi in bad else h)
                                  for qi, h in ans], traffic.queries, db, k,
                                 go, ge, seed, full=[f for f in full
                                                     if f in got],
                                 device=args.device)
            print(json.dumps({
                "workload": CELL, "seed": seed, "control": name,
                "correct": all(judged[n] <= lim
                               for n, lim in check.LIMITS.items()),
                "m8_row_mismatches": sum(bad.values()),
                "responses": len(ans), "rows": sum(map(len, got.values())),
                "counts": judged, "make_s": make_s, "reference_s": ref_s,
                "judge_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
