"""The open-loop client: sends each request of a schedule at its due time
over the server's TCP line protocol, whatever the server is doing, and
records when it was due, when it went out and when its response line came
back (all on ``time.perf_counter``, which on Linux is CLOCK_MONOTONIC and
so the same clock in the server's process).

It runs as its own process, so that it does not share an interpreter lock
with the server: ``python -m swbench.loadgen SCHEDULE OUT HOST PORT``.
SCHEDULE is JSON ``{"pool": n, "deadline_s": d, "requests": [{"id", "due",
"line"}]}``; once its pool of connections is open the client prints
``ready`` and reads the window's start (a perf_counter time) from stdin.
Each request is due at start + due. A response not back by start +
deadline_s is recorded as missing. OUT gets one JSON line per request:
``{"id", "due", "sent", "recv", "resp"}`` (recv and resp null if missing).
It imports only the standard library.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time

LINE_LIMIT = 1 << 24


async def _run(sched: dict, host: str, port: int, out_path: str) -> None:
    idle = []
    for _ in range(sched["pool"]):
        idle.append(await asyncio.open_connection(host, port,
                                                  limit=LINE_LIMIT))
    print("ready", flush=True)
    loop = asyncio.get_running_loop()
    start = float(await loop.run_in_executor(None, sys.stdin.readline))
    records = {}

    async def one(req):
        due = start + req["due"]
        rec = records[req["id"]] = {"id": req["id"], "due": due,
                                    "sent": None, "recv": None,
                                    "resp": None}
        delay = due - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        rec["sent"] = time.perf_counter()
        conn = (idle.pop() if idle else await asyncio.open_connection(
            host, port, limit=LINE_LIMIT))
        reader, writer = conn
        writer.write(req["line"].encode() + b"\n")
        await writer.drain()
        line = await reader.readline()
        rec["recv"] = time.perf_counter()
        rec["resp"] = line.decode()
        idle.append(conn)

    tasks = [asyncio.create_task(one(r)) for r in sched["requests"]]
    left = start + sched["deadline_s"] - time.perf_counter()
    done, pending = await asyncio.wait(tasks, timeout=max(left, 0.0))
    for t in pending:
        t.cancel()
    for t in done:
        if t.exception() is not None:
            print(f"loadgen: request failed: {t.exception()!r}",
                  file=sys.stderr)
    for reader, writer in idle:
        writer.close()
    with open(out_path, "w") as fh:
        for req in sched["requests"]:
            rec = records.get(req["id"], {"id": req["id"]})
            if rec.get("recv") is None:
                rec["recv"] = rec["resp"] = None
            fh.write(json.dumps(rec) + "\n")


def main(argv=None) -> int:
    sched_path, out_path, host, port = (argv or sys.argv[1:])[:4]
    with open(sched_path) as fh:
        sched = json.load(fh)
    asyncio.run(_run(sched, host, int(port), out_path))
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
