"""Each test file's start offset and wall in a pytest run, workers and all:
where the tier-1 command's time goes (ROADMAP item 0).

Load it as a plugin beside the command; every process (the controller and
each xdist worker) appends its tests' start and end times to one file,
then this script prints a line per test file, in start order:

    PYTHONPATH=tools PYTEST_FILE_TIMES=/tmp/times.jsonl python -m pytest tests/ ... -p pytest_file_times
    python tools/pytest_file_times.py /tmp/times.jsonl
"""

from __future__ import annotations

import collections
import json
import os
import sys
import time

_PATH = os.environ.get("PYTEST_FILE_TIMES", "test_times.jsonl")


def _write(event: dict) -> None:
    with open(_PATH, "a") as f:  # one short appended line a write
        f.write(json.dumps(event) + "\n")


def pytest_sessionstart(session) -> None:
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        _write({"ev": "session", "t": time.time()})


def pytest_runtest_logstart(nodeid, location) -> None:
    _write({"ev": "start", "id": nodeid, "t": time.time()})


def pytest_runtest_logfinish(nodeid, location) -> None:
    _write({"ev": "end", "id": nodeid, "t": time.time()})


def report(path: str) -> list[str]:
    """The lines: seconds from the session's start to the file's first
    test, to its last test's end, the file's wall, its tests, its name."""
    t0, start, end = None, {}, {}
    with open(path) as f:
        for line in f:
            e = json.loads(line)
            if e["ev"] == "session":
                t0 = e["t"] if t0 is None else min(t0, e["t"])
            elif e["ev"] == "start":
                start[e["id"]] = min(start.get(e["id"], e["t"]), e["t"])
            else:
                end[e["id"]] = max(end.get(e["id"], e["t"]), e["t"])
    t0 = min(start.values()) if t0 is None else t0
    files = collections.defaultdict(lambda: [float("inf"), 0.0, 0])
    for nodeid, t in start.items():
        row = files[nodeid.split("::")[0]]
        row[0] = min(row[0], t)
        row[1] = max(row[1], end.get(nodeid, t))
        row[2] += 1
    out = [f"{'start':>7} {'end':>7} {'wall':>6} {'tests':>5}  file"]
    for name, (a, b, n) in sorted(files.items(), key=lambda kv: kv[1][0]):
        out.append(f"{a - t0:7.0f} {b - t0:7.0f} {b - a:6.0f} {n:5d}  {name}")
    return out


if __name__ == "__main__":
    print("\n".join(report(sys.argv[1] if len(sys.argv) > 1 else _PATH)))
