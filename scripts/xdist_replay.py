#!/usr/bin/env python3
"""Replay pytest-xdist's ``--dist load`` schedule over logged test times.

The tier-1 run's wall time hangs on how xdist's ``LoadScheduling`` chunks
the collection, not only on the work: it hands a worker consecutive tests
in collection order, in chunks sized from the count still pending, and
never takes queued tests back, so a few long consecutive tests can all
land on one worker. This script replays that rule (xdist 3.8's
``check_schedule``: refill below ``pending // nodes // 4`` up to
``pending // nodes // 2``, hold back after a test of 0.1 s or more while
two are queued; a worker starts a test only once the next one is queued
or it was told to stop) over the per-test times of a finished run, and
prints the predicted wall time and each worker's busy time. With
``--sweep A:B`` it inserts k placeholder tests (``--insert-at``, default
before the first ``test_torch_generate`` item, each of ``--insert-s``
seconds) for each k in A..B, with ``--trials`` runs whose times are
scaled by lognormal noise of ``--noise`` sigma, and prints the mean, the
90th percentile and the worst wall time per k. ``--crash`` models the
worker lost to the known XLA abort: it dies at the end of that test, its
queue goes back to the end of the pending list, and a new worker joins
15 s later.

    pytest tests/ -m 'not slow' -p xdist -n 6 --durations=0 > run.log
    pytest tests/ -m 'not slow' --collect-only -q | grep :: > collect.txt
    python scripts/xdist_replay.py run.log collect.txt --crash
    python scripts/xdist_replay.py run.log collect.txt --crash --sweep 0:40

The replay is approximate: it ignores collection and start-up time and
the pipes' latency, and tests under 5 ms (which ``--durations=0`` does
not print) count 3 ms.
"""

from __future__ import annotations

import argparse
import collections
import heapq
import random
import re
import statistics

CRASH = "tests/test_ring_attention.py::test_dryrun_multichip_exercises_sp"


def load_durations(path):
    """test id -> seconds (setup + call + teardown) from --durations=0."""
    out = collections.defaultdict(float)
    text = open(path, errors="replace").read()
    for m in re.finditer(r"^([\d.]+)s (?:call|setup|teardown)\s+(\S+)$", text,
                         re.M):
        out[m.group(2)] += float(m.group(1))
    return out


def replay(coll, dur, nodes=6, crash=False, default=0.003, rejoin_s=15.0):
    """Predicted wall time and each worker's busy seconds."""
    n_items = len(coll)
    pending = list(range(n_items))
    queue, stopping, running, busy = {}, {}, {}, collections.Counter()
    events = []

    def join(node):
        queue[node], stopping[node], running[node] = [], False, None

    def send(node, num):
        queue[node].extend(pending[:num])
        del pending[:num]

    def refill(node, last_s=0.0):
        if stopping[node]:
            return
        if not pending:
            stopping[node] = True
            return
        low = max(2, len(pending) // len(queue) // 4)
        high = max(2, len(pending) // len(queue) // 2)
        if len(queue[node]) < low:
            if last_s >= 0.1 and len(queue[node]) >= 2:
                return
            send(node, high - len(queue[node]))

    def start(node, now):
        q = queue.get(node)
        if q and running[node] is None and (len(q) >= 2 or stopping[node]):
            running[node] = q[0]
            heapq.heappush(events, (now + dur.get(coll[q[0]], default),
                                    "done", node))

    for node in range(nodes):
        join(node)
    for node in range(nodes):
        send(node, max(min(n_items // nodes // 4, n_items), 2))
    for node in range(nodes):
        start(node, 0.0)
    end, next_node = 0.0, nodes
    while events:
        now, kind, node = heapq.heappop(events)
        end = max(end, now)
        if kind == "join":
            join(node)
            for other in list(queue):
                refill(other)
        else:
            item = running[node]
            running[node] = None
            took = dur.get(coll[item], default)
            busy[node] += took
            if crash and coll[item] == CRASH:
                lost = queue.pop(node)[1:]
                pending.extend(lost)
                for other in list(queue):
                    refill(other)
                heapq.heappush(events, (now + rejoin_s, "join", next_node))
                next_node += 1
            else:
                queue[node].remove(item)
                refill(node, took)
        for other in list(queue):
            start(other, now)
    return end, dict(busy)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("log", help="a run's output with --durations=0")
    parser.add_argument("collection", help="test ids in collection order")
    parser.add_argument("--nodes", type=int, default=6)
    parser.add_argument("--crash", action="store_true")
    parser.add_argument("--sweep", default="", metavar="A:B")
    parser.add_argument("--insert-at", default="test_torch_generate")
    parser.add_argument("--insert-s", type=float, default=2.6)
    parser.add_argument("--trials", type=int, default=30)
    parser.add_argument("--noise", type=float, default=0.25)
    args = parser.parse_args(argv)
    dur = load_durations(args.log)
    coll = [line.strip() for line in open(args.collection) if "::" in line]
    if not args.sweep:
        end, busy = replay(coll, dur, args.nodes, args.crash)
        print(f"wall {end:.1f} s; busy s by worker "
              f"{ {k: round(v, 1) for k, v in sorted(busy.items())} }")
        return 0
    lo, hi = (int(x) for x in args.sweep.split(":"))
    at = next(i for i, c in enumerate(coll) if args.insert_at in c)
    rng = random.Random(0)
    trials = [{k: v * rng.lognormvariate(0, args.noise)
               for k, v in dur.items()} for _ in range(args.trials)]
    for k in range(lo, hi + 1):
        fake = [f"tests/placeholder.py::t{i}" for i in range(k)]
        order = coll[:at] + fake + coll[at:]
        ends = []
        for times in trials:
            times.update({f: args.insert_s for f in fake})
            ends.append(replay(order, times, args.nodes, args.crash)[0])
        ends.sort()
        print(f"k={k}: mean {statistics.mean(ends):.0f} s, p90 "
              f"{ends[int(0.9 * len(ends))]:.0f} s, worst {ends[-1]:.0f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
