"""Closed-loop HTTP load: ``clients`` keep-alive connections, each sending
its next request as soon as the previous answer's last byte is read.

Run as a child process (``python3 -m portbench.client``) so that the
load does not share the server's interpreter. It reads one JSON line of
settings on standard input (port, clients, path template, users, seed),
opens every connection, prints ``ready``, then serves commands, one a
line:

- ``run <seconds> <keep>``: every connection loops for ``seconds`` from
  the command on; a request sent before that end is finished and
  recorded. It prints one JSON line: the window's start and end on the
  monotonic clock, the CPU seconds this process took in it, and one row per request, ``[user, status, t_send, t_done, body]``,
  with the body's text only where ``keep`` is 1;
- ``quit``: closes the connections and exits.

Each connection draws its users from a generator of its own, seeded from
the run's seed and the connection's number. Only the standard library is
imported.
"""

from __future__ import annotations

import http.client
import json
import random
import resource
import sys
import threading
import time


def _loop(conn, path: str, users: int, rng: random.Random, t_end: float,
          keep: bool, rows: list) -> None:
    headers = {"Accept": "application/json"}
    while time.monotonic() < t_end:
        user = rng.randrange(users)
        t0 = time.monotonic()
        try:
            conn.request("GET", path.format(user=user), headers=headers)
            resp = conn.getresponse()
            body = resp.read()
            status = resp.status
        except (OSError, http.client.HTTPException):
            body, status = b"", 0
            conn.close()  # reconnects on the next request
        t1 = time.monotonic()
        rows.append([user, status, t0, t1, body.decode() if keep else None])


def main() -> int:
    cfg = json.loads(sys.stdin.readline())
    n = int(cfg["clients"])
    conns = [http.client.HTTPConnection("127.0.0.1", int(cfg["port"]), timeout=120)
             for _ in range(n)]
    for c in conns:
        c.connect()
    rngs = [random.Random(f"{cfg['seed']}:{w}") for w in range(n)]
    print("ready", flush=True)
    for line in sys.stdin:
        cmd = line.split()
        if not cmd or cmd[0] == "quit":
            break
        seconds, keep = float(cmd[1]), cmd[2] == "1"
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t_start = time.monotonic()
        t_end = t_start + seconds
        per = [[] for _ in range(n)]
        threads = [threading.Thread(
            target=_loop, args=(conns[w], cfg["path"], int(cfg["users"]), rngs[w],
                                t_end, keep, per[w]))
            for w in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        rows = [r for rs in per for r in rs]
        print(json.dumps({"t_start": t_start, "t_end": t_end, "rows": rows,
                          "cpu_s": (ru1.ru_utime + ru1.ru_stime) - (ru0.ru_utime + ru0.ru_stime)}),
              flush=True)
    for c in conns:
        c.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
