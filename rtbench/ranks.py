"""Cells on more than one card: the launcher, each rank's run, and the
harness's channel between them.

``launch`` runs in the process the command started. It imports no torch
and puts nothing on a card: it starts N processes of the same script,
rank r with the environment ``torchrun`` gives it (``RANK`` =
``LOCAL_RANK`` = r, ``WORLD_SIZE`` = ``LOCAL_WORLD_SIZE`` = N,
``MASTER_ADDR`` 127.0.0.1 and a free ``MASTER_PORT`` for the program's
own group) and the port of the harness's channel, a
``torch.distributed.TCPStore`` that rank 0 serves. Each rank checks that
the cell's N cards are visible (``core.require_cards``: a rank without
them ends with 2, and so does the run), then runs ``core.run_cell`` on
``cuda:<r>`` with a ``Team``:

  * all ranks start the window together, after a barrier, and before
    each unit of it rank 0 puts its decision to go on (by its own clock)
    on the channel, which the others wait for: every rank runs the same
    units. The traced stretches start after a barrier too, and set-up's
    warm-up and the live-lanes unit run a fixed number of units;
  * the channel carries no tensor and puts nothing on the program's
    streams: the program's collectives are the drivers' alone.

After its run each rank puts a report on the channel: its card's name
and UUID, its peak memory, its units, its traced seconds and the JAX
modules it loaded. Rank 0 makes the line from its own result and every
report, and prints it; the launcher forwards rank 0's standard output
once every rank has ended with 0, with the compared numbers before it on
standard error. Other ranks' standard output goes to standard error.

Failure ends the run: a rank that exits with another code than 0, or
dies, makes the launcher stop the others (SIGTERM, SIGKILL after
``GRACE_S``) and exit without a result. Every wait on the channel has a
timeout, and a rank dies with its launcher (``PR_SET_PDEATHSIG``, set
before the rank's script starts).
"""

from __future__ import annotations

import ctypes
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta

from . import core

# a barrier or a report: long enough for one rank's first build of the
# kernels while another waits
WAIT_S = 1200
UNIT_WAIT_S = 300      # rank 0's decision before one unit of the window
GRACE_S = 10           # SIGTERM to SIGKILL
EXIT_WAIT_S = 60       # once rank 0 has ended well, the others' exits
POLL_S = 0.05


class Refused(RuntimeError):
    """The ranks' reports do not make one line."""


class Team:
    """This rank's end of the harness's channel, a ``TCPStore`` that rank
    0 serves and every rank is a client of. Barriers, gathers and
    decisions keep their keys apart (``barrier/``, ``gather/``, ``go/``),
    so that no name of one can stand for another's."""

    def __init__(self, port: int, rank: int, world: int):
        from torch.distributed import TCPStore
        self.rank, self.world = rank, world
        self.store = TCPStore("127.0.0.1", port, None, rank == 0,
                              timedelta(seconds=UNIT_WAIT_S),
                              wait_for_workers=False)
        self.decisions = 0
        self.decision_s = 0.0

    def _all(self, prefix):
        return [f"{prefix}/{r}" for r in range(self.world)]

    def barrier(self, name: str):
        """Wait until every rank has reached ``name``."""
        prefix = f"barrier/{name}"
        self.store.set(f"{prefix}/{self.rank}", b"1")
        self.store.wait(self._all(prefix), timedelta(seconds=WAIT_S))

    def agree(self, go: bool) -> bool:
        """Rank 0's ``go`` for the next unit of the window, on every
        rank."""
        t0 = time.perf_counter()
        key = f"go/{self.decisions}"
        if self.rank == 0:
            self.store.set(key, b"1" if go else b"0")
        else:
            go = self.store.get(key) == b"1"
        self.decisions += 1
        self.decision_s += time.perf_counter() - t0
        return go

    def gather(self, name: str, value) -> list:
        """Every rank's ``value`` (JSON) put under ``name``, in rank
        order."""
        prefix = f"gather/{name}"
        self.store.set(f"{prefix}/{self.rank}", json.dumps(value))
        keys = self._all(prefix)
        self.store.wait(keys, timedelta(seconds=WAIT_S))
        return [json.loads(self.store.get(k)) for k in keys]

    def collect(self, name: str, value):
        """As ``gather`` on rank 0; the other ranks put their ``value`` and
        get None. It is each rank's last use of the channel, and rank 0,
        which serves it, returns only once every rank has put its own, so
        no rank reaches for the channel after rank 0 has ended."""
        if self.rank == 0:
            return self.gather(name, value)
        self.store.set(f"gather/{name}/{self.rank}", json.dumps(value))
        return None


def free_ports(n: int) -> list:
    """``n`` distinct ports that were free on 127.0.0.1 a moment ago."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def card_id(device) -> str:
    """The card's UUID; on the CPU, this process."""
    import torch
    if device.type == "cuda":
        return str(torch.cuda.get_device_properties(device).uuid)
    return f"cpu-{socket.gethostname()}-{os.getpid()}"


def death_signal():
    """A ``preexec_fn`` for the ranks' ``Popen``: the kernel kills the
    rank when the launcher dies (Linux's PR_SET_PDEATHSIG, kept across
    the exec), so that no rank outlives a launcher killed by the caller's
    time limit, even while it imports torch. A launcher that died before
    the signal was set has already left the rank to another parent: the
    rank ends at once. None where the system has no ``prctl``."""
    try:
        prctl = ctypes.CDLL(None, use_errno=True).prctl
    except (OSError, AttributeError):
        return None
    launcher = os.getpid()

    def set_death_signal():
        prctl(1, signal.SIGKILL)
        if os.getppid() != launcher:
            os._exit(1)
    return set_death_signal


def run_rank(args, t_start: float, marks: list, device=None) -> int:
    """One rank of the run: ``core.run_cell`` on this rank's card, the
    reports gathered, and on rank 0 the line. ``t_start``: this process's
    start; ``args.launched_at``: the launcher's, from which ``setup_s``
    is timed (``time.perf_counter`` is the system's monotonic clock, the
    same in every process)."""
    import torch
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device is None:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    device = torch.device(device)
    team = Team(args.store_port, rank, world)
    marks.insert(0, ("launch", t_start - args.launched_at))
    result = core.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), args.launched_at,
                           device=device, marks=marks, team=team)
    dev = result["device"]
    report = {"kind": dev["kind"], "uuid": card_id(device),
              "memory_peak_bytes": dev["memory_peak_bytes"],
              "attempted": result["attempted"],
              "forbidden": core.forbidden_modules()}
    report.update({k: dev[k] for k in ("busy_s", "window_s") if k in dev})
    reports = team.collect("report", report)
    print(f"rtbench: rank {rank}: stop decision "
          f"{1e6 * team.decision_s / max(team.decisions, 1):.1f} us a "
          f"unit over {team.decisions}", file=sys.stderr)
    if report["forbidden"]:
        print(f"rtbench: rank {rank} loaded {report['forbidden']}; "
              f"no result", file=sys.stderr)
        return 3
    if rank:
        return 0
    try:
        merge(result, reports)
    except Refused as e:
        print(f"rtbench: {e}; no result", file=sys.stderr)
        return 3
    dev["power"] = core.power_limit()
    core.print_setup(marks)
    print(json.dumps(result), flush=True)
    return 0


def merge(result: dict, reports: list):
    """Rank 0's ``result`` made the run's from every rank's report: the
    count of distinct cards a rank ran the window on and allocated memory
    on (on the CPU, of rank processes), the fullest card's peak, and each
    rank's card. Raises Refused where the ranks' cards differ in kind,
    their units differ, or a rank loaded JAX or the JAX package."""
    dev = result["device"]
    found = {r: rep["forbidden"] for r, rep in enumerate(reports)
             if rep["forbidden"]}
    if found:
        raise Refused(f"ranks loaded {found}")
    kinds = sorted({rep["kind"] for rep in reports})
    if len(kinds) > 1:
        raise Refused(f"the ranks' cards differ: {kinds}")
    units = [rep["attempted"] for rep in reports]
    if len(set(units)) > 1:
        raise Refused(f"the ranks ran {units} units")
    used = {rep["uuid"] for rep in reports
            if dev["platform"] == "cpu" or rep["memory_peak_bytes"] > 0}
    peak = max(rep["memory_peak_bytes"] for rep in reports)
    dev["count"] = len(used)
    dev["memory_peak_bytes"] = peak
    if "peak_mem_gib" in result["metrics"]:
        result["metrics"]["peak_mem_gib"]["value"] = peak / 2 ** 30
    dev["ranks"] = [{k: rep[k] for k in ("uuid", "memory_peak_bytes",
                                         "busy_s", "window_s") if k in rep}
                    for rep in reports]


def stop(procs):
    """SIGTERM to every rank still running, SIGKILL to any left after
    ``GRACE_S``; returns once all have ended."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + GRACE_S
    for p in procs:
        try:
            p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


def watch(procs):
    """Wait for every rank → None where all ended with 0, else (rank,
    exit code) of the first that did not, or of the first still running
    ``EXIT_WAIT_S`` after rank 0 ended well. Rank 0 ends only once every
    rank has put its report, so by then the others have only to exit;
    before it, a rank that has ended well waits for nothing."""
    rank_0_done = None
    while True:
        codes = [p.poll() for p in procs]
        for r, c in enumerate(codes):
            if c not in (None, 0):
                return r, c
        if all(c == 0 for c in codes):
            return None
        if rank_0_done is None and codes[0] == 0:
            rank_0_done = time.monotonic()
        if rank_0_done is not None and (time.monotonic() - rank_0_done
                                        > EXIT_WAIT_S):
            return codes.index(None), None
        time.sleep(POLL_S)


def launch(argv: list, chips: int, t_start: float) -> int:
    """Start ``chips`` ranks of the script that started this process,
    wait for them, and forward rank 0's line → the exit code."""
    master_port, store_port = free_ports(2)
    env = dict(os.environ, WORLD_SIZE=str(chips),
               LOCAL_WORLD_SIZE=str(chips), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(master_port))
    cmd = [sys.executable, os.path.abspath(sys.argv[0]), *argv,
           "--store-port", str(store_port), "--launched-at", repr(t_start)]
    procs, out = [], []
    previous = signal.signal(signal.SIGTERM, _terminated)
    preexec = death_signal()
    try:
        for r in range(chips):
            procs.append(subprocess.Popen(
                cmd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=subprocess.PIPE if r == 0 else sys.stderr,
                preexec_fn=preexec))
        reader = threading.Thread(
            target=lambda: out.append(procs[0].stdout.read()), daemon=True)
        reader.start()
        failed = watch(procs)
        if failed is not None:
            r, code = failed
            how = ("did not end" if code is None else
                   f"ended with {code}" if code > 0 else
                   f"was killed by signal {-code}")
            print(f"rtbench: rank {r} {how}; the ranks are stopped and "
                  f"the run has no result", file=sys.stderr)
            return code if code and code > 0 else 1
        reader.join()
        text = out[0].decode() if out else ""
        lines = text.strip().splitlines()
        if not lines:
            print("rtbench: rank 0 printed no result", file=sys.stderr)
            return 1
        core.print_checks(json.loads(lines[-1]))
        sys.stdout.write(text)
        sys.stdout.flush()
        return 0
    finally:
        stop(procs)
        signal.signal(signal.SIGTERM, previous)
