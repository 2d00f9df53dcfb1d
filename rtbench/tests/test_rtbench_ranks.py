"""Cells on more than one card (``rtbench/ranks.py``), through the real
launcher on the test bench of ``rtbench/tests/ranks`` (``entry.py``
points the harness at it; its cells are in no ``BENCHMARK.json``): two
gloo ranks on the CPU run in lock-step and only rank 0 prints the line,
with ``count`` the number of rank processes; the window holds the slowest
rank's units; a gather on the channel is apart from a barrier of its
name; the exit clock starts when rank 0 ends; ranks die with their
launcher; a rank that raises, loads JAX or finds no card ends the run
without a result; a cell on one card starts no process.
The ``cuda`` test runs two ranks on two cards."""

import json
import os
import re
import subprocess
import sys
import time

import pytest

from rtbench import core
from rtbench.tests.common import ROOT

BENCH = ROOT / "rtbench" / "tests" / "ranks"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(workload, trace=0, seconds=1.0, device="cpu", **env):
    """The test bench's command → (completed process, seconds it took)."""
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, str(BENCH / "entry.py"), "--workload", workload,
         "--seed", str(2 ** 31 + 17), "--seconds", str(seconds),
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, RANKS_DEVICE=device, **env))
    return out, time.monotonic() - t0


def steps_by_rank(err):
    """{rank: units its driver ran}, from the driver's lines on standard
    error (two processes' lines may run together)."""
    return {int(r): int(n) for r, n in
            re.findall(r"ranks-test: rank (\d+) steps (\d+)", err)}


def the_line(out):
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    return json.loads(lines[0])


@pytest.mark.parametrize("trace", [0, 1])
def test_two_ranks_run_the_same_units_and_rank_0_prints(trace):
    out, _ = run("ranks-two", trace)
    assert out.returncode == 0, out.stderr[-3000:]
    r = the_line(out)
    assert list(r) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert r["correct"] is True and r["attempted"] >= 1
    dev = r["device"]
    assert dev["count"] == 2 and len(dev["ranks"]) == 2
    assert len({rank["uuid"] for rank in dev["ranks"]}) == 2
    # the window, and in a traced run both stretches and the live-lanes
    # unit, on every rank
    steps = steps_by_rank(out.stderr)
    assert steps == {0: r["attempted"] + (2 * 2 + 1 if trace else 0),
                     1: steps[0]}
    if trace:
        assert r["metrics"]["ranks_traced"]["value"] == 2
        for rank in dev["ranks"]:
            assert set(rank) == {"uuid", "memory_peak_bytes", "busy_s",
                                 "window_s"}
            assert rank["window_s"] > 0
        assert dev["window_s"] == dev["ranks"][0]["window_s"]
    else:
        assert set(r["metrics"]) == {"units_per_s", "setup_s"}
        assert r["metrics"]["setup_s"]["value"] > 0
    # the compared numbers are the last lines on standard error
    assert out.stderr.strip().splitlines()[-2:] == [
        "step_gap 0.0 limit 0", "sum_gap 0.0 limit 0"]


def test_the_window_holds_every_ranks_units():
    # rank 1 sleeps 4 ms a unit and rank 0 2 ms, with no collective
    # between them: the window ends only once rank 1 has run its units
    out, _ = run("ranks-lag")
    assert out.returncode == 0, out.stderr[-3000:]
    r = the_line(out)
    assert steps_by_rank(out.stderr) == {0: r["attempted"],
                                         1: r["attempted"]}
    window_s = r["attempted"] / r["metrics"]["units_per_s"]["value"]
    assert window_s >= 0.004 * r["attempted"]


def test_a_gather_waits_for_values_not_a_barrier_of_its_name():
    import threading

    from rtbench import ranks
    port = ranks.free_ports(1)[0]
    zero = ranks.Team(port, 0, 2)
    one = ranks.Team(port, 1, 2)
    got = {}

    def rank_1():
        one.barrier("trace")
        time.sleep(0.5)
        got[1] = one.gather("trace", {"busy_s": 1.5, "window_s": 2.0})
    t = threading.Thread(target=rank_1)
    t.start()
    zero.barrier("trace")
    got[0] = zero.gather("trace", {"busy_s": 0.5, "window_s": 1.0})
    t.join()
    want = [{"busy_s": 0.5, "window_s": 1.0}, {"busy_s": 1.5, "window_s": 2.0}]
    assert got == {0: want, 1: want}


class Ends:
    """A rank for ``ranks.watch`` that ends with ``code`` at ``at``
    seconds (None: never)."""

    def __init__(self, at, code=0):
        self.t0, self.at, self.code = time.monotonic(), at, code

    def poll(self):
        if self.at is not None and time.monotonic() - self.t0 >= self.at:
            return self.code
        return None


def test_the_exit_clock_starts_when_rank_0_ends(monkeypatch):
    from rtbench import ranks
    monkeypatch.setattr(ranks, "EXIT_WAIT_S", 0.2)
    monkeypatch.setattr(ranks, "POLL_S", 0.01)
    # rank 0 ends well 0.6 s after rank 1: a long check() on rank 0
    assert ranks.watch([Ends(0.6), Ends(0.0)]) is None
    # a rank still running EXIT_WAIT_S after rank 0 ended
    assert ranks.watch([Ends(0.0), Ends(None)]) == (1, None)
    assert ranks.watch([Ends(None), Ends(0.1, 3)]) == (1, 3)


def children(pid):
    """The pids of the processes whose parent is ``pid``, from /proc."""
    found = []
    for stat in os.listdir("/proc"):
        if stat.isdigit():
            try:
                with open(f"/proc/{stat}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == pid:
                found.append(int(stat))
    return found


def running(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


@pytest.mark.skipif(not sys.platform.startswith("linux"),
                    reason="PR_SET_PDEATHSIG is Linux's")
def test_ranks_die_with_their_launcher_even_while_starting():
    launcher = subprocess.Popen(
        [sys.executable, str(BENCH / "entry.py"), "--workload", "ranks-two",
         "--seed", "5", "--seconds", "30", "--trace", "0"], cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        env=dict(os.environ, RANKS_DEVICE="cpu"))
    deadline = time.monotonic() + 60
    while len(procs := children(launcher.pid)) < 2:
        assert time.monotonic() < deadline and launcher.poll() is None
        time.sleep(0.01)
    # the ranks are still importing torch
    launcher.kill()
    launcher.wait()
    deadline = time.monotonic() + 15
    while any(running(p) for p in procs) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = [p for p in procs if running(p)]
    for p in left:
        os.kill(p, 9)
    assert not left


@pytest.mark.parametrize("workload", ["ranks-raise", "ranks-jax"])
def test_a_failing_rank_ends_the_run_without_a_result(workload):
    out, took = run(workload, seconds=3.0)
    assert out.returncode != 0 and out.stdout == ""
    assert "no result" in out.stderr
    assert took < 60


def test_ranks_without_their_cards_end_the_run_with_no_card():
    out, took = run("ranks-two", device="cuda", CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 2 and out.stdout == ""
    assert "no result" in out.stderr
    assert took < 60


def test_one_card_starts_no_process(monkeypatch, capsys):
    import subprocess as sp

    import torch.distributed as dist
    started = []

    def no_spawn(cmd, *a, **kw):
        started.append(cmd)
        raise OSError("a one-card run starts no process")
    monkeypatch.setattr(core, "BENCHMARK", BENCH / "bench.json")
    monkeypatch.setattr(core, "HERE", BENCH)
    monkeypatch.setattr(core, "require_cards", lambda n: None)
    monkeypatch.setattr(sp, "Popen", no_spawn)
    monkeypatch.delitem(sys.modules, "rtbench.ranks", raising=False)
    rc = core.main(["--workload", "ranks-one", "--seed", "3", "--seconds",
                    "0.2"], time.perf_counter(), device="cpu")
    out = capsys.readouterr().out
    assert rc == 0
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["count"] == 1
    assert "ranks" not in r["device"]
    # nvidia-smi, which reads the power limit, is the only command tried
    assert all(cmd[0] == "nvidia-smi" for cmd in started), started
    assert "rtbench.ranks" not in sys.modules
    assert not dist.is_initialized()


@pytest.fixture
def two_cards():
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("fewer than 2 CUDA devices")


@pytest.mark.cuda
def test_two_ranks_on_two_cards(two_cards):
    out, _ = run("ranks-two", seconds=2.0, device="cuda")
    assert out.returncode == 0, out.stderr[-3000:]
    r = the_line(out)
    dev = r["device"]
    assert r["correct"] is True and dev["platform"] == "gpu"
    assert dev["count"] == 2 and len({x["uuid"] for x in dev["ranks"]}) == 2
    assert dev["memory_peak_bytes"] == max(
        x["memory_peak_bytes"] for x in dev["ranks"]) > 0
