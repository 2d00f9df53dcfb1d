"""The benchmark's run of one cell: set-up, the measured window, the traced
stretch, the comparison with the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel sits in a file of its own that this module finds by the
name ``BENCHMARK.json`` gives it:

  * ``configs/<config>.json``: the scene recipe and the render settings
    (the path is the configuration's ``file``);
  * ``traffic/<traffic>.json``: the mix's parameters; its ``driver`` names
    the loop in ``drivers/<driver>.py`` that runs it;
  * ``limits/<cell>.json``: the limit of each number the cell compares;
  * ``metrics/<metric>.py``: ``read(trace)``, the metric from the traced
    stretch, or None where there is nothing to read; a reader of the
    port's own counters also has ``counters()``, their values now by
    name, which the run reads before and after the stretch;
  * ``roofline/<kernel>.py``: the bytes of one launch by its contract,
    and the probe that counts a launch's live lanes;
  * ``scenes/<kind>.py``: the arrays of a scene recipe's kind.

A driver's module has ``SMALL``, the traffic's keys at a size a test on
the CPU can hold, and ``Cell(config, traffic, seed, device)`` with
``setup()`` (calling ``mark(name)`` after each of its phases),
``step()`` (one unit of the closed loop: a render call, a training step,
a viewer frame), ``end_to_end(units, window_s)``,
``layer_context(units)`` (what the per-layer readers need),
``release()`` (drops the program's state), ``check()`` (the numbers
compared with the reference, by name) and ``control()`` (the same
numbers with the reference in a lower precision, or with a fault
planted, in the program's place: readings by name, for
``rtbench/control.py``).

A cell whose ``chips`` is N > 1 runs as N ranks, one per card
(``rtbench/ranks.py``): ``run.py`` starts N processes of itself with the
environment ``torchrun`` sets (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). Each rank checks
that N cards are visible, as a run on one card does, and runs
``run_cell`` on card ``cuda:<LOCAL_RANK>``, in lock-step with the others
over a channel of the harness's own; rank 0 prints the line. For the
driver of such a cell:

  * its ``Cell`` gets ``device`` = this rank's own card, which is also
    the current CUDA device;
  * it reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` from the
    environment where it needs them;
  * only the drivers call the program's entry of its process group (such
    as ``parallel.distributed.initialize()``): the harness makes no group
    and puts no collective on the program's streams;
  * every rank runs the same phases and the same number of ``step()``
    calls in each. The window ends on rank 0's clock once every rank has
    finished its units, so ``window_s``, and every rate taken over it,
    holds all ranks' work, whether a collective couples them in each
    unit or not;
  * ``release()`` and ``check()`` run on every rank, so they may gather
    over the program's group; rank 0's numbers are judged. Once rank 0
    has ended, the others have ``ranks.EXIT_WAIT_S`` (60 s) to end, and
    rank 0 waits for each rank's report at most ``ranks.WAIT_S``: a
    driver may give rank 0 alone a long ``check()``.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
# modules whose presence in the process means JAX or the JAX package ran
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tracer_tpu")


class NoCard(RuntimeError):
    """The run found fewer CUDA devices than its cell needs."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark by its file (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "rtbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(name: str):
    """(cell, configuration entry, configuration, traffic, per-layer
    metrics of the cell, end-to-end metrics of the cell) of the workload
    ``name``."""
    bench = load_json(BENCHMARK)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {BENCHMARK.name}; "
                       f"known: {sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT / entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")

    def mine(metrics):
        return [m for m in metrics
                if name in m.get("workloads", [name])]

    return (cell, entry, config, traffic, mine(bench["per_layer"]),
            mine(bench["end_to_end"]))


def driver(traffic: dict):
    return load_module(HERE / "drivers" / f"{traffic['driver']}.py")


def limits(cell_name: str) -> dict:
    return load_json(HERE / "limits" / f"{cell_name}.json")


def judge(numbers: dict, limit: dict):
    """The compared numbers against their limits → (checks, failed): each
    number beside its limit, and how many are missing, not finite or
    over."""
    checks = {k: {"value": None if v is None else float(v),
                  "limit": limit[k]}
              for k, v in numbers.items()}
    failed = sum(1 for c in checks.values()
                 if c["value"] is None or not math.isfinite(c["value"])
                 or c["value"] > c["limit"])
    return checks, failed


def metric_module(name: str):
    return load_module(HERE / "metrics" / f"{name}.py")


def rooflines() -> dict:
    """Every kernel's roofline module by its name."""
    return {p.stem: load_module(p)
            for p in sorted((HERE / "roofline").glob("*.py"))}


def require_cards(n: int):
    """Raise NoCard unless this process sees at least ``n`` CUDA devices:
    a measurement never falls back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell "
                     f"needs {n}")


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def forbidden_modules(modules=None) -> list:
    """Top-level names in ``modules`` (default ``sys.modules``) that are
    JAX or the JAX package, compared whole."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


def synchronize(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(cell, seconds: float, device, agree=bool, close=None):
    """The closed loop for ``seconds``, ended by a synchronize →
    (units, window seconds). ``agree`` turns this process's decision to
    go on into the run's: on more than one rank, rank 0's. ``close``, on
    more than one rank, waits after the synchronize until every rank has
    finished its units, so that the window holds all ranks' work."""
    synchronize(device)
    t0 = time.perf_counter()
    units = 0
    while agree(time.perf_counter() - t0 < seconds):
        cell.step()
        units += 1
    synchronize(device)
    if close is not None:
        close()
    return units, time.perf_counter() - t0


def traced_stretch(cell, units: int, device, host_ops: bool, counters):
    """``units`` steps of the loop under torch.profiler, bracketed by
    synchronizes → (profiler, stretch seconds, the port's counters over
    the stretch). ``counters()`` reads the counters now. Without
    ``host_ops`` only the device's activity is traced (CUPTI), which
    leaves the host's pace nearly as it is; with them every host op is
    recorded too, which slows the host by some tens of microseconds an
    op."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    if host_ops or not acts:
        acts.append(ProfilerActivity.CPU)
    synchronize(device)
    with profile(activities=acts) as prof:
        before = counters()
        t0 = time.perf_counter()
        for _ in range(units):
            cell.step()
        synchronize(device)
        window_s = time.perf_counter() - t0
        after = counters()
    return prof, window_s, {k: after[k] - before[k] for k in after}


def live_lanes(cell, device) -> dict:
    """One more unit of the loop, untraced, with each roofline's probe
    wrapped round the program's entry of its kernel → {kernel: mean live
    lanes a launch}, for the kernels that ran. A probe adds a reduction
    on the device a launch, so it stays out of the traced stretch."""
    seen, undo = {}, []
    for kernel, mod in rooflines().items():
        owner_name, fn_name = mod.PROBE
        owner = importlib.import_module(owner_name)
        true = getattr(owner, fn_name)

        def probe(*a, _k=kernel, _mod=mod, _true=true, **kw):
            seen.setdefault(_k, []).append(_mod.live(*a, **kw))
            return _true(*a, **kw)
        undo.append((owner, fn_name, true))
        setattr(owner, fn_name, functools.update_wrapper(probe, true))
    try:
        cell.step()
        synchronize(device)
    finally:
        for owner, fn_name, true in undo:
            setattr(owner, fn_name, true)
    return {k: sum(float(x) for x in v) / len(v) for k, v in seen.items()}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, overrides=None,
             marks=None, team=None) -> dict:
    """One run of one cell → the result line as a dict. ``device``
    (default the first CUDA device, whose presence ``main`` has checked)
    and ``overrides`` (``{"traffic": {...}, "scene": {...}}``: keys of the
    traffic mix and of the scene recipe replaced, for tests at a size a
    CPU can hold) are for the tests only. ``marks`` collects (phase, host
    seconds) of the set-up from ``t_start`` on. ``team``: this rank's
    channel to the others (``ranks.Team``) on a cell of more than one
    card, which starts the window and each traced stretch on every rank
    together and runs the window's units by rank 0's clock; None on one
    card."""
    import torch
    from .trace import Trace
    _, _, config, traffic, per_layer, end_to_end = find_cell(workload)
    overrides = overrides or {}
    traffic = dict(traffic, **overrides.get("traffic", {}))
    config = dict(config, scene=dict(config["scene"],
                                     **overrides.get("scene", {})))
    device = torch.device(device or "cuda:0")
    marks = [] if marks is None else marks
    last = [t_start + sum(v for _, v in marks)]

    def mark(name):
        now = time.perf_counter()
        marks.append((name, now - last[0]))
        last[0] = now
    torch.zeros(1, device=device)
    synchronize(device)
    mark("device_init")
    cell = driver(traffic).Cell(config, traffic, seed, device)
    cell.mark = mark
    cell.setup()
    synchronize(device)
    mark("warm_up")
    if team is not None:
        team.barrier("window")
        mark("ranks_ready")
    setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if team is None:
        units, window_s = run_window(cell, seconds, device)
    else:
        units, window_s = run_window(
            cell, seconds, device, team.agree,
            lambda: team.barrier("window_end"))
    metrics = {}
    breakdown = None
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if trace:
        readers = {m["name"]: metric_module(m["name"]) for m in per_layer}
        sources = [r.counters for r in readers.values()
                   if hasattr(r, "counters")]

        def counters():
            return {k: v for f in sources for k, v in f().items()}
        n = int(traffic["trace_units"])
        context = dict(cell.layer_context(units))
        if team is not None:
            team.barrier("trace")
        stretch = traced_stretch(cell, n, device, False, counters)
        context["live"] = live_lanes(cell, device)
        tr = Trace(*stretch, n, context)
        if team is not None:
            tr.ranks = team.gather("trace", tr.ranks[0])
        values = {name: r.read(tr) for name, r in readers.items()}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        # what the host did in the device's idle gaps: a second stretch,
        # with host ops recorded
        if team is not None:
            team.barrier("host_trace")
        host = Trace(*traced_stretch(cell, n, device, True, counters), n,
                     context)
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": host.idle_gaps()}
        del tr, host, stretch
    else:
        values = cell.end_to_end(units, window_s)
        values.update(setup_s=setup_s, peak_mem_gib=(
            peak / 2 ** 30 if device.type == "cuda" else None))
    for m in per_layer if trace else end_to_end:
        if values.get(m["name"]) is not None:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    dev["memory_peak_bytes"] = int(peak)
    cell.release()
    checks, failed = judge(cell.check(), limits(workload))
    result = {"correct": failed == 0, "attempted": int(units),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # given by the launcher to each rank of a cell on more than one card:
    # the port of the harness's channel and the launcher's start on the
    # monotonic clock
    ap.add_argument("--store-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--launched-at", type=float, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def print_setup(marks):
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in marks),
          file=sys.stderr)


def print_checks(result):
    """Each compared number beside its limit, on standard error."""
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)


def main(argv, t_start: float, device=None) -> int:
    """The command: one run of one cell, its line printed last on
    standard output. ``device`` is for the tests only, as in
    ``run_cell``."""
    args = parse(argv)
    cell = find_cell(args.workload)[0]
    chips = int(cell["chips"])
    if chips > 1 and args.store_port is None:
        from . import ranks
        return ranks.launch(argv, chips, t_start)
    import torch
    marks = [("import_torch", time.perf_counter() - t_start)]
    try:
        require_cards(chips)
    except NoCard as e:
        print(f"rtbench: {e}; no result", file=sys.stderr)
        return 2
    marks.append(("card_check", time.perf_counter() - t_start
                  - marks[0][1]))
    # the loop's host work is one thread's; no pool of CPU threads beside it
    torch.set_num_threads(1)
    if chips > 1:
        from . import ranks
        return ranks.run_rank(args, t_start, marks, device)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start, device=device, marks=marks)
    found = forbidden_modules()
    if found:
        print(f"rtbench: the process loaded {found}; no result",
              file=sys.stderr)
        return 3
    result["device"]["power"] = power_limit()
    print_setup(marks)
    print_checks(result)
    print(json.dumps(result), flush=True)
    return 0
