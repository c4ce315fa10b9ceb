"""Gloo worlds for the port's mesh tests.

``start_world(job, n, workdir)`` starts ``n`` rank processes of
``tests/_torch_mesh_worker.py`` (one CPU thread each, output to
``WORKDIR/<job><n>_<rank>.log``); ``World.wait()`` waits at most
``timeout`` seconds (120 by default) from the world's start for all of
them, kills every one still running when that runs out, and raises with
the logs' tails unless every rank exited 0.  A hung rank fails its
test; it never stalls the suite.
``start_reference`` runs a snippet on ``n`` forced host devices of the
reference package (the environment of ``conftest.run_devices``) the same
way.

Under ``pytest -n`` several modules' worlds would otherwise run at once
and compete for the machine's CPUs (a 4-rank and an 8-rank world are 12
busy processes), beside other modules' references (a few processes
each, compiling).  So a module starts its worlds and its reference
inside ``exclusive()``, an ``fcntl.flock`` on one lock file in the
system temp directory that every xdist worker shares, and waits there
for all of them (``run``): one module's worlds and reference run at a
time, and each limit starts once the lock is held, never while a world
waits for it.  The reference runs in one process a group of its cases,
side by side, so that it takes about as long as the worlds beside it.
Each module sets its limits from its worlds' and reference's times
measured alone on an 8-CPU host, with ``MARGIN`` to spare for the rest
of the suite's load (the other workers' tests run beside them).
"""
from __future__ import annotations

import contextlib
import fcntl
import os
import pickle
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORKER = os.path.join(HERE, "_torch_mesh_worker.py")
#: the lock file every xdist worker's mesh modules share
LOCK = os.path.join(tempfile.gettempdir(), "repro_torch_mesh_worlds.lock")
#: a world's or reference's limit over its time measured alone, and the
#: least limit: under the suite's load a rank's start alone (importing
#: torch, joining the store) can take tens of seconds.  3x did not hold:
#: in one whole run of the suite (``pytest -n 6``) on a host where every
#: module ran 1.5-2x slower than on another, the 4-rank world of
#: ``tests/test_torch_mesh_train_families.py`` outlived 172 s, 3x its 57 s
#: alone
MARGIN, MIN_LIMIT = 5.0, 60


def limit(alone_s: float) -> int:
    """The limit of a world measured at ``alone_s`` seconds alone."""
    return max(MIN_LIMIT, int(MARGIN * alone_s) + 1)


@contextlib.contextmanager
def exclusive():
    """Hold the mesh modules' lock: no other module's worlds run until
    it is released."""
    with open(LOCK, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def run(*worlds):
    """Wait for every world (or reference) in turn; if one fails or runs
    out of time, kill every process still running in the others before
    raising."""
    try:
        for w in worlds:
            w.wait()
    finally:
        for w in worlds:
            w.kill()
    for w in worlds:
        print(f"[{w.name}] {w.seconds:.1f} s of {w.timeout}")
    return worlds


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, HERE] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", **extra)
    return env


class World:
    def __init__(self, name, procs, logs, workdir, timeout):
        self.name, self.procs, self.logs = name, procs, logs
        self.workdir, self.timeout = workdir, timeout
        self.start = time.monotonic()

    def kill(self):
        """Kill every process of the world still running."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def wait(self):
        deadline = self.start + self.timeout
        timed_out = False
        for p in self.procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
        if timed_out:
            self.kill()
        self.seconds = time.monotonic() - self.start
        rcs = [p.returncode for p in self.procs]
        if timed_out or any(rcs):
            tails = []
            for r, log in enumerate(self.logs):
                with open(log, errors="replace") as fh:
                    tails.append(f"--- {self.name} rank {r} (rc {rcs[r]})\n"
                                 f"{fh.read()[-3000:]}")
            raise AssertionError(
                f"{self.name}: {'timed out after ' + str(self.timeout) + ' s' if timed_out else 'failed'}, "
                f"return codes {rcs}\n" + "\n".join(tails))
        return self

    def result(self, rank=0):
        with open(os.path.join(self.workdir, f"{self.name}_{rank}.pkl"),
                  "rb") as fh:
            return pickle.load(fh)


def start_world(job, n, workdir, timeout=120):
    """World ``<job><n>``: its store, logs and results are named so."""
    workdir, name = str(workdir), f"{job}{n}"
    procs, logs = [], []
    for r in range(n):
        log = os.path.join(workdir, f"{name}_{r}.log")
        logs.append(log)
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, job, str(r), str(n), workdir, name],
                env=_env(), stdout=fh, stderr=subprocess.STDOUT))
    return World(name, procs, logs, workdir, timeout)


def start_references(name, src, groups, n_devices, workdir, timeout,
                     xla_flags=""):
    """The reference snippet ``src`` in one process a group of its cases,
    side by side (compiling the cases is most of a reference's time, and
    a compile takes one core): process g runs with ``GROUP`` (``groups[g]``,
    which ``src`` keeps its cases to), ``FIRST`` (g == 0: the one that
    runs what belongs to no group) and ``NAME`` (``<name><g>``, the name
    it writes its results under) defined first."""
    return [start_reference(
        f"{name}{g}", f"GROUP, FIRST, NAME = {group!r}, {g == 0}, "
        f"{name + str(g)!r}\n" + src, n_devices, workdir, timeout=timeout,
        xla_flags=xla_flags) for g, group in enumerate(groups)]


def merged(worlds):
    """The results of rank 0 of ``worlds`` (the processes of
    ``start_references``) as one dict, dicts under one key merged."""
    out = {}
    for w in worlds:
        for key, val in w.result().items():
            if isinstance(val, dict):
                out.setdefault(key, {}).update(val)
            else:
                out[key] = val
    return out


def start_reference(name, src, n_devices, workdir, timeout=240,
                    xla_flags=""):
    """The reference snippet ``src`` on ``n_devices`` forced host devices
    (with ``xla_flags`` added); it writes its results itself (to
    ``WORKDIR``)."""
    workdir = str(workdir)
    log = os.path.join(workdir, f"{name}_0.log")
    env = _env(XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{n_devices} {xla_flags}".strip(),
               JAX_PLATFORMS="cpu")
    with open(log, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-c", src, workdir],
                                env=env, stdout=fh,
                                stderr=subprocess.STDOUT)
    return World(name, [proc], [log], workdir, timeout)
