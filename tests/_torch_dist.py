"""Gloo worlds for the port's mesh tests.

``start_world(job, n, workdir)`` starts ``n`` rank processes of
``tests/_torch_mesh_worker.py`` (one CPU thread each, output to
``WORKDIR/<job><n>_<rank>.log``); ``World.wait()`` waits at most ``timeout``
seconds (120 by default) for all of them, kills every one still running
when that runs out, and raises with the logs' tails unless every rank
exited 0.  A hung rank fails its test; it never stalls the suite.
``start_reference`` runs a snippet on ``n`` forced host devices of the
reference package (the environment of ``conftest.run_devices``) the same
way.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORKER = os.path.join(HERE, "_torch_mesh_worker.py")


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
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
            for p in self.procs:
                p.wait()
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
