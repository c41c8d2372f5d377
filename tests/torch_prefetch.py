"""Test references computed once per test session in background processes,
started as the test modules are collected.

A few of the port's references take minutes (JAX's trainers' steps, the
4-rank spawns). Computed where a test first asks for them, they run at the
end of the session, where ``--dist load`` hands out the last tests, and
the workers that ask meanwhile wait on them. Here a test module names each
such reference at import (``start(name, argv)``): every pytest-xdist worker
imports every module when it collects, and the first to create
``<name>.started`` in the session's shared directory (under the temporary
directory, keyed by ``PYTEST_XDIST_TESTRUNUID``) starts ``python <argv>
--out <name>.pkl`` in the background, in a process group of its own. A
test then reads the result (``result(name)``), waiting for the file if it
is not written yet.

The first reference of a session also starts a janitor (``python
tests/torch_prefetch.py --janitor <pid> <dir>``): it waits for the session's
pytest process (the xdist controller, or pytest itself without xdist) to
exit, then kills every reference's process group that is still running
(the rank processes of a spawn included) and removes the shared directory.
So a reference outlives neither the session nor the worker that started
it, and no worker stops one that another still waits on. A reference's own
process starts none of its own.
"""

from __future__ import annotations

import glob
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_DIR)
CHILD_ENV = "GSPLAT_TORCH_PREFETCH_CHILD"
DIR_ENV = "GSPLAT_TORCH_PREFETCH_DIR"
TIMEOUT_S = 1200
_CHILDREN = []  # this process's Popen objects, kept so they are not collected while running


def shared_dir() -> str:
    """The session's directory: named by the environment in a reference's
    process, else by the xdist run's id (the pytest process's pid without
    xdist)."""
    d = os.environ.get(DIR_ENV)
    if not d:
        uid = os.environ.get("PYTEST_XDIST_TESTRUNUID") or f"pid{os.getpid()}"
        d = os.path.join(tempfile.gettempdir(), f"gsplat_torch_prefetch_{uid}")
    os.makedirs(d, exist_ok=True)
    return d


def _paths(name):
    d = shared_dir()
    return (os.path.join(d, f"{name}.started"), os.path.join(d, f"{name}.pkl"), os.path.join(d, f"{name}.log"))


def _claim(started):
    """An fd of ``started`` if this process created it, else None."""
    try:
        return os.open(started, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return None


def _popen(argv, env, log):
    with open(log, "wb") as f:
        p = subprocess.Popen([sys.executable, *argv], cwd=_ROOT, env=env, stdin=subprocess.DEVNULL, stdout=f,
                             stderr=subprocess.STDOUT, start_new_session=True)
    _CHILDREN.append(p)
    return p


def _start_janitor(d):
    fd = _claim(os.path.join(d, "janitor.lock"))
    if fd is None:
        return
    os.close(fd)
    # an xdist worker is a child of the controller, which outlives every worker
    session = os.getppid() if os.environ.get("PYTEST_XDIST_WORKER") else os.getpid()
    _popen([os.path.abspath(__file__), "--janitor", str(session), d], dict(os.environ),
           os.path.join(d, "janitor.log"))


def start(name: str, argv) -> None:
    """Start ``python <argv> --out <result file>`` in the background, once
    per session (no-op in a reference's process, or where another process
    of the session started it)."""
    if os.environ.get(CHILD_ENV):
        return
    started, out, log = _paths(name)
    fd = _claim(started)
    if fd is None:
        return
    d = os.path.dirname(started)
    _start_janitor(d)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=_DIR + os.pathsep + _ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env[CHILD_ENV], env[DIR_ENV] = "1", d
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "PYTEST_XDIST_WORKER"):
        env.pop(k, None)
    p = _popen([*argv, "--out", out], env, log)
    os.write(fd, str(p.pid).encode())
    os.close(fd)


def _alive(pid: int) -> bool:
    try:  # a finished child of this process is a zombie until reaped
        if os.waitpid(pid, os.WNOHANG)[0]:
            return False
    except ChildProcessError:
        pass
    try:  # another process's finished child: a zombie until its parent reaps it
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _pid(started: str) -> int:
    """The pid written in ``started``, 0 while it is not written yet."""
    try:
        with open(started) as f:
            return int(f.read() or 0)
    except (OSError, ValueError):
        return 0


def result(name: str):
    """The reference ``name``'s result, waiting for its background process.
    Raises if it was not started (its module calls `start` at import) or
    ended without a result."""
    started, out, log = _paths(name)
    if not os.path.exists(started):
        raise RuntimeError(f"reference {name} was not started")
    deadline = time.monotonic() + TIMEOUT_S
    while not os.path.exists(out):
        pid = _pid(started)
        if pid and not _alive(pid) and not os.path.exists(out):
            tail = open(log, errors="replace").read()[-4000:] if os.path.exists(log) else ""
            raise RuntimeError(f"reference {name} ended without a result:\n{tail}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"reference {name}: no result after {TIMEOUT_S} s")
        time.sleep(0.5)
    with open(out, "rb") as f:
        return pickle.load(f)


def as_test_process() -> None:
    """This process as a test worker's: conftest's JAX (8 CPU devices), one
    torch thread, the tests' directory importable; the test modules it
    imports start no reference."""
    os.environ[CHILD_ENV] = "1"
    sys.path.insert(0, _DIR)
    sys.path.insert(0, _ROOT)
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)


def write(out: str, value) -> None:
    """Write a reference's result (pickled, renamed into place)."""
    with open(out + ".tmp", "wb") as f:
        pickle.dump(value, f)
    os.replace(out + ".tmp", out)


def janitor(session: int, d: str) -> None:
    """Wait for the session's pytest process to exit, then kill every
    reference's process group still running and remove ``d``."""
    while _alive(session):
        time.sleep(1.0)
    for started in glob.glob(os.path.join(d, "*.started")):
        pid = _pid(started)
        if pid:
            try:
                os.killpg(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
    shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__" and sys.argv[1:2] == ["--janitor"]:
    janitor(int(sys.argv[2]), sys.argv[3])
