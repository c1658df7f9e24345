"""Host processes of a multi-host run, for tests/test_torch_multihost*.py.

Each "host" is a process of its own that runs the port's command line
(``kbbq_tpu_torch.cli.main.main(argv, device="cpu")``) with the launcher's
variables (``JAX_COORDINATOR``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``),
so the hosts' ranks form one gloo group.  Every host starts in a session of
its own and its whole process group (its spawned ranks included) is killed
in a ``finally``, so no rank outlives a test; every wait has a timeout.
Output goes to files, not pipes: a host blocked on a full pipe would stall
its peers in a collective.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_TIMEOUT = 240           # seconds a host process may take
# a host: argv[1] pins time.time (gzip blocks stamp the clock) where given
_RUNNER = (
    "import sys, time\n"
    "clock = sys.argv.pop(1)\n"
    "if clock:\n"
    "    time.time = lambda: float(clock)\n"
    "from kbbq_tpu_torch.cli.main import main\n"
    "sys.exit(main(sys.argv[1:], device='cpu'))\n")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Hosts:
    """`hosts` host processes of `argv` (the command line's, after the
    program name), started on construction; ``wait`` collects them,
    ``close`` kills whatever is left."""

    def __init__(self, argv, logdir, hosts: int = 2, env=None,
                 clock: float | None = None, jax: bool = False,
                 program: str | None = None):
        coord = f"127.0.0.1:{free_port()}"
        # the JAX package's command line: its own test's environment, one
        # CPU device a process; `program`: a Python program of its own
        cmd = ([sys.executable, "-m", "kbbq_tpu"] if jax else
               [sys.executable, "-c", program] if program else
               [sys.executable, "-c", _RUNNER,
                "" if clock is None else repr(clock)])
        self.logs = []
        self.procs = []
        try:
            for pid in range(hosts):
                e = dict(os.environ, JAX_COORDINATOR=coord,
                         JAX_NUM_PROCESSES=str(hosts),
                         JAX_PROCESS_ID=str(pid),
                         PYTHONPATH=REPO + os.pathsep
                         + os.environ.get("PYTHONPATH", ""))
                if jax:
                    e.pop("JAX_PLATFORMS", None)
                    e["KBBQ_PLATFORM"] = "cpu"
                    e["XLA_FLAGS"] = \
                        "--xla_force_host_platform_device_count=1"
                e.update(env or {})
                out = os.path.join(str(logdir), f"host{pid}.out")
                err = os.path.join(str(logdir), f"host{pid}.err")
                self.logs.append((out, err))
                with open(out, "wb") as fo, open(err, "wb") as fe:
                    self.procs.append(subprocess.Popen(
                        [*cmd, *argv], cwd=REPO, env=e, stdout=fo,
                        stderr=fe, start_new_session=True))
        except BaseException:
            self.close()
            raise

    def stderr(self, pid: int) -> str:
        with open(self.logs[pid][1], "rb") as f:
            return f.read().decode(errors="replace")[-4000:]

    def wait(self, timeout: float = HOST_TIMEOUT) -> list:
        """Every host's exit code, waiting until `timeout` s in all."""
        deadline = time.monotonic() + timeout
        return [p.wait(timeout=max(0.1, deadline - time.monotonic()))
                for p in self.procs]

    def stats(self) -> list:
        """Each host's stats: the JSON line its command line printed
        last."""
        out = []
        for path, _ in self.logs:
            with open(path, "rb") as f:
                out.append(json.loads(f.read().splitlines()[-1]))
        return out

    def close(self) -> None:
        for p in self.procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_hosts(argv, logdir, hosts: int = 2, env=None,
              clock: float | None = None, jax: bool = False,
              program: str | None = None) -> list:
    """Run the hosts (the JAX package's command line with `jax`, a program
    of its own with `program`) to their end; each must exit 0 -> their
    stats."""
    with Hosts(argv, logdir, hosts, env, clock, jax, program) as h:
        codes = h.wait()
        for pid, code in enumerate(codes):
            assert code == 0, f"host {pid} exited {code}: {h.stderr(pid)}"
        return h.stats()


def crash_and_stop(argv, logdir, done, hosts: int = 2) -> None:
    """Run the hosts with host 1 killed between pass 1 and pass 2
    (``KBBQ_CRASH_POINT=pass2:1``): it must exit 41; then, once `done()`
    says pass 1's checkpoint is on disk, the other hosts (waiting on their
    dead peer) are killed, as a scheduler would."""
    with Hosts(argv, logdir, hosts, {"KBBQ_CRASH_POINT": "pass2:1"}) as h:
        code = h.procs[1].wait(timeout=HOST_TIMEOUT)
        assert code == 41, f"host 1 exited {code}: {h.stderr(1)}"
        deadline = time.monotonic() + 60
        while not done() and time.monotonic() < deadline:
            time.sleep(0.2)
        assert done(), "pass 1's checkpoint is missing"
