"""The no-JAX check compares whole top-level module names, and a run that
has loaded JAX or the JAX package by the time it would print its result
prints none."""

import importlib.util
import os
import sys

import pytest

from bqsr_bench.harness import modules, runner, spec
from bqsr_bench.tests.helpers import FASTQ, cpu_run, small_cell


def _load_command():
    path = os.path.join(spec.BENCH_DIR, "run.py")
    s = importlib.util.spec_from_file_location("bqsr_bench_run", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.main


bench_main = _load_command()


def test_the_program_is_not_the_jax_package():
    assert modules.forbidden(["kbbq_tpu_torch", "kbbq_tpu_torch.ops",
                              "kbbq_tpu_torchx", "numpy", "torch"]) == []


def test_jax_and_the_jax_package_are_found():
    assert modules.forbidden(["kbbq_tpu.ops.bloom", "numpy"]) == ["kbbq_tpu"]
    assert modules.forbidden(["jax.numpy", "jaxlib.xla_client", "flax",
                              "kbbq_tpu"]) == ["flax", "jax", "jaxlib",
                                               "kbbq_tpu"]


def test_a_cpu_run_of_the_harness_loads_none_of_them():
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, '.');"
            "from bqsr_bench.tests.helpers import cpu_run, FASTQ;"
            "cpu_run(FASTQ, num_reads=300);"
            "from bqsr_bench.harness import modules;"
            "print(modules.forbidden())")
    from bqsr_bench.harness.spec import ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def _reader_that_imports(stub_dir):
    """A metric reader that imports a package named ``kbbq_tpu`` found in
    `stub_dir` (a stub, not the JAX package) and reads a number."""
    def reader(name):
        def read(run):
            sys.path.insert(0, str(stub_dir))
            try:
                import kbbq_tpu  # noqa: F401
            finally:
                sys.path.remove(str(stub_dir))
            return 1.0
        return read
    return reader


@pytest.fixture
def stub_jax_package(tmp_path, monkeypatch):
    (tmp_path / "kbbq_tpu").mkdir()
    (tmp_path / "kbbq_tpu" / "__init__.py").write_text("")
    assert "kbbq_tpu" not in sys.modules
    monkeypatch.setattr(spec, "reader", _reader_that_imports(tmp_path))
    yield
    sys.modules.pop("kbbq_tpu", None)


def test_a_reader_that_loads_the_jax_package_leaves_no_result(
        stub_jax_package):
    with pytest.raises(modules.ForbiddenModules, match="kbbq_tpu"):
        cpu_run(FASTQ, num_reads=300)


def test_the_command_then_exits_3_with_no_last_line(stub_jax_package,
                                                     monkeypatch, capsys):
    real_run = runner.run

    def on_the_cpu(name, seed, seconds, traced, t_start):
        return real_run(name, seed, seconds, traced, t_start, device="cpu",
                        cell=small_cell(name, num_reads=300))
    monkeypatch.setattr(runner, "run", on_the_cpu)
    rc = bench_main(["--workload", FASTQ, "--seed", "5", "--seconds", "0.2",
                     "--trace", "0"])
    captured = capsys.readouterr()
    assert rc == 3
    assert captured.out.strip() == ""
    assert "kbbq_tpu" in captured.err
