"""The benchmark of kbbq_tpu_torch: one run of one cell.

    python3 bqsr_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

prints one JSON object as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit,
also the last lines of standard error).  It needs the CUDA cards the cell
asks for and exits 1 without them, printing no result.  See
``bqsr_bench/README.md``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from bqsr_bench.harness import modules, runner, spec
    try:
        runner.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   T_START)
    except runner.NoDevice as e:
        print(f"[bench] {e}", file=sys.stderr)
        return 1
    except modules.ForbiddenModules as e:
        print(f"[bench] forbidden modules loaded: {e}", file=sys.stderr)
        return 3
    except spec.SpecError as e:
        print(f"[bench] {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
