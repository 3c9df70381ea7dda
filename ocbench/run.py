"""Run one cell of the benchmark of opencalibration_tpu_torch on the card.

    python3 -m ocbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration and its traffic mix
are read from ``BENCHMARK.json`` and the files under ``ocbench/`` that
``cell.py`` names. The survey is rendered from the seed into a directory
under ``TMPDIR`` that is removed at exit; builds stay inside the checkout
(the program's ``build/``, this benchmark's ``ocbench/.build/``). The last
lines on standard error are the numbers that decide ``correct``, each
beside its limit; the last line on standard output is the result, one JSON
object. Without as many CUDA cards as the cell asks for, or with JAX or the
JAX package loaded once the window has closed, it prints no result and
exits with another code than 0.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (Linux: from
    /proc; elsewhere the import of this module)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_env(root: str):
    """Kernel caches at fixed paths inside the checkout, so that only a
    cell's first run in a checkout builds: also the driver's cache of the
    kernels it compiles from PTX for the card (``CUDA_CACHE_PATH``, read when
    CUDA starts), which is otherwise under ``HOME``."""
    build = os.path.join(root, "ocbench", ".build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "nv")
    os.environ["CUDA_CACHE_MAXSIZE"] = str(4 << 30)


def few_threads():
    """One process with few threads: PyTorch's and numpy's CPU pools at one
    thread each (read when they load), so that no pool of idle, spinning
    threads competes for the host's cores with the main thread, which
    launches the card's work. The program's own decode threads stay."""
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[name] = "1"


def main(argv=None) -> int:
    t_start = process_start()
    args = parse_args(argv)
    root = os.getcwd()
    try:
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            benchmark = json.load(f)
    except OSError as e:
        print(f"ocbench: no BENCHMARK.json in {root}: {e}", file=sys.stderr)
        return 2
    cache_env(root)
    few_threads()

    import torch

    from ocbench import cell as C

    cell = C.find_cell(benchmark, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"ocbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    try:
        import opencalibration_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"ocbench: the program is not in this checkout: {e}", file=sys.stderr)
        return 2

    from ocbench.counts import power_limit

    print(f"ocbench: {args.workload} seed {args.seed} on {power_limit() or torch.cuda.get_device_name(0)}",
          file=sys.stderr)
    workdir = tempfile.mkdtemp(prefix="ocbench-", dir=os.environ.get("TMPDIR"))
    try:
        result = C.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", workdir, t_start,
                            benchmark=benchmark)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    found = C.jax_modules()
    if found:
        print(f"ocbench: JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    numbers = result.pop("_numbers")
    times = dict(result.pop("_times"), total_s=time.perf_counter() - t_start)
    print("ocbench: wall seconds " + json.dumps(times), file=sys.stderr)
    print("ocbench: numbers read " + json.dumps(numbers), file=sys.stderr)
    for name, c in result["checks"].items():
        op = "<=" if c["kind"] == "max" else ">="
        print(f"check {name} {c['value']!r} {op} {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
