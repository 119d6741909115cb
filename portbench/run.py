"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 -m portbench.run --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout. With ``--trace 0`` the result line carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(the window under ``torch.profiler`` and the program's spans). The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` when traced), and
last ``checks``, each number compared with the plain reference beside
its limit; the same numbers end standard error.

Exits 2, printing no result, without as many CUDA cards as the cell
asks for, and 3 if a module of the JAX stack or of the JAX package was
loaded by the time the window has closed.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def _fixed_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc builds already go to ``build/``), and no library
    that could load JAX by itself."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    _fixed_cache_dirs(root)

    from portbench import harness

    spec = harness.cell_spec(harness.load_benchmark(root), root,
                             args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    doc = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"portbench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 3
    harness.emit(doc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
