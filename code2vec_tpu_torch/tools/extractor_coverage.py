#!/usr/bin/env python3
"""Method coverage of the port's native C++ extractor: the counterpart
of tools/extractor_coverage.py of the JAX package, over the port's
`c2v_extract` (code2vec_tpu_torch/extractor/native.py, built with the
host's C++ compiler at first use) and the port's corpus generator.

A hand-written Java grammar must still reach a high method coverage.
This tool generates a corpus with a known method count
(code2vec_tpu_torch/tools/gen_java_corpus.py is deterministic), runs the
extractor's command line over it, and prints the JAX tool's JSON: the
coverage and the distribution of contexts a method. The JAX package's
reference point is 249,996 / 250,000 methods (99.998%) on the default
corpus.

Usage:
  python -m code2vec_tpu_torch.tools.extractor_coverage [--methods 20000]
      [--dir <.java dir> --expected N]   # --dir measures your corpus
It runs on the host alone, so it has no --backend flag.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile


def measure(extractor: str, java_dir: str, expected: int,
            num_threads: int = 4) -> dict:
    """The JAX tool's `measure` over the extractor binary `extractor`."""
    out = subprocess.run(
        [extractor, "--dir", java_dir, "--max_path_length", "8",
         "--max_path_width", "2", "--num_threads", str(num_threads)],
        capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"extractor failed (rc={out.returncode}):\n"
                 f"{out.stderr}")
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    ctx_counts = sorted(len(ln.split(" ")) - 1 for ln in lines)
    n = len(lines)

    def pct(p: float) -> int:
        return ctx_counts[min(n - 1, int(p * n))] if n else 0

    return {
        "methods_expected": expected,
        "methods_extracted": n,
        "coverage": round(n / expected, 5) if expected else None,
        "contexts_per_method": {
            "p10": pct(0.10), "p50": pct(0.50), "p90": pct(0.90),
            "max": ctx_counts[-1] if n else 0},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m code2vec_tpu_torch.tools.extractor_coverage")
    ap.add_argument("--methods", type=int, default=20_000)
    ap.add_argument("--dir", default=None,
                    help="measure an existing .java corpus instead of "
                         "generating one")
    ap.add_argument("--expected", type=int, default=0,
                    help="known method count for --dir")
    ap.add_argument("--num_threads", type=int, default=4)
    args = ap.parse_args(argv)

    from code2vec_tpu_torch.extractor import native
    from code2vec_tpu_torch.ops._build import KernelBuildError
    try:
        extractor = native.binary_path()
    except KernelBuildError as e:
        sys.exit(f"extractor not built: {e}")

    if args.dir:
        if args.expected <= 0:
            sys.exit("--dir requires --expected N (the known method "
                     "count) — coverage is the whole point of the tool")
        stats = measure(extractor, args.dir, args.expected, args.num_threads)
    else:
        from code2vec_tpu_torch.tools import gen_java_corpus
        with tempfile.TemporaryDirectory() as tmp:
            said = io.StringIO()
            with contextlib.redirect_stdout(said):
                gen_java_corpus.main(
                    ["--out", tmp, "--methods", str(args.methods),
                     "--names", str(min(5000, args.methods // 4))])
            # the generator prints its exact written count: parse it
            # rather than re-deriving the split math
            m = re.search(r"total: (\d+) methods", said.getvalue())
            if not m:
                sys.exit(f"could not parse generator output:\n"
                         f"{said.getvalue()}")
            stats = measure(extractor, tmp, int(m.group(1)),
                            args.num_threads)
    print(json.dumps(stats, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
