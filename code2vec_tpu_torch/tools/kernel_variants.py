"""Time build variants of kernels 1 and 4 on one CUDA card.

    python -m code2vec_tpu_torch.tools.kernel_variants [--out FILE]

Each variant is the package's own source (`code2vec_tpu_torch/csrc/`)
with one constant or expression replaced, built with the package's nvcc
flags into a temporary directory and called through the same C entry
point as the package's wrapper. The package ships one design of each
kernel; this is how the alternatives were measured against it, in one
process on one card:

- kernel 1 (`attention_pool.cu`, bf16 contexts on the tensor cores) with
  T split into 3 (shipped), 2 or 1 bf16 terms, and with a ring of 2
  slices of T instead of up to 4, and with a launch bound of 384 threads
  (D = 384 only: up to 168 registers a thread, not 128), at B = 1, 64
  and 1024 (C = 200,
  D = 384): CUDA-event ms (median of 20) and the largest error against
  the float32 plain version;
- kernel 4 (`requant.cu`) on the 16-byte vector kernel (shipped for
  E = 128) and with every table sent to the scalar kernel, at the
  java-large token table (1,301,138 x 128, bf16 update): event ms and
  whether q and s equal the plain version's.

It prints one line per variant and, last, the card's name and power
limit; `--out` also writes the rows as JSON.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import shutil
import subprocess
import tempfile

import torch

from code2vec_tpu_torch.ops import _build

C, D = 200, 384
POOL_B = (1, 64, 1024)
TOKEN_ROWS, E = 1301138, 128
VARIANTS = {
    "attention_pool": {
        "3 terms, 112-row tiles (shipped)": [],
        "2 terms": [("constexpr int kTerms = 3;", "constexpr int kTerms = 2;")],
        "1 term": [("constexpr int kTerms = 3;", "constexpr int kTerms = 1;")],
        "64-row tiles": [("constexpr int kTallMT = 7;", "constexpr int kTallMT = 4;")],
        "80-row tiles": [("constexpr int kTallMT = 7;", "constexpr int kTallMT = 5;")],
        "96-row tiles": [("constexpr int kTallMT = 7;", "constexpr int kTallMT = 6;")],
        "ring of 2 slices": [("constexpr int kMaxStages = 4;",
                              "constexpr int kMaxStages = 2;")],
    },
    "requant": {
        "vector kernel (shipped)": [],
        "scalar kernel": [("  return vec_lanes(q, upd, E);\n",
                           "  return 0 * vec_lanes(q, upd, E);\n"),
                          ("  const int lanes = vec_lanes(q, upd, E);\n",
                           "  const int lanes = 0 * vec_lanes(q, upd, E);\n")],
    },
}


def build_variant(root: str, index: int, name: str, label: str, subs) -> str:
    """The library of csrc/<name>.cu with `subs` applied, in directory
    `index` under `root`."""
    d = os.path.join(root, str(index))
    shutil.copytree(_build.SRC_DIR, d)
    path = os.path.join(d, name + ".cu")
    with open(path) as f:
        text = f.read()
    for old, new in subs:
        if old not in text:
            raise ValueError(f"{name} variant {label!r}: {old!r} not in the source")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    so = os.path.join(d, name + ".so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, path],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"{name} variant {label!r} did not build:\n"
                           + proc.stdout)
    return so, ptxas(proc.stdout)


def ptxas(log: str):
    """{entry function: "registers / spill stores / spill loads"} of an
    `nvcc -Xptxas -v` log."""
    out, name, spills = {}, None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill stores" in ln:
            spills = ln.split(":", 1)[-1].strip()
        elif "Used" in ln and "registers" in ln and name:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out[name] = f"{regs} registers, {spills}"
            name = None
    return out


def event_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def pool_rows(so: str, label: str, gen):
    from code2vec_tpu_torch.ops.attention_kernel import attention_pool_plain
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(so)
    lib.attention_pool_forward.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, p]
    lib.attention_pool_tc_scratch_bytes.argtypes = [i, i, i]
    lib.attention_pool_tc_scratch_bytes.restype = ctypes.c_longlong
    rows = []
    for B in POOL_B:
        ctx = torch.randn((B, C, D), generator=gen, device="cuda").to(torch.bfloat16)
        lim = (3.0 / D) ** 0.5
        tr = (torch.rand((D, D), generator=gen, device="cuda") * 2 - 1) * lim
        at = (torch.rand((D,), generator=gen, device="cuda") * 2 - 1) * (6 / (D + 1)) ** 0.5
        mask = (torch.rand((B, C), generator=gen, device="cuda") > 0.3).float()
        code = torch.empty((B, D), device="cuda")
        attn = torch.empty((B, C), device="cuda")
        scratch = torch.empty(lib.attention_pool_tc_scratch_bytes(B, C, D),
                              dtype=torch.uint8, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            err = lib.attention_pool_forward(
                ctx.data_ptr(), 1, tr.data_ptr(), at.data_ptr(), mask.data_ptr(),
                code.data_ptr(), attn.data_ptr(), scratch.data_ptr(), B, C, D, 0,
                stream)
            if err:
                raise RuntimeError(f"{label}: cudaError {err}")
        run()
        want_code, want_attn = attention_pool_plain(ctx, tr, at, mask)
        torch.cuda.synchronize()
        rows.append({"kernel": "attention_pool", "variant": label, "B": B,
                     "ms": event_ms(run),
                     "max_abs_err_code": (code - want_code).abs().max().item(),
                     "max_abs_err_attn": (attn - want_attn).abs().max().item()})
    return rows


def requant_rows(so: str, label: str, gen):
    from code2vec_tpu_torch.ops import quant
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(so)
    lib.requant_launch.argtypes = [p, p, p, i, ctypes.c_uint, ctypes.c_longlong,
                                   i, i, p]
    table = quant.quantize_table(
        torch.randn((TOKEN_ROWS, E), generator=gen, device="cuda") * 0.3)
    upd = (torch.randn((TOKEN_ROWS, E), generator=gen, device="cuda")
           * 0.005).to(torch.bfloat16)
    upd[::3] = 0
    stream = torch.cuda.current_stream().cuda_stream

    def run(salt=7):
        err = lib.requant_launch(table["q"].data_ptr(), table["s"].data_ptr(),
                                 upd.data_ptr(), 1, salt, TOKEN_ROWS, E, 0, stream)
        if err:
            raise RuntimeError(f"{label}: cudaError {err}")
    want = quant.requantize_reference(table, upd, 5)
    run(5)
    torch.cuda.synchronize()
    equal = torch.equal(table["q"], want["q"]) and torch.equal(table["s"], want["s"])
    return [{"kernel": "requant", "variant": label, "V": TOKEN_ROWS, "E": E,
             "ms": event_ms(run), "bits_equal": equal}]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available; it runs on a CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    root = tempfile.mkdtemp(prefix="kernel_variants-")
    try:
        jobs = [(name, label, subs) for name, vs in VARIANTS.items()
                for label, subs in vs.items()]
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
            libs = list(ex.map(lambda ij: build_variant(root, *ij),
                               [(i, *j) for i, j in enumerate(jobs)]))
        rows = []
        for (name, label, _subs), (so, regs) in zip(jobs, libs):
            gen = torch.Generator(device="cuda").manual_seed(0)
            new = (pool_rows if name == "attention_pool" else requant_rows)(
                so, label, gen)
            entry = "tc_kernel" if name == "attention_pool" else "vec_kernel"
            for row in new:
                row["ptxas"] = {k: v for k, v in regs.items() if entry in k}
                print(json.dumps(row), flush=True)
            rows += new
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
