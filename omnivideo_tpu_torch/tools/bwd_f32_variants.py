"""Build and time variants of the f32 flash backward kernels (rows 4 and 5 on
f32 operands, `csrc/flash_train_f32.cu`) side by side on one card.

    python3 omnivideo_tpu_torch/tools/bwd_f32_variants.py \
        [--src NAME=PATH.cu ...] [--reps 20] [--rounds 3] [--cases rank4 ...]

Each source is a whole copy of `flash_train_f32.cu` with its two C entry
points (`flash_bwd_dq_f32_launch`, `flash_bwd_dkv_f32_launch`); it includes
`hopper_common.cuh` from its own directory where it has a copy there, else
from the package's `csrc/`. Every source is compiled by its own nvcc (all
started together, `-Xptxas -v`) into its own shared library under
`build/bwd_f32_variants/` and loaded with ctypes, so a design change is
timed against the tree's kernels in one sitting, on the same card, with the
same operands. Without `--src` the tree's source alone is built.

Each variant is first held to `flash_bwd_plain` (TF32 off) within 1e-5 of
each gradient's norm per (batch row, head): at the timed shapes, and at a
ragged case (kv_lens [433, 0], Lq 300, Lk 700, 12 heads) whose k and v hold
NaN past kv_len, which must not reach any gradient, with the empty row's dq
and the rows past kv_len zero. Then each kernel is timed by CUDA events over
`rounds` rounds of `reps` launches after one untimed round, the variants
taking turns within a case. One JSON line a (variant, case) carries the
times, the check, nvcc's registers and spill bytes for each kernel, the
bounds (three TF32 products of 6·B·N·L²·D and 8·B·N·L²·D FLOPs at 495
TFLOP/s) and the card's name and power limit. Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from omnivideo_tpu_torch.ops import _kernels
from omnivideo_tpu_torch.ops.flash_attention import flash_bwd_plain, flash_delta, flash_fwd_lse_plain
from omnivideo_tpu_torch.tools.flash_time import _time

OUT = Path(__file__).resolve().parents[2] / "build" / "bwd_f32_variants"
CASES = {  # name: (B, L, N); every key visible, as the f32 ring backward's earlier shards
    "rank4": (2, 512, 32),
    "in_process": (1, 512, 32),
    "shard2048": (1, 2048, 32),
}
TOL = 1e-5  # of each gradient's norm per (batch row, head)
TF32_FLOPS = 495e12
KERNELS = ("flash_bwd_dq_f32", "flash_bwd_dkv_f32")


def _build(sources: dict) -> dict:
    """{name: (ctypes library, {kernel: {"registers", "spill_stores", "spill_loads"}})}."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _kernels._nvcc()
    procs = {}
    for name, src in sources.items():
        lib = OUT / f"{name}.so"
        cmd = [nvcc, *_kernels.NVCC_FLAGS, "-shared", "-I", str(src.parent), "-I",
               str(_kernels.CSRC), str(src), "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        dll = ctypes.CDLL(str(lib))
        for fn in KERNELS:
            f = getattr(dll, fn + "_launch")
            f.argtypes = _kernels._SIGNATURES[fn + "_launch"]
            f.restype = ctypes.c_int
        out[name] = (dll, _ptxas(log))
    return out


def _ptxas(log: str) -> dict:
    res, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = next((k for k in KERNELS if k in m.group(1)), None)
        elif cur and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            res.setdefault(cur, {}).update(spill_stores=int(st), spill_loads=int(ld))
        elif cur and "Used" in ln and "registers" in ln:
            res.setdefault(cur, {})["registers"] = int(re.search(r"Used (\d+) registers",
                                                                 ln).group(1))
    res["wgmma_serialised"] = [ln.strip() for ln in log.splitlines() if re.search(r"\bC75\d\d\b", ln)]
    return res


def _operands(B, Lq, Lk, N, lens, gen):
    q, do = (torch.randn(B, Lq, N, 128, generator=gen, device="cuda") for _ in range(2))
    k, v = (torch.randn(B, Lk, N, 128, generator=gen, device="cuda") for _ in range(2))
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
    o, lse = flash_fwd_lse_plain(q, k, v, kv)
    return [q, k, v, do, lse, flash_delta(do, o), kv]


def _launchers(dll, ops):
    q, k, v, do, lse, delta, kv = ops
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    stream = torch.cuda.current_stream().cuda_stream
    tail = (kv.data_ptr() if kv is not None else None, B, Lq, Lk, N, D, D**-0.5, stream)

    def run_dq():
        _kernels.check(dll.flash_bwd_dq_f32_launch(*ptrs, dq.data_ptr(), *tail), "dq")

    def run_dkv():
        _kernels.check(dll.flash_bwd_dkv_f32_launch(*ptrs, dk.data_ptr(), dv.data_ptr(), *tail),
                       "dkv")
    return run_dq, run_dkv, (dq, dk, dv)


def _rel(g, r):
    num = (g.double() - r.double()).square().sum(dim=(1, 3)).sqrt()
    return num / r.double().square().sum(dim=(1, 3)).sqrt().clamp_min(1e-30)


def _check(dll, ops, ref, lens=None):
    """The worst gradient's error per (batch row, head) against `ref`, or
    the check that failed: "not finite", "nonzero row" (the empty batch
    row's dq, a row past kv_len of dk or dv), "rerun differs"."""
    run_dq, run_dkv, grads = _launchers(dll, ops)
    run_dq()
    run_dkv()
    torch.cuda.synchronize()
    B = ops[0].shape[0]
    live = [b for b in range(B) if lens is None or lens[b] > 0]
    worst = 0.0
    for g, r in zip(grads, ref):
        if not torch.isfinite(g).all():
            return "not finite"
        worst = max(worst, float(_rel(g[live], r[live]).max()))
    for b in range(B):
        if lens is not None and (lens[b] == 0 and (grads[0][b] != 0).any()
                                 or any((g[b, lens[b]:] != 0).any() for g in grads[1:])):
            return "nonzero row"
    again = [g.clone() for g in grads]
    for _ in range(3):
        run_dq()
        run_dkv()
        torch.cuda.synchronize()
        diff = {n: (int((a != g).sum()), float((a - g).abs().max()))
                for n, a, g in zip(("dq", "dk", "dv"), again, grads) if not torch.equal(a, g)}
        if diff:
            return f"rerun differs: {diff}"
    return worst


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", nargs="+", default=[f"tree={_kernels.CSRC / 'flash_train_f32.cu'}"],
                    help="NAME=PATH of each variant's source")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--cases", nargs="+", choices=sorted(CASES), default=["rank4", "in_process"])
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sources = dict(s.split("=", 1) for s in args.src)
    libs = _build({n: Path(p).resolve() for n, p in sources.items()})
    gen = torch.Generator("cuda").manual_seed(23)
    lens = [433, 0]
    ragged = _operands(2, 300, 700, 12, lens, gen)
    ref = flash_bwd_plain(*ragged)
    for t in ragged[1:3]:  # k and v past kv_len: NaN, which no gradient may see
        t[0, lens[0]:] = float("nan")
        t[1] = float("nan")
    ragged_err = {n: _check(dll, ragged, ref, lens) for n, (dll, _) in libs.items()}
    del ragged, ref
    for case in args.cases:
        B, L, N = CASES[case]
        ops = _operands(B, L, L, N, None, gen)
        ref = flash_bwd_plain(*ops)
        flop = 2 * B * N * L * L * 128
        recs = {}
        for n, (dll, ptxas) in libs.items():
            recs[n] = {"variant": n, "source": sources[n], "case": case, "q": [B, L, N, 128],
                       "max_rel_err_per_head": _check(dll, ops, ref),
                       "ragged_nan_max_rel_err": ragged_err[n], "tolerance": TOL,
                       "ptxas": ptxas, "ms": {k: [] for k in KERNELS},
                       "bound_ms": {"flash_bwd_dq_f32": 9 * flop / TF32_FLOPS * 1e3,
                                    "flash_bwd_dkv_f32": 12 * flop / TF32_FLOPS * 1e3},
                       "nvidia_smi": smi}
        for _ in range(2):  # the variants take turns: a, b, ..., a, b, ...
            for n, (dll, _) in libs.items():
                run_dq, run_dkv, _ = _launchers(dll, ops)
                recs[n]["ms"]["flash_bwd_dq_f32"] += _time(run_dq, args.reps, args.rounds)
                recs[n]["ms"]["flash_bwd_dkv_f32"] += _time(run_dkv, args.reps, args.rounds)
        for rec in recs.values():
            rec["share_of_bound"] = {k: rec["bound_ms"][k] / min(rec["ms"][k]) for k in KERNELS}
            print(json.dumps(rec), flush=True)
        del ops, ref


if __name__ == "__main__":
    main()
