"""Build and time variants of the i2v cross-attention's pair kernel
(`csrc/flash_pair.cu`) side by side on one card.

    python3 omnivideo_tpu_torch/tools/pair_variants.py \
        [--src NAME=PATH.cu ...] [--reps 20] [--rounds 3]

Each source is a whole copy of `flash_pair.cu` with its C entry point
`flash_pair_launch`; it includes `flash_fwd_hopper.cuh` and
`hopper_common.cuh` from its own directory where it has copies there, else
from the package's `csrc/`. Every source is compiled by its own nvcc (all
started together, `-Xptxas -v`) into its own shared library under
`build/pair_variants/` and loaded with ctypes, so a design change is timed
against the tree's kernel in one sitting, on the same card, with the same
operands. Without `--src` the tree's source alone is built.

Each variant is first held to `flash_attention_pair_plain` (every output
row within 4 bf16 ulps of its max, three reruns bit-equal) at I2V-14B's q
[2, 32760, 40, 128] over 512 + 257 keys and at the tilings the main path
does not reach (a narrow text tail, a masked image tile, one q row over one
key of each). Then it is timed by CUDA events over `rounds` rounds of `reps`
launches after one untimed round, the variants taking turns, at the main
shape (`--keys` sets its key counts). One JSON line a variant carries the
times, the checks, nvcc's registers, spill bytes and C75xx warnings, the
bound (4·B·N·Lq·(Lt + Li)·D FLOPs at 989 TFLOP/s) and the card's name and
power limit. A variant that also exports `int pair_stamps_read(unsigned
long long* dst)` (clock64 stamps it took in block 0, [2 warpgroups][64
items][8 points]) gets each point's mean cycles after the one before it,
over the items after the first, from one more launch at the timed shape.
Needs one CUDA device and nvcc.
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
from omnivideo_tpu_torch.ops.flash_attention import (
    _qscale,
    flash_attention_pair_plain,
    pair_bound,
)
from omnivideo_tpu_torch.tools.flash_time import _time

OUT = Path(__file__).resolve().parents[2] / "build" / "pair_variants"
MAIN = (2, 32760, 512, 257, 40)  # (B, Lq, Lt, Li, N)
CHECKS = (MAIN, (2, 200, 513, 65, 40), (2, 63, 1, 129, 2), (1, 1, 1, 1, 2))
ULPS = 4.0
BF16_FLOPS = 989e12


def _build(sources: dict) -> dict:
    """{name: (ctypes library, ptxas report)}."""
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
        dll.flash_pair_launch.argtypes = _kernels._SIGNATURES["flash_pair_launch"]
        dll.flash_pair_launch.restype = ctypes.c_int
        out[name] = (dll, _ptxas(log))
    return out


def _ptxas(log: str) -> dict:
    res = {"wgmma_serialised": [ln.strip() for ln in log.splitlines()
                                if re.search(r"\bC75\d\d\b", ln)]}
    for ln in log.splitlines():
        if "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            res.update(spill_stores=int(st), spill_loads=int(ld))
        elif "Used" in ln and "registers" in ln:
            res["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return res


def _operands(shape, gen):
    B, Lq, Lt, Li, N = shape

    def normed(L):
        t = torch.randn(B, L, N, 128, generator=gen, device="cuda")
        return (t * torch.rsqrt(t.square().mean(-1, keepdim=True))).to(torch.bfloat16)

    q, kt, ki = normed(Lq), normed(Lt), normed(Li)
    vt, vi = (torch.randn(B, L, N, 128, generator=gen, device="cuda").to(torch.bfloat16)
              for L in (Lt, Li))
    mb, safe = pair_bound(q, kt, ki, 128**-0.5)
    return q, kt, vt, ki, vi, mb, safe


def _launcher(dll, ops):
    q, kt, vt, ki, vi, mb, safe = ops
    B, Lq, N, D = q.shape
    out = torch.empty_like(q)
    ptrs = [t.data_ptr() for t in (q, kt, vt, ki, vi, out, mb[0], safe[0:1], mb[1], safe[1:2])]
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        _kernels.check(dll.flash_pair_launch(*ptrs, B, Lq, kt.shape[1], ki.shape[1], N, D,
                                             _qscale(D**-0.5), stream), "flash_pair_launch")
    return run, out


def _check(dll, ops, ref):
    """The worst row's error in bf16 ulps of its max, or the check that
    failed ("not finite", "rerun differs")."""
    run, out = _launcher(dll, ops)
    run()
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        return "not finite"
    ulp = torch.exp2(torch.floor(torch.log2(
        ref.float().abs().amax(-1, keepdim=True).clamp_min(2.0**-126))) - 7)
    worst = float(((out.float() - ref.float()).abs() / ulp).max())
    first = out.clone()
    for _ in range(3):
        run()
        torch.cuda.synchronize()
        if not torch.equal(out, first):
            return "rerun differs"
    return worst


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", nargs="+", default=[f"tree={_kernels.CSRC / 'flash_pair.cu'}"],
                    help="NAME=PATH of each variant's source")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--keys", type=int, nargs=2, default=MAIN[2:4], metavar=("LT", "LI"),
                    help="text and image keys of the timed case (default I2V-14B's)")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sources = dict(s.split("=", 1) for s in args.src)
    libs = _build({n: Path(p).resolve() for n, p in sources.items()})
    gen = torch.Generator("cuda").manual_seed(24)
    checks = {n: {} for n in libs}
    for shape in CHECKS:
        ops = _operands(shape, gen)
        ref = flash_attention_pair_plain(*ops[:5], None, ops[5], ops[6])
        for n, (dll, _) in libs.items():
            checks[n]["x".join(map(str, shape))] = _check(dll, ops, ref)
        del ops, ref
    B, Lq, _, _, N = MAIN
    Lt, Li = args.keys
    ops = _operands((B, Lq, Lt, Li, N), gen)
    flop = 4 * B * N * Lq * (Lt + Li) * 128
    recs = {n: {"variant": n, "source": sources[n], "q": [B, Lq, N, 128], "Lt": Lt, "Li": Li,
                "max_row_ulps": checks[n], "tolerance_row_ulps": ULPS, "ptxas": ptxas, "ms": [],
                "bound_ms": flop / BF16_FLOPS * 1e3, "nvidia_smi": smi}
            for n, (_, ptxas) in libs.items()}
    for _ in range(2):  # the variants take turns: a, b, ..., a, b, ...
        for n, (dll, _) in libs.items():
            run, _ = _launcher(dll, ops)
            recs[n]["ms"] += _time(run, args.reps, args.rounds)
    for n, (dll, _) in libs.items():
        if hasattr(dll, "pair_stamps_read"):
            run, _ = _launcher(dll, ops)
            run()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (2 * 64 * 8))()
            _kernels.check(dll.pair_stamps_read(buf), "pair_stamps_read")
            st = torch.tensor(list(buf), dtype=torch.float64).view(2, 64, 8)
            d = (st[:, 1:, 1:] - st[:, 1:, :-1]).mean(1)  # point i after point i - 1
            item = (st[:, 2:, 0] - st[:, 1:-1, 0]).mean(1)  # one item to the next
            recs[n]["stamp_cycles"] = {"phases": d.tolist(), "item": item.tolist()}
    for rec in recs.values():
        rec["share_of_bound"] = rec["bound_ms"] / min(rec["ms"])
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
