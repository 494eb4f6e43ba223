"""Build, check and time variants of the MoE's grouped product (`csrc/gmm.cu`,
row 9 and its split widths, row 9s) side by side on one card.

    python3 omnivideo_tpu_torch/tools/gmm_variants.py \
        [--src NAME=PATH.cu ...] [--explore] [--cases NAME ...] [--reps 20] [--rounds 3]

Each source is a whole copy of `gmm.cu` with its C entry point `gmm_launch`
(the signature of `ops/_kernels.py`); it includes `hopper_common.cuh` from
its own directory where it has a copy there, else from the package's
`csrc/`. Every source is compiled by its own nvcc (all started together,
`-Xptxas -v`) into its own shared library under `build/gmm_variants/` and
loaded with ctypes. Without `--src` the tree's source alone is built.

The cases are Qwen3-VL-30B-A3B's MoE (128 experts, top-8) with the seeded
skewed routing of `tools/flash_time.py`: the prefill (1,481 tokens, 11,848
rows) and a decode step (8 rows), gate/up [E, 2048, w] and down [E, w, 2048]
at w = 768 (row 9) and at `--vlm_fsdp`'s split widths 384 and 192 (row
9s), bf16. Every variant runs each case with the schedule `ops.gmm.
gmm_schedule` picks and, with `--explore`, with the other column tiles,
splits and stage counts the kernels take. Each run is first held to
`gmm_plain` (every routed row within 4 bf16 ulps of its max, the rows past
the group sum zero, three reruns bit-equal; both `transpose_rhs`), then
timed in turns (variant a, b, ..., a, b, ...): the kernel's device time a
launch from torch.profiler over `reps` launches, `rounds` times (one
profiler session a round holds every run of the case). One JSON
line a (variant, case, schedule) carries the times, the checks (and, where
the variant exports `gmm_max_clusters`, the clusters of a split-k schedule
the card holds at once beside those it launches), nvcc's
registers, spill bytes and C75xx warnings for the variant, the bound (the
experts hit's bank bytes, the rows and the output at 3.35 TB/s, or the
routed FLOPs at 989 TFLOP/s) and the card's name and power limit. Needs
one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import math
import re
import subprocess
from pathlib import Path

import torch

from omnivideo_tpu_torch.ops import _kernels
from omnivideo_tpu_torch.tools.flash_time import (
    BF16_FLOPS,
    EXPERTS,
    HBM_BYTES_PER_S,
    TOP_K,
    _routed_sizes,
)

gmm_mod = importlib.import_module("omnivideo_tpu_torch.ops.gmm")  # the module, not `gmm`

OUT = Path(__file__).resolve().parents[2] / "build" / "gmm_variants"
CASES = tuple(  # (case, tokens, k, n)
    (f"{pre}{step}_{proj}", tokens, *((2048, w) if proj == "gate_up" else (w, 2048)))
    for pre, w in (("", 768), ("split2_", 384), ("split4_", 192))
    for step, tokens in (("prefill", 1481), ("decode", 1))
    for proj in ("gate_up", "down"))
ULPS = 4.0


def _build(sources: dict) -> dict:
    """{name: (ctypes library, ptxas report by kernel)}."""
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
        for fn in ("gmm_launch", "gmm_max_clusters"):
            if hasattr(dll, fn):
                getattr(dll, fn).argtypes = _kernels._SIGNATURES[fn]
                getattr(dll, fn).restype = ctypes.c_int
        out[name] = (dll, _ptxas(log))
    return out


def _ptxas(log: str) -> dict:
    """Registers and spill bytes of each gmm kernel (the demangled name's
    head and template arguments), and any C75xx line."""
    res, name = {"wgmma_serialised": [ln.strip() for ln in log.splitlines()
                                      if re.search(r"\bC75\d\d\b", ln)]}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            continue
        if name is None or "gmm" not in name:
            continue
        rec = res.setdefault(name, {})
        if "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            rec.update(spill_stores=int(st), spill_loads=int(ld))
        elif "Used" in ln and "registers" in ln:
            rec["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return res


def _schedules(m: int, k: int, n: int, sms: int, explore: bool) -> list:
    """The wrapper's schedule first; with `explore`, the other column tiles
    (the many-row kernel) or tiles, splits and stage counts (the few-row
    one) that fit, each as gmm_schedule would size its stages."""
    main = gmm_mod.gmm_schedule(m, k, n, EXPERTS, torch.bfloat16, sms)
    out = [main]
    if not explore:
        return out
    if main.kind == "wgmma":  # every stage count a layout without staged outputs takes
        for tile in gmm_mod.WIDE_TILES:
            unstaged = 2 * (tile // 64) * gmm_mod._BOX
            for stages in range(2, 9):
                if gmm_mod._wide_smem(tile, stages) - unstaged <= gmm_mod.BLOCK_SMEM:
                    out.append(gmm_mod.Schedule("wgmma", 0, 0, 0, tile, stages))
    else:
        k_steps, a_rows = math.ceil(k / 64), math.ceil(m / 8) * 8
        for tile in gmm_mod.SPLIT_TILES:
            tiles = min(EXPERTS, m) * math.ceil(n / tile)
            for s in range(1, min(8, k_steps) + 1):
                steps = math.ceil(k_steps / s)
                splits = math.ceil(k_steps / steps)
                blocks = splits * tiles
                share = gmm_mod.SM_SMEM // min(math.ceil(blocks / sms), 8) - 1024
                fit = [p for p in range(min(2, steps), steps + 1) if gmm_mod._split_smem(
                    tile, p, a_rows, splits) <= min(share, gmm_mod.BLOCK_SMEM)]
                if fit:
                    out.append(gmm_mod.Schedule("split_k", splits, steps, blocks, tile, max(fit)))
    return list(dict.fromkeys(out))


def _launcher(dll, lhs, rhs, sizes, out, sched, trans, sms):
    m, k = lhs.shape
    n = out.shape[1]
    args = (lhs.data_ptr(), rhs.data_ptr(), sizes.data_ptr(), out.data_ptr(), m, k, n,
            sizes.numel(), int(trans), 0, sched.splits, sched.tile_n, sched.stages, sms)

    def run():
        _kernels.check(dll.gmm_launch(*args, torch.cuda.current_stream().cuda_stream),
                       "gmm_launch")
    return run


def _check(dll, lhs, rhs, sizes, ref, sched, trans, sms):
    """The worst routed row's error in bf16 ulps of its max against `ref`
    (gmm_plain's routed rows), or the check that failed (a schedule whose
    shared memory a variant's layout does not take is refused at launch)."""
    m = lhs.shape[0]
    n = rhs.shape[1] if trans else rhs.shape[2]
    out = torch.full((m, n), float("nan"), dtype=lhs.dtype, device="cuda")
    run = _launcher(dll, lhs, rhs, sizes, out, sched, trans, sms)
    try:
        run()
    except RuntimeError as exc:
        return f"refused: {exc}"
    torch.cuda.synchronize()
    total = ref.shape[0]
    if torch.count_nonzero(out[total:]) != 0:
        return "rows past the sum not zero"
    if not torch.isfinite(out).all():
        return "not finite"
    ulp = torch.exp2(torch.floor(torch.log2(
        ref.float().abs().amax(-1, keepdim=True).clamp_min(2.0**-126))) - 7)
    worst = float(((out[:total].float() - ref.float()).abs() / ulp).max()) if total else 0.0
    first = out.clone()
    for _ in range(3):
        run()
        torch.cuda.synchronize()
        if not torch.equal(out, first):
            return "rerun differs"
    return worst


def _device_ms(runs: list, reps: int) -> list:
    """Each run's kernel time a launch (ms): one profiler session in which
    every run makes `reps` launches in turn, the card's kernels taken in the
    order they ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for run in runs:
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for run in runs:
            for _ in range(reps):
                run()
        torch.cuda.synchronize()
    kernels = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start)
    if len(kernels) != len(runs) * reps:
        raise RuntimeError(f"{len(kernels)} kernels profiled for {len(runs) * reps} launches")
    return [sum(ev.time_range.elapsed_us() for ev in kernels[i * reps:(i + 1) * reps])
            / reps / 1e3 for i in range(len(runs))]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", nargs="+", default=[f"tree={_kernels.CSRC / 'gmm.cu'}"],
                    help="NAME=PATH of each variant's source")
    ap.add_argument("--explore", action="store_true",
                    help="also the other tiles, splits and stage counts")
    ap.add_argument("--cases", nargs="+", choices=[c[0] for c in CASES])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sources = dict(s.split("=", 1) for s in args.src)
    libs = _build({n: Path(p).resolve() for n, p in sources.items()})
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(25)
    for name, tokens, k, n in CASES:
        if args.cases and name not in args.cases:
            continue
        sizes = _routed_sizes(tokens, gen)
        m = tokens * TOP_K
        lhs = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        rhs = (torch.randn(EXPERTS, k, n, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        rhs_t = rhs.transpose(1, 2).contiguous()
        hit = int((sizes > 0).sum())
        nbytes = 2 * (hit * k * n + m * k + m * n)
        flop = 2.0 * m * k * n
        bound = max(nbytes / HBM_BYTES_PER_S, flop / BF16_FLOPS) * 1e3
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        total = min(int(sizes.sum()), m)
        refs = {trans: gmm_mod.gmm_plain(lhs, r, sizes, trans)[:total]
                for trans, r in ((False, rhs), (True, rhs_t))}
        recs = []
        for i, sched in enumerate(_schedules(m, k, n, sms, args.explore)):
            for vname, (dll, ptxas) in libs.items():
                checks = {f"transpose_rhs={trans}": _check(dll, lhs, r, sizes, refs[trans], sched,
                                                           trans, sms)
                          for trans, r in ((False, rhs), (True, rhs_t))}
                if sched.kind == "split_k" and hasattr(dll, "gmm_max_clusters"):
                    most = ctypes.c_int(0)
                    _kernels.check(dll.gmm_max_clusters(m, sched.tile_n, sched.splits,
                                                        sched.stages, ctypes.byref(most)),
                                   "gmm_max_clusters")
                    checks["clusters"] = {"resident": most.value,
                                          "launched": sched.blocks // sched.splits}
                recs.append({"variant": vname, "case": name, "m": m, "k": k, "n": n,
                             "experts_hit": hit, "schedule": sched._asdict(),
                             "wrapper_schedule": i == 0, "schedule_t": sched,
                             "max_row_ulps": checks, "tolerance_row_ulps": ULPS,
                             "kernel_ms": [], "bound_ms": bound,
                             "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                             >= flop / BF16_FLOPS else "operations",
                             "ptxas": ptxas, "nvidia_smi": smi, "_dll": dll})
        timed = [rec for rec in recs if all(isinstance(v, float) and v <= ULPS for c, v in
                                            rec["max_row_ulps"].items() if c.startswith("tr"))]
        runs = [_launcher(rec["_dll"], lhs, rhs, sizes, out, rec["schedule_t"], False, sms)
                for rec in timed]
        reps = args.reps * (5 if tokens == 1 else 1)
        for _ in range(args.rounds):  # the runs take turns
            for rec, ms in zip(timed, _device_ms(runs, reps)):
                rec["kernel_ms"].append(ms)
        for rec in recs:
            rec.pop("_dll")
            rec.pop("schedule_t")
            if rec["kernel_ms"]:
                rec["share_of_bound"] = rec["bound_ms"] / min(rec["kernel_ms"])
            print(json.dumps(rec), flush=True)
        del lhs, rhs, rhs_t, out


if __name__ == "__main__":
    main()
