"""GPU smoke test of the PyTorch/CUDA port (omnivideo_tpu_torch) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py profile    # device time by kernel class, one DiT forward

Phases, each printing one JSON line; any failure raises (non-zero exit):
  device   card name and power limit, torch/CUDA versions, precision
           switches, kernel build time and nvcc's register/spill report;
  qk_prep  the qk_prep CUDA kernel against qk_prep_plain on the card at the
           T2V-1.3B shapes (RoPE self-attention q/k, norm-only context k, a
           sequence longer than the RoPE table);
  flash    the flash CUDA kernel against the q-chunked flash_attention_plain
           (bounded self- and cross-attention, a forced max-tracked case, a
           ragged kv_lens case with one fully masked batch row), with
           scaled_dot_product_attention timed beside it as a yardstick only;
  tiny     a small generate() on the card (kernels) against the same
           weights and noise on the CPU (plain versions);
  e2e      OmniVideoX2XUnified.random_init(T2V_1_3B) at full width and depth,
           832x480, 81 frames, 2 UniPC steps, CFG 5.0, VAE decode to uint8,
           with the kernels' launch counts asserted.
The line before the last is the kernel summary; the last line is
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from omnivideo_tpu_torch.configs.base import T2V_1_3B, PipelineConfig, VAEConfig, WanDiTConfig
from omnivideo_tpu_torch.ops import _kernels
from omnivideo_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    softmax_bound,
)
from omnivideo_tpu_torch.ops.qk_prep import qk_prep, qk_prep_plain, row_tiles
from omnivideo_tpu_torch.ops.rope import rope_3d_tables
from omnivideo_tpu_torch.pipelines.x2x import OmniVideoX2XUnified

HBM_BYTES_PER_S = 3.35e12  # NVIDIA's H100 SXM data sheet, at the 700 W limit
BF16_FLOPS = 989e12  # dense tensor-core bf16
F32_FLOPS = 67e12  # f32 outside the tensor cores
FLASH_ULPS = 4.0  # |o − o_plain| in bf16 ulps of max|o_plain|: p is rounded to
# bf16 before p·v at points that differ with the mode; the outputs are means
# over Lk keys (|o| ~ sqrt(e/Lk)), so the limit scales with them
RN_TOL = 1e-4  # rel, row-norm bound: f32 sums in another order
QK_PAIR_ULPS = 4.0  # two bf16 roundings before the rotation, one after (pair_ulps)
QK_MISMATCH = 1e-3  # share of y elements allowed to differ at all
STEPS = 2
FRAMES = 81
SIZE = (832, 480)
GRID = (21, 30, 52)  # latent grid of 832x480x81 after the (1, 2, 2) patch
SEQ = 21 * 30 * 52  # 32,760


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps launches, CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |v| (8 significant bits)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0**-126)))
    return torch.exp2(e - 7)


def pair_ulps(y: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|y − ref| in bf16 ulps of each RoPE pair's magnitude |(ref[2j],
    ref[2j+1])|. Where the f32 rs of the two versions differs in its last
    bits (another summation order), the bf16 roundings before the rotation
    can flip by one ulp; the rotation mixes the pair, so the flip shows at
    the pair's scale, not at the scale of a small rotated output."""
    r = ref.float().unflatten(-1, (-1, 2)).square().sum(-1).sqrt()
    r = r.repeat_interleave(2, dim=-1)
    return (y.float() - ref.float()).abs() / bf16_ulp(r)


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.library()
    ptxas = [ln.strip() for ln in _kernels.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    info = {"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "kernel_build_s": _kernels.build_seconds, "ptxas": ptxas}
    emit(info)
    return info


def phase_qk_prep(gen: torch.Generator) -> dict:
    dev = "cuda"
    d, N = 1536, 12
    hd = d // N
    cos, sin = (torch.tensor(t, device=dev) for t in rope_3d_tables(GRID, hd))
    cases = [("self_rope", 2, SEQ, True), ("context_norm_only", 2, 6272, False),
             ("past_table", 2, SEQ + 1000, True)]
    main = None
    for name, B, L, rope in cases:
        x = (torch.randn(B, L, d, generator=gen, device=dev) * 3.0).to(torch.bfloat16)
        g = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
        c, s = (cos, sin) if rope else (None, None)
        y, rn = qk_prep(x, g, c, s, N, 1e-6)
        yp, rnp = qk_prep_plain(x, g, c, s, N, 1e-6)
        torch.cuda.synchronize()
        diff = (y.float() - yp.float()).abs()
        ulps = float(pair_ulps(y, yp).max())
        mismatch = float((y != yp).float().mean())
        rn_rel = float(((rn - rnp).abs() / rnp).max())
        if ulps > QK_PAIR_ULPS or mismatch > QK_MISMATCH or rn_rel > RN_TOL:
            raise AssertionError(f"qk_prep {name}: max diff {float(diff.max())}, "
                                 f"{ulps} pair ulps, mismatch {mismatch}, rn rel {rn_rel}")
        ms = cuda_ms(lambda: qk_prep(x, g, c, s, N, 1e-6), reps=20)
        plain_ms = cuda_ms(lambda: qk_prep_plain(x, g, c, s, N, 1e-6), reps=3)
        nbytes = (2 * B * L * d * 2 + d * 2 + B * row_tiles(L) * N * 4
                  + (2 * min(L, SEQ) * hd // 2 * 4 if rope else 0))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 9 * B * L * d / F32_FLOPS * 1e3
        rec = {"phase": "qk_prep", "case": name, "shape": [B, L, d], "rope": rope,
               "max_abs_err": float(diff.max()), "max_pair_ulps": ulps,
               "mismatch_fraction": mismatch,
               "max_rel_err_rn": rn_rel, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        emit(rec)
        main = main or rec
        del x, y, yp
    return main


def _normed(B, L, N, D, gen, scale=1.0):
    """q/k-like rows with RMS 1 (norm √D), as qk-normed projections give."""
    t = torch.randn(B, L, N, D, generator=gen, device="cuda")
    t = t * torch.rsqrt(t.square().mean(-1, keepdim=True))
    return (t * scale).to(torch.bfloat16)


def phase_flash(gen: torch.Generator) -> dict:
    N, D = 12, 128
    cases = [
        ("self_bounded", 2, SEQ, SEQ, 1.0, None),
        ("cross_bounded", 2, SEQ, 6272, 1.0, None),
        ("max_tracked_forced", 2, 8192, 8192, 4.0, None),
        ("kv_lens_ragged", 2, 4096, 8190, 1.0, [5001, 0]),
    ]
    main = None
    for name, B, Lq, Lk, sc, lens in cases:
        q = _normed(B, Lq, N, D, gen, sc)
        k = _normed(B, Lk, N, D, gen, sc)
        v = torch.randn(B, Lk, N, D, generator=gen, device="cuda").to(torch.bfloat16)
        kv = torch.tensor(lens, dtype=torch.int32, device="cuda") if lens else None
        scale = D**-0.5
        mb, safe = softmax_bound(q, k, scale)
        bounded = bool(safe.item())
        o = flash_attention(q, k, v, kv_lens=kv, assume_normalized=True)
        o_max = flash_attention(q, k, v, kv_lens=kv, assume_normalized=False)
        op = flash_attention_plain(q, k, v, kv, scale, mb, safe)
        torch.cuda.synchronize()
        err = float((o.float() - op.float()).abs().max())
        err_modes = float((o.float() - o_max.float()).abs().max())
        ref_max = float(op.float().abs().max())
        limit = FLASH_ULPS * float(bf16_ulp(torch.tensor(ref_max)))
        zero_ok = True
        if lens and 0 in lens:
            zero_ok = bool((o[lens.index(0)] == 0).all() and (o_max[lens.index(0)] == 0).all())
        if name == "max_tracked_forced" and bounded:
            raise AssertionError("guard did not fail for the scaled q/k")
        if name != "max_tracked_forced" and not bounded:
            raise AssertionError(f"flash {name}: bounded softmax unexpectedly unsafe")
        if err > limit or err_modes > limit or not zero_ok:
            raise AssertionError(f"flash {name}: err {err}, modes {err_modes} (limit {limit} "
                                 f"at max|o_plain| {ref_max}), zero rows ok {zero_ok}")
        reps = 5 if Lq * Lk > 1e8 else 20
        ms = cuda_ms(lambda: flash_attention(q, k, v, kv_lens=kv, assume_normalized=True), reps)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, kv, scale, mb, safe), 1, 0)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if kv is not None:
            mask = (torch.arange(Lk, device="cuda")[None, :] < kv[:, None])[:, None, None, :]
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), reps)
        live = sum(min(l, Lk) for l in lens) if lens else B * Lk
        flops = 4 * N * Lq * live * D
        t_ops = flops / BF16_FLOPS * 1e3
        t_bytes = (2 * B * Lq * N * D * 2 + 2 * B * Lk * N * D * 2) / HBM_BYTES_PER_S * 1e3
        rec = {"phase": "flash", "case": name, "q": [B, Lq, N, D], "Lk": Lk,
               "kv_lens": lens, "bounded": bounded, "max_abs_err": err,
               "max_abs_err_bounded_vs_max_tracked": err_modes, "max_abs_plain": ref_max,
               "tolerance_abs": limit, "zero_rows_ok": zero_ok,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "tflops": flops / ms / 1e9}
        emit(rec)
        main = main or rec
        del q, k, v, o, o_max, op, qt, kt, vt
    return main


def _tiny_config() -> PipelineConfig:
    return PipelineConfig(
        name="tiny",
        dit=WanDiTConfig(patch_size=(1, 2, 2), in_dim=4, dim=256, ffn_dim=512, freq_dim=32,
                         text_dim=48, out_dim=4, num_heads=2, num_layers=2),
        vae=VAEConfig(dim=8, z_dim=4),
        vlm_in_dim=24, max_context_len=64)


def phase_tiny() -> dict:
    """The port on the card (kernels) vs the same port on the CPU (plain)."""
    cfg = _tiny_config()
    gen = torch.Generator().manual_seed(11)
    pipe_cpu = OmniVideoX2XUnified.random_init(cfg, seed=3, device="cpu")
    with torch.no_grad():  # init zero-fills the head: make velocities non-zero
        pipe_cpu.low_noise.wan.head.head.weight.normal_(0.0, 0.1, generator=gen)
    pipe_gpu = OmniVideoX2XUnified.random_init(cfg, seed=3, device="cuda")
    pipe_gpu.low_noise.wan.load_state_dict(pipe_cpu.low_noise.wan.state_dict())
    for src, dst in ((pipe_cpu.vae.params, pipe_gpu.vae.params),
                     (pipe_cpu.low_noise.companions, pipe_gpu.low_noise.companions)):
        _copy_tree(src, dst)
    ctx = torch.randn(12, cfg.dit.text_dim, generator=gen)
    noise = torch.randn(1, 4, 3, 8, 8, generator=gen)
    kw = dict(precomputed_context=ctx, precomputed_context_null=torch.zeros_like(ctx),
              size=(64, 64), frame_num=9, sampling_steps=3, guide_scale=5.0, noise=noise)
    lat_c = pipe_cpu.generate(decode=False, **kw)
    lat_g = pipe_gpu.generate(decode=False, **kw).cpu()
    err = float((lat_c - lat_g).abs().max())
    rel = err / float(lat_c.abs().max())
    vid = pipe_gpu.generate(output_uint8=True, **kw)
    if not torch.isfinite(lat_g).all() or rel > 5e-2 or tuple(vid.shape) != (9, 64, 64, 3):
        raise AssertionError(f"tiny generate: rel err {rel}, video {tuple(vid.shape)}")
    rec = {"phase": "tiny", "latent_max_abs_err": err, "latent_rel_err": rel,
           "tolerance_rel": 5e-2, "video_shape": list(vid.shape)}
    emit(rec)
    return rec


def _copy_tree(src, dst):
    for key, val in src.items():
        if isinstance(val, dict):
            _copy_tree(val, dst[key])
        else:
            dst[key].copy_(val)


def phase_e2e() -> dict:
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = OmniVideoX2XUnified.random_init(T2V_1_3B, seed=0, device="cuda",
                                           residual_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(1)
    head = pipe.low_noise.wan.head.head
    with torch.no_grad():  # init zero-fills the head: make velocities non-zero
        head.weight.normal_(0.0, T2V_1_3B.dit.dim**-0.5, generator=gen)
    ctx = torch.randn(77, T2V_1_3B.dit.text_dim, generator=gen, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    qk_prep.launches = 0
    flash_attention.launches = 0
    frames = pipe.generate(
        precomputed_context=ctx, precomputed_context_null=torch.zeros_like(ctx),
        size=SIZE, frame_num=FRAMES, sampling_steps=STEPS, guide_scale=5.0,
        output_uint8=True, generator=gen)
    launches = {"qk_prep": qk_prep.launches, "flash_fwd": flash_attention.launches}
    expect = {"qk_prep": 120 * STEPS, "flash_fwd": 60 * STEPS}
    shape = tuple(frames.shape)
    if launches != expect or shape != (FRAMES, SIZE[1], SIZE[0], 3):
        raise AssertionError(f"e2e: launches {launches} (expected {expect}), frames {shape}")
    rec = {"phase": "e2e", "config": "T2V_1_3B", "layers": T2V_1_3B.dit.num_layers,
           "dim": T2V_1_3B.dit.dim, "seq_len": SEQ, "size": list(SIZE), "frames": FRAMES,
           "steps": STEPS, "residual_dtype": "bfloat16", "init_s": t_init,
           **{k: v for k, v in pipe.timings.items()}, "launches": launches,
           "frames_shape": list(shape), "frames_mean": float(frames.float().mean()),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(rec)
    return rec


def _kernel_class(name: str) -> str:
    if "flash_fwd" in name:
        return "flash_fwd"
    if "qk_prep" in name:
        return "qk_prep"
    if any(s in name.lower() for s in ("gemm", "xmma", "cutlass", "sm90_", "nvjet")):
        return "gemm"
    if "elementwise" in name or "vectorized" in name or "unrolled" in name:
        return "elementwise"
    if "reduce" in name.lower():
        return "reduce"
    return "other"


def phase_profile() -> dict:
    """One full-size T2V-1.3B DiT forward (CFG batch 2, 32,760 tokens, bf16
    residual) under torch.profiler: device time by kernel class (device-side
    events only; one stream, so they do not overlap) and the device's idle
    share of the traced forward's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = T2V_1_3B
    pipe = OmniVideoX2XUnified.random_init(cfg, seed=0, device="cuda", with_vae=False)
    dit = pipe.low_noise.wan
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(2, 16, GRID[0], GRID[1] * 2, GRID[2] * 2, generator=gen, device="cuda")
    t = torch.full((2,), 999.0, device="cuda")
    with torch.inference_mode():
        ctx = dit.embed_context(torch.randn(2, cfg.max_context_len, cfg.dit.text_dim,
                                            generator=gen, device="cuda"))
        fwd = lambda: dit(x.bfloat16(), t, ctx, context_embedded=True,  # noqa: E731
                          residual_dtype=torch.bfloat16)
        fwd()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
    by_class, by_name = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        by_name[ev.key] = by_name.get(ev.key, 0.0) + ms
        c = _kernel_class(ev.key)
        by_class[c] = by_class.get(c, 0.0) + ms
    busy = sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    rec = {"phase": "profile", "what": "one DiT forward, T2V_1_3B, B=2, L=32760, bf16 residual",
           "wall_ms_untraced": wall_ms, "wall_ms_traced": traced_ms,
           "device_busy_ms_traced": busy, "idle_share": max(0.0, 1.0 - busy / traced_ms),
           "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
           "top_kernels_ms": [[k[:80], v] for k, v in top]}
    emit(rec)
    return rec


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one GPU", file=sys.stderr)
        return 2
    if argv[:1] == ["profile"]:
        phase_device()
        phase_profile()
        return 0
    if argv:
        raise SystemExit(f"chip_smoke: unknown arguments {argv} (only 'profile')")
    dev = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(0)
    qk = phase_qk_prep(gen)
    fl = phase_flash(gen)
    phase_tiny()
    launches = phase_e2e()["launches"]
    kernels = [
        {"name": "qk_prep", "route": "cuda", "source": "omnivideo_tpu_torch/csrc/qk_prep.cu",
         "replaces": "omnivideo_tpu/ops/pallas/qk_prep.py:41",
         "launches": launches["qk_prep"], "max_abs_err": qk["max_abs_err"],
         "ms": qk["ms"], "plain_ms": qk["plain_ms"], "bound_ms": qk["bound_ms"],
         "bound_by": qk["bound_by"], "library_ms": None},
        {"name": "flash_fwd", "route": "cuda", "source": "omnivideo_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "omnivideo_tpu/ops/pallas/flash_attention.py:42",
         "launches": launches["flash_fwd"], "max_abs_err": fl["max_abs_err"],
         "ms": fl["ms"], "plain_ms": fl["plain_ms"], "bound_ms": fl["bound_ms"],
         "bound_by": fl["bound_by"], "library_ms": fl["library_ms"]},
    ]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
