"""GPU smoke test of the PyTorch/CUDA port (omnivideo_tpu_torch) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py profile    # device time by kernel class, one DiT forward
    python3 chip_smoke.py sp         # the sp phase alone (VLM features seeded): on a
                                     # machine with 2+ cards its multi-card half runs

Phases, each printing one JSON line; any failure raises (non-zero exit):
  device    card name and power limit, torch/CUDA versions, precision
            switches, kernel build time and nvcc's register/spill report
            per kernel row (fails if a row is missing from it, or if
            ptxas serialised a kernel's wgmma: a C75xx warning);
  qk_prep   the qk_prep CUDA kernel against qk_prep_plain on the card at the
            T2V-1.3B shapes (RoPE self-attention q/k, norm-only context k, a
            sequence longer than the RoPE table);
  flash     the flash CUDA kernel against the q-chunked flash_attention_plain
            at the DiT's shapes (bounded self- and cross-attention, self at
            T2V-A14B's 40 heads, a forced max-tracked case, a ragged kv_lens
            case with one fully masked batch row), the Qwen3 prefill's
            (causal, head dim 128, with and without kv_lens) and the vision
            tower's (head dim 72: bounded, forced max-tracked, kv_lens, and
            kv_lens with NaN in the K/V rows past it), each output row held
            to its own scale; each kernel timed alone at its C entry point
            and through the wrapper, scaled_dot_product_attention timed
            beside it as a yardstick only;
  tiny      a small generate() on the card (kernels) against the same
            weights and noise on the CPU (plain versions);
  tiny_vlm  a small Qwen3-VL (vision head dim 72, text head dim 128) on the
            card against the same weights on the CPU: features and greedy
            tokens with every token routed to all experts, and features at
            top-2 of 8 experts with the CPU's routing replayed on the card;
  vlm       Qwen3-VL-30B-A3B at full width and depth from seeded random
            weights (~62 GB bf16, on the card): 6 seeded 832x480 frames →
            frames_to_patches (grid 3x30x52, 1,170 visual tokens), synthetic
            ids (L ~ 1.5k), the feature forward, a 16-token greedy decode,
            launch counts asserted, the top-8-of-128 grouped MoE of layer 0
            against its all-experts oracle, a profile of one feature
            forward; then the engine (Qwen3VLEngine.from_model with a
            stand-in tokenizer) on a seeded 1280x720, 48-frame, 24 fps clip
            file: source caption (grid 3x44x80 at 704x1280), target caption
            (text only), features (grid 3x2x2 at 32x32), each pass's
            launches (27 flash_d72 with a clip, 48 flash_causal), grids and
            feature shape asserted; the model is freed before the e2e phase;
  e2e       OmniVideoX2XUnified.random_init(T2V_1_3B) at full width and depth,
            832x480, 81 frames, 2 UniPC steps, CFG 5.0, conditioned on the
            vlm phase's features (ar_vision_input), VAE decode to uint8, with
            the kernels' launch counts asserted;
  load      the e2e phase's expert written in the diffusers layout
            (safetensors by write_safetensors, companions as .bin) and read
            back by load_expert onto the card: every tensor bit-equal, load
            seconds, GB/s and the host's resident-set rise;
  cli       the generate CLI in-process (tools/generate.py `run`): one V2V
            row from the 720p clip file, T2V-1.3B random weights at
            832x480x81, 2 steps, kernel launches asserted, the written file
            read back as [81, 480, 832, 3] uint8, stage seconds;
  ring      the ring-step CUDA kernel (row 8) over in-process shards against
            the same driver with ring_step_plain (per output row, bf16 ulps)
            and against the flash kernel over the whole sequence: the sp
            phase's launch ([2, 32760, 12, 128], one shard), a 4-card run's
            per-rank shapes (4 shards of 8,190), kv_lens with 8 pad keys and
            with the last shard all padding, and the four causal layouts at
            [1, 4096, 32, 128] (block against the plain twin; token, stripe
            and zigzag also against the causal flash kernel);
  sp        the e2e pipeline sequence-parallel: a real NCCL process group of
            world 1 runs the ring with the fused step (30 ring_step launches
            per forward asserted), held to the same pipeline's non-SP
            unfused generate from the same seed and features; with 2+ cards
            min(4, count) spawned ranks also run Ulysses and the ring (both
            impls) against the same reference, else a line says why not;
  adaln     the fused_adaln CUDA kernel against fused_adaln_plain at the four
            call sites' shapes of T2V-A14B ([2, 32760, 5120]: modulation only
            with bf16 out, gated residual + norm3 affine, residual +
            modulation, the head's modulation with f32 out) and of T2V-1.3B
            ([2, 32760, 1536]); x_new bit for bit, y per row in bf16 ulps;
  tiny_a14b a tiny dual-expert model (2 layers, dim 256, head dim 128) in the
            A14B parity mode (f32 residual, ew_impl="kernel") on the card
            against the same weights on the CPU, fed by a tiny umT5 encode
            and a tiny VAE encode (each also compared), both solvers, 7
            fused_adaln launches per forward asserted;
  a14b      T2V-A14B at full width and depth from seeded weights: umT5-XXL
            (bf16, on the card) encodes 512 seeded ids for the prompt and the
            negative and is freed; the full-size VAE encodes a seeded
            832x480x81 clip; both experts (2 x 14.29B bf16) run a V2V
            generate with the vlm phase's features, f32 residual,
            ew_impl="kernel", qk_impl="kernel", 3 UniPC steps at shift 12
            (2 high-noise steps, 1 low-noise, asserted) with 121 fused_adaln
            launches per forward asserted, one profiled forward, then the
            experts are freed (under 2 GB left allocated) and the VAE
            decodes to uint8; peak memory below 80 GB;
  flash_train  the training forward (o and LSE) and the dq and dk/dv
            backward kernels against their plain twins on the same bf16
            inputs at the training path's shapes (self-attention [1, 32760,
            12, 128], cross-attention over 6,272 keys, ragged kv_lens with a
            batch row of none), two backward launches bit for bit equal,
            achieved TFLOP/s and share of bound beside each time, SDPA
            forward and backward timed beside them;
  tiny_train  3 unified train steps of a 2-layer head-dim-128 model on the
            card (kernels) and on the CPU (plain twins) from the same
            weights, batch and draws: loss and grad_norm gaps;
  train     make_unified_train_step on T2V_1_3B at full width and depth, f32
            master params, batch 1 at 832x480x81 (32,760 tokens, the mixed
            context cut to 6,272), remat, AdamW: 3 steps on one batch and one
            set of draws (the loss must fall), launch counts per step
            asserted, train_step_s and peak memory, then one profiled step.
The line before the last is the kernel summary; the last line is
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import re
import resource
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from omnivideo_tpu_torch.configs.base import (
    T2V_1_3B,
    T2V_A14B,
    PipelineConfig,
    T5Config,
    VAEConfig,
    WanDiTConfig,
)
from omnivideo_tpu_torch.configs.prompts import FEATURE_EXTRACTION_SYSTEM_PROMPT
from omnivideo_tpu_torch.configs.qwen3vl import (
    QWEN3_VL_30B_A3B,
    SPECIAL_TOKEN_IDS,
    Qwen3TextConfig,
    Qwen3VLConfig,
    Qwen3VLVisionConfig,
)
from omnivideo_tpu_torch.models.qwen3vl import full_model as vlm_full
from omnivideo_tpu_torch.models.qwen3vl import text_model as vlm_text
from omnivideo_tpu_torch.models.qwen3vl.engine import (
    Qwen3VLEngine,
    VLMConfig,
    compute_system_prompt_drop_idx,
    extract_features,
)
from omnivideo_tpu_torch.models.qwen3vl.full_model import (
    Qwen3VLModel,
    qwen3vl_forward,
    qwen3vl_greedy_decode,
)
from omnivideo_tpu_torch.models.qwen3vl.media import smart_resize
from omnivideo_tpu_torch.models.qwen3vl.preprocess import frames_to_patches, video_prompt_ids
from omnivideo_tpu_torch.models.t5 import T5EncoderModel, init_t5
from omnivideo_tpu_torch.models.wan_dit import SPConfig
from omnivideo_tpu_torch.models.vae2_1 import Wan21VAE, init_vae
from omnivideo_tpu_torch.ops import _kernels
from omnivideo_tpu_torch.ops import flash_attention as flash_mod
from omnivideo_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    flash_attention_train,
    flash_bwd,
    flash_bwd_plain,
    flash_delta,
    flash_fwd_lse,
    flash_fwd_lse_plain,
    softmax_bound,
)
from omnivideo_tpu_torch.ops.fused_adaln import fused_adaln, fused_adaln_plain
from omnivideo_tpu_torch.ops.ring_attention import (
    ring_carry,
    ring_flash_attention_shards,
    ring_step,
    ring_step_plain,
    stripe_order,
    zigzag_order,
)
from omnivideo_tpu_torch.ops.qk_prep import qk_prep, qk_prep_plain, row_tiles
from omnivideo_tpu_torch.ops.rope import rope_3d_tables
from omnivideo_tpu_torch.parallel.distributed import maybe_initialize_distributed
from omnivideo_tpu_torch.parallel.mesh import create_mesh
from omnivideo_tpu_torch.pipelines.loading import load_expert
from omnivideo_tpu_torch.pipelines.x2x import OmniVideoX2XUnified
from omnivideo_tpu_torch.schedulers.unipc import FlowUniPC
from omnivideo_tpu_torch.tools import generate as generate_cli
from omnivideo_tpu_torch.training.trainer import (
    TrainConfig,
    init_train_state,
    init_unified_params,
    make_optimizer,
    make_unified_train_step,
    sample_draws,
)
from omnivideo_tpu_torch.utils.video import read_video_frames

HBM_BYTES_PER_S = 3.35e12  # NVIDIA's H100 SXM data sheet, at the 700 W limit
BF16_FLOPS = 989e12  # dense tensor-core bf16
F32_FLOPS = 67e12  # f32 outside the tensor cores
FLASH_ULPS = 4.0  # |o − o_plain| in bf16 ulps of its row's max|o_plain|: p is
# rounded to bf16 before p·v at points that differ with the mode; an output
# row is a mean over the keys it sees (|o| ~ sqrt(e/keys)), so the limit
# scales with each row: under the causal mask row 0 is a raw v row and row r
# is ~sqrt(e/(r+1)), so a limit from the global max would miss later rows
MOE_TOL = 2e-2  # grouped vs all-experts MoE, of scale: bf16 products, and the
# grouped form sums each token's k weighted expert outputs in bf16
RN_TOL = 1e-4  # rel, row-norm bound: f32 sums in another order
QK_PAIR_ULPS = 4.0  # two bf16 roundings before the rotation, one after (pair_ulps)
QK_MISMATCH = 1e-3  # share of y elements allowed to differ at all
LSE_TOL = 1e-4  # |LSE − LSE_plain|, natural-log units, rows with keys: f32 sums in another order
GRAD_TOL = 1e-2  # ‖g − g_plain‖/‖g_plain‖ per (batch row, head): p and ds round to bf16 before
# their products in both versions, at values that differ in their last f32 bits
TRAIN_TOL = 2e-3  # tiny train, card vs CPU, relative loss and grad_norm gaps (measured 5.7e-5): q/k/v/dO enter
# the card's flash kernels in bf16 where the CPU's plain twins compute in f32
TRAIN_STEPS = 3
ADALN_F32_TOL = 1e-5  # f32 y, of its row's max |y_plain|: the row sums run in another order
ADALN_BF16_ULPS = 1.0  # bf16 y, in ulps of its row's max |y_plain|: those sums can flip a rounding
ENCODE_TOL = 1e-3  # VAE encode, card vs CPU, of the latent scale: f32 convolutions (TF32 off)
# summed in other orders by cuDNN and oneDNN
A14B_STEPS = 3  # at the A14B shift 12: t = 999, 959 (high-noise expert), 856 (low-noise)
T5_IDS = 512  # umT5's text_len: the prompt and the negative are encoded at full length
CTX_LEN = 512  # PadSpec text_len and vlm_len
STEPS = 2
FRAMES = 81
SIZE = (832, 480)
GRID = (21, 30, 52)  # latent grid of 832x480x81 after the (1, 2, 2) patch
SEQ = 21 * 30 * 52  # 32,760
VLM_FRAMES = 6  # the reference's video_nframes for the VLM stage
VLM_GRID = (3, 30, 52)  # 6 frames at 832x480 after the (2, 16, 16) patch
VLM_NEW_TOKENS = 16  # the reference decodes up to 512; only the loop is cut
SYSTEM_PREFIX = 31  # synthetic system-prompt prefix, dropped from the features
CLIP_SHAPE = (48, 720, 1280, 3)  # the engine's and the CLI's source clip: 2 s of 720p
CLIP_FPS = 24
EDIT_PROMPT = "Replace the dog with a gray rabbit."
ENGINE_GRIDS = {"caption": (3, 44, 80), "features": (3, 2, 2)}  # 720p after smart_resize:
# 704x1280 at 480²…4·480² pixels, 32x32 at 480…1,920 (the JAX engine's budgets)
D72_SEQ = 30 * 52  # one temporal group of the vision tower, 1,560 patches
KERNEL_ROWS = ("qk_prep", "flash_fwd", "flash_causal", "flash_d72", "flash_fwd_lse",
               "flash_bwd_dq", "flash_bwd_dkv", "fused_adaln", "ring_step")


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


def row_ulps(o: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|o − ref| in bf16 ulps of each [.., D] row's max |ref|."""
    return (o.float() - ref.float()).abs() / bf16_ulp(ref.float().abs().amax(-1, keepdim=True))


def pair_ulps(y: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|y − ref| in bf16 ulps of each RoPE pair's magnitude |(ref[2j],
    ref[2j+1])|. Where the f32 rs of the two versions differs in its last
    bits (another summation order), the bf16 roundings before the rotation
    can flip by one ulp; the rotation mixes the pair, so the flip shows at
    the pair's scale, not at the scale of a small rotated output."""
    r = ref.float().unflatten(-1, (-1, 2)).square().sum(-1).sqrt()
    r = r.repeat_interleave(2, dim=-1)
    return (y.float() - ref.float()).abs() / bf16_ulp(r)


def kernel_row(name: str):
    """The port's kernel that a compiled or profiled GPU function is, from its
    mangled (nvcc's log) or demangled (the profiler's) name, or None. The
    Hopper forward mainloop `attn_fwd_kernel` serves five rows, told apart by
    its epilogue policy's type: InferOut<128> row 1, CausalOut row 2,
    InferOut<72> row 3a, LseOut row 3b, RingCarry row 8."""
    if "attn_fwd_kernel" in name:
        if "RingCarry" in name:
            return "ring_step"
        if "LseOut" in name:
            return "flash_fwd_lse"
        if "CausalOut" in name:
            return "flash_causal"
        m = re.search(r"InferOut(?:ILi|<)(\d+)", name)
        if m:
            return {"128": "flash_fwd", "72": "flash_d72"}.get(m.group(1))
        return None
    for key, row in (("flash_bwd_dkv", "flash_bwd_dkv"), ("flash_bwd_dq", "flash_bwd_dq"),
                     ("qk_prep", "qk_prep"), ("adaln_kernel", "fused_adaln")):
        if key in name:
            return row
    return None


def ptxas_by_kernel(log: str) -> dict:
    """{kernel: {"registers": n, "spill_stores": bytes, "spill_loads": bytes}}
    for every kernel of the port's table, from nvcc's -Xptxas -v log."""
    out, name = {}, None
    for ln in log.splitlines():
        f = re.search(r"Compiling entry function '(\w+)'", ln)
        if f:
            name = kernel_row(f.group(1))
        elif name and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            out.setdefault(name, {}).update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in ln and "registers" in ln:
            out.setdefault(name, {})["registers"] = int(re.search(r"Used (\d+) registers",
                                                                  ln).group(1))
    return out


def serialised_wgmma(log: str) -> list:
    """ptxas's C75xx warnings in nvcc's log: wgmma.mma_async serialised (a
    wgmma under a runtime branch, spills, a function call inside the
    pipeline), which costs a Hopper kernel its overlap of products."""
    return [ln.strip() for ln in log.splitlines() if re.search(r"\bC75\d\d\b", ln)]


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
    by_kernel = ptxas_by_kernel(_kernels.build_log)
    info = {"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
            "ptxas_by_kernel": by_kernel,
            "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "kernel_build_s": _kernels.build_seconds, "ptxas": ptxas}
    emit(info)
    missing = sorted(set(KERNEL_ROWS) - set(by_kernel))
    serial = serialised_wgmma(_kernels.build_log)
    if missing or serial:
        raise AssertionError(f"device: no ptxas report for {missing}; wgmma serialised: {serial}")
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


def _nan_past(t: torch.Tensor, lens) -> torch.Tensor:
    """A copy of [B, L, ...] `t` with the rows past lens[b] set to NaN."""
    t = t.clone()
    for b, n in enumerate(lens):
        t[b, n:] = float("nan")
    return t


def _flash_case(name, q, k, v, kv, normalized, causal, forced, reps, nan_tail=False):
    """One flash case: kernel vs plain (and, for the bounded cases, the
    max-tracked kernel), the kernel timed alone at its C entry point and
    through the wrapper (which also computes the softmax bound unless given
    the row norms), SDPA timed as a yardstick; returns the record. With
    `nan_tail` the K/V rows past kv_len hold NaN (the bound is taken from
    the rows before it, as qk_prep's row norms would give it)."""
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    scale = D**-0.5
    lens = kv.tolist() if kv is not None else None
    mb = safe = norms = None
    bounded = False
    if normalized:
        if nan_tail:
            norms = tuple(t.float().square().sum(-1).amax(dim=1).sqrt() for t in (q, k))
        mb, safe = softmax_bound(q, k, scale, norms)
        bounded = bool(safe.item())
    if nan_tail:
        k, v = _nan_past(k, lens), _nan_past(v, lens)
    wrapper = lambda: flash_attention(q, k, v, kv_lens=kv,  # noqa: E731
                                      assume_normalized=normalized, qk_row_norms=norms,
                                      causal=causal)
    o = wrapper()
    op = flash_attention_plain(q, k, v, kv, scale, mb, safe, causal)
    o_max = flash_attention(q, k, v, kv_lens=kv, causal=causal) if normalized else o
    torch.cuda.synchronize()
    err = float((o.float() - op.float()).abs().max())
    ulps = float(row_ulps(o, op).max())
    ulps_modes = float(row_ulps(o_max, op).max())
    ref_max = float(op.float().abs().max())
    zero_ok = bool(torch.isfinite(o).all() and torch.isfinite(o_max).all())
    if lens and 0 in lens:
        zero_ok &= bool((o[lens.index(0)] == 0).all() and (o_max[lens.index(0)] == 0).all())
    if normalized and forced == bounded:
        raise AssertionError(f"flash {name}: guard chose bounded={bounded}, expected {not forced}")
    if ulps > FLASH_ULPS or ulps_modes > FLASH_ULPS or not zero_ok:
        raise AssertionError(f"flash {name}: {ulps} row ulps, max-tracked {ulps_modes} "
                             f"(limit {FLASH_ULPS}), zero rows finite and ok {zero_ok}")
    # the kernel alone: the same launch the wrapper makes, its operands made once
    lens_i = kv.to(torch.int32).contiguous() if kv is not None else None
    out = torch.empty_like(q)
    args = [t.data_ptr() if t is not None else None for t in (q, k, v, out, lens_i, mb, safe)]
    args += [B, Lq, Lk, N, D, int(causal), flash_mod._qscale(scale),
             torch.cuda.current_stream().cuda_stream]
    lib = _kernels.library()
    ms = cuda_ms(lambda: _kernels.check(lib.flash_fwd_launch(*args), "flash_fwd_launch"), reps)
    wrapper_ms = cuda_ms(wrapper, reps)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, kv, scale, mb, safe, causal), 1, 0)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = None
    if kv is not None:
        mask = (torch.arange(Lk, device="cuda")[None, :] < kv[:, None])[:, None, None, :]
        if causal:
            mask = mask & torch.ones(Lq, Lk, dtype=torch.bool, device="cuda").tril()
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None), reps)
    # what this run's data needs: live (row, col) pairs under kv_lens and
    # causality; q rows read only where a batch row has live keys, K/V rows
    # up to kv_len, every output row written once
    live = nbytes = 0
    row_bytes = N * D * 2
    for b in range(B):
        kl = min(lens[b], Lk) if lens else Lk
        if causal:
            live += int(np.minimum(np.arange(Lq) + 1, kl).sum())
        else:
            live += Lq * kl
        nbytes += (Lq * (2 if kl > 0 else 1) + 2 * kl) * row_bytes
    flops = 4 * N * live * D
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rec = {"phase": "flash", "case": name, "kernel": flash_mod.KERNELS[(D, causal)],
           "q": [B, Lq, N, D], "Lk": Lk, "kv_lens": lens, "causal": causal,
           "bounded": bounded, "max_abs_err": err, "max_row_ulps": ulps,
           "max_row_ulps_max_tracked": ulps_modes, "tolerance_row_ulps": FLASH_ULPS,
           "max_abs_plain": ref_max, "zero_rows_ok": zero_ok,
           "nan_past_kv_len": nan_tail, "reps": reps,
           "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "share_of_bound": max(t_ops, t_bytes) / ms, "tflops": flops / ms / 1e9}
    emit(rec)
    return rec


def phase_flash(gen: torch.Generator) -> dict:
    """Cases per kernel instantiation; returns {kernel: its main-path case}."""
    main = {}

    def run(name, B, Lq, Lk, N, D, sc, lens, normalized, causal, nan_tail=False):
        q = _normed(B, Lq, N, D, gen, sc)
        k = _normed(B, Lk, N, D, gen, sc)
        v = torch.randn(B, Lk, N, D, generator=gen, device="cuda").to(torch.bfloat16)
        kv = torch.tensor(lens, dtype=torch.int32, device="cuda") if lens else None
        # launches per timing: a second or more of device time at the DiT's
        # shapes, and at the VLM's (~0.1 ms each) enough that two runs of one
        # tree agree within a few per cent
        reps = 5 if Lq * Lk > 1e8 else 200
        rec = _flash_case(name, q, k, v, kv, normalized, causal, sc != 1.0, reps, nan_tail)
        main.setdefault(rec["kernel"], rec)
        del q, k, v

    # the Wan DiT (head dim 128, bounded softmax on qk-normed q/k)
    run("self_bounded", 2, SEQ, SEQ, 12, 128, 1.0, None, True, False)
    run("cross_bounded", 2, SEQ, 6272, 12, 128, 1.0, None, True, False)
    run("max_tracked_forced", 2, 8192, 8192, 12, 128, 4.0, None, True, False)
    run("kv_lens_ragged", 2, 4096, 8190, 12, 128, 1.0, [5001, 0], True, False)
    run("self_bounded_n40", 2, SEQ, SEQ, 40, 128, 1.0, None, True, False)  # T2V-A14B's heads
    # the Qwen3 text prefill (causal, max-tracked, K/V repeated to 32 heads)
    L = vlm_prompt_len()
    run("causal_prefill", 1, L, L, 32, 128, 1.0, None, False, True)
    run("causal_kv_lens", 2, L, L, 32, 128, 1.0, [L * 3 // 4, 0], False, True)
    # the vision tower (head dim 72, one segment per temporal group)
    t = VLM_GRID[0]
    run("d72_bounded", t, D72_SEQ, D72_SEQ, 16, 72, 1.0, None, True, False)
    run("d72_max_tracked_forced", t, D72_SEQ, D72_SEQ, 16, 72, 4.0, None, True, False)
    run("d72_kv_lens", t, D72_SEQ, D72_SEQ, 16, 72, 1.0, [D72_SEQ, 999, 0], True, False)
    run("d72_kv_lens_nan", t, D72_SEQ, D72_SEQ, 16, 72, 1.0, [D72_SEQ, 999, 0], True, False,
        nan_tail=True)
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


def vlm_prompt_ids(cfg: Qwen3VLConfig, grid) -> np.ndarray:
    """Synthetic chat-template ids of the caption and feature prompts: a
    system prefix, per temporal group a 6-token timestamp then the video
    span, 256 tokens of user text and the assistant header."""
    rng = np.random.default_rng(7)
    text = lambda n: rng.integers(0, 151643, n).tolist()  # noqa: E731 (below the specials)
    return video_prompt_ids(text(SYSTEM_PREFIX), text(256), grid, cfg,
                            frame_prefixes=[text(6) for _ in range(grid[0])])


def vlm_prompt_len() -> int:
    return vlm_prompt_ids(QWEN3_VL_30B_A3B, VLM_GRID).shape[1]


class StandInTokenizer:
    """The FastTokenizer API without the `tokenizers` package (this machine
    may lack it): the Qwen chat and vision specials split out at their real
    ids (configs/qwen3vl.py), every other UTF-8 byte b as the id b. Ids it
    has no text for decode as "?"."""

    SPECIALS = ("<|im_start|>", "<|im_end|>", "<|vision_start|>", "<|vision_end|>",
                "<|video_pad|>")

    def __init__(self):
        self.ids = {t: SPECIAL_TOKEN_IDS[t] for t in self.SPECIALS}
        self.text = {i: t for t, i in self.ids.items()}
        self.eos_token_id = self.ids["<|im_end|>"]
        self._split = "(" + "|".join(re.escape(t) for t in self.SPECIALS) + ")"

    def __call__(self, text: str, add_special_tokens: bool = True):
        ids = []
        for part in re.split(self._split, text):
            ids.extend([self.ids[part]] if part in self.ids else part.encode())
        return {"input_ids": ids}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = []
        for i in (int(i) for i in ids):
            if i < 256:
                out.append(bytes([i]))
            elif i in self.text:
                out.append(b"" if skip_special_tokens else self.text[i].encode())
            else:
                out.append(b"?")
        return b"".join(out).decode("utf-8", errors="replace")


ST_DTYPES = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16",
             torch.int64: "I64", torch.int32: "I32", torch.uint8: "U8", torch.bool: "BOOL"}


def write_safetensors(path: Path, tensors: dict) -> int:
    """A safetensors file from the format (this machine may lack the
    package): the 8-byte header length, the JSON header padded to 8 bytes,
    the tensors' bytes in order. Returns the bytes written."""
    header, offset, blobs = {}, 0, []
    for name, t in tensors.items():
        raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        blobs.append(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for raw in blobs:
            f.write(raw)
    return 8 + len(head) + offset


def write_clip(path: Path) -> Path:
    """The seeded 720p source clip, uint8 frames at CLIP_FPS, as .npz."""
    frames = np.random.default_rng(11).integers(0, 256, CLIP_SHAPE, dtype=np.uint8)
    np.savez(path, frames=frames, fps=CLIP_FPS)
    return path


def _reset_launches() -> None:
    qk_prep.launches = 0
    fused_adaln.launches = 0
    ring_step.launches = 0
    for name in flash_attention.launches:
        flash_attention.launches[name] = 0


def _launches() -> dict:
    return {"qk_prep": qk_prep.launches, "fused_adaln": fused_adaln.launches,
            "ring_step": ring_step.launches, **flash_attention.launches}


def _tiny_vlm_config() -> Qwen3VLConfig:
    """Every kernel mode of the VLM path: vision head dim 72, text head dim
    128, MoE text layers with deepstack. A 16-token vocabulary keeps the
    greedy choices well separated, and every token is routed to all four
    experts: with top-k < E a router near-tie in bf16 flips the chosen
    experts between the devices and swaps whole expert outputs, which says
    nothing about the kernels."""
    return Qwen3VLConfig(
        text=Qwen3TextConfig(vocab_size=16, hidden_size=256, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2, head_dim=128,
                             num_experts=4, num_experts_per_tok=4, moe_intermediate_size=64),
        vision=Qwen3VLVisionConfig(hidden_size=144, intermediate_size=288, depth=2, num_heads=2,
                                   out_hidden_size=256, num_position_embeddings=64,
                                   deepstack_visual_indexes=(0, 1), rope_dtype="bfloat16"),
        video_token_id=15, image_token_id=14, vision_start_token_id=13)


def phase_tiny_vlm() -> dict:
    """The VLM port on the card (kernels) vs the same weights on the CPU
    (plain versions), bf16 both: the feature forward within 5e-2 of scale,
    and the same greedy tokens. Weights ~ N(0, 1/fan_in) so activations are
    O(1). bf16 rounds at other points on the two devices, so a greedy choice
    whose top logit leads its runner-up by less than NEAR_TIE of the largest
    |logit| (in the CPU decode) may legitimately flip: the tokens must agree
    up to the first such near-tie, and any divergence must start at one."""
    near_tie = 0.05
    cfg = _tiny_vlm_config()
    cpu, gpu = _tiny_vlm_pair(cfg, seed=51)
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (4, 64, 96, 3), dtype=np.uint8)
    vc = cfg.vision
    patches, grid = frames_to_patches(frames, vc.patch_size, vc.temporal_patch_size,
                                      vc.spatial_merge_size)
    ids = video_prompt_ids([1, 2, 3], [4, 5, 6, 7, 8], grid, cfg, vision_end_token_id=12)
    h_cpu = qwen3vl_forward(cpu, ids, patches, grid).float()
    _reset_launches()
    h_gpu = qwen3vl_forward(gpu, ids, patches, grid).float().cpu()
    launches = _launches()
    margins = []  # the CPU decode's top-1 lead over the runner-up, per step
    sample = vlm_full.sample_token

    def spy(logits, *args):
        top2 = logits.float().topk(2).values
        margins.append(float((top2[0] - top2[1]) / logits.float().abs().max()))
        return sample(logits, *args)

    vlm_full.sample_token = spy
    try:
        tok_cpu = qwen3vl_greedy_decode(cpu, ids, patches, grid, max_new_tokens=8)
    finally:
        vlm_full.sample_token = sample
    tok_gpu = qwen3vl_greedy_decode(gpu, ids, patches, grid, max_new_tokens=8)
    differ = np.nonzero(tok_cpu != tok_gpu)[0]
    first = int(differ[0]) if len(differ) else None
    rel = float((h_cpu - h_gpu).abs().max() / h_cpu.abs().max())
    text = np.random.default_rng(4).integers(0, 12, 200).tolist()  # below the specials
    top2 = _tiny_vlm_top2(cfg, video_prompt_ids([1, 2, 3], text, grid, cfg,
                                                vision_end_token_id=12), patches, grid)
    rec = {"phase": "tiny_vlm", "grid": list(grid), "seq_len": int(ids.shape[1]),
           "hidden_rel_err": rel, "tolerance_rel": 5e-2, "tokens_cpu": tok_cpu.tolist(),
           "tokens_gpu": tok_gpu.tolist(), "first_divergence": first,
           "cpu_rel_logit_margins": margins, "near_tie": near_tie, "launches": launches,
           "top2": top2}
    emit(rec)
    if (not torch.isfinite(h_gpu).all() or rel > 5e-2
            or (first is not None and margins[first] >= near_tie)
            or top2["hidden_rel_err_replayed"] > 5e-2
            or launches["flash_d72"] != vc.depth
            or launches["flash_causal"] != cfg.text.num_hidden_layers):
        raise AssertionError(f"tiny_vlm: {rec}")
    return rec


def _tiny_vlm_pair(cfg: Qwen3VLConfig, seed: int):
    """(CPU model, card model) with the same bf16 weights ~ N(0, 1/fan_in)."""
    gen = torch.Generator().manual_seed(seed)
    cpu = Qwen3VLModel(cfg, torch.bfloat16, device="cpu")
    with torch.no_grad():
        for name, prm in cpu.named_parameters():
            if prm.ndim >= 2:
                fan_in = prm.shape[1] if "experts_" in name else prm.shape[-1]
                prm.normal_(0.0, fan_in**-0.5, generator=gen)
    gpu = Qwen3VLModel(cfg, torch.bfloat16, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def _tiny_vlm_top2(cfg: Qwen3VLConfig, ids, patches, grid) -> dict:
    """The tiny VLM with top-2 of 8 experts over a 219-token prompt: the
    card's feature forward with its own routing, and with the CPU's routing
    decisions replayed (the CPU's chosen experts, weighted by the card's own
    router probabilities). With the choices replayed, what is left is
    rounding, held to 5e-2 of scale by the caller. The tokens whose chosen
    experts differ between the devices, with the CPU's margin between the
    2nd and 3rd router probability, say whether the free run's gap comes
    from near-ties."""
    cfg = cfg.replace(text=dataclasses.replace(cfg.text, num_experts=8, num_experts_per_tok=2))
    cpu, gpu = _tiny_vlm_pair(cfg, seed=52)
    route = vlm_text.router
    cpu_calls, gpu_calls = [], []

    def record(calls):
        def spy(mlp, xt):
            topv, topi, probs = route(mlp, xt)
            calls.append((topi.cpu(), probs.cpu()))
            return topv, topi, probs
        return spy

    def replay(mlp, xt):
        _, _, probs = route(mlp, xt)
        topi = cpu_calls[len(gpu_calls)][0].to(probs.device)
        gpu_calls.append(None)
        topv = probs.gather(1, topi)
        if mlp.cfg.norm_topk_prob:
            topv = topv / topv.sum(-1, keepdim=True)
        return topv, topi, probs

    try:
        vlm_text.router = record(cpu_calls)
        h_cpu = qwen3vl_forward(cpu, ids, patches, grid).float()
        vlm_text.router = record(gpu_calls)
        h_free = qwen3vl_forward(gpu, ids, patches, grid).float().cpu()
        free_calls, gpu_calls = gpu_calls, []
        vlm_text.router = replay
        h_replay = qwen3vl_forward(gpu, ids, patches, grid).float().cpu()
    finally:
        vlm_text.router = route
    flipped, flip_margins, all_margins = 0, [], []
    for (ti_c, p_c), (ti_g, _) in zip(cpu_calls, free_calls):
        top3 = p_c.topk(3, dim=-1).values
        margin = (top3[:, 1] - top3[:, 2]).numpy()
        differ = (ti_c.sort(-1).values != ti_g.sort(-1).values).any(-1).numpy()
        flipped += int(differ.sum())
        flip_margins += margin[differ].tolist()
        all_margins += margin.tolist()
    scale = h_cpu.abs().max()
    return {"experts_per_token": 2, "experts": cfg.text.num_experts, "seq_len": int(ids.shape[1]),
            "hidden_rel_err_own_routing": float((h_cpu - h_free).abs().max() / scale),
            "hidden_rel_err_replayed": float((h_cpu - h_replay).abs().max() / scale),
            "router_calls": len(cpu_calls), "tokens_routed_otherwise": flipped,
            "their_cpu_margins": flip_margins,
            "median_cpu_margin": float(np.median(all_margins))}


def _vlm_profile(model, ids, patches, grid) -> dict:
    """One feature forward under torch.profiler. Kernel time of the vision
    tower and of the MoE blocks from their profiler ranges ("qwen3vl.vision",
    "qwen3vl.moe"); attention is the causal flash kernel; "other" is the rest
    of the kernel time (projections, norms, RoPE, router). The ranges' spans
    on the device timeline (first kernel to last, idle gaps included) say how
    long each stage holds the card; busy/idle counts kernels only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ranges = ("qwen3vl.vision", "qwen3vl.moe")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        qwen3vl_forward(model, ids, patches, grid)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernel_ms = {r: 0.0 for r in ranges}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name in ranges:
            kernel_ms[ev.name] += ev.device_time_total / 1e3
    busy = attn = 0.0
    span_ms, by_name = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        if ev.key in ranges:  # the range's span on the device timeline, not a kernel
            span_ms[ev.key] = ms
            continue
        busy += ms
        by_name[ev.key] = by_name.get(ev.key, 0.0) + ms
        if kernel_row(ev.key) == "flash_causal":
            attn += ms
    vision, moe = kernel_ms["qwen3vl.vision"], kernel_ms["qwen3vl.moe"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"what": "one feature forward, Qwen3-VL-30B-A3B, grid 3x30x52, L=%d" % ids.shape[1],
            "wall_ms_traced": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "vision_kernel_ms": vision, "moe_kernel_ms": moe,
            "attention_causal_flash_ms": attn, "other_kernel_ms": busy - vision - moe - attn,
            "vision_span_ms": span_ms.get("qwen3vl.vision"),
            "moe_span_ms": span_ms.get("qwen3vl.moe"),
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def _vlm_moe_check(model: Qwen3VLModel, L: int) -> dict:
    """Layer 0's grouped MoE (top-8 of 128: expert sort, per-expert
    segments, scatter-add) on L seeded RMS-1 tokens against the all-experts
    oracle `moe_dense` on the same card; both take the router's decisions
    from the same inputs on the same device."""
    mlp = model.language_model.layers[0].mlp
    tcfg = model.cfg.text
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(1, L, tcfg.hidden_size, generator=gen, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        y, ref = vlm_text.moe(mlp, x).float(), vlm_text.moe_dense(mlp, x).float()
        _, topi, _ = vlm_text.router(mlp, x.reshape(L, -1))
    rel = float((y - ref).abs().max() / ref.abs().max())
    rec = {"layer": 0, "tokens": L, "experts_per_token": tcfg.num_experts_per_tok,
           "experts": tcfg.num_experts, "experts_used": int(topi.unique().numel()),
           "rel_err_vs_all_experts": rel, "tolerance_rel": MOE_TOL}
    if not torch.isfinite(y).all() or rel > MOE_TOL:
        raise AssertionError(f"vlm moe: {rec}")
    del x, y, ref
    return rec


def _engine_pass(model: Qwen3VLModel, clip: Path) -> dict:
    """The Qwen3-VL engine on the same model and the 720p clip file, through
    the stand-in tokenizer: source caption, target caption and features as
    `generate_caption_and_extract_features` runs them, VLM_NEW_TOKENS new
    tokens a caption. Launches, prompt length and grid are read per pass."""
    cfg = model.cfg
    engine = Qwen3VLEngine.from_model(model, VLMConfig(max_new_tokens=VLM_NEW_TOKENS),
                                      StandInTokenizer())
    passes, inputs = {}, []
    native = engine._native_inputs

    def spy_inputs(*args, **kw):
        ids, patches, grid = native(*args, **kw)
        inputs.append((int(ids.shape[1]), grid))
        return ids, patches, grid

    def counted(name, fn):
        def run(*args, **kw):
            _reset_launches()
            out = fn(*args, **kw)
            passes[name] = {"launches": _launches(), "seq_len": inputs[-1][0],
                            "grid": list(inputs[-1][1]) if inputs[-1][1] else None}
            return out
        return run

    engine._native_inputs = spy_inputs
    for name in ("generate_source_video_caption", "predict_target_video_caption",
                 "extract_features"):
        setattr(engine, name, counted(name, getattr(engine, name)))
    torch.cuda.reset_peak_memory_stats()
    feats = engine.generate_caption_and_extract_features(str(clip), EDIT_PROMPT)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    vc = cfg.vision
    f = vc.patch_size * vc.spatial_merge_size
    sizes = {"caption": smart_resize(CLIP_SHAPE[1], CLIP_SHAPE[2], f, 480 * 480, 4 * 480 * 480),
             "features": smart_resize(CLIP_SHAPE[1], CLIP_SHAPE[2], f, 480, 1920)}
    want = {"generate_source_video_caption": (vc.depth, ENGINE_GRIDS["caption"]),
            "predict_target_video_caption": (0, None),
            "extract_features": (vc.depth, ENGINE_GRIDS["features"])}
    h = feats["vlm_last_hidden_states"]
    drop = compute_system_prompt_drop_idx(engine.tokenizer, FEATURE_EXTRACTION_SYSTEM_PROMPT)
    expect_shape = (passes["extract_features"]["seq_len"] - drop, cfg.text.hidden_size)
    rec = {"clip": list(CLIP_SHAPE), "clip_fps": CLIP_FPS, "resized_to": sizes,
           "passes": passes, "source_caption_s": engine.timings["source_caption_s"],
           "target_caption_s": engine.timings["target_caption_s"],
           "features_s": engine.timings["features_s"], "drop_idx": drop,
           "features_shape": list(h.shape), "max_memory_allocated_gb": peak_gb,
           "source_caption_chars": len(feats["source_caption"]),
           "target_caption_chars": len(feats["target_caption"])}
    bad = [name for name, (d72, grid) in want.items()
           if passes[name]["launches"] != {**{k: 0 for k in _launches()}, "flash_d72": d72,
                                           "flash_causal": cfg.text.num_hidden_layers}
           or passes[name]["grid"] != (list(grid) if grid else None)]
    if (bad or tuple(h.shape) != expect_shape or not torch.isfinite(h).all()
            or any((s[0] // vc.patch_size, s[1] // vc.patch_size) != ENGINE_GRIDS[k][1:]
                   for k, s in sizes.items())):
        raise AssertionError(f"vlm engine: passes {bad} off, {rec}")
    del feats, h
    return rec


def phase_vlm(clip: Path) -> dict:
    """Qwen3-VL-30B-A3B at full width and depth: feature forward and a
    16-token greedy caption on 6 frames of 832x480, then the engine on the
    720p clip file (`_engine_pass`). Returns the record with the features
    ([L − system prefix, 2048] f32 on the card) under "features"; the model
    is freed before returning."""
    cfg = QWEN3_VL_30B_A3B
    vc = cfg.vision
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Qwen3VLModel.random_init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    # the captioning pixel budget (480²…4·480²) keeps 832x480
    size = smart_resize(SIZE[1], SIZE[0], vc.patch_size * vc.spatial_merge_size,
                        480 * 480, 4 * 480 * 480)
    frames = np.random.default_rng(0).integers(0, 256, (VLM_FRAMES, *size, 3), dtype=np.uint8)
    patches, grid = frames_to_patches(frames, vc.patch_size, vc.temporal_patch_size,
                                      vc.spatial_merge_size)
    if size != (SIZE[1], SIZE[0]) or grid != VLM_GRID:
        raise AssertionError(f"vlm: resize {size}, grid {grid}")
    ids = vlm_prompt_ids(cfg, grid)
    patches = torch.from_numpy(patches).cuda()

    guard = []  # the vision tower's softmax guard, one device flag per block
    bound_fn = flash_mod.softmax_bound

    def spy(*args, **kw):
        mb, safe = bound_fn(*args, **kw)
        guard.append(safe)
        return mb, safe

    per_pass = {"flash_d72": vc.depth, "flash_causal": cfg.text.num_hidden_layers,
                "flash_fwd": 0, "qk_prep": 0, "fused_adaln": 0, "ring_step": 0}
    total = {k: 0 for k in per_pass}
    flash_mod.softmax_bound = spy
    try:
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = extract_features(model, ids, patches, grid, drop_idx=SYSTEM_PREFIX)
        torch.cuda.synchronize()
        features_s = time.perf_counter() - t0
        got_f = _launches()
        _reset_launches()
        timings = {}
        toks = qwen3vl_greedy_decode(model, ids, patches, grid, max_new_tokens=VLM_NEW_TOKENS,
                                     timings=timings)
        got_d = _launches()
    finally:
        flash_mod.softmax_bound = bound_fn
    for got in (got_f, got_d):
        if got != per_pass:
            raise AssertionError(f"vlm: launches {got} per pass, expected {per_pass}")
        for k in total:
            total[k] += got[k]
    h = feats["vlm_last_hidden_states"]
    L = ids.shape[1]
    expect = (L - SYSTEM_PREFIX, cfg.text.hidden_size)
    if (tuple(h.shape) != expect or not torch.isfinite(h).all() or len(toks) != VLM_NEW_TOKENS
            or not ((toks >= 0) & (toks < cfg.text.vocab_size)).all()):
        raise AssertionError(f"vlm: features {tuple(h.shape)} (expected {expect}), "
                             f"finite {bool(torch.isfinite(h).all())}, tokens {toks}")
    safe = torch.cat(guard).cpu()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moe_check = _vlm_moe_check(model, L)
    profile = _vlm_profile(model, ids, patches, grid)
    engine = _engine_pass(model, clip)
    steps = timings["decode_steps"]
    rec = {"phase": "vlm", "config": "QWEN3_VL_30B_A3B", "text_layers": cfg.text.num_hidden_layers,
           "experts": cfg.text.num_experts, "vision_depth": vc.depth, "grid": list(grid),
           "visual_tokens": int(np.prod(grid)) // vc.spatial_merge_size**2, "seq_len": L,
           "weights_gb": weights_gb, "init_s": init_s, "features_s": features_s,
           "vision_s": timings["vision_s"], "prefill_s": timings["prefill_s"],
           "decode_s": timings["decode_s"], "decode_steps": steps,
           "decode_ms_per_token": timings["decode_s"] / steps * 1e3,
           "max_memory_allocated_gb": peak_gb, "features_shape": list(h.shape),
           "features_rms": float(h.square().mean().sqrt()), "tokens": toks.tolist(),
           "d72_guard": {"bounded_blocks": int(safe.sum()),
                         "max_tracked_blocks": int((safe == 0).sum())},
           "launches_per_pass": per_pass, "launches": total, "moe_check": moe_check,
           "profile": profile, "engine": engine}
    emit(rec)
    rec["features"] = h
    del model, feats, patches
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def t2v_pipeline(cfg: PipelineConfig, device, **pipe_kw):
    """The seeded x2x pipeline of the e2e and sp phases (and of every rank
    of the multi-card sp run): random_init from seed 0, the zero-init DiT
    head filled with N(0, 1/√dim), a 77-token context; returns (pipe, ctx,
    the generator those were drawn from)."""
    pipe = OmniVideoX2XUnified.random_init(cfg, seed=0, device=device,
                                           residual_dtype="bfloat16", **pipe_kw)
    gen = torch.Generator(device=device).manual_seed(1)
    head = pipe.low_noise.wan.head.head
    with torch.no_grad():  # init zero-fills the head: make velocities non-zero
        head.weight.normal_(0.0, cfg.dit.dim**-0.5, generator=gen)
    ctx = torch.randn(77, cfg.dit.text_dim, generator=gen, device=device)
    return pipe, ctx, gen


def phase_e2e(ar_vision: torch.Tensor) -> dict:
    """The x2x generate at full width and depth, conditioned on the VLM
    features (`ar_vision_input`, [L, 2048] f32 on the card). The record
    carries the pipeline and its context ("pipe", "ctx") for the sp phase."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe, ctx, gen = t2v_pipeline(T2V_1_3B, "cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    _reset_launches()
    frames = pipe.generate(
        precomputed_context=ctx, precomputed_context_null=torch.zeros_like(ctx),
        ar_vision_input=ar_vision, size=SIZE, frame_num=FRAMES, sampling_steps=STEPS,
        guide_scale=5.0, output_uint8=True, generator=gen)
    launches = _launches()
    expect = {"qk_prep": 120 * STEPS, "flash_fwd": 60 * STEPS, "flash_causal": 0, "flash_d72": 0,
              "fused_adaln": 0, "ring_step": 0}
    shape = tuple(frames.shape)
    if launches != expect or shape != (FRAMES, SIZE[1], SIZE[0], 3):
        raise AssertionError(f"e2e: launches {launches} (expected {expect}), frames {shape}")
    rec = {"phase": "e2e", "config": "T2V_1_3B", "layers": T2V_1_3B.dit.num_layers,
           "dim": T2V_1_3B.dit.dim, "seq_len": SEQ, "size": list(SIZE), "frames": FRAMES,
           "steps": STEPS, "residual_dtype": "bfloat16", "init_s": t_init,
           "ar_vision_input": list(ar_vision.shape),
           **{k: v for k, v in pipe.timings.items()}, "launches": launches,
           "frames_shape": list(shape), "frames_mean": float(frames.float().mean()),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(rec)
    rec.update(pipe=pipe, ctx=ctx)
    return rec


def _host_rss_gb() -> float:
    """The process's resident set now (/proc/self/status VmRSS), GB."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no VmRSS in /proc/self/status")


class RssSampler:
    """The largest resident set seen while the `with` block runs, sampled
    every `period` seconds by a thread (VmHWM holds the whole run's peak,
    and a process may not be allowed to reset it)."""

    def __init__(self, period: float = 0.005):
        self.period, self.peak_gb = period, 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while True:
            self.peak_gb = max(self.peak_gb, _host_rss_gb())
            if self._stop.wait(self.period):
                return

    def __enter__(self) -> "RssSampler":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak_gb = max(self.peak_gb, _host_rss_gb())


def _companion_state_dicts(comp: dict) -> dict:
    """The port's companion params (JAX layout, kernels [in, out]) → the
    reference's `{name}_pytorch_model.bin` state dicts."""
    lin = lambda p: {"weight": p["kernel"].T.contiguous(), "bias": p["bias"]}  # noqa: E731
    out = {"vlm_norm": {"weight": comp["vlm_norm"]}, "vlm_proj": lin(comp["vlm_proj"])}
    if "visual_context_adapter" in comp:
        a = comp["visual_context_adapter"]
        out["visual_context_adapter"] = {
            **{f"patch_embedding.{k}": v for k, v in lin(a["patch_embedding"]).items()},
            **{f"projection.{k}": v for k, v in lin(a["projection"]).items()}}
    return {k: {n: t.detach().cpu() for n, t in sd.items()} for k, sd in out.items()}


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                               8: torch.int64}[t.element_size()])


def phase_load(expert, tmp: Path) -> dict:
    """The seeded T2V-1.3B expert (the e2e phase's) written in the diffusers
    layout (`low_noise_model/wan_model/diffusion_pytorch_model.safetensors`
    by `write_safetensors`, the companions as `.bin` pickles), then
    `load_expert` onto the card: every tensor bit-equal to its source; the
    load's seconds and GB/s, and how far the host's resident set rose
    during it (each tensor is read once through a pinned staging buffer of
    `STAGING_BYTES`, so it should stay far below the file's size)."""
    root = tmp / "ckpt_1_3b"
    sub = root / T2V_1_3B.low_noise_checkpoint
    (sub / "wan_model").mkdir(parents=True)
    t0 = time.perf_counter()
    nbytes = write_safetensors(sub / "wan_model" / "diffusion_pytorch_model.safetensors",
                               dict(expert.wan.named_parameters()))
    for name, sd in _companion_state_dicts(expert.companions).items():
        torch.save(sd, sub / f"{name}_pytorch_model.bin")
    write_s = time.perf_counter() - t0
    gc.collect()
    rss0 = _host_rss_gb()
    torch.cuda.synchronize()
    with RssSampler() as rss:
        t0 = time.perf_counter()
        loaded = load_expert(T2V_1_3B, str(root), T2V_1_3B.low_noise_checkpoint,
                             torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    src = dict(expert.wan.named_parameters())
    got = dict(loaded.wan.named_parameters())
    differ = [k for k in src if src[k].dtype != got[k].dtype
              or not torch.equal(_bits(src[k]), _bits(got[k]))]
    c_src, c_got = _flat(expert.companions), _flat(loaded.companions)
    differ += [k for k in c_src if k not in c_got or not torch.equal(c_src[k], c_got[k])]
    rec = {"phase": "load", "config": "T2V_1_3B", "layout": "diffusers (safetensors + .bin)",
           "tensors": len(src), "companions": sorted(c_src), "gb": nbytes / 1e9,
           "write_s": write_s, "load_s": load_s, "gb_per_s": nbytes / 1e9 / load_s,
           "host_rss_before_gb": rss0, "host_rss_peak_during_load_gb": rss.peak_gb,
           "host_rss_rise_gb": rss.peak_gb - rss0,
           "host_peak_rss_gb_process": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
           "bit_equal": not differ}
    emit(rec)
    del loaded, got
    shutil.rmtree(root)
    gc.collect()
    torch.cuda.empty_cache()
    if differ or set(c_src) != set(c_got):
        raise AssertionError(f"load: {len(differ)} tensors differ from their source: {differ[:8]}")
    return rec


def phase_cli(clip: Path, tmp: Path) -> dict:
    """The generate CLI in-process at full width: one V2V row from the 720p
    24 fps clip file, T2V-1.3B random weights, 832x480x81, 2 steps (sampling
    to 16 fps, resize and normalise on the card, VAE encode, two DiT steps
    with their kernel launches asserted, decode, save_video); the file it
    wrote must hold [81, 480, 832, 3] uint8."""
    rows = tmp / "cli_rows.jsonl"
    rows.write_text(json.dumps({"id": "v2v_0", "source_clip_path": str(clip),
                                "edit_prompt": EDIT_PROMPT}) + "\n")
    argv = ["--task", "t2v-1.3B", "--random_weights", "--sample_steps", str(STEPS),
            "--size", f"{SIZE[0]}*{SIZE[1]}", "--frame_num", str(FRAMES), "--input", str(rows),
            "--output_dir", str(tmp / "cli_out"), "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    (res,) = generate_cli.run(generate_cli.parse_args(argv))
    wall_s = time.perf_counter() - t0
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    path = Path(res["path"])
    frames, fps = read_video_frames(str(path)) if path.exists() else (np.zeros(0), 0.0)
    layers = T2V_1_3B.dit.num_layers  # per layer and CFG forward: 2 qk_prep, 1 flash_fwd
    expect = {**{k: 0 for k in launches}, "qk_prep": 4 * layers * STEPS,
              "flash_fwd": 2 * layers * STEPS}
    t = res["timings"]
    rec = {"phase": "cli", "argv": argv, "written": path.name, "frames_shape": list(frames.shape),
           "frames_dtype": str(frames.dtype), "fps": fps, "wall_s": wall_s,
           **{k: t.get(k) for k in ("read_s", "transform_s", "encode_s", "denoise_step_s",
                                    "decode_s", "save_s")},
           "launches": launches, "max_memory_allocated_gb": peak_gb}
    emit(rec)
    if (launches != expect or tuple(frames.shape) != (FRAMES, SIZE[1], SIZE[0], 3)
            or frames.dtype != np.uint8):
        raise AssertionError(f"cli: launches {launches} (expected {expect}), {rec}")
    shutil.rmtree(tmp / "cli_out")
    gc.collect()
    torch.cuda.empty_cache()
    return rec


RING_N = 4  # in-process shards: the per-rank shapes of a 4-card SP run
CAUSAL_Q = (1, 4096, 32, 128)  # a Qwen3 prefill's heads at a length 2n chunks of 64 divide
SP_SEED = 5
SP_TOL = 5e-2  # SP latents vs the non-SP unfused ones, of scale, the tiny generate's limit:
# measured 1.2e-2 to 1.5e-2 on the H100 at world 1 and 4 (bf16 residual; the ring's
# max-tracked softmax rounds p where the non-SP chain's bounded one does not)


def _shards(t: torch.Tensor, n: int):
    return [c.contiguous() for c in t.chunk(n, 1)]


def _causal_pairs(B, L, causal, n) -> int:
    """(q row, key) pairs a causal mode makes visible, per head."""
    if causal == "block":
        return B * (L // n) ** 2 * n * (n + 1) // 2
    return B * L * (L + 1) // 2  # the token triangle, in whichever layout


def _ring_case(name, q, k, v, n, kv=None, causal=None, whole=None, reps=10) -> dict:
    """The kernel over n in-process shards (ring_flash_attention_shards)
    against the same driver with ring_step_plain, per output row in bf16
    ulps of the row's max, and against `whole` (the flash kernel over the
    whole sequence, in the shards' token order) when given. Times: one step
    (own shard, non-causal) or the whole driver (causal), the plain twin's,
    and SDPA over the same pairs as a yardstick."""
    B, L, N, D = q.shape
    Ls = L // n
    qs, ks, vs = (_shards(t, n) for t in (q, k, v))
    out = torch.cat(ring_flash_attention_shards(qs, ks, vs, kv_lens=kv, causal=causal), 1)
    ref = torch.cat(ring_flash_attention_shards(qs, ks, vs, kv_lens=kv, causal=causal,
                                                step=ring_step_plain), 1)
    torch.cuda.synchronize()
    ulps = float(row_ulps(out, ref).max())
    ulps_whole = None if whole is None else float(row_ulps(out, whole).max())
    rec = {"phase": "ring", "case": name, "q": [B, L, N, D], "shards": n,
           "kv_lens": kv.tolist() if kv is not None else None, "causal": causal,
           "max_abs_err": float((out.float() - ref.float()).abs().max()), "max_row_ulps": ulps,
           "max_row_ulps_vs_flash": ulps_whole, "tolerance_row_ulps": FLASH_ULPS}
    if (ulps > FLASH_ULPS or (ulps_whole is not None and ulps_whole > FLASH_ULPS)
            or not torch.isfinite(out).all()):
        raise AssertionError(f"ring {name}: {rec}")
    del out, ref
    row = N * D
    if causal is None:  # one step: rank 0 against its own shard
        lens = None if kv is None else kv.clamp(max=Ls)
        carry = ring_carry(B, Ls, N, D, "cuda")
        rec["ms"] = cuda_ms(lambda: ring_step(qs[0], ks[0], vs[0], *carry, step_lens=lens), reps)
        rec["plain_ms"] = cuda_ms(lambda: ring_step_plain(qs[0], ks[0], vs[0], *carry,
                                                          step_lens=lens), 1, 0)
        mask = None
        if lens is not None:
            mask = (torch.arange(Ls, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (qs[0], ks[0], vs[0]))
        rec["library_ms"] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), reps)
        pairs = Ls * (sum(int(x) for x in lens.tolist()) if lens is not None else B * Ls)
        kv_rows = pairs // Ls
        nbytes = (B * Ls + 2 * kv_rows) * row * 2 + 2 * (2 * B * N * Ls * 4 + B * Ls * row * 4)
        rec["timed"] = "one step: shard 0 against its own K/V"
        del qt, kt, vt, carry
    else:  # the whole driver, n·n steps
        rec["ms"] = cuda_ms(lambda: ring_flash_attention_shards(qs, ks, vs, causal=causal), 3)
        rec["plain_ms"] = cuda_ms(lambda: ring_flash_attention_shards(
            qs, ks, vs, causal=causal, step=ring_step_plain), 1, 0)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        rec["library_ms"] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 3)  # causal attention in the original order
        pairs = _causal_pairs(B, L, causal, n)
        nbytes = 3 * B * L * row * 2 + 2 * (2 * B * N * L * 4 + B * L * row * 4)
        rec["timed"] = f"the whole driver, {n * n} steps"
        del qt, kt, vt
    t_ops = 4 * N * D * pairs / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rec.update(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
               visible_pairs_per_head=pairs)
    emit(rec)
    return rec


def phase_ring(gen: torch.Generator) -> dict:
    """Row 8 at the 1.3B DiT's SP shapes and at a causal prefill's; returns
    {case: record}."""
    recs = {}

    def dit(name, n, L, lens):
        q, k = _normed(2, L, 12, 128, gen), _normed(2, L, 12, 128, gen)
        v = torch.randn(2, L, 12, 128, generator=gen, device="cuda").to(torch.bfloat16)
        kv = None if lens is None else torch.tensor([lens] * 2, dtype=torch.int32, device="cuda")
        whole = flash_attention(q, k, v, kv_lens=kv)  # row 1, max-tracked
        recs[name] = _ring_case(name, q, k, v, n, kv, whole=whole)

    dit("sp1_main", 1, SEQ, None)  # the sp phase's launch: one card, one step of 32,760 keys
    dit("sp4", RING_N, SEQ, None)  # a 4-card run's per-rank step: 8,190 q rows x 8,190 keys
    dit("sp4_pad8", RING_N, 32768, 32760)  # the last shard ends in 8 pad keys
    dit("sp4_empty_shard", RING_N, 32768, 24576)  # the last shard is all padding
    B, L, N, D = CAUSAL_Q
    q, k = _normed(B, L, N, D, gen), _normed(B, L, N, D, gen)
    v = torch.randn(B, L, N, D, generator=gen, device="cuda").to(torch.bfloat16)
    causal = flash_attention(q, k, v, causal=True)  # row 2 over the whole sequence
    recs["block"] = _ring_case("block", q, k, v, RING_N, causal="block")
    recs["token"] = _ring_case("token", q, k, v, RING_N, causal="token", whole=causal)
    for name, order in (("stripe", stripe_order(L, RING_N)), ("zigzag", zigzag_order(L, RING_N))):
        idx = order.to("cuda")
        recs[name] = _ring_case(name, *(t[:, idx].contiguous() for t in (q, k, v)), RING_N,
                                causal=name, whole=causal[:, idx])
    del q, k, v, causal
    torch.cuda.empty_cache()
    return recs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sp_generate(pipe, ctx, features, size, frames, steps=STEPS):
    """Denoise steps from the SP seed; (latents, denoise_step_s, ring_step
    launches of each DiT forward). Callers first run one untimed step, so
    the timed steps find NCCL's communicators, cuBLAS and the kernels warm."""
    per_forward, dit = [], pipe.low_noise.wan
    hooks = [dit.register_forward_pre_hook(lambda *a: per_forward.append(ring_step.launches)),
             dit.register_forward_hook(
                 lambda *a: per_forward.append(ring_step.launches - per_forward.pop()))]
    try:
        lat = pipe.generate(precomputed_context=ctx, precomputed_context_null=torch.zeros_like(ctx),
                            ar_vision_input=features, size=size, frame_num=frames,
                            sampling_steps=steps, guide_scale=5.0, decode=False,
                            generator=torch.Generator(device=ctx.device).manual_seed(SP_SEED))
    finally:
        for h in hooks:
            h.remove()
    return lat, pipe.timings["denoise_step_s"], per_forward


def _sp_rank(rank, world, port, tmp, device, cfg, size, frames):
    """One rank of the multi-card sp run: the seeded pipeline on its own
    card, then Ulysses and the ring at full width; rank 0 writes the
    latents and the records to `tmp`."""
    maybe_initialize_distributed(f"localhost:{port}", world, rank, device=device, local_rank=rank)
    try:
        mesh = create_mesh(sp=world, device=device)
        base, ctx, _ = t2v_pipeline(cfg, device, with_vae=False)
        features = torch.load(Path(tmp) / "features.pt").to(ctx.device)
        recs, lats = {}, {}
        for mode in ("ulysses", "ring"):
            pipe = OmniVideoX2XUnified(cfg, base.low_noise, residual_dtype="bfloat16",
                                       sp=SPConfig(mesh, mode, ring_impl="pallas"))
            _sp_generate(pipe, ctx, features, size, frames, steps=1)  # warm-up
            _reset_launches()
            lat, step_s, per_forward = _sp_generate(pipe, ctx, features, size, frames)
            recs[mode] = {"denoise_step_s": step_s, "launches": _launches(),
                          "ring_step_per_forward": per_forward}
            lats[mode] = lat.cpu()
        if rank == 0:
            torch.save(lats, Path(tmp) / "latents.pt")
            (Path(tmp) / "records.json").write_text(json.dumps(recs))
    finally:
        dist.destroy_process_group()


def sp_multi_card(world, device, cfg, features, ref, size=SIZE, frames=FRAMES) -> dict:
    """Spawn `world` ranks (one card each; "cpu": gloo, for a rehearsal),
    run Ulysses and the ring, hold each mode's latents to `ref` (SP_TOL of
    scale) and its launch counts; returns the records."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sp"))
    try:
        torch.save(features.cpu(), tmp / "features.pt")
        mp.spawn(_sp_rank, args=(world, _free_port(), str(tmp), device, cfg, size, frames),
                 nprocs=world)
        lats = torch.load(tmp / "latents.pt")
        recs = json.loads((tmp / "records.json").read_text())
    finally:
        for f in tmp.iterdir():
            f.unlink()
        tmp.rmdir()
    ref = ref.float().cpu()
    layers = cfg.dit.num_layers
    for name, rec in recs.items():
        rec["latent_rel_err"] = float((lats[name] - ref).abs().max() / ref.abs().max())
        ring = name == "ring"
        want = [layers * world if ring else 0] * STEPS
        if (rec["latent_rel_err"] > SP_TOL or rec["ring_step_per_forward"] != want
                or rec["launches"]["flash_fwd"] != (1 if ring else 2) * layers * STEPS):
            raise AssertionError(f"sp {name} on {world} ranks: {rec}, ring_step per forward "
                                 f"expected {want}")
    return recs


def phase_sp(pipe, ctx, features) -> dict:
    """The sequence-parallel generate at full width and depth: on this card
    a real NCCL process group of world size 1 runs the ring with the fused
    step (30 ring_step launches per forward: one step per block), held to
    the same pipeline's non-SP generate with the unfused attention chain
    (which SP resolves to) from the same seed and features. With 2 or more
    cards, world = min(4, count) ranks also run Ulysses and the ring (its
    two `ring_impl` names run one path) and are held to the same
    reference."""
    cfg = T2V_1_3B
    ref_pipe = OmniVideoX2XUnified(cfg, pipe.low_noise, residual_dtype="bfloat16",
                                   qk_impl="unfused")
    _sp_generate(ref_pipe, ctx, features, SIZE, FRAMES, steps=1)  # warm-up
    lat_ref, step_ref, _ = _sp_generate(ref_pipe, ctx, features, SIZE, FRAMES)
    maybe_initialize_distributed(f"localhost:{_free_port()}", 1, 0, device="cuda")
    try:
        mesh = create_mesh(sp=1, device="cuda")
        sp_pipe = OmniVideoX2XUnified(cfg, pipe.low_noise, residual_dtype="bfloat16",
                                      sp=SPConfig(mesh, "ring", ring_impl="pallas"))
        _sp_generate(sp_pipe, ctx, features, SIZE, FRAMES, steps=1)  # warm-up
        _reset_launches()
        lat_sp, step_sp, per_forward = _sp_generate(sp_pipe, ctx, features, SIZE, FRAMES)
        launches = _launches()
    finally:
        dist.destroy_process_group()
    rel = float((lat_sp - lat_ref).abs().max() / lat_ref.abs().max())
    layers = cfg.dit.num_layers
    expect = {"ring_step": layers * STEPS, "flash_fwd": layers * STEPS, "qk_prep": 0,
              "flash_causal": 0, "flash_d72": 0, "fused_adaln": 0}
    rec = {"phase": "sp", "config": "T2V_1_3B", "size": list(SIZE), "frames": FRAMES,
           "steps": STEPS, "world": 1, "mode": "ring", "ring_impl": "pallas",
           "latent_rel_err": rel, "tolerance_rel": SP_TOL, "denoise_step_s": step_sp,
           "denoise_step_s_no_sp_unfused": step_ref, "launches": launches,
           "ring_step_per_forward": per_forward}
    count = torch.cuda.device_count()
    if count >= 2:
        del sp_pipe, ref_pipe
        torch.cuda.empty_cache()
        rec["multi_card"] = {"world": min(4, count),
                             **sp_multi_card(min(4, count), "cuda", cfg, features, lat_ref)}
    else:
        print(f"sp: the multi-card half did not run: this machine has {count} CUDA device "
              "(it needs 2 or more, one per rank)", flush=True)
        rec["multi_card"] = None
    emit(rec)
    if (launches != expect or per_forward != [layers] * STEPS or rel > SP_TOL
            or not torch.isfinite(lat_sp).all()):
        raise AssertionError(f"sp: {rec} (launches expected {expect})")
    return rec


ADALN_SITES = (  # (case, (residual, gate, affine, modulation), y dtype): the DiT's call sites
    ("mod_bf16", (0, 0, 0, 1), torch.bfloat16),  # before self-attention
    ("res_gate_affine", (1, 1, 1, 0), torch.bfloat16),  # gated residual + norm3
    ("res_mod", (1, 0, 0, 1), torch.bfloat16),  # residual + modulation before the FFN
    ("head_mod_f32", (0, 0, 0, 1), torch.float32),  # the head
)


def _adaln_case(config, d, case, subset, out, gen) -> dict:
    r, g, a, m = subset
    B, L = 2, SEQ
    f = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")  # noqa: E731
    args = (2.0 + 3.0 * f(B, L, d), f(B, L, d).bfloat16() if r else None, f(B, d) if g else None,
            1.0 + 0.1 * f(d) if a else None, 0.1 * f(d) if a else None,
            f(B, d) if m else None, f(B, d) if m else None)
    x_new, y = fused_adaln(*args, eps=1e-6, out_dtype=out)
    x_ref, y_ref = fused_adaln_plain(*args, eps=1e-6, out_dtype=out)
    torch.cuda.synchronize()
    x_equal = None if x_new is None else bool(torch.equal(x_new, x_ref))
    row_max = y_ref.float().abs().amax(-1, keepdim=True)
    err = (y.float() - y_ref.float()).abs()
    if out == torch.bfloat16:
        worst, limit = float((err / bf16_ulp(row_max)).max()), ADALN_BF16_ULPS
    else:
        worst, limit = float((err / row_max).max()), ADALN_F32_TOL
    max_abs = float(err.max())
    del x_new, y, x_ref, y_ref, err
    ms = cuda_ms(lambda: fused_adaln(*args, eps=1e-6, out_dtype=out), reps=20)
    plain_ms = cuda_ms(lambda: fused_adaln_plain(*args, eps=1e-6, out_dtype=out), reps=3)
    elems = B * L * d
    per_elem = 4 + (2 + 4 if r else 0) + out.itemsize  # x, o and x_new, y
    nbytes = elems * per_elem + 4 * d * (B * (g + 2 * m) + 2 * a)
    ops = elems * (5 + r + g + 2 * a + 2 * m)  # f32 adds and multiplies per element
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    rec = {"phase": "adaln", "config": config, "case": case, "shape": [B, L, d],
           "residual": bool(r), "gate": bool(g), "affine": bool(a), "modulation": bool(m),
           "y_dtype": str(out).replace("torch.", ""), "x_new_bit_equal": x_equal,
           "max_abs_err": max_abs, "max_err_of_row_max": worst, "tolerance": limit,
           "tolerance_unit": "bf16 ulps" if out == torch.bfloat16 else "relative",
           "ms": ms, "plain_ms": plain_ms, "bytes_per_element": per_elem,
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "achieved_tb_s": nbytes / ms / 1e9}
    emit(rec)
    if worst > limit or x_equal is False:
        raise AssertionError(f"adaln {config} {case}: {rec}")
    del args
    return rec


def phase_adaln(gen: torch.Generator) -> dict:
    """The four sandwiches at A14B and 1.3B width; returns the A14B gated
    residual case (the kernels line reads it) and every record."""
    recs = [_adaln_case(cfg, d, case, subset, out, gen)
            for cfg, d in (("T2V_A14B", 5120), ("T2V_1_3B", 1536))
            for case, subset, out in ADALN_SITES]
    torch.cuda.empty_cache()
    return {"main": recs[1], "cases": recs}


def _tiny_a14b_config() -> PipelineConfig:
    """A dual-expert model at head dim 128 (the kernels' head dim), with a
    small umT5 and VAE."""
    return PipelineConfig(
        name="tiny-a14b",
        dit=WanDiTConfig(patch_size=(1, 2, 2), in_dim=4, dim=256, ffn_dim=512, freq_dim=32,
                         text_dim=64, out_dim=4, num_heads=2, num_layers=2),
        vae=VAEConfig(dim=8, z_dim=4),
        t5=T5Config(vocab_size=97, dim=64, dim_attn=64, dim_ffn=128, num_heads=4, num_layers=2,
                    num_buckets=8, text_len=16),
        vlm_in_dim=24, max_context_len=96, dual_expert=True, sample_shift=12.0)


class _ForwardLaunches:
    """Per DiT forward of each expert: fused_adaln launches (hooks)."""

    def __init__(self, pipe):
        self.per_forward = {"high": [], "low": []}
        for name in ("high", "low"):
            dit = getattr(pipe, f"{name}_noise").wan
            dit.register_forward_pre_hook(lambda *a: setattr(self, "start", fused_adaln.launches))
            dit.register_forward_hook(lambda *a, n=name: self.per_forward[n].append(
                fused_adaln.launches - self.start))


def phase_tiny_a14b() -> dict:
    """The A14B path at tiny width on the card (kernels) vs the CPU (plain
    twins): umT5 encode of seeded ids (bf16), VAE encode of a seeded clip
    (f32), then a V2V dual-expert generate with both solvers from the same
    weights and noise, decoded."""
    cfg = _tiny_a14b_config()
    gen = torch.Generator().manual_seed(31)
    t5_cpu = init_t5(cfg.t5, device="cpu", seed=7)
    t5_gpu = init_t5(cfg.t5, device="cuda", seed=7)
    t5_gpu.load_state_dict(t5_cpu.state_dict())
    ids = torch.from_numpy(np.random.default_rng(8).integers(0, 97, (2, 16)))
    mask = torch.ones(2, 16, dtype=torch.int64)
    mask[1, 11:] = 0
    ctx_cpu = T5EncoderModel(t5_cpu).encode_ids(ids, mask)
    ctx_gpu = [c.cpu() for c in T5EncoderModel(t5_gpu).encode_ids(ids, mask)]
    t5_rel = max(float((g - c).abs().max() / c.abs().max()) for c, g in zip(ctx_cpu, ctx_gpu))

    pipe_cpu = OmniVideoX2XUnified.random_init(cfg, seed=5, device="cpu", ew_impl="kernel")
    pipe_gpu = OmniVideoX2XUnified.random_init(cfg, seed=5, device="cuda", ew_impl="kernel")
    for name in ("low", "high"):
        src, dst = getattr(pipe_cpu, f"{name}_noise"), getattr(pipe_gpu, f"{name}_noise")
        with torch.no_grad():
            src.wan.head.head.weight.normal_(0.0, 0.1, generator=gen)
        dst.wan.load_state_dict(src.wan.state_dict())
    for src, dst in ((pipe_cpu.vae.params, pipe_gpu.vae.params),
                     (pipe_cpu.low_noise.companions, pipe_gpu.low_noise.companions)):
        _copy_tree(src, dst)
    clip = torch.rand(1, 3, 9, 64, 64, generator=gen) * 2 - 1
    vis_cpu = pipe_cpu.vae.encode(clip)[0]
    vis_gpu = pipe_gpu.vae.encode(clip.cuda())[0].cpu()
    enc_rel = float((vis_gpu - vis_cpu).abs().max() / vis_cpu.abs().max())
    counts = _ForwardLaunches(pipe_gpu)
    noise = torch.randn(1, 4, 3, 8, 8, generator=gen)
    arv = torch.randn(6, 24, generator=gen)
    solvers = {}
    for solver in ("unipc", "dpm++"):
        counts.per_forward = {"high": [], "low": []}
        out = {}
        for dev, pipe, ctx, vis in (("cpu", pipe_cpu, ctx_cpu, vis_cpu),
                                    ("cuda", pipe_gpu, ctx_gpu, vis_gpu)):
            lat = pipe.generate(precomputed_context=ctx[0], precomputed_context_null=ctx[1],
                                ar_vision_input=arv, visual_emb=vis, size=(64, 64), frame_num=9,
                                sampling_steps=A14B_STEPS, shift=cfg.sample_shift,
                                guide_scale=cfg.sample_guide_scale, sample_solver=solver,
                                decode=False, noise=noise)
            out[dev] = (lat.cpu(), pipe.decode(lat).cpu())
        (lat_c, vid_c), (lat_g, vid_g) = out["cpu"], out["cuda"]
        solvers[solver] = {
            "latent_rel_err": float((lat_g - lat_c).abs().max() / lat_c.abs().max()),
            "video_max_abs_err": float((vid_g - vid_c).abs().max()),
            "fused_adaln_per_forward": dict(counts.per_forward)}
    per_fwd = 3 * cfg.dit.num_layers + 1
    rec = {"phase": "tiny_a14b", "t5_rel_err": t5_rel, "t5_tolerance_rel": 5e-2,
           "vae_encode_rel_err": enc_rel, "vae_encode_tolerance_rel": ENCODE_TOL,
           "solvers": solvers, "tolerance": 5e-2, "expected_fused_adaln_per_forward": per_fwd}
    emit(rec)
    bad = [n for n, r in solvers.items()
           if r["latent_rel_err"] > 5e-2 or r["video_max_abs_err"] > 5e-2
           or r["fused_adaln_per_forward"] != {"high": [per_fwd] * 2, "low": [per_fwd]}]
    if t5_rel > 5e-2 or enc_rel > ENCODE_TOL or bad:
        raise AssertionError(f"tiny_a14b: {rec}")
    return rec


def phase_a14b(ar_vision: torch.Tensor) -> dict:
    """T2V-A14B at full width and depth: umT5-XXL encode (then freed), VAE
    encode of the source clip, the dual-expert V2V generate in the f32
    parity mode with both fused kernels, experts freed, VAE decode."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = T2V_A14B
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t5 = init_t5(cfg.t5, dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    t5_init_s = time.perf_counter() - t0
    t5_gb = sum(p.numel() * p.element_size() for p in t5.parameters()) / 1e9
    ids = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.t5.vocab_size, (2, T5_IDS)))
    t0 = time.perf_counter()
    context, context_null = T5EncoderModel(t5).encode_ids(ids, torch.ones_like(ids))
    torch.cuda.synchronize()
    t5_s = time.perf_counter() - t0
    t5_peak = torch.cuda.max_memory_allocated() / 1e9
    del t5
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(4)
    vae = Wan21VAE.create(init_vae(cfg.vae, device="cuda", generator=gen), cfg.vae)
    clip = torch.randint(0, 256, (1, 3, FRAMES, SIZE[1], SIZE[0]), generator=gen,
                         device="cuda").float() / 127.5 - 1.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    visual_emb = vae.encode(clip)[0]
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    del clip
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    pipe = OmniVideoX2XUnified.random_init(cfg, seed=0, device="cuda", with_vae=False,
                                           qk_impl="kernel", ew_impl="kernel")
    pipe.vae = vae
    with torch.no_grad():  # init zero-fills the heads: make velocities non-zero
        for head in (pipe.high_noise.wan.head.head, pipe.low_noise.wan.head.head):
            head.weight.normal_(0.0, cfg.dit.dim**-0.5, generator=gen)
    del head  # hold no reference to an expert past free_experts()
    torch.cuda.synchronize()
    experts_init_s = time.perf_counter() - t0
    n_params = [sum(p.numel() for p in e.wan.parameters()) for e in (pipe.high_noise,
                                                                    pipe.low_noise)]
    experts_gb = sum(p.numel() * p.element_size() for e in (pipe.high_noise, pipe.low_noise)
                     for p in e.wan.parameters()) / 1e9
    counts = _ForwardLaunches(pipe)
    _reset_launches()
    latents = pipe.generate(precomputed_context=context, precomputed_context_null=context_null,
                            ar_vision_input=ar_vision, visual_emb=visual_emb, size=SIZE,
                            frame_num=FRAMES, sampling_steps=A14B_STEPS, shift=cfg.sample_shift,
                            guide_scale=cfg.sample_guide_scale, decode=False, generator=gen)
    launches = _launches()
    per_forward = {k: list(v) for k, v in counts.per_forward.items()}
    timings = dict(pipe.timings)
    per_fwd = 3 * cfg.dit.num_layers + 1
    expect = {"qk_prep": 4 * cfg.dit.num_layers * A14B_STEPS,
              "flash_fwd": 2 * cfg.dit.num_layers * A14B_STEPS, "flash_causal": 0,
              "flash_d72": 0, "fused_adaln": per_fwd * A14B_STEPS, "ring_step": 0}
    dit = pipe.high_noise.wan
    with torch.inference_mode():
        x2 = torch.cat([latents, latents]).bfloat16()
        ctx2 = dit.embed_context(torch.randn(2, cfg.max_context_len, cfg.dit.text_dim,
                                             generator=gen, device="cuda").bfloat16())
        t = torch.full((2,), 999.0, device="cuda")
        profile = _profile(lambda: dit(x2, t, ctx2, context_embedded=True, ew_impl="kernel"))
    del x2, ctx2, dit
    denoise_peak = torch.cuda.max_memory_allocated() / 1e9
    pipe.free_experts()
    after_free_gb = torch.cuda.memory_allocated() / 1e9
    frames = pipe.decode(latents, output_uint8=True)
    shape = tuple(frames.shape)
    rec = {"phase": "a14b", "config": "T2V_A14B", "layers": cfg.dit.num_layers, "dim": cfg.dit.dim,
           "heads": cfg.dit.num_heads, "ffn_dim": cfg.dit.ffn_dim, "params_per_expert": n_params,
           "experts_weights_gb": experts_gb, "t5_weights_gb": t5_gb, "t5_ids": T5_IDS,
           "t5_init_s": t5_init_s, "t5_s": t5_s, "t5_peak_gb": t5_peak, "encode_s": encode_s,
           "visual_emb": list(visual_emb.shape), "experts_init_s": experts_init_s,
           "seq_len": SEQ, "context_len": cfg.max_context_len, "size": list(SIZE),
           "frames": FRAMES, "steps": A14B_STEPS, "shift": cfg.sample_shift,
           "timesteps": [float(t) for t in FlowUniPC.create(A14B_STEPS, shift=cfg.sample_shift)
                         .timesteps], "residual_dtype": "float32",
           "ar_vision_input": list(ar_vision.shape),
           "denoise_s": timings["denoise_s"], "denoise_step_s": timings["denoise_step_s"],
           "decode_s": pipe.timings["decode_s"], "launches": launches,
           "fused_adaln_per_forward": per_forward,
           "frames_shape": list(shape), "frames_mean": float(frames.float().mean()),
           "denoise_peak_gb": denoise_peak, "allocated_after_free_gb": after_free_gb,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "profile_one_forward": profile}
    emit(rec)
    if (launches != expect or per_forward != {"high": [per_fwd] * 2, "low": [per_fwd]}
            or shape != (FRAMES, SIZE[1], SIZE[0], 3) or rec["max_memory_allocated_gb"] >= 80.0
            or after_free_gb > 2.0
            or tuple(visual_emb.shape) != (cfg.vae.z_dim, (FRAMES - 1) // 4 + 1,
                                           SIZE[1] // 8, SIZE[0] // 8)):
        raise AssertionError(f"a14b: launches {launches} (expected {expect}), per forward "
                             f"{per_forward}, frames {shape}")
    del pipe, vae, latents, frames
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _grad_rel(g: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """‖g − ref‖ / ‖ref‖ per (batch row, head) of [B, L, N, D] gradients."""
    num = (g.float() - ref.float()).square().sum(dim=(1, 3)).sqrt()
    return num / ref.float().square().sum(dim=(1, 3)).sqrt().clamp_min(1e-30)


def _bwd_launcher(name, q, k, v, do, lse, delta, kv, outs, scale):
    """One backward kernel, called on the library directly (timing only:
    these launches are not counted)."""
    lib = _kernels.library()
    B, Lq, N, D = q.shape
    lens = kv.to(torch.int32).contiguous() if kv is not None else None
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(o.data_ptr() for o in outs),
            lens.data_ptr() if lens is not None else None, B, Lq, k.shape[1], N, D, scale,
            torch.cuda.current_stream().cuda_stream)
    fn = getattr(lib, name + "_launch")
    return lambda: _kernels.check(fn(*args), name)


def _flash_train_case(name, B, Lq, Lk, lens, gen, reps):
    N, D = 12, 128
    scale = D**-0.5
    q, k = _normed(B, Lq, N, D, gen), _normed(B, Lk, N, D, gen)
    v = torch.randn(B, Lk, N, D, generator=gen, device="cuda").to(torch.bfloat16)
    do = torch.randn(B, Lq, N, D, generator=gen, device="cuda").to(torch.bfloat16)
    kv = torch.tensor(lens, dtype=torch.int32, device="cuda") if lens else None
    o, lse = flash_fwd_lse(q, k, v, kv)
    op, lsep = flash_fwd_lse_plain(q, k, v, kv)
    delta = flash_delta(do, op)
    grads = flash_bwd(q, k, v, do, lsep, delta, kv)
    ref = flash_bwd_plain(q, k, v, do, lsep, delta, kv)
    torch.cuda.synchronize()
    live = [b for b in range(B) if not lens or lens[b] > 0]
    dead = [b for b in range(B) if b not in live]
    ulps = float(row_ulps(o, op).max())
    lse_err = float((lse[live] - lsep[live]).abs().max())
    grad_err = {n: float(_grad_rel(g[live], r[live]).max()) for n, g, r in zip(
        ("dq", "dk", "dv"), grads, ref)}
    again = flash_bwd(q, k, v, do, lsep, delta, kv)
    deterministic = all(torch.equal(a, b) for a, b in zip(grads, again))  # bit for bit
    del again
    zero_ok = all(bool((t[b] == 0).all()) for b in dead for t in (o, *grads))
    if lens:
        zero_ok &= all(bool((g[b, lens[b]:] == 0).all()) for b in live for g in grads[1:])
    rec = {"phase": "flash_train", "case": name, "q": [B, Lq, N, D], "Lk": Lk,
           "kv_lens": lens, "max_row_ulps_o": ulps, "tolerance_row_ulps": FLASH_ULPS,
           "max_abs_err_lse": lse_err, "tolerance_lse": LSE_TOL,
           "max_rel_err_per_head": grad_err, "tolerance_grad": GRAD_TOL, "zero_rows_ok": zero_ok,
           "bwd_deterministic": deterministic,
           "max_abs_err": {"o": float((o.float() - op.float()).abs().max()),
                           **{n: float((g - r).abs().max()) for n, g, r in zip(
                               ("dq", "dk", "dv"), grads, ref)}}}
    if (ulps > FLASH_ULPS or lse_err > LSE_TOL or max(grad_err.values()) > GRAD_TOL
            or not zero_ok or not deterministic or not all(torch.isfinite(g).all() for g in grads)):
        raise AssertionError(f"flash_train {name}: {rec}")
    # times: each kernel alone, the plain twins, SDPA forward and backward
    dq_out, dk_out, dv_out = (torch.empty_like(g) for g in grads)
    dq_fn = _bwd_launcher("flash_bwd_dq", q, k, v, do, lsep, delta, kv, (dq_out,), scale)
    dkv_fn = _bwd_launcher("flash_bwd_dkv", q, k, v, do, lsep, delta, kv, (dk_out, dv_out), scale)
    lib = _kernels.library()
    lens_i = kv.contiguous() if kv is not None else None
    o_out = torch.empty_like(q)
    fwd_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o_out.data_ptr(), lse.data_ptr(),
                lens_i.data_ptr() if lens_i is not None else None, B, Lq, Lk, N, D,
                flash_mod._qscale(scale), torch.cuda.current_stream().cuda_stream)
    rec["ms"] = {"flash_fwd_lse": cuda_ms(lambda: _kernels.check(
        lib.flash_fwd_lse_launch(*fwd_args), "flash_fwd_lse"), reps),
        "flash_bwd_dq": cuda_ms(dq_fn, reps), "flash_bwd_dkv": cuda_ms(dkv_fn, reps)}
    rec["plain_ms"] = {"fwd": cuda_ms(lambda: flash_fwd_lse_plain(q, k, v, kv), 1, 0),
                       "bwd": cuda_ms(lambda: flash_bwd_plain(q, k, v, do, lsep, delta, kv),
                                      1, 0)}
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    mask = None
    if kv is not None:
        mask = (torch.arange(Lk, device="cuda")[None, :] < kv[:, None])[:, None, None, :]
        mask = mask | ~mask.any(-1, keepdim=True)  # SDPA gives NaN for a row with no key
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,  # noqa: E731
                                                                    attn_mask=mask)
    out = sdpa()
    dot = do.transpose(1, 2).contiguous()
    rec["library_ms"] = {"sdpa_fwd": cuda_ms(lambda: sdpa().detach(), reps),
                         "sdpa_bwd": cuda_ms(lambda: torch.autograd.grad(
                             out, (qt, kt, vt), dot, retain_graph=True), reps)}
    # bounds from this run's data: live (row, key) pairs, each operand read once
    live_pairs = sum(Lq * (min(lens[b], Lk) if lens else Lk) for b in range(B))
    kv_rows = sum(min(lens[b], Lk) if lens else Lk for b in range(B))
    q_rows = Lq * len(live)
    row = N * D
    stat = B * N * Lq * 4  # one f32 per (b, head, q row)
    nbytes = {"flash_fwd_lse": (q_rows + 2 * kv_rows) * row * 2 + B * Lq * row * 2 + stat,
              "flash_bwd_dq": (2 * q_rows + 2 * kv_rows) * row * 2 + 2 * stat + B * Lq * row * 4,
              "flash_bwd_dkv": (2 * q_rows + 2 * kv_rows) * row * 2 + 2 * stat
              + 2 * B * Lk * row * 4}
    ops = {"flash_fwd_lse": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}
    rec["bound_ms"], rec["bound_by"], rec["tflops"], rec["share_of_bound"] = {}, {}, {}, {}
    for kname, n_ops in ops.items():
        flop = n_ops * N * live_pairs * D
        t_ops = flop / BF16_FLOPS * 1e3
        t_bytes = nbytes[kname] / HBM_BYTES_PER_S * 1e3
        rec["bound_ms"][kname] = max(t_ops, t_bytes)
        rec["bound_by"][kname] = "operations" if t_ops >= t_bytes else "bytes"
        rec["tflops"][kname] = flop / (rec["ms"][kname] * 1e-3) / 1e12
        rec["share_of_bound"][kname] = rec["bound_ms"][kname] / rec["ms"][kname]
    emit(rec)
    del q, k, v, do, o, op, grads, ref, qt, kt, vt, out
    torch.cuda.empty_cache()
    return rec


def phase_flash_train(gen: torch.Generator) -> dict:
    """Rows 3b, 4 and 5 at the training path's shapes; returns the
    self-attention case (the kernels line reads it)."""
    main = _flash_train_case("self", 1, SEQ, SEQ, None, gen, reps=3)
    _flash_train_case("cross", 1, SEQ, 6272, None, gen, reps=5)
    _flash_train_case("kv_lens_ragged", 2, 4100, 8190, [5001, 0], gen, reps=5)
    return main


def _tiny_train_config() -> PipelineConfig:
    """2 layers at head dim 128 (the kernels' head dim), a 62-token mixed
    context (6 VLM + 8 text + 48 visual) inside a 64-token budget."""
    return PipelineConfig(
        name="tiny-train",
        dit=WanDiTConfig(patch_size=(1, 2, 2), in_dim=4, dim=256, ffn_dim=512, freq_dim=32,
                         text_dim=48, out_dim=4, num_heads=2, num_layers=2),
        vae=VAEConfig(dim=8, z_dim=4), vlm_in_dim=24, max_context_len=64)


def _train_launches() -> dict:
    return dict(flash_attention_train.launches)


def _reset_train_launches() -> None:
    for name in flash_attention_train.launches:
        flash_attention_train.launches[name] = 0


def phase_tiny_train() -> dict:
    """The unified train step on the card (kernels) vs on the CPU (plain
    twins): same weights (the DiT head filled), batch and draws, 3 steps."""
    cfg = _tiny_train_config()
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10, cfg_dropout=0.5)
    gen = torch.Generator().manual_seed(21)
    cpu = init_unified_params(cfg, seed=4, device="cpu")
    with torch.no_grad():
        cpu.wan.head.head.weight.normal_(0.0, 0.1, generator=gen)
    gpu = init_unified_params(cfg, seed=4, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    lat = (2, 4, 3, 16, 16)
    batch = {"latents": torch.randn(lat, generator=gen),
             "context": torch.cat([torch.randn(2, 5, 48, generator=gen), torch.zeros(2, 3, 48)], 1),
             "vlm": torch.randn(2, 6, 24, generator=gen),
             "visual_emb": torch.randn(lat, generator=gen)}
    draws = [sample_draws(gen, lat, tc) for _ in range(TRAIN_STEPS)]
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        tx = make_optimizer(tc, model)
        state = init_train_state(model, tx)
        step = make_unified_train_step(cfg, tc, tx)
        _reset_train_launches()
        rows = []
        for d in draws:
            state, m = step(state, batch, d)
            rows.append((float(m["loss"]), float(m["grad_norm"])))
        out[dev] = (rows, _train_launches())
    (cpu_rows, _), (gpu_rows, launches) = out["cpu"], out["cuda"]
    loss_gap = max(abs(g[0] / c[0] - 1) for c, g in zip(cpu_rows, gpu_rows))
    gn_gap = max(abs(g[1] / c[1] - 1) for c, g in zip(cpu_rows, gpu_rows))
    n_attn = 2 * cfg.dit.num_layers * TRAIN_STEPS
    expect = {"flash_fwd_lse": 2 * n_attn, "flash_bwd_dq": n_attn, "flash_bwd_dkv": n_attn}
    rec = {"phase": "tiny_train", "steps": TRAIN_STEPS, "loss_cpu": [r[0] for r in cpu_rows],
           "loss_gpu": [r[0] for r in gpu_rows], "grad_norm_cpu": [r[1] for r in cpu_rows],
           "grad_norm_gpu": [r[1] for r in gpu_rows], "loss_rel_gap": loss_gap,
           "grad_norm_rel_gap": gn_gap, "tolerance_rel": TRAIN_TOL, "launches": launches}
    emit(rec)
    if loss_gap > TRAIN_TOL or gn_gap > TRAIN_TOL or launches != expect:
        raise AssertionError(f"tiny_train: {rec} (launches expected {expect})")
    return rec


def _profile(fn) -> dict:
    """fn() once under torch.profiler: device time by kernel class (device-side
    events only; one stream, so they do not overlap), the top kernels, and the
    device's idle share of the traced wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class, by_name = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        by_name[ev.key] = by_name.get(ev.key, 0.0) + ms
        c = _kernel_class(ev.key)
        by_class[c] = by_class.get(c, 0.0) + ms
    busy = sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms_traced": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def phase_train() -> dict:
    """make_unified_train_step on T2V_1_3B at full width and depth."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = T2V_1_3B
    # the JAX CLI's learning rate, 3e-6: Adam's first step moves every param by ~lr,
    # and 1e-4 on all 1.43B params overshoots (loss 2.87 → 17.6 on this batch)
    tc = TrainConfig(warmup_steps=0, total_steps=1000, remat=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_unified_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    with torch.no_grad():  # init zero-fills the head: every block gradient would be 0
        params.wan.head.head.weight.normal_(0.0, cfg.dit.dim**-0.5, generator=gen)
    lat = (1, cfg.dit.in_dim, GRID[0], GRID[1] * 2, GRID[2] * 2)
    batch = {"latents": torch.randn(lat, generator=gen, device="cuda"),
             "context": torch.randn(1, CTX_LEN, cfg.dit.text_dim, generator=gen, device="cuda"),
             "vlm": torch.randn(1, CTX_LEN, cfg.vlm_in_dim, generator=gen, device="cuda"),
             "visual_emb": torch.randn(lat, generator=gen, device="cuda")}
    draws = sample_draws(gen, lat, tc)
    tx = make_optimizer(tc, params)
    state = init_train_state(params, tx)
    step = make_unified_train_step(cfg, tc, tx)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    rows, step_s, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        _reset_launches()
        _reset_train_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, draws)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        rows.append((loss, gnorm))
        per_step.append({**_train_launches(), **_launches()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_attn = 2 * cfg.dit.num_layers
    expect = {"flash_fwd_lse": 2 * n_attn, "flash_bwd_dq": n_attn, "flash_bwd_dkv": n_attn,
              "qk_prep": 0, "flash_fwd": 0, "flash_causal": 0, "flash_d72": 0, "fused_adaln": 0,
              "ring_step": 0}
    profile = _profile(lambda: step(state, batch, draws))
    rec = {"phase": "train", "config": "T2V_1_3B", "layers": cfg.dit.num_layers,
           "dim": cfg.dit.dim, "params": n_params, "latents": list(lat), "seq_len": SEQ,
           "context_len": cfg.max_context_len, "remat": tc.remat, "carry_dtype": tc.carry_dtype,
           "lr": tc.learning_rate, "tid": int(draws[0][0]), "cfg_drop": bool(draws[2][0]),
           "init_s": init_s, "loss": [r[0] for r in rows], "grad_norm": [r[1] for r in rows],
           "step_s": step_s, "train_step_s": sum(step_s[1:]) / (len(step_s) - 1),
           "max_memory_allocated_gb": peak_gb, "launches_per_step": per_step,
           "profile_one_step": profile}
    emit(rec)
    finite = all(np.isfinite(r[0]) and np.isfinite(r[1]) for r in rows)
    if (not finite or not rows[-1][0] < rows[0][0] or any(p != expect for p in per_step)
            or peak_gb >= 80.0):
        raise AssertionError(f"train: {rec} (launches expected {expect} per step)")
    rec["launches"] = per_step[0]
    del state, params, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _kernel_class(name: str) -> str:
    row = kernel_row(name)
    if row is not None:
        return row
    if any(s in name.lower() for s in ("gemm", "xmma", "cutlass", "sm90_", "nvjet")):
        return "gemm"
    if "elementwise" in name or "vectorized" in name or "unrolled" in name:
        return "elementwise"
    if "reduce" in name.lower():
        return "reduce"
    return "other"


def phase_profile() -> dict:
    """One full-size T2V-1.3B DiT forward (CFG batch 2, 32,760 tokens, bf16
    residual) under torch.profiler, after an untraced one."""
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
        rec = {"phase": "profile",
               "what": "one DiT forward, T2V_1_3B, B=2, L=32760, bf16 residual",
               "wall_ms_untraced": wall_ms, **_profile(fwd)}
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
    if argv[:1] == ["sp"]:
        phase_device()
        pipe, ctx, gen = t2v_pipeline(T2V_1_3B, "cuda")
        phase_sp(pipe, ctx, torch.randn(1450, QWEN3_VL_30B_A3B.text.hidden_size,
                                        generator=gen, device="cuda"))
        return 0
    if argv:
        raise SystemExit(f"chip_smoke: unknown arguments {argv} (only 'profile' or 'sp')")
    dev = phase_device()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        return _all_phases(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _all_phases(dev: dict, tmp: Path) -> int:
    """Every phase in order, then the kernel summary and the last line."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    qk = phase_qk_prep(gen)
    fl = phase_flash(gen)
    ft = phase_flash_train(gen)
    phase_tiny()
    phase_tiny_vlm()
    phase_tiny_train()
    clip = write_clip(tmp / "clip_720p.npz")
    vlm = phase_vlm(clip)
    features = vlm.pop("features")
    e2e_rec = phase_e2e(features)
    e2e = e2e_rec["launches"]
    phase_load(e2e_rec["pipe"].low_noise, tmp)
    phase_cli(clip, tmp)
    ring = phase_ring(gen)
    sp = phase_sp(e2e_rec.pop("pipe"), e2e_rec.pop("ctx"), features)
    del e2e_rec
    gc.collect()
    torch.cuda.empty_cache()
    adaln = phase_adaln(gen)["main"]
    phase_tiny_a14b()
    a14b = phase_a14b(features)
    del features
    train = phase_train()
    launches = {"qk_prep": e2e["qk_prep"], "flash_fwd": e2e["flash_fwd"],
                "flash_causal": vlm["launches"]["flash_causal"],
                "flash_d72": vlm["launches"]["flash_d72"],
                "fused_adaln": a14b["launches"]["fused_adaln"],
                **{k: sum(p[k] for p in train["launches_per_step"])
                   for k in flash_attention_train.launches}}
    kernels = [
        {"name": "qk_prep", "route": "cuda", "source": "omnivideo_tpu_torch/csrc/qk_prep.cu",
         "replaces": "omnivideo_tpu/ops/pallas/qk_prep.py:41",
         "launches": launches["qk_prep"], "max_abs_err": qk["max_abs_err"],
         "ms": qk["ms"], "plain_ms": qk["plain_ms"], "bound_ms": qk["bound_ms"],
         "bound_by": qk["bound_by"], "library_ms": None},
    ]
    for name in ("flash_fwd", "flash_causal", "flash_d72"):
        rec = fl[name]
        kernels.append(
            {"name": name, "route": "cuda", "source": "omnivideo_tpu_torch/csrc/flash_fwd.cu",
             "replaces": "omnivideo_tpu/ops/pallas/flash_attention.py:42",
             "launches": launches[name], "max_abs_err": rec["max_abs_err"],
             "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
             "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    outputs = {"flash_fwd_lse": ("o",), "flash_bwd_dq": ("dq",), "flash_bwd_dkv": ("dk", "dv")}
    replaces = {"flash_fwd_lse": "omnivideo_tpu/ops/pallas/flash_attention.py:42",
                "flash_bwd_dq": "omnivideo_tpu/ops/pallas/flash_attention.py:485",
                "flash_bwd_dkv": "omnivideo_tpu/ops/pallas/flash_attention.py:530"}
    for name, line in replaces.items():
        src = "flash_fwd.cu" if name == "flash_fwd_lse" else "flash_train.cu"
        lib = ft["library_ms"]["sdpa_fwd" if name == "flash_fwd_lse" else "sdpa_bwd"]
        kernels.append(
            {"name": name, "route": "cuda", "source": f"omnivideo_tpu_torch/csrc/{src}",
             "replaces": line, "launches": launches[name],
             "max_abs_err": max(ft["max_abs_err"][o] for o in outputs[name]),
             "ms": ft["ms"][name],
             "plain_ms": ft["plain_ms"]["fwd" if name == "flash_fwd_lse" else "bwd"],
             "bound_ms": ft["bound_ms"][name], "bound_by": ft["bound_by"][name],
             "library_ms": lib})
    kernels.append(
        {"name": "fused_adaln", "route": "cuda", "source": "omnivideo_tpu_torch/csrc/adaln.cu",
         "replaces": "omnivideo_tpu/ops/pallas/adaln.py:37", "launches": launches["fused_adaln"],
         "max_abs_err": adaln["max_abs_err"], "ms": adaln["ms"], "plain_ms": adaln["plain_ms"],
         "bound_ms": adaln["bound_ms"], "bound_by": adaln["bound_by"], "library_ms": None})
    main_ring = ring["sp1_main"]
    kernels.append(
        {"name": "ring_step", "route": "cuda", "source": "omnivideo_tpu_torch/csrc/ring_step.cu",
         "replaces": "omnivideo_tpu/ops/pallas/ring_attention.py:36",
         "launches": sp["launches"]["ring_step"], "max_abs_err": main_ring["max_abs_err"],
         "ms": main_ring["ms"], "plain_ms": main_ring["plain_ms"],
         "bound_ms": main_ring["bound_ms"], "bound_by": main_ring["bound_by"],
         "library_ms": main_ring["library_ms"]})
    if any(k["launches"] == 0 for k in kernels):
        raise AssertionError(f"a kernel of the main paths never launched: {launches}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
