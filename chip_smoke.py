"""GPU smoke test of the PyTorch/CUDA port (omnivideo_tpu_torch) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py profile    # device time by kernel class, one DiT forward
    python3 chip_smoke.py sp         # the sp phase alone (VLM features seeded): on a
                                     # machine with 2+ cards its multi-card half runs
    python3 chip_smoke.py sp_train   # the train phase (its reference), then sp_train:
                                     # with 2+ cards its multi-card part runs
    python3 chip_smoke.py lora       # the train phase (AdamW's yardstick), then lora
    python3 chip_smoke.py adafactor  # the train phase, then adafactor
    python3 chip_smoke.py qwen3_sp   # the vlm phase, with its text-only pass and qwen3_sp
    python3 chip_smoke.py sft        # tiny_sft, then sft
    python3 chip_smoke.py sft_sp     # the f32 ring step's and backward's cases, then the
                                     # SFT step under --sp at world 1 beside its one-card
                                     # step: with 2+ cards the SFT modes and
                                     # qwen3_forward_sp across the cards too
    python3 chip_smoke.py i2v        # flash (with the pair), then tiny_i2v, i2v, vae22
                                     # and xlm
    python3 chip_smoke.py stream     # cli and a14b (experts kept on the host), then stream
    python3 chip_smoke.py stream_train  # the streamed trainers' phase alone
    python3 chip_smoke.py serve      # e2e (VLM features seeded), then serve, export and
                                     # eval_videos on its pipeline
    python3 chip_smoke.py gmm        # the MoE's grouped products (rows 9, 9b) alone
    python3 chip_smoke.py vlm_fsdp   # the vlm model, then vlm_fsdp: with 2+ cards its
                                     # multi-card part runs

Phases, each printing one JSON line; any failure raises (non-zero exit):
  device    card name and power limit, torch/CUDA versions, precision
            switches, kernel build time and nvcc's register/spill report
            per kernel row (fails if a row is missing from it, or if
            ptxas serialised a kernel's wgmma: a C75xx warning);
  qk_prep   the qk_prep CUDA kernel against qk_prep_plain on the card at the
            T2V-1.3B shapes (RoPE self-attention q/k, norm-only context k, a
            sequence longer than the RoPE table) and at the 14B models'
            RoPE self-attention q/k ([2, 32760, 5120], 40 heads: the a14b
            and i2v paths);
  flash     the flash CUDA kernel against the q-chunked flash_attention_plain
            at the DiT's shapes (bounded self- and cross-attention, self at
            T2V-A14B's 40 heads, a forced max-tracked case, a ragged kv_lens,
            I2V-14B's cross-attention over 257 and over 512 keys apart), and
            the pair kernel (flash_pair) against flash_attention_pair_plain
            at I2V-14B's [2, 32760, 40, 128] over 512 + 257 keys (three
            reruns bit-equal, the two SDPA calls and their sum as its
            yardstick) and with one context's guard failed
            case with one fully masked batch row, I2V-14B's split
            cross-attention: [2, 32760, 40, 128] q over the 257 CLIP keys and
            over the 512 text keys, bounded), the Qwen3 prefill's
            (causal, head dim 128, with and without kv_lens) and the vision
            tower's (head dim 72: bounded, forced max-tracked, kv_lens, and
            kv_lens with NaN in the K/V rows past it), each output row held
            to its own scale; each kernel timed alone at its C entry point
            and through the wrapper, scaled_dot_product_attention timed
            beside it as a yardstick only;
  gmm       rows 9 (gmm) and 9b (tgmm) of csrc/gmm.cu against their plain
            twins at Qwen3-VL-30B-A3B's MoE (128 experts, top-8, 2,048 →
            768 → 2,048) with routing from a seeded router over a skewed
            draw: the vlm phase's prefill (11,848 rows, bf16), a decode step
            (8 rows), the SFT's f32 step (16,384 rows: forward, the input's
            gradient through the transposed bank, the bank's by tgmm), tgmm
            in bf16; the prefill's and the decode's gate/up and down at the
            widths of the banks split over 2 and 4 cards (vlm_fsdp: n and k
            384 or 192); one expert with every row, group sizes summing below m
            (those rows exactly zero), half the experts empty, the few-row
            schedule at 1 and 64 rows, tgmm with each group's neighbours
            1000x larger and NaN past the sum; bf16 rows within
            GMM_BF16_ULPS of each row's max, f32 within GMM_F32_TOL, tgmm
            per group's block, the same bits on a second call; each case's
            schedule (ops.gmm.gmm_schedule), ms through the wrapper,
            kernel_ms (the profiler's device time), plain_ms, bound_ms (f32:
            three TF32 products, FFMA's beside it), and torch._grouped_mm's
            ms beside them as a yardstick;
  tiny      a small generate() on the card (kernels) against the same
            weights and noise on the CPU (plain versions);
  tiny_vlm  a small Qwen3-VL (vision head dim 72, text head dim 128) on the
            card against the same weights on the CPU: features and greedy
            tokens with every token routed to all experts, and features at
            top-2 of 8 experts with the CPU's routing replayed on the card;
  tiny_sft  the sft_vlm CLI's --tiny SFT (its Qwen3 and alignment chain) on
            the card against the CPU from the same weights and batch, 3
            steps each of LM-only, combined (align_weight 1) and bare LoRA
            rank 4: loss and grad_norm within SFT_TOL;
  vlm       first stage 1 of the data pipeline: vae_feature_extract
            --random_weights on the seeded 720p clip file at 832x480x81 (the
            file's keys and latent shape); then
            Qwen3-VL-30B-A3B at full width and VLM_LAYERS of its 48 text
            layers from seeded random weights (bf16, on the card; ~62 GB at
            full depth): 6 seeded 832x480 frames →
            frames_to_patches (grid 3x30x52, 1,170 visual tokens), synthetic
            ids (L ~ 1.5k), the feature forward, a 16-token greedy decode,
            launch counts asserted (three gmm launches a MoE layer a pass
            here and on every MoE path below, tgmm in the SFT's), the
            feature forward and decode again through the per-expert
            torch.matmul MoE (the port's before rows 9/9b), recording its
            routing, then through the kernels with that routing replayed:
            features within VLM_PATH_TOL of scale, greedy tokens equal up
            to a near-tie; the top-8-of-128 grouped MoE of layer 0
            against its all-experts oracle, a profile of one feature
            forward (its idle share); then the engine (Qwen3VLEngine.from_model with a
            stand-in tokenizer) on a seeded 1280x720, 48-frame, 24 fps clip
            file: source caption (grid 3x44x80 at 704x1280), target caption
            (text only), features (grid 3x2x2 at 32x32), each pass's
            launches (27 flash_d72 with a clip, a flash_causal per text
            layer), grids and
            feature shape asserted; the image path: the engine's image
            message on a seeded 1280x720 PNG still (grid 1x44x80, 880
            <|image_pad|> tokens, 27 flash_d72 and a flash_causal per layer)
            and its features; tools/eval_vlm.py over a seeded generic JSONL
            (2 image rows on that still, 2 video rows on the clip, one
            multiple-choice; 27 flash_d72 and a flash_causal per layer
            per row; the summary's keys; preprocess_video on the card
            within PV_MAX_LEVELS of the CPU); stage 2: ar_feature_extract's per-row
            function with that engine on the stage-1 file (54 flash_d72 and
            three flash_causal per layer); then vlm_fsdp below on the
            model as built, then the text-only pass (text_only below) on
            its text stack; the model is freed, and one T2V-1.3B
            train step (the train phase's settings) reads the extracted
            file through training/dataset.py (its launches asserted);
  text_only the vlm model's text stack as a text-only Qwen3 (qwen3_forward
            on the prompt's 1,481 ids, a 16-token qwen3_greedy_decode, a
            flash_causal launch per layer a pass): base, rank-16 bare adapters with
            B = 0 (logits and tokens bit-equal), B perturbed, merged
            (MERGE_TOL of scale against the adapters); then the vision tower
            once with VISION_BARE_NAMES adapters (27 flash_d72 launches);
  qwen3_sp  qwen3_forward_sp on a NCCL group of world 1 (a token-causal
            ring_step launch per layer) against qwen3_forward on the same weights,
            SP_TOL of scale (run from the text-only pass);
  vlm_fsdp  the sharded Qwen3-VL engine (generate --vlm_fsdp) on the vlm
            model: an NCCL group of world 1, the model's MoEs given its
            ExpertShard through Qwen3VLEngine.from_model (the f32 combine,
            the group's all-reduce and the cross-rank routing check at
            every MoE layer), feature forward and 16-token decode within
            VLM_FSDP_TOL of scale of the unsharded run and its tokens up to
            a near-tie, launches per pass asserted (3 gmm a MoE layer); the
            all-reduce's ms at a prefill's and a decode step's rows; a
            seeded transformers-layout checkpoint (fused gate_up_proj) of
            the model's first 2 text layers read as rank 1 of 4, every
            tensor bit-equal to its source's slice, its load seconds and
            rate. Alone with 2+ cards (`chip_smoke.py vlm_fsdp`): min(4,
            count) ranks hold their shards of the 24-layer model, features
            within VLM_FSDP_TOL and tokens up to a near-tie of the
            unsharded run, features and tokens bit-equal across the ranks;
            then at 48 layers each rank's peak memory, bytes held, vision_s,
            prefill_s, decode ms/token and all-reduce ms; and the
            checkpoint read as each rank's shard;
  e2e       OmniVideoX2XUnified.random_init(T2V_1_3B) at full width and depth,
            832x480, 81 frames, 2 UniPC steps, CFG 5.0, conditioned on the
            vlm phase's features (ar_vision_input), VAE decode to uint8, with
            the kernels' launch counts asserted; the decode again with
            vae_dtype=bf16, timed beside the f32 one, its frames within
            VAE_BF16_MAX_LEVELS (and on average VAE_BF16_MEAN_LEVELS) uint8
            levels of the f32 ones;
  serve     tools/serve.py's Server on the e2e phase's pipeline (no second
            init) behind http.server on 127.0.0.1:0, driven by urllib: a
            832x480x81 request (2 steps, a seeded 64x4096 context) whose
            frames must equal, bit for bit, the same generate called
            directly beside it, with the same qk_prep and flash_fwd
            launches; a 832x480x17 request with the id "../../evil" (its
            file stays inside the output dir); a malformed body (500) and
            /healthz after it; latency per request;
  export    tools/export_aot.py on the same expert at 832x480x81 (bf16):
            torch.export, save, load, one call of the loaded program held to
            the eager forward (bit-equal, else FLASH_ULPS of each row's max)
            with the same launches; export, save and load seconds, the
            artifact's bytes, the program's and the eager forward's ms;
  eval_videos  tools/eval_videos.py over the serve phase's two clips on the
            card, each its own reference (PSNR infinite, SSIM 1), and the
            two requests' first 17 frames as a pair, card vs CPU within
            METRIC_REL_TOL;
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
  a14b      T2V-A14B at full width from seeded weights, A14B_LAYERS of its
            40 layers (the stream phase and stream_train's LoRA expert
            share the cut): umT5-XXL
            (bf16, on the card) encodes 512 seeded ids for the prompt and the
            negative and is freed; the full-size VAE encodes a seeded
            832x480x81 clip; both experts (2 x 14.29B bf16 at 40 layers)
            run a V2V generate with the vlm phase's features, f32 residual,
            ew_impl="kernel", qk_impl="kernel", 3 UniPC steps at shift 12
            (2 high-noise steps, 1 low-noise, asserted) with 3 fused_adaln
            launches per layer and one more per forward asserted, one
            profiled forward, then the
            experts are freed (under 2 GB left allocated) and the VAE
            decodes to uint8; peak memory below 80 GB;
  stream    T2V-A14B generate with both experts' blocks in page-locked host
            memory (the a14b phase's weights, moved by split_host_params),
            streamed through the card (pipelines/streaming.py), from the
            a14b phase's inputs and noise: window 2 with each copy and
            block timed by CUDA events on the two streams (copy GB/s, the
            share of copy time hidden behind compute), window 1 and group 4
            bit-equal to it, int8 (each expert quantised on the card, then
            its bf16 host copy dropped) within STREAM_Q8_TOL of scale at
            ≤ 0.51 of the bytes; latents within STREAM_TOL of the resident
            run's, launches per generate as a14b's, per-step seconds, peak
            device GB, host RSS and pinned GB; then the cli phase's row
            through the generate CLI again, resident and with
            --layer_stream: latents bit-equal to the cli phase's, the
            streamed row's frames (before the lossy writer) within 1 uint8
            level of the resident row's, decoded in the same state;
  tiny_i2v  WanI2V.generate of a tiny i2v model (2 layers, dim 256, head
            dim 128; CLIP of width 1280 and 2 layers, 257 tokens; a 2.1 VAE of
            width 8) on the card against the same weights, 48x80 first frame
            (both resizes run), contexts and noise on the CPU: latents within
            I2V_TOL, the two decoders on the CPU's latents within
            ENCODE_TOL, each device's own frames within ENCODE_TOL plus
            the CPU decoder's gap between the two sets of latents (its
            witness of how far the decoder carries the latents' gap),
            launches per forward asserted (qk_prep 5,
            flash_fwd 1 and flash_pair 1 a block, fused_adaln 3 a block + 1);
  i2v       I2V-14B at full width and depth from seeded bf16 weights (~16.4B
            parameters), the full ViT-H/14 CLIP (bf16) and Wan2.1 VAE: a
            seeded 1280x720 first frame, 832x480x81, seeded 512x4096
            contexts, 2 UniPC steps at shift 5, CFG 5.0, f32 residual,
            qk_impl and ew_impl "kernel"; launches per forward asserted (200
            qk_prep, 40 flash_fwd, 40 flash_pair, 121 fused_adaln), each
            denoise step's seconds beside one profiled forward,
            the DiT and CLIP freed, the decode to uint8 [81, 480, 832, 3];
            stage seconds and peak memory (below 80 GB);
  vae22     the Wan2.2 VAE: a tiny one on the card against the CPU (encode
            and decode within VAE22_TOL), then VAE22Config() from a seeded
            reference-layout state dict (vae22_state_dict_to_params):
            a seeded 832x480x81 clip encoded to [48, 21, 30, 52] and decoded
            back; shapes, finite values, seconds and peaks;
  xlm       XLM-Roberta large with the CLIP head at full width, f32, on the
            card against the same weights on the CPU: [2, 512] seeded ids
            with pad tails, hidden states and pooled output within XLM_TOL;
  flash_train  the training forward (o and LSE) and the dq and dk/dv
            backward kernels against their plain twins on the same bf16
            inputs at the training paths' shapes (T2V-1.3B: self-attention
            [1, 32760, 12, 128], cross-attention over 6,272 keys, ragged
            kv_lens with a batch row of none; T2V-A14B, as the streamed LoRA
            step runs it: self-attention [1, 32760, 40, 128], cross-attention
            over 512 keys), two backward launches bit for bit equal,
            achieved TFLOP/s and share of bound beside each time, SDPA
            forward and backward timed beside them;
  tiny_train  3 unified train steps of a 2-layer head-dim-128 model on the
            card (kernels) and on the CPU (plain twins) from the same
            weights, batch and draws: loss and grad_norm gaps;
  train     make_unified_train_step on T2V_1_3B at full width and
            TRAIN_LAYERS of its 30 layers (this phase, sp_train's modes, lora,
            adafactor and the data pipeline's step share the cut), f32
            master params, batch 1 at 832x480x81 (32,760 tokens, the mixed
            context cut to 6,272), remat, AdamW: 3 steps on one batch and one
            set of draws (the loss must fall), launch counts per step
            asserted, train_step_s and peak memory, then one profiled step;
  sp_train  training across cards: (a) the ring backward (rows 4 and 5 per
            ring step) over 4 in-process shards of [1, 8190, 12, 128] (no
            padding, 8 pad keys, the last shard all padding) against
            flash_bwd over the whole sequence and against the same loop
            with flash_bwd_plain, per head within 1e-2 of its norm, and the
            block and token layouts at [1, 4096, 32, 128] against the plain
            loop, launches per ring backward asserted, ms per rank; (b) on
            this card in a NCCL group of world 1, the train phase's step
            under SPConfig ring, Ulysses and shard_params (FSDP2), 2 steps
            each, loss within 2e-3 and grad_norm within 1e-2 of the train
            phase's single-card step, every leaf's step-1 grad within 1e-2 of
            its norm (step 2's reported), launches per step,
            train_step_s and peak memory; (c) with 2+ cards, min(4, count)
            spawned NCCL ranks run sp ring, sp Ulysses, fsdp, tp (where the
            heads and FFN divide) and on 4 cards dp2 x fsdp2 the same way,
            then qwen3_forward_sp on the SFT model in f32 and bf16 (a ring
            of min(4, count); on 4 cards also ring 2 x Ulysses 2) against
            each card's one-card qwen3_forward (SP_TOL of scale), then
            generate under fsdp and tp against the non-SP generate
            (SP_TOL of scale); with one card a line says why (c) did not run.
            The VLM's SFT beside it: the token-causal ring backward over 4
            in-process shards of [1, 2048, 32, 128] (rows 4 and 5 on the
            earlier shards), bf16 and f32, against the plain loop and, per
            head, the dense f32 causal backward (GRAD_TOL for bf16; for f32
            BWD_F32_TOL against the plain loop and BWD_F32_DENSE_TOL against
            the dense backward, with the f32 kernels launched 6 times each
            and no bf16 backward kernel); rows 4 and 5 on f32 operands
            (csrc/flash_train_f32.cu) against flash_bwd_plain at a 4-card
            run's earlier-shard shape [2, 512, 32, 128] and the in-process
            [1, 512, 32, 128], each kernel timed beside f32 SDPA's backward;
            the SFT step on the full-width 2-layer, 16-expert Qwen3 (batch
            2 × 2048, rows of unequal target counts) under --sp at world 1
            (NCCL, row 8) and on 2+
            cards under --sp (the f32 backward kernels on each rank's
            earlier shards, 2 × 6 × 2 launches each on 4 cards, no bf16
            backward kernel), --fsdp and (4 cards) --dp 2 --fsdp 2, held to
            the single-card step as the train modes are; the f32 LM's ring
            runs the f32 step kernel (csrc/ring_step_f32.cu), held to
            ring_step_plain within RING_F32_TOL of each output row's max
            (and the LSE) at the world-1 step's shape [2, 2048, 32, 128]
            (own shard, token-causal) and at a 4-card run's per-rank
            [2, 512, 32, 128] (own shard; an earlier shard, all visible),
            each timed beside f32 SDPA (its kernel named by the profiler);
  lora      the train phase's T2V-1.3B step with rank-16 LoRA on the
            attention and FFN projections, the base frozen, AdamW on the
            adapters: 3 steps, launches per step asserted, step time, peak
            memory and optimizer-state bytes beside the train phase's, the
            adapters moved and the base bit-equal (a fingerprint of every
            frozen tensor); the adapters (B perturbed) exported as .npz:
            2-step 832x480x81 latents merged against unmerged (MERGE_TOL) and
            against none, merged weights at three sites within FOLD_ULPS of
            the f64 fold, the generate CLI with --lora_adapters (rows 1 and
            6 counted), and the finetune CLI from a YAML --config (LoRA with
            adafactor, 2 steps at full width on its dummy data);
  adafactor the same step with the adafactor optimizer on every parameter:
            3 steps, step time, peak memory and state bytes beside AdamW's,
            step 2's update of three JAX leaves (factored across the
            layers, unfactored across the layers, one factored kernel)
            within UPDATE_TOL of an f64 reference of the same rule;
  sft       the VLM's SFT at full width: Qwen3-VL-30B-A3B's text stack with
            4 of 48 layers (3.1B parameters, f32 params, grads and AdamW
            moments), batch 1 × 2048, SFTConfig's defaults but warmup 0, 3
            steps on one seeded batch (a third of it prompt) then a
            profiled one: the full finetune, bare LoRA rank 16 on q/k/v/o
            and the combined loss (the CLI's alignment chain); the loss
            must fall, peak under 80 GB, no attention kernel launched (the
            masked attention is the dense path, as in JAX), the MoE through
            rows 9 and 9b (tgmm unless the banks are frozen); then sft_tokenize
            through the stand-in tokenizer (ChatML) and the sft_vlm CLI
            from a YAML --config on that --data_dir, 3 steps.
  stream_train  StreamedTrainer at T2V-1.3B full width and depth beside
            make_train_step from the same weights, batch and draws (f32
            masters, AdamW lr 3e-6, clip 0.1, context 6,272, 3 steps: loss
            within 2e-3, grad_norm within 1e-2, launches per step as the
            resident step's, then every block's and resident leaf's
            parameter change within STREAM_PARAM_TOL of the resident
            step's), its fused (clip 0: the same checks) and adafactor
            (loss; grad_norm at step 1) modes at full depth,
            STREAM_VARIANT_STEPS steps each; StreamedLoRATrainer on one
            T2V-A14B expert (rank 16, bf16 base, then int8, 3 steps each)
            beside the resident LoRA step on the same expert (73.8 GB);
            step seconds, peak device GB, host RSS and pinned GB.
The line before the kernel summary gives each phase's wall seconds. The line
before the last is the kernel summary (each row's launches per
path, each path's count reset just before it); the last line is
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
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
import urllib.error
import urllib.request
from http.server import HTTPServer
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor

from omnivideo_tpu_torch.configs.base import (
    I2V_14B,
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
from omnivideo_tpu_torch.io.hf_reader import load_qwen3vl_dir
from omnivideo_tpu_torch.io.jax_bridge import to_torch
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
from omnivideo_tpu_torch.models.clip_vision import CLIPVisionConfig, init_clip_vision
from omnivideo_tpu_torch.models.t5 import T5EncoderModel, init_t5
from omnivideo_tpu_torch.models.wan_dit import SPConfig, WanDiT
from omnivideo_tpu_torch.models.vae2_1 import Wan21VAE, init_vae
from omnivideo_tpu_torch.models.vae2_2 import (
    VAE22Config,
    Wan22VAE,
    vae22_reference_shapes,
    vae22_state_dict_to_params,
)
from omnivideo_tpu_torch.models.xlm_roberta import (
    PAD_ID,
    init_xlm_roberta,
    xlm_roberta_apply,
    xlm_roberta_with_head_apply,
)
from omnivideo_tpu_torch.ops import _kernels
from omnivideo_tpu_torch.ops import flash_attention as flash_mod
from omnivideo_tpu_torch.ops.flash_attention import (
    BWD_KERNELS,
    flash_attention,
    flash_attention_pair,
    flash_attention_pair_plain,
    flash_attention_plain,
    flash_attention_train,
    flash_bwd,
    flash_bwd_plain,
    flash_delta,
    flash_fwd_lse,
    flash_fwd_lse_plain,
    pair_bound,
    softmax_bound,
)
from omnivideo_tpu_torch.ops.fused_adaln import fused_adaln, fused_adaln_plain
from omnivideo_tpu_torch.ops.gmm import (gmm, gmm_plain, gmm_schedule, resident_clusters,
                                         tgmm, tgmm_plain)
from omnivideo_tpu_torch.ops.ring_attention import (
    ring_carry,
    ring_finish,
    ring_flash_attention_shards,
    ring_flash_backward_shards,
    ring_step,
    ring_step_plain,
    step_lens_for,
    stripe_order,
    zigzag_order,
)
from omnivideo_tpu_torch.ops.qk_prep import qk_prep, qk_prep_plain, row_tiles
from omnivideo_tpu_torch.ops.rope import rope_3d_tables
from omnivideo_tpu_torch.parallel.distributed import maybe_initialize_distributed
from omnivideo_tpu_torch.parallel.expert_shard import (
    ExpertShard,
    expert_slice,
    shard_bytes,
    shard_experts,
    shard_plan,
    vlm_group,
)
from omnivideo_tpu_torch.parallel.mesh import create_mesh
from omnivideo_tpu_torch.parallel.sharding import shard_params
from omnivideo_tpu_torch.pipelines.i2v import WanI2V
from omnivideo_tpu_torch.pipelines.loading import load_expert
from omnivideo_tpu_torch.pipelines.streaming import (HostBuffer, host_block_targets,
                                                      split_host_params)
from omnivideo_tpu_torch.pipelines.x2x import ExpertParams, OmniVideoX2XUnified
from omnivideo_tpu_torch.schedulers.unipc import FlowUniPC
from omnivideo_tpu_torch.tools import generate as generate_cli
from omnivideo_tpu_torch.models.qwen3vl.text_model import (
    qwen3_forward,
    qwen3_forward_sp,
    qwen3_greedy_decode,
)
from omnivideo_tpu_torch.ops.lora import has_lora
from omnivideo_tpu_torch.training.lora import (
    DEFAULT_TARGETS,
    LORA_FILTERS,
    VISION_BARE_NAMES,
    apply_lora_state,
    count_lora_params,
    freeze_base,
    inject_lora,
    inject_lora_bare,
    load_adapters_npz,
    merge_lora,
    save_adapters_npz,
    set_adapter,
    strip_lora,
)
from omnivideo_tpu_torch.training.lora import draw_lora
from omnivideo_tpu_torch.training.lora import sites as lora_sites
from omnivideo_tpu_torch.training.streaming import StreamedLoRATrainer, StreamedTrainer
from omnivideo_tpu_torch.training.trainer import (
    TrainConfig,
    global_norm,
    init_train_state,
    init_unified_params,
    jax_path,
    make_optimizer,
    make_train_step,
    make_unified_train_step,
    sample_draws,
)
from omnivideo_tpu_torch.utils.run_config import write_yaml
from omnivideo_tpu_torch.utils.video import read_video_frames
from omnivideo_tpu_torch.models.qwen3vl.preprocess import build_chat_ids, preprocess_image
from omnivideo_tpu_torch.models.qwen3vl.text_model import Qwen3LM
from omnivideo_tpu_torch.tools import sft_vlm
from omnivideo_tpu_torch.tools.data_prepare import (
    ar_feature_extract,
    sft_tokenize,
    vae_feature_extract,
)
from omnivideo_tpu_torch.training.conversation import ConversationDataset
from omnivideo_tpu_torch.training.dataset import OmniVideoDataset, PadSpec, collate
from omnivideo_tpu_torch.training.sft import (
    SFTConfig,
    SFTParams,
    init_sft_state,
    make_sft_optimizer,
    make_sft_step,
    sft_collate,
)
from omnivideo_tpu_torch.utils.png import write_png
from omnivideo_tpu_torch.models.qwen3vl.preprocess import CLIP_STD, preprocess_video
from omnivideo_tpu_torch.tools import eval_videos as eval_videos_tool
from omnivideo_tpu_torch.tools import eval_vlm as eval_vlm_tool
from omnivideo_tpu_torch.tools import export_aot
from omnivideo_tpu_torch.tools import serve as serve_tool
from omnivideo_tpu_torch.utils.metrics import evaluate_pair

HBM_BYTES_PER_S = 3.35e12  # NVIDIA's H100 SXM data sheet, at the 700 W limit
BF16_FLOPS = 989e12  # dense tensor-core bf16
F32_FLOPS = 67e12  # f32 outside the tensor cores
TF32_FLOPS = 495e12  # dense tensor-core tf32; an f32-accurate product takes 3 of them
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
TRAIN_LAYERS = 6  # T2V-1.3B layers (of 30) in the train phase and the phases that share its
# step (sp_train's modes, adafactor, the data pipeline's step; not lora, whose adapters go
# through the full-depth generate), cut so that the whole run fits its time limit with
# stream_train at full depth
VLM_LAYERS = 24  # Qwen3-VL-30B-A3B text layers (of 48) in the vlm phase, for the same reason
A14B_LAYERS = 20  # T2V-A14B layers (of 40) wherever the run builds its experts: the a14b
# and stream phases and stream_train's LoRA expert; cut so that the whole run, with the
# serve, export and eval phases, fits its time limit
ADALN_F32_TOL = 1e-5  # f32 y, of its row's max |y_plain|: the row sums run in another order
ADALN_BF16_ULPS = 1.0  # bf16 y, in ulps of its row's max |y_plain|: those sums can flip a rounding
ENCODE_TOL = 1e-3  # VAE encode, card vs CPU, of the latent scale: f32 convolutions (TF32 off)
# summed in other orders by cuDNN and oneDNN
A14B_STEPS = 3  # at the A14B shift 12: t = 999, 959 (high-noise expert), 856 (low-noise)
T5_IDS = 512  # umT5's text_len: the prompt and the negative are encoded at full length
VAE_BF16_MAX_LEVELS = 8  # uint8 frames, vae_dtype=bf16 vs f32: the decoders differ only in z's
VAE_BF16_MEAN_LEVELS = 0.5  # rounding to bf16 (the f32 scale promotes it back, as in JAX)
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
KERNEL_ROWS = ("qk_prep", "flash_fwd", "flash_pair", "flash_causal", "flash_d72",
               "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_f32",
               "flash_bwd_dkv_f32",
               "fused_adaln", "ring_step", "ring_step_f32", "gmm", "tgmm")
TRAIN_ROWS = ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")  # the DiT trainer's kernels
BWD_F32_ROWS = ("flash_bwd_dq_f32", "flash_bwd_dkv_f32")  # rows 4 and 5 on f32 operands


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
    InferOut<72> row 3a, LseOut row 3b, RingCarry row 8. The MoE's grouped
    products: row 9 is `gmm_wgmma_kernel` (bf16, many rows),
    `gmm_splitk_kernel` (bf16, few rows) and `gmm_tf32_kernel` (f32); row 9b
    `tgmm_wgmma_kernel` (bf16) and `tgmm_tf32_kernel` (f32). Rows 4 and 5 on
    f32 operands are `flash_bwd_dq_f32_kernel` and `flash_bwd_dkv_f32_kernel`;
    rows 1x and 1t as one launch `flash_pair_kernel`."""
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
    for key, row in (("flash_bwd_dkv_f32", "flash_bwd_dkv_f32"),
                     ("flash_bwd_dq_f32", "flash_bwd_dq_f32"),
                     ("flash_bwd_dkv", "flash_bwd_dkv"), ("flash_bwd_dq", "flash_bwd_dq"),
                     ("flash_pair_kernel", "flash_pair"),
                     ("qk_prep", "qk_prep"), ("adaln_kernel", "fused_adaln"),
                     ("ring_step_f32", "ring_step_f32"), ("tgmm_wgmma_kernel", "tgmm"),
                     ("tgmm_tf32_kernel", "tgmm"), ("gmm_wgmma_kernel", "gmm"),
                     ("gmm_splitk_kernel", "gmm"), ("gmm_tf32_kernel", "gmm")):
        if key in name:
            return row
    return None


def ptxas_by_kernel(log: str) -> dict:
    """{kernel: {"registers": n, "spill_stores": bytes, "spill_loads": bytes}}
    for every kernel of the port's table, from nvcc's -Xptxas -v log; a row
    that several entry functions serve (rows 9, 9b) takes the most of each."""
    out, name = {}, None

    def most(key, v):
        row = out.setdefault(name, {})
        row[key] = max(row.get(key, v), v)

    for ln in log.splitlines():
        f = re.search(r"Compiling entry function '(\w+)'", ln)
        if f:
            name = kernel_row(f.group(1))
        elif name and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            most("spill_stores", int(st))
            most("spill_loads", int(ld))
        elif name and "Used" in ln and "registers" in ln:
            most("registers", int(re.search(r"Used (\d+) registers", ln).group(1)))
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
    """qk_prep against its plain twin: the 1.3B self-attention q/k (the
    kernels line's case), its context, a sequence past the RoPE table, and
    the 14B self-attention q/k that the a14b and i2v paths give it."""
    dev = "cuda"
    hd = 128
    cos, sin = (torch.tensor(t, device=dev) for t in rope_3d_tables(GRID, hd))
    cases = [("self_rope", 2, SEQ, 1536, True), ("context_norm_only", 2, 6272, 1536, False),
             ("past_table", 2, SEQ + 1000, 1536, True), ("self_rope_14b", 2, SEQ, 5120, True)]
    main = None
    for name, B, L, d, rope in cases:
        N = d // hd
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
        rec = {"phase": "qk_prep", "case": name, "shape": [B, L, d], "heads": N, "rope": rope,
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


def _pair_case(name, Lq, Lt, Li, N, gen, scales=(1.0, 1.0), timed=True, reps=5) -> dict:
    """The pair kernel (flash_pair: the i2v cross-attention over text and
    image keys in one launch) against flash_attention_pair_plain on the same
    inputs, through its wrapper with the row norms given (as qk_prep gives
    them to the model): every row within FLASH_ULPS of its max, three runs
    bit-equal, each context bounded unless its keys' RMS (`scales`) fails
    its guard. Timed: the kernel alone at its C entry point, the wrapper,
    the two row-1 launches it replaces (flash_fwd_launch twice, the bounds
    made once), the plain twin, and the yardstick: two SDPA calls and their
    bf16 sum."""
    B, D = 2, 128
    q = _normed(B, Lq, N, D, gen)
    kt, ki = _normed(B, Lt, N, D, gen, scales[0]), _normed(B, Li, N, D, gen, scales[1])
    vt, vi = (torch.randn(B, L, N, D, generator=gen, device="cuda").to(torch.bfloat16)
              for L in (Lt, Li))
    norms = tuple(t.float().square().sum(-1).amax(dim=1).sqrt() for t in (q, kt, ki))
    mb, safe = pair_bound(q, kt, ki, D**-0.5, norms)
    wrapper = lambda: flash_attention_pair(q, kt, vt, ki, vi, qk_row_norms=norms)  # noqa: E731
    runs = [wrapper() for _ in range(3)]
    ref = flash_attention_pair_plain(q, kt, vt, ki, vi, None, mb, safe)
    torch.cuda.synchronize()
    o = runs[0]
    bit_equal = all(torch.equal(r, o) for r in runs[1:])
    ulps = float(row_ulps(o, ref).max())
    bounded = [bool(b) for b in safe.tolist()]
    rec = {"phase": "flash", "case": name, "kernel": flash_mod.PAIR_KERNEL,
           "q": [B, Lq, N, D], "Lt": Lt, "Li": Li, "bounded": bounded,
           "max_abs_err": float((o.float() - ref.float()).abs().max()), "max_row_ulps": ulps,
           "tolerance_row_ulps": FLASH_ULPS, "max_abs_plain": float(ref.float().abs().max()),
           "reruns_bit_equal": bit_equal}
    del runs
    if (ulps > FLASH_ULPS or not bit_equal or not torch.isfinite(o).all()
            or bounded != [sc == 1.0 for sc in scales]):
        raise AssertionError(f"flash {name}: {rec}")
    if timed:
        out = torch.empty_like(q)
        ptrs = [t.data_ptr() for t in (q, kt, vt, ki, vi, out, mb[0], safe[0:1], mb[1], safe[1:2])]
        lib = _kernels.library()
        stream = torch.cuda.current_stream().cuda_stream
        qscale = flash_mod._qscale(D**-0.5)
        ms = cuda_ms(lambda: _kernels.check(lib.flash_pair_launch(
            *ptrs, B, Lq, Lt, Li, N, D, qscale, stream), "flash_pair_launch"), reps)
        ot, oi = torch.empty_like(q), torch.empty_like(q)

        def two_row1():
            for c, (k, v, oo, L) in enumerate(((kt, vt, ot, Lt), (ki, vi, oi, Li))):
                _kernels.check(lib.flash_fwd_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), oo.data_ptr(), None,
                    mb[c].data_ptr(), safe[c:c + 1].data_ptr(), B, Lq, L, N, D, 0, qscale,
                    stream), "flash_fwd_launch")

        two_ms = cuda_ms(two_row1, reps)
        wrapper_ms = cuda_ms(wrapper, reps)
        plain_ms = cuda_ms(lambda: flash_attention_pair_plain(q, kt, vt, ki, vi, None, mb, safe),
                           1, 0)
        qt, ktt, vtt, kit, vit = (t.transpose(1, 2).contiguous() for t in (q, kt, vt, ki, vi))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = cuda_ms(lambda: sdpa(qt, ktt, vtt) + sdpa(qt, kit, vit), reps)
        del qt, ktt, vtt, kit, vit, ot, oi, out
        # each input read once and the output written once; every (row, key) pair is live
        flops = 4 * B * N * Lq * (Lt + Li) * D
        nbytes = 2 * (2 * B * Lq * N * D + 2 * B * (Lt + Li) * N * D)
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        rec.update(reps=reps, ms=ms, wrapper_ms=wrapper_ms, two_row1_ms=two_ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   share_of_bound=max(t_ops, t_bytes) / ms, tflops=flops / ms / 1e9)
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
    # I2V-14B's split cross-attention: the 257 CLIP tokens (a 1-key tail tile) and 512 text
    run("i2v_cross_image", 2, SEQ, 257, 40, 128, 1.0, None, True, False)
    run("i2v_cross_text", 2, SEQ, 512, 40, 128, 1.0, None, True, False)
    # ... and both in one launch, as the i2v DiT runs them; and with the
    # image keys' guard failed (that context max-tracked, the text bounded)
    main["flash_pair"] = _pair_case("i2v_cross_pair", SEQ, 512, 257, 40, gen)
    _pair_case("i2v_cross_pair_image_max_tracked", 8190, 512, 257, 40, gen, scales=(1.0, 4.0),
               timed=False)
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
    ring_step.launches_f32 = 0
    gmm.launches = 0
    tgmm.launches = 0
    for name in flash_attention.launches:
        flash_attention.launches[name] = 0


def _launches() -> dict:
    return {"qk_prep": qk_prep.launches, "fused_adaln": fused_adaln.launches,
            "ring_step": ring_step.launches, **flash_attention.launches}


def _moe_launches() -> dict:
    """The MoE's grouped-product kernels (rows 9 and 9b), kept apart from
    `_launches` so that the attention paths' launch dicts stay as they were."""
    return {"gmm": gmm.launches, "tgmm": tgmm.launches}


def _check_moe_launches(what: str, got: dict, layers: int, backward: bool = False) -> None:
    """Three gmm launches a layer a pass (gate, up, down), so a multiple of
    3·layers and at least one pass; tgmm only under autograd."""
    n = got["gmm"]
    if n == 0 or n % (3 * layers) or (got["tgmm"] == 0) == backward:
        raise AssertionError(f"{what}: MoE launches {got} for {layers} MoE layers "
                             f"({'with' if backward else 'no'} backward)")


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


GMM_BF16_ULPS = 4.0  # bf16 out of f32 sums: the tensor cores add the products of a k16
# step in an order of their own before the f32 accumulator, so a sum may differ
# in its last f32 bits and round to the other bf16 neighbour; 4 ulps of a row's max
# as the flash rows
GMM_F32_TOL = 1e-5  # f32, of each row's max |plain|: the same products summed in another order
GMM_TOKENS = (1481, 1, 2048)  # the vlm phase's prompt (L), a decode step, the SFT's batch
VLM_SPLITS = (2, 4)  # vlm_fsdp's cards: each holds 768 / n of every expert's columns


def _routed(tokens: int, experts: int, k: int, gen: torch.Generator, skew: float = 1.5):
    """A seeded router over a skewed draw, as the MoE routes: tokens [T, D]
    ~ N(0, 1) at Qwen3-VL-30B-A3B's width, logits x·Wr + skew·N(0, 1) per
    expert (some experts popular, some rarely hit), top-k, the (token,
    slot) pairs sorted by expert → (x, token of each sorted row, int32 group
    sizes on the card)."""
    D = QWEN3_VL_30B_A3B.text.hidden_size
    x = torch.randn(tokens, D, generator=gen, device="cuda")
    wr = torch.randn(D, experts, generator=gen, device="cuda") * D**-0.5
    bias = skew * torch.randn(experts, generator=gen, device="cuda")
    flat = torch.topk(x @ wr + bias, k, dim=-1).indices.reshape(-1)
    sizes = torch.bincount(flat, minlength=experts).to(torch.int32)
    return x, torch.argsort(flat, stable=True) // k, sizes


def _gmm_row_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out − ref| over each row's max |ref|: bf16 in ulps of it, f32 as
    a share of it (0 for no rows)."""
    if out.numel() == 0:
        return 0.0
    if out.dtype == torch.bfloat16:
        return float(row_ulps(out, ref).max())
    rmax = ref.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return float(((out.float() - ref.float()).abs() / rmax).max())


def _gmm_limit(dtype) -> float:
    return GMM_BF16_ULPS if dtype == torch.bfloat16 else GMM_F32_TOL


def _grouped_mm_ms(a: torch.Tensor, b: torch.Tensor, sizes: torch.Tensor, reps: int):
    """torch._grouped_mm on the same operands, the yardstick only (the port
    never calls it): (ms, None), or (None, why) where this torch lacks it or
    refuses the operands (it takes bf16 only)."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None or a.dtype != torch.bfloat16:
        return None, "torch._grouped_mm takes bf16 only" if fn else "no torch._grouped_mm"
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    try:
        return cuda_ms(lambda: fn(a, b, offs=offs), reps), None
    except (RuntimeError, ValueError, TypeError) as exc:
        return None, str(exc).splitlines()[0][:160]


def _kernel_ms(fn, reps: int) -> float:
    """Device time of the kernels that fn() launches, per call, from
    torch.profiler over reps calls: where the host takes longer than the card
    (the decode's few rows), cuda_ms reads the host's enqueue rate instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / reps / 1e3


def _gmm_bound(nbytes: float, ops: float, dtype) -> dict:
    """The least time: bytes at HBM's rate, or the operations at bf16's
    tensor-core rate, or (f32) three TF32 products each, the split the
    kernels run (FFMA's bound beside it)."""
    peak = BF16_FLOPS if dtype == torch.bfloat16 else TF32_FLOPS / 3
    by_ops = ops / peak
    rec = {"bound_ms": max(nbytes / HBM_BYTES_PER_S, by_ops) * 1e3,
           "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= by_ops else "operations"}
    if dtype == torch.float32:
        rec["bound_ffma_ms"] = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
    return rec


def _gmm_case(name: str, lhs, rhs, sizes, transpose=False, reps=20) -> dict:
    """gmm against gmm_plain on the same operands: the rows of the groups
    within each row's limit, the rows past the group sum exactly zero, the
    same bits on a second call; the schedule the wrapper picks (a split-k
    schedule's clusters all held by the card at once); the kernel timed at
    its wrapper (and its device time alone), the plain twin,
    torch._grouped_mm; the bound from this data (the experts hit, the rows
    routed)."""
    m, k = lhs.shape
    out = gmm(lhs, rhs, sizes, transpose_rhs=transpose)
    ref = gmm_plain(lhs, rhs, sizes, transpose)
    again = gmm(lhs, rhs, sizes, transpose_rhs=transpose)
    torch.cuda.synchronize()
    n = out.shape[1]
    total = min(int(sizes.sum()), m)
    err = _gmm_row_err(out[:total], ref[:total])
    zero_tail = bool(torch.count_nonzero(out[total:]) == 0)
    esize = lhs.element_size()
    nbytes = (int((sizes > 0).sum()) * k * n + total * k + m * n) * esize
    lib_ms, lib_why = _grouped_mm_ms(lhs, rhs.transpose(1, 2) if transpose else rhs, sizes,
                                     reps)
    fn = lambda: gmm(lhs, rhs, sizes, transpose_rhs=transpose)  # noqa: E731
    sched = gmm_schedule(m, k, n, sizes.numel(), lhs.dtype,
                         torch.cuda.get_device_properties(lhs.device).multi_processor_count)
    rec = {"case": name, "op": "gmm", "dtype": str(lhs.dtype).split(".")[-1], "m": m, "k": k,
           "n": n, "groups": sizes.numel(), "groups_hit": int((sizes > 0).sum()),
           "rows_routed": total, "transpose_rhs": transpose, "schedule": sched._asdict(),
           "max_row_err": err, "limit": _gmm_limit(lhs.dtype),
           "max_abs_err": float((out - ref).abs().max()), "rows_past_sum_zero": zero_tail,
           "repeat_bitwise": bool(torch.equal(out, again)),
           "ms": cuda_ms(fn, reps), "kernel_ms": _kernel_ms(fn, reps),
           "plain_ms": cuda_ms(lambda: gmm_plain(lhs, rhs, sizes, transpose), 1, 0),
           **_gmm_bound(nbytes, 2.0 * total * k * n, lhs.dtype), "library_ms": lib_ms}
    if lib_why:
        rec["library_why_none"] = lib_why
    clustered = sched.kind == "split_k" and sched.splits > 1
    if clustered:  # the schedule keeps its clusters to one wave: the card holds them all
        rec["clusters"] = {"resident": resident_clusters(m, sched),
                           "launched": sched.blocks // sched.splits}
    rec["ok"] = (err <= rec["limit"] and zero_tail and rec["repeat_bitwise"]
                 and bool(torch.isfinite(out).all())
                 and (not clustered or rec["clusters"]["launched"] <= rec["clusters"]["resident"]))
    return rec


def _tgmm_case(name: str, lhs, dy, sizes, reps=10) -> dict:
    """tgmm against tgmm_plain: each group's [k, n] block within the limit
    of its own max, an empty group's block exactly zero, the same bits on a
    second call; timed as gmm."""
    m, k = lhs.shape
    n, E = dy.shape[1], sizes.numel()
    out = tgmm(lhs, dy, sizes)
    ref = tgmm_plain(lhs, dy, sizes)
    again = tgmm(lhs, dy, sizes)
    torch.cuda.synchronize()
    hit = (sizes > 0).nonzero().flatten()
    err = _gmm_row_err(out[hit].reshape(len(hit), -1), ref[hit].reshape(len(hit), -1))
    empty_zero = bool(torch.count_nonzero(out[sizes == 0]) == 0)
    total = min(int(sizes.sum()), m)
    esize = lhs.element_size()
    nbytes = (total * (k + n) + E * k * n) * esize
    lib_ms, lib_why = _grouped_mm_ms(lhs.T, dy, sizes, reps)
    fn = lambda: tgmm(lhs, dy, sizes)  # noqa: E731
    rec = {"case": name, "op": "tgmm", "dtype": str(lhs.dtype).split(".")[-1], "m": m, "k": k,
           "n": n, "groups": E, "groups_hit": len(hit), "rows_routed": total,
           "schedule": {"kind": "wgmma" if lhs.dtype == torch.bfloat16 else "tf32"},
           "max_block_err": err, "limit": _gmm_limit(lhs.dtype),
           "max_abs_err": float((out - ref).abs().max()), "empty_groups_zero": empty_zero,
           "repeat_bitwise": bool(torch.equal(out, again)),
           "ms": cuda_ms(fn, reps), "kernel_ms": _kernel_ms(fn, reps),
           "plain_ms": cuda_ms(lambda: tgmm_plain(lhs, dy, sizes), 1, 0),
           **_gmm_bound(nbytes, 2.0 * total * k * n, lhs.dtype), "library_ms": lib_ms}
    if lib_why:
        rec["library_why_none"] = lib_why
    rec["ok"] = (err <= rec["limit"] and empty_zero and rec["repeat_bitwise"]
                 and bool(torch.isfinite(out).all()))
    return rec


def phase_gmm(gen: torch.Generator) -> dict:
    """Rows 9 and 9b against their plain twins at the main paths' shapes,
    routed by `_routed`: Qwen3-VL-30B-A3B's MoE (128 experts, top-8, 2,048 →
    768 → 2,048) at the vlm phase's prefill (1,481 tokens, 11,848 rows,
    bf16) and at a decode step (8 rows), the SFT's f32 step (2,048 tokens,
    16,384 rows: the forward, the input's gradient through the transposed
    bank and the bank's gradient by tgmm), tgmm in bf16 at the prefill's
    rows; edge cases: one expert with every row, group sizes summing below
    m (the rows past are zero), half the experts never routed, the few-row
    schedule at 1 and 64 rows, and tgmm where each group's neighbours hold
    rows 1000x larger and the rows past the sum NaN (a row of another group
    in a group's last step would miss the limit by far); the prefill's and
    the decode's products at vlm_fsdp's split widths (768 / n columns of
    each bank, n in VLM_SPLITS: the wide kernel's 192-column tiles, the
    split-k kernel unsplit over the down's 3 or 6 k steps). Returns
    {"gmm": the prefill gate/up case, "tgmm": the SFT's bank gradient,
    "cases": all}."""
    cfg = QWEN3_VL_30B_A3B.text
    E, D, M, k = cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts_per_tok
    bf = torch.bfloat16
    up = (torch.randn(E, D, M, generator=gen, device="cuda") * 0.02).to(bf)  # [E, D, M]
    down = (torch.randn(E, M, D, generator=gen, device="cuda") * 0.02).to(bf)  # [E, M, D]
    cases = []
    prefill, decode, sft = GMM_TOKENS
    x, tok, sizes = _routed(prefill, E, k, gen)
    xs = x.to(bf)[tok]
    h = torch.randn(xs.shape[0], M, generator=gen, device="cuda").to(bf)
    cases.append(_gmm_case("prefill_gate_up", xs, up, sizes))
    cases.append(_gmm_case("prefill_down", h, down, sizes))
    cases.append(_tgmm_case("prefill_bank_grad_bf16", xs, h, sizes, reps=5))
    x1, tok1, sizes1 = _routed(decode, E, k, gen)
    xs1 = x1.to(bf)[tok1]
    cases.append(_gmm_case("decode_gate_up", xs1, up, sizes1, reps=200))
    cases.append(_gmm_case("decode_down", h[:xs1.shape[0]].contiguous(), down, sizes1,
                           reps=200))
    one_row = torch.zeros(E, dtype=torch.int32, device="cuda")
    one_row[5] = 1
    cases.append(_gmm_case("decode_1_row", xs1[:1].contiguous(), up, one_row, reps=200))
    x8, tok8, sizes8 = _routed(8, E, k, gen)  # 8 tokens: 64 rows, the few-row schedule's most
    cases.append(_gmm_case("decode_64_rows", x8.to(bf)[tok8], up, sizes8, reps=100))
    leak_x, leak_h = xs.clone(), h.clone()
    bounds = torch.cumsum(sizes, 0).tolist()
    for e in range(1, E, 2):  # every other group's rows 1000x larger
        lo = bounds[e - 1]
        leak_x[lo:bounds[e]] *= 1000
        leak_h[lo:bounds[e]] *= 1000
    leak_sizes = sizes.clone()
    leak_sizes[int((sizes > 0).nonzero().max())] = 0  # the last hit group's rows: NaN, past the sum
    tail = int(leak_sizes.sum())
    leak_x[tail:], leak_h[tail:] = float("nan"), float("nan")
    cases.append(_tgmm_case("tgmm_neighbours_1000x_nan_tail_bf16", leak_x, leak_h, leak_sizes,
                            reps=3))
    del leak_x, leak_h
    for n in VLM_SPLITS:  # rank 0's columns of the banks split over n cards (vlm_fsdp)
        w = M // n
        up_n, down_n, h_n = up[:, :, :w].contiguous(), down[:, :w].contiguous(), h[:, :w]
        cases.append(_gmm_case(f"split{n}_prefill_gate_up", xs, up_n, sizes))
        cases.append(_gmm_case(f"split{n}_prefill_down", h_n.contiguous(), down_n, sizes))
        cases.append(_gmm_case(f"split{n}_decode_gate_up", xs1, up_n, sizes1, reps=200))
        cases.append(_gmm_case(f"split{n}_decode_down", h_n[:xs1.shape[0]].contiguous(), down_n,
                               sizes1, reps=200))
        del up_n, down_n, h_n
    one = torch.zeros(E, dtype=torch.int32, device="cuda")
    one[3] = 1000
    cases.append(_gmm_case("one_expert_all_rows", xs[:1000].contiguous(), up, one))
    short = sizes.clone()
    short[E // 2:] = 0  # rows past the first half's sum must come out zero
    cases.append(_gmm_case("sum_below_m", xs, up, short))
    del up, down, xs, h
    up32 = torch.randn(E, D, M, generator=gen, device="cuda") * 0.02
    x, tok, sizes = _routed(sft, E, k, gen)
    xs = x[tok].contiguous()
    dy = torch.randn(xs.shape[0], M, generator=gen, device="cuda")
    cases.append(_gmm_case("sft_forward_f32", xs, up32, sizes, reps=5))
    cases.append(_gmm_case("sft_input_grad_f32", dy, up32, sizes, transpose=True, reps=5))
    main_t = _tgmm_case("sft_bank_grad_f32", xs, dy, sizes, reps=5)
    cases.append(main_t)
    half = sizes.clone()
    half[::2] = 0
    rows = int(half.sum())
    cases.append(_gmm_case("half_experts_empty_f32", xs[:rows].contiguous(), up32, half, reps=5))
    cases.append(_tgmm_case("half_experts_empty_tgmm_f32", xs[:rows].contiguous(),
                            dy[:rows].contiguous(), half, reps=5))
    del up32, xs, dy
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"phase": "gmm", "config": "QWEN3_VL_30B_A3B.text MoE", "experts": E,
           "experts_per_token": k, "tolerance_bf16_row_ulps": GMM_BF16_ULPS,
           "tolerance_f32_row_rel": GMM_F32_TOL, "cases": cases}
    emit(rec)
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"gmm: cases {bad} off: {rec}")
    return {"gmm": cases[0], "tgmm": main_t, "cases": cases}


VLM_PATH_TOL = 5e-2  # the vlm features, the grouped kernels vs the per-expert products on the
# same routing, of scale: both round each product to bf16 once from f32 sums taken in other
# orders, and 24 layers carry the flipped roundings through attention, the norms and the
# residual (the tiny VLM's card-vs-CPU limit, which covers such roundings along the same model)
VLM_NEAR_TIE = 0.05  # a greedy choice whose top logit leads by less than this share of the
# largest |logit| may flip (phase_tiny_vlm's rule)


def _moe_per_expert(mlp, x: torch.Tensor) -> torch.Tensor:
    """The MoE as the port ran it before rows 9 and 9b: the group sizes read
    back to the host, one torch.matmul per expert over its row segment. The
    vlm phase's yardstick only; the port no longer calls it."""
    B, L, D = x.shape
    xt = x.reshape(B * L, D)
    k = mlp.cfg.num_experts_per_tok
    topv, topi, _ = vlm_text.router(mlp, xt)
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=mlp.cfg.num_experts).tolist()  # host sync
    xs = xt[order // k]
    gate, up, down = (w.unbind(0) for w in (mlp.experts_gate, mlp.experts_up, mlp.experts_down))
    outs, start = [], 0
    for e, n in enumerate(counts):
        if n:
            seg = xs[start:start + n]
            outs.append((torch.nn.functional.silu(seg @ gate[e]) * (seg @ up[e])) @ down[e])
            start += n
    o = torch.cat(outs)
    o = o * topv.reshape(-1)[order][:, None].to(o.dtype)
    slots = torch.empty_like(o)
    slots[order] = o
    return slots.view(B * L, k, D).sum(1).reshape(B, L, D)


def _vlm_per_expert_check(model, ids, patches, grid, feats, toks) -> dict:
    """The feature forward and greedy decode through `_moe_per_expert` (the
    parent's MoE), recording each MoE call's routing and the decode's logit
    margins; then the port's path (rows 9) again with that routing replayed
    (its own router probabilities, the reference's chosen experts): the
    features within VLM_PATH_TOL of scale and the greedy tokens equal up to
    the first near-tie. The free run's gaps (`feats`, `toks`: the port's own
    routing) are reported beside them: a router near-tie flipped by a bf16
    rounding swaps a token's expert, which says nothing about the kernels."""
    moe_fn = vlm_text.moe
    vlm_text.moe = _moe_per_expert
    try:
        ref = _vlm_run(model, ids, patches, grid)
    finally:
        vlm_text.moe = moe_fn
    replayed = _vlm_run(model, ids, patches, grid, replay=ref["routing"])
    held = _held_to(replayed, ref)
    free = _held_to({"features": feats, "tokens": toks}, ref)
    rec = {"features_rel_err_replayed": held["features_rel_err"], "tolerance_rel": VLM_PATH_TOL,
           "features_rel_err_own_routing": free["features_rel_err"],
           "tokens_per_expert": ref["tokens"].tolist(),
           "tokens_replayed": replayed["tokens"].tolist(),
           "first_divergence_replayed": held["first_divergence"],
           "first_divergence_own_routing": free["first_divergence"],
           "per_expert_margins": ref["margins"], "near_tie": VLM_NEAR_TIE,
           "router_calls": len(ref["routing"]),
           "per_expert_features_s": ref["features_s"], "per_expert_prefill_s": ref["prefill_s"],
           "per_expert_decode_ms_per_token": ref["decode_s"] / ref["decode_steps"] * 1e3}
    if held["features_rel_err"] > VLM_PATH_TOL or not held["tokens_agree_up_to_near_tie"]:
        raise AssertionError(f"vlm per-expert check: {rec}")
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
    """Stage 1 of the data pipeline (`_vae_extract`) on the 720p clip file,
    then Qwen3-VL-30B-A3B at full width, VLM_LAYERS deep: feature forward and a
    16-token greedy caption on 6 frames of 832x480, the engine on the clip
    (`_engine_pass`), the image path (`_image_pass`) and stage 2
    (`_ar_extract`); the model is freed, and one finetune step reads the
    extracted files (`_pipeline_train_step`). Returns the record with the
    features ([L − system prefix, 2048] f32 on the card) under
    "features"."""
    cfg = dataclasses.replace(QWEN3_VL_30B_A3B, text=dataclasses.replace(
        QWEN3_VL_30B_A3B.text, num_hidden_layers=VLM_LAYERS))
    vc = cfg.vision
    vae = _vae_extract(clip, clip.parent)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Qwen3VLModel.random_init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    ids, patches, grid = vlm_inputs(cfg)

    guard = []  # the vision tower's softmax guard, one device flag per block
    bound_fn = flash_mod.softmax_bound

    def spy(*args, **kw):
        mb, safe = bound_fn(*args, **kw)
        guard.append(safe)
        return mb, safe

    per_pass = {"flash_d72": vc.depth, "flash_causal": cfg.text.num_hidden_layers,
                "flash_fwd": 0, "qk_prep": 0, "fused_adaln": 0, "ring_step": 0, "flash_pair": 0}
    total = {k: 0 for k in per_pass}
    flash_mod.softmax_bound = spy
    try:
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = extract_features(model, ids, patches, grid, drop_idx=SYSTEM_PREFIX)
        torch.cuda.synchronize()
        features_s = time.perf_counter() - t0
        got_f, moe_f = _launches(), _moe_launches()
        _reset_launches()
        timings = {}
        toks = qwen3vl_greedy_decode(model, ids, patches, grid, max_new_tokens=VLM_NEW_TOKENS,
                                     timings=timings)
        got_d, moe_d = _launches(), _moe_launches()
    finally:
        flash_mod.softmax_bound = bound_fn
    for got in (got_f, got_d):
        if got != per_pass:
            raise AssertionError(f"vlm: launches {got} per pass, expected {per_pass}")
        for k in total:
            total[k] += got[k]
    layers = cfg.text.num_hidden_layers
    if moe_f != {"gmm": 3 * layers, "tgmm": 0}:  # one forward: gate, up, down a layer
        raise AssertionError(f"vlm: MoE launches {moe_f} in the feature forward")
    _check_moe_launches("vlm decode", moe_d, layers)
    moe_total = {k: moe_f[k] + moe_d[k] for k in moe_f}
    h = feats["vlm_last_hidden_states"]
    L = ids.shape[1]
    expect = (L - SYSTEM_PREFIX, cfg.text.hidden_size)
    if (tuple(h.shape) != expect or not torch.isfinite(h).all() or len(toks) != VLM_NEW_TOKENS
            or not ((toks >= 0) & (toks < cfg.text.vocab_size)).all()):
        raise AssertionError(f"vlm: features {tuple(h.shape)} (expected {expect}), "
                             f"finite {bool(torch.isfinite(h).all())}, tokens {toks}")
    safe = torch.cat(guard).cpu()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_expert = _vlm_per_expert_check(model, ids, patches, grid, h, toks)
    moe_check = _vlm_moe_check(model, L)
    profile = _vlm_profile(model, ids, patches, grid)
    engine = _engine_pass(model, clip)
    image = _image_pass(model, clip.parent)
    eval_vlm = _eval_vlm_pass(model, clip)
    ar = _ar_extract(model, vae)
    fsdp = phase_vlm_fsdp(model, ids, patches, grid, clip.parent)  # before text_only adapts it
    shutil.rmtree(fsdp.pop("ckpt_dir"), ignore_errors=True)
    del fsdp["ref"]
    text = phase_text_only(model, ids, patches, grid)
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
           "launches_per_pass": per_pass, "launches": total, "moe_launches": moe_total,
           "moe_launches_per_pass": {"features": moe_f, "decode": moe_d},
           "idle_share": profile["idle_share"], "per_expert": per_expert, "moe_check": moe_check,
           "profile": profile, "engine": engine, "image": image, "eval_vlm": eval_vlm,
           "vae_feature_extract": {k: v for k, v in vae.items() if k not in ("dir", "manifest")},
           "ar_feature_extract": ar, "text_only_launches": text["launches"],
           "qwen3_sp_launches": text["qwen3_sp"]["launches"],
           "vlm_fsdp_launches": {**fsdp["launches"], **fsdp["moe_launches"]}}
    emit(rec)
    rec["text_only"] = text
    rec["vlm_fsdp"] = fsdp
    rec["features"] = h
    del model, feats, patches
    gc.collect()
    torch.cuda.empty_cache()
    rec["pipeline_train"] = _pipeline_train_step(vae["dir"])
    emit({"phase": "vlm", "part": "pipeline_train", **rec["pipeline_train"]})
    return rec


VLM_FSDP_TOL = VLM_PATH_TOL  # vlm_fsdp's features vs the unsharded model's on the same
# routing, of scale: the same kernels, but each MoE layer sums its k weighted outputs in f32 and
# rounds once to bf16 where the unsharded MoE rounds each weighted output and sums in bf16
# (across cards the down products' columns are summed in parts too); one rounding step at the
# largest bf16 feature is already up to 2^-7 = 7.8e-3 of scale, and 24 layers carry the flipped
# roundings through attention, the norms and the residual, as VLM_PATH_TOL says
VLM_FSDP_CKPT_LAYERS = 2  # text layers of vlm_fsdp's seeded reference-layout checkpoint


def _hf_vlm_config(cfg: Qwen3VLConfig) -> dict:
    """config.json of a Qwen3-VL checkpoint of `cfg` (the fields the reader
    takes, under transformers' names)."""
    t, v = dataclasses.asdict(cfg.text), dataclasses.asdict(cfg.vision)
    t["rope_scaling"] = {"rope_type": "default", "mrope_section": list(cfg.mrope_section),
                         "mrope_interleaved": True}
    for k in ("rope_dtype", "hidden_act"):
        v.pop(k)
    v["deepstack_visual_indexes"] = list(v["deepstack_visual_indexes"])
    return {"text_config": t, "vision_config": v, "video_token_id": cfg.video_token_id,
            "image_token_id": cfg.image_token_id,
            "vision_start_token_id": cfg.vision_start_token_id}


def write_vlm_dir(model: Qwen3VLModel, layers: int, d: Path) -> int:
    """The model's vision tower, embedding, head and first `layers` text
    layers as a Qwen3-VL-MoE checkpoint dir in transformers' layout: the
    Conv3d patch embedding, each MoE's banks fused as `experts.gate_up_proj`
    [E, D, 2M] and `experts.down_proj` [E, M, D]. Returns the bytes written."""
    cfg = dataclasses.replace(model.cfg, text=dataclasses.replace(model.cfg.text,
                                                                  num_hidden_layers=layers))
    vc, out = cfg.vision, {}
    for name, p in model.named_parameters():
        if name.startswith("language_model.layers.") and int(name.split(".")[2]) >= layers:
            continue
        if name == "visual.patch_embed.weight":
            out["model.visual.patch_embed.proj.weight"] = p.view(
                p.shape[0], vc.in_channels, vc.temporal_patch_size, vc.patch_size, vc.patch_size)
        elif name == "visual.patch_embed.bias":
            out["model.visual.patch_embed.proj.bias"] = p
        elif name.endswith("experts_gate"):
            up = dict(model.named_parameters())[name[:-4] + "up"]
            out["model." + name[:-len("experts_gate")] + "experts.gate_up_proj"] = torch.cat(
                [p, up], -1)
        elif name.endswith("experts_down"):
            out["model." + name[:-len("experts_down")] + "experts.down_proj"] = p
        elif not name.endswith("experts_up"):
            out[name if name.startswith("lm_head") else "model." + name] = p
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(_hf_vlm_config(cfg)))
    return write_safetensors(d / "model.safetensors", out)


class _Routing:
    """Inside the `with`, every MoE call's chosen experts are recorded
    (`calls`), or with `replay` a record is replayed call by call: each
    call's own router probabilities, the recorded experts (a router near-tie
    that a bf16 rounding flips swaps a token's expert, which says nothing
    about the path under test). `rows` picks the recorded tokens a call
    sees (a sequence-parallel rank's share of the one-card record)."""

    def __init__(self, replay=None, rows: torch.Tensor | None = None):
        self.calls, self.replay, self.used = (replay or []), replay is not None, 0
        self.rows = rows

    def __enter__(self) -> "_Routing":
        self.route, vlm_text.router = vlm_text.router, self._route
        return self

    def __exit__(self, *exc) -> None:
        vlm_text.router = self.route

    def _route(self, mlp, xt):
        topv, topi, probs = self.route(mlp, xt)
        if not self.replay:
            self.calls.append(topi.cpu())
        elif self.used < len(self.calls):
            rec = self.calls[self.used] if self.rows is None else self.calls[self.used][self.rows]
            if rec.shape == topi.shape:
                topi = rec.to(topi.device)
                topv = probs.gather(1, topi)
                if mlp.cfg.norm_topk_prob:
                    topv = topv / topv.sum(-1, keepdim=True)
        self.used += 1
        return topv, topi, probs


def _vlm_run(model, ids, patches, grid, replay=None) -> dict:
    """The feature forward and a VLM_NEW_TOKENS greedy decode: features,
    tokens, each choice's margin (the top two logits' gap over the largest
    |logit|), the decode's timings, each pass's launches and the routing
    (recorded, or `replay`ed)."""
    sample, margins = vlm_full.sample_token, []

    def spy(logits, *args):
        top2 = logits.float().topk(2).values
        margins.append(float((top2[0] - top2[1]) / logits.float().abs().max()))
        return sample(logits, *args)

    timings, counts = {}, {}
    vlm_full.sample_token = spy
    try:
        with _Routing(replay) as routing:
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = extract_features(model, ids, patches, grid, drop_idx=SYSTEM_PREFIX)[
                "vlm_last_hidden_states"]
            torch.cuda.synchronize()
            features_s = time.perf_counter() - t0
            counts["features"] = {**_launches(), **_moe_launches()}
            _reset_launches()
            toks = qwen3vl_greedy_decode(model, ids, patches, grid,
                                         max_new_tokens=VLM_NEW_TOKENS, timings=timings)
            counts["decode"] = {**_launches(), **_moe_launches()}
    finally:
        vlm_full.sample_token = sample
    if replay is not None and routing.used != len(replay):
        raise AssertionError(f"vlm_fsdp: {routing.used} MoE calls replayed {len(replay)} records")
    keep = ("flash_causal", "flash_d72", "gmm", "tgmm")
    return {"features": h, "tokens": np.asarray(toks), "margins": margins,
            "routing": routing.calls, "features_s": features_s, **timings,
            "launches_per_pass": {p: {k: c[k] for k in keep} for p, c in counts.items()}}


def _held_to(run: dict, ref: dict) -> dict:
    """A run's features and tokens against a reference run's: the
    features' largest gap over their scale, the first differing token and
    whether the reference's choice there was a near-tie (led by less than
    VLM_NEAR_TIE)."""
    d = np.nonzero(np.asarray(run["tokens"]) != ref["tokens"])[0]
    first = int(d[0]) if len(d) else None
    gap = (run["features"].float().cpu() - ref["features"].float().cpu()).abs().max()
    return {"features_rel_err": float(gap / ref["features"].float().abs().max()),
            "first_divergence": first,
            "tokens_agree_up_to_near_tie": first is None or ref["margins"][first] < VLM_NEAR_TIE}


def _sharded_vlm_pass(model, ids, patches, grid, ref: dict) -> dict:
    """A model whose MoEs hold an ExpertShard: its own run (each pass's
    launches, the routing checks across the group counted) and a run with
    the unsharded run's routing replayed, whose features must lie within
    VLM_FSDP_TOL of scale of `ref`'s and tokens agree up to a near-tie.
    Returns the record (the own run's features under "features")."""
    checks = vlm_text.check_routing.calls
    own = _vlm_run(model, ids, patches, grid)
    checks = vlm_text.check_routing.calls - checks
    replayed = _vlm_run(model, ids, patches, grid, replay=ref["routing"])
    layers, depth = model.cfg.text.num_hidden_layers, model.cfg.vision.depth
    steps = own["decode_steps"]
    rec = {"replayed_routing": _held_to(replayed, ref), "own_routing": _held_to(own, ref),
           "tolerance_rel": VLM_FSDP_TOL, "tokens": own["tokens"].tolist(),
           "features_s": own["features_s"], "vision_s": own["vision_s"],
           "prefill_s": own["prefill_s"], "decode_ms_per_token": own["decode_s"] / steps * 1e3,
           "decode_steps": steps, "routing_checks": checks,
           "launches_per_pass": own["launches_per_pass"],
           "launches": {k: sum(p[k] for p in own["launches_per_pass"].values())
                        for k in ("flash_causal", "flash_d72")},
           "moe_launches": {k: sum(p[k] for p in own["launches_per_pass"].values())
                            for k in ("gmm", "tgmm")}}
    want = {"features": {"flash_causal": layers, "flash_d72": depth, "gmm": 3 * layers,
                         "tgmm": 0},
            "decode": {"flash_causal": layers, "flash_d72": depth,
                       "gmm": 3 * layers * (steps + 1), "tgmm": 0}}
    held = rec["replayed_routing"]
    if (own["launches_per_pass"] != want or held["features_rel_err"] > VLM_FSDP_TOL
            or not held["tokens_agree_up_to_near_tie"] or not torch.isfinite(own["features"]).all()
            or tuple(own["features"].shape) != tuple(ref["features"].shape)
            or checks != layers * (steps + 2)):
        raise AssertionError(f"vlm_fsdp: {rec}, launches per pass expected {want}, "
                             f"{layers * (steps + 2)} routing checks")
    rec["features"] = own["features"]
    return rec


def _vlm_fsdp_load(d: Path, nbytes: int, shard, src=None) -> dict:
    """`load_qwen3vl_dir` of the checkpoint at `d` as `shard`'s rank: its
    seconds and the rate of the file's bytes; with `src` (the model the
    dir was written from), every parameter bit-equal to the same slice of
    the source."""
    gc.collect()
    rss0 = _host_rss_gb()
    torch.cuda.synchronize()
    with RssSampler() as rss:
        t0 = time.perf_counter()
        loaded = load_qwen3vl_dir(str(d), "cuda", shard=shard)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    held = shard_bytes(loaded)
    rec = {"file_gb": nbytes / 1e9, "load_s": load_s, "file_gb_per_s": nbytes / 1e9 / load_s,
           "replicated_gb": held["replicated"] / 1e9, "sharded_gb": held["sharded"] / 1e9,
           "host_rss_rise_gb": rss.peak_gb - rss0}
    if src is not None:
        want = dict(src.named_parameters())
        plan = shard_plan(loaded)
        differ = [k for k, p in loaded.named_parameters()
                  if not torch.equal(_bits(p), _bits(
                      (expert_slice(want[k], plan[k], shard) if plan[k] is not None
                       else want[k]).contiguous()))]
        rec["bit_equal_to_source_slice"] = not differ
        if differ:
            raise AssertionError(f"vlm_fsdp load: {len(differ)} tensors differ: {differ[:8]}")
    del loaded
    torch.cuda.empty_cache()
    return rec


VLM_SPLIT_ROUNDINGS = 2.0**-8  # the split MoE's f32 sum of n rank partials vs the world-1
# f32 combine on the same input, of scale, per partial: each rank's down product rounds its
# partial sum over 768 / n columns to bf16 once (at most half an ulp, 2^-8 of its magnitude),
# where the world-1 product rounds the whole sum once, so n + 1 such roundings of a slot's
# output reach the router-weighted sum (its weights add to 1); the limit is (n + 1) · 2^-8


def _split_moe_path(model, ids, patches, grid) -> dict:
    """Row 9s on one card, on the model's own data: the first MoE layer's
    input from the feature forward's prefill (a forward hook), then for each
    n in VLM_SPLITS every rank r of n in turn runs `moe_partial` on its
    slices of the layer's banks (ExpertShard(r, n), no group: a Qwen3MoE of
    768 / n columns holding them). The f32 partials, summed in rank order,
    are held to the world-1 f32 combine (`moe_partial` on the whole banks)
    within (n + 1) · VLM_SPLIT_ROUNDINGS of scale; the path's gmm launches
    (counted from zero just before it, read just after) must be 3·n; each
    rank's call is timed by CUDA events. {n: record}."""
    mlp = model.language_model.layers[0].mlp
    seen = []
    hook = mlp.register_forward_hook(
        lambda mod, args, out: seen.append(args[0].detach()) if not seen else None)
    try:
        with torch.no_grad():
            extract_features(model, ids, patches, grid, drop_idx=SYSTEM_PREFIX)
    finally:
        hook.remove()
    x = seen[0]
    out = {}
    with torch.no_grad():
        ref = vlm_text.moe_partial(mlp, x)
        for n in VLM_SPLITS:
            ranks = []
            for r in range(n):
                shard = ExpertShard(r, n)
                sub = vlm_text.Qwen3MoE(mlp.cfg, mlp.experts_down.dtype, x.device, shard)
                sub.gate.weight.copy_(mlp.gate.weight)
                for name, dim in shard_plan(mlp).items():
                    if dim is not None:
                        getattr(sub, name).copy_(expert_slice(getattr(mlp, name), dim, shard))
                ranks.append(sub)
            _reset_launches()
            parts = [vlm_text.moe_partial(sub, x) for sub in ranks]
            torch.cuda.synchronize()
            launches = _moe_launches()
            total = parts[0]
            for part in parts[1:]:
                total = total + part
            err = float((total - ref).abs().max() / ref.abs().max())
            limit = (n + 1) * VLM_SPLIT_ROUNDINGS
            rec = {"cards": n, "x": list(x.shape), "bank_columns": mlp.experts_down.shape[1] // n,
                   "rel_err_vs_world1": err, "tolerance_rel": limit, "launches": launches,
                   "rank_ms": [cuda_ms(lambda sub=sub: vlm_text.moe_partial(sub, x), 10)
                               for sub in ranks]}
            out[n] = rec
            if (launches != {"gmm": 3 * n, "tgmm": 0} or err > limit
                    or not torch.isfinite(total).all() or total.shape != ref.shape):
                raise AssertionError(f"vlm_fsdp split MoE path: {rec}")
            del ranks, parts, total
    torch.cuda.empty_cache()
    return out


def phase_vlm_fsdp(model, ids, patches, grid, tmp: Path) -> dict:
    """The sharded engine path on this card: the unsharded run of the vlm
    model (its routing recorded), then an NCCL group of world 1 and the
    model's MoEs given its ExpertShard through Qwen3VLEngine.from_model
    (1 of 1: the f32 combine, the group's all-reduce and the routing check
    at every MoE layer), run as `_sharded_vlm_pass` holds it, and the
    all-reduce timed; then a seeded reference-layout checkpoint of the
    model's first VLM_FSDP_CKPT_LAYERS text layers (fused gate_up_proj)
    read as rank 1 of 4, each tensor bit-equal to its source's slice. The
    model is left unsharded. Returns the record, with the checkpoint dir
    and the unsharded run under "ckpt_dir" and "ref"."""
    t_start = time.perf_counter()
    ref = _vlm_run(model, ids, patches, grid)
    split = _split_moe_path(model, ids, patches, grid)
    maybe_initialize_distributed(f"localhost:{_free_port()}", 1, 0, device="cuda")
    try:
        engine = Qwen3VLEngine.from_model(model, VLMConfig(max_new_tokens=VLM_NEW_TOKENS),
                                          StandInTokenizer(),
                                          shard=vlm_group(1, check_routing=True))
        run = _sharded_vlm_pass(engine.model, ids, patches, grid, ref)
        ar_ms = _all_reduce_ms(ids.shape[1], engine.model.language_model.layers[0].mlp.shard)
    finally:
        shard_experts(model, None)
        dist.destroy_process_group()
    ckpt = tmp / "vlm_ckpt"
    t0 = time.perf_counter()
    nbytes = write_vlm_dir(model, VLM_FSDP_CKPT_LAYERS, ckpt)
    write_s = time.perf_counter() - t0
    load = _vlm_fsdp_load(ckpt, nbytes, ExpertShard(1, 4), src=model)
    run.pop("features")
    rec = {"phase": "vlm_fsdp", "config": "QWEN3_VL_30B_A3B",
           "text_layers": model.cfg.text.num_hidden_layers, "world": 1, "backend": "nccl",
           **run, "all_reduce_ms": ar_ms, "split_moe": split,
           "ckpt": {"text_layers": VLM_FSDP_CKPT_LAYERS, "layout": "fused gate_up_proj",
                    "write_s": write_s, "read_as": "rank 1 of 4", **load},
           "seconds": time.perf_counter() - t_start}
    emit(rec)
    rec["ckpt_dir"], rec["ckpt_bytes"], rec["ref"] = ckpt, nbytes, ref
    return rec


def _all_reduce_ms(L: int, shard, reps: int = 20) -> dict:
    """The MoE's all-reduce over the shard's group, CUDA events: a prefill
    layer's [L, 2048] f32 and a decode step's [1, 2048]."""
    out = {}
    for name, rows in (("prefill", L), ("decode", 1)):
        t = torch.ones(rows, QWEN3_VL_30B_A3B.text.hidden_size, device="cuda")
        out[name] = cuda_ms(lambda: dist.all_reduce(t, group=shard.group), reps)  # noqa: B023
    return out


def _vlm_fsdp_rank(rank, world, port, tmp):
    """One rank of the multi-card vlm_fsdp run, on its own card: the
    VLM_LAYERS-deep model as its shard of a group of every rank, run as
    `_sharded_vlm_pass` runs it (its own routing, checked across the ranks
    at every MoE call, and the unsharded run's replayed), the runs written
    to `tmp`; then at the full 48 layers (seeded alike, no check): peak
    memory, the bytes held, vision_s, prefill_s, decode ms/token and the
    all-reduce's ms; then the reference-layout checkpoint read as its
    shard."""
    maybe_initialize_distributed(f"localhost:{port}", world, rank, device="cuda", local_rank=rank)
    try:
        inp = torch.load(Path(tmp) / "inputs.pt", weights_only=False)
        ids, grid, patches = inp["ids"], inp["grid"], inp["patches"].cuda()
        shard = vlm_group(world, check_routing=True)
        quiet = dataclasses.replace(shard, check_routing=False)
        rec = {"rank": rank}
        for layers in (VLM_LAYERS, QWEN3_VL_30B_A3B.text.num_hidden_layers):
            cfg = dataclasses.replace(QWEN3_VL_30B_A3B, text=dataclasses.replace(
                QWEN3_VL_30B_A3B.text, num_hidden_layers=layers))
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = Qwen3VLModel.random_init(cfg, seed=0, device="cuda",
                                             shard=shard if layers == VLM_LAYERS else quiet)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            held = shard_bytes(model)
            if layers == VLM_LAYERS:
                checks = vlm_text.check_routing.calls
                own = _vlm_run(model, ids, patches, grid)
                checks = vlm_text.check_routing.calls - checks
                replayed = _vlm_run(model, ids, patches, grid, replay=inp["ref"]["routing"])
                torch.save({name: {k: (v.cpu() if torch.is_tensor(v) else v)
                                   for k, v in run.items() if k != "routing"}
                            for name, run in (("own", own), ("replayed", replayed))},
                           Path(tmp) / f"rank{rank}.pt")
                run = own
            else:
                run = _vlm_run(model, ids, patches, grid)
                checks = None
            rec[str(layers)] = {
                "init_s": init_s, "replicated_gb": held["replicated"] / 1e9,
                "sharded_gb": held["sharded"] / 1e9,
                "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                "vision_s": run["vision_s"], "prefill_s": run["prefill_s"],
                "decode_ms_per_token": run["decode_s"] / run["decode_steps"] * 1e3,
                "decode_steps": run["decode_steps"], "routing_checks": checks,
                "launches_per_pass": run["launches_per_pass"],
                "all_reduce_ms": _all_reduce_ms(ids.shape[1], quiet)}
            del model, run
            gc.collect()
            torch.cuda.empty_cache()
        rec["load"] = _vlm_fsdp_load(Path(inp["ckpt_dir"]), inp["ckpt_bytes"], quiet)
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()


def vlm_fsdp_multi_card(world: int, ids, patches, grid, ref: dict, ckpt: Path,
                        ckpt_bytes: int) -> dict:
    """Spawn `world` ranks (`_vlm_fsdp_rank`, one card each). Every rank's
    VLM_LAYERS-deep run with the unsharded run's routing replayed is held
    to `ref` (VLM_FSDP_TOL of scale, tokens up to a near-tie); its own run
    (the routing checked across the ranks at every MoE call) must give
    every rank the same features and tokens, bit for bit, and three gmm
    launches a MoE layer a pass. Returns the per-rank records."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_vlm_fsdp"))
    try:
        torch.save({"ids": ids, "grid": grid, "patches": patches.cpu(), "ckpt_dir": str(ckpt),
                    "ckpt_bytes": ckpt_bytes, "ref": {"routing": ref["routing"]}},
                   tmp / "inputs.pt")
        mp.spawn(_vlm_fsdp_rank, args=(world, _free_port(), str(tmp)), nprocs=world)
        recs = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]
        runs = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    layers = VLM_LAYERS
    for rec, run in zip(recs, runs):
        rec["replayed_routing"] = _held_to(run["replayed"], ref)
        rec["own_routing"] = _held_to(run["own"], ref)
        rec["features_bit_equal_to_rank0"] = bool(torch.equal(run["own"]["features"],
                                                              runs[0]["own"]["features"]))
        rec["tokens_equal_to_rank0"] = bool((run["own"]["tokens"]
                                             == runs[0]["own"]["tokens"]).all())
        r = rec[str(layers)]
        steps = r["decode_steps"]
        if (rec["replayed_routing"]["features_rel_err"] > VLM_FSDP_TOL
                or not rec["replayed_routing"]["tokens_agree_up_to_near_tie"]
                or not rec["features_bit_equal_to_rank0"] or not rec["tokens_equal_to_rank0"]
                or r["routing_checks"] != layers * (steps + 2)
                or r["launches_per_pass"]["features"]["gmm"] != 3 * layers
                or r["launches_per_pass"]["decode"]["gmm"] != 3 * layers * (steps + 1)):
            raise AssertionError(f"vlm_fsdp on {world} cards: {rec}")
    return {"world": world, "ranks": recs}


def _vlm_fsdp_alone() -> int:
    """`chip_smoke.py vlm_fsdp`: the vlm phase's model (VLM_LAYERS deep) and
    prompt, then phase_vlm_fsdp on this card; with 2+ cards, the model is
    freed and min(4, count) ranks run `_vlm_fsdp_rank`."""
    phase_device()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        cfg = dataclasses.replace(QWEN3_VL_30B_A3B, text=dataclasses.replace(
            QWEN3_VL_30B_A3B.text, num_hidden_layers=VLM_LAYERS))
        model = Qwen3VLModel.random_init(cfg, seed=0, device="cuda")
        ids, patches, grid = vlm_inputs(cfg)
        rec = phase_vlm_fsdp(model, ids, patches, grid, tmp)
        count = torch.cuda.device_count()
        if count < 2:
            print(f"vlm_fsdp: the multi-card part did not run: this machine has {count} CUDA "
                  "device (it needs 2 or more, one per rank)", flush=True)
            return 0
        del model
        gc.collect()
        torch.cuda.empty_cache()
        multi = vlm_fsdp_multi_card(min(4, count), ids, patches, grid, rec["ref"],
                                    rec["ckpt_dir"], rec["ckpt_bytes"])
        emit({"phase": "vlm_fsdp", "part": "multi_card", **multi})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def vlm_inputs(cfg: Qwen3VLConfig):
    """The vlm phase's prompt: 6 seeded 832x480 frames (the captioning
    pixel budget keeps the size) → patches on the card, grid VLM_GRID, the
    synthetic ids."""
    vc = cfg.vision
    size = smart_resize(SIZE[1], SIZE[0], vc.patch_size * vc.spatial_merge_size,
                        480 * 480, 4 * 480 * 480)
    frames = np.random.default_rng(0).integers(0, 256, (VLM_FRAMES, *size, 3), dtype=np.uint8)
    patches, grid = frames_to_patches(frames, vc.patch_size, vc.temporal_patch_size,
                                      vc.spatial_merge_size)
    if size != (SIZE[1], SIZE[0]) or grid != VLM_GRID:
        raise AssertionError(f"vlm: resize {size}, grid {grid}")
    return vlm_prompt_ids(cfg, grid), torch.from_numpy(patches).cuda(), grid


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
    latents = pipe.generate(
        precomputed_context=ctx, precomputed_context_null=torch.zeros_like(ctx),
        ar_vision_input=ar_vision, size=SIZE, frame_num=FRAMES, sampling_steps=STEPS,
        guide_scale=5.0, decode=False, generator=gen)
    launches = _launches()
    timings = dict(pipe.timings)
    frames = pipe.decode(latents, output_uint8=True)
    timings["decode_s"] = pipe.timings["decode_s"]
    frames_bf16 = pipe.decode(latents, output_uint8=True, vae_dtype=torch.bfloat16)
    timings["decode_s_bf16"] = pipe.timings["decode_s"]
    diff = (frames_bf16.int() - frames.int()).abs()
    vae_bf16 = {"max_levels": int(diff.max()), "mean_levels": float(diff.float().mean()),
                "tolerance_max_levels": VAE_BF16_MAX_LEVELS,
                "tolerance_mean_levels": VAE_BF16_MEAN_LEVELS}
    del frames_bf16, diff
    if (vae_bf16["max_levels"] > VAE_BF16_MAX_LEVELS
            or vae_bf16["mean_levels"] > VAE_BF16_MEAN_LEVELS):
        raise AssertionError(f"e2e: the bf16 VAE decode strays from the f32 one: {vae_bf16}")
    expect = {"qk_prep": 120 * STEPS, "flash_fwd": 60 * STEPS, "flash_causal": 0, "flash_d72": 0,
              "fused_adaln": 0, "ring_step": 0, "flash_pair": 0}
    shape = tuple(frames.shape)
    if launches != expect or shape != (FRAMES, SIZE[1], SIZE[0], 3):
        raise AssertionError(f"e2e: launches {launches} (expected {expect}), frames {shape}")
    rec = {"phase": "e2e", "config": "T2V_1_3B", "layers": T2V_1_3B.dit.num_layers,
           "dim": T2V_1_3B.dit.dim, "seq_len": SEQ, "size": list(SIZE), "frames": FRAMES,
           "steps": STEPS, "residual_dtype": "bfloat16", "init_s": t_init,
           "ar_vision_input": list(ar_vision.shape), **timings, "vae_bf16_vs_f32": vae_bf16,
           "launches": launches,
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
    """Nested dicts and lists of tensors → {dotted path: tensor}."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, (dict, list))
                   else {f"{prefix}{k}": v})
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                               8: torch.int64}[t.element_size()])


LOAD_RSS_RISE_GB = 0.3  # the staging buffers (2 × 64 MiB) and the reader's own objects


def phase_load(expert, tmp: Path) -> dict:
    """The seeded T2V-1.3B expert (the e2e phase's) written in the diffusers
    layout (`low_noise_model/wan_model/diffusion_pytorch_model.safetensors`
    by `write_safetensors`, the companions as `.bin` pickles), then
    `load_expert` onto the card: every tensor bit-equal to its source; the
    load's seconds and GB/s, and how far the host's resident set rose
    during it: each tensor is read once through two pinned staging buffers
    of `STAGING_BYTES`, used in turn, so it must stay under LOAD_RSS_RISE_GB,
    far below the file's size."""
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
    if rec["host_rss_rise_gb"] > LOAD_RSS_RISE_GB:
        raise AssertionError(f"load: the host's resident set rose by {rec['host_rss_rise_gb']} GB")
    return rec


class _CapturedFrames:
    """Inside the `with`, the frames `generate_cli.save_video` gets (before
    its lossy MJPEG writer), by file name."""

    def __enter__(self):
        self.frames, self._real = {}, generate_cli.save_video

        def capture(path, video, **kw):
            self.frames[Path(path).stem] = torch.as_tensor(video).cpu().numpy()
            return self._real(path, video, **kw)

        generate_cli.save_video = capture
        return self

    def __exit__(self, *exc):
        generate_cli.save_video = self._real


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
    with _CapturedFrames() as written:
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
    rec.update(latents=res["latents"], frames=written.frames["v2v_0"], expect=expect)  # for stream
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
              "flash_causal": 0, "flash_d72": 0, "fused_adaln": 0, "flash_pair": 0}
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


def phase_a14b(ar_vision: torch.Tensor, keep_host: bool = False) -> dict:
    """T2V-A14B at full width and depth: umT5-XXL encode (then freed), VAE
    encode of the source clip, the dual-expert V2V generate in the f32
    parity mode with both fused kernels, experts freed, VAE decode. With
    keep_host the experts' blocks move to page-locked host memory first
    (split_host_params) and the record's "stream" holds them, the inputs and
    the latents for the stream phase."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = T2V_A14B.replace(dit=T2V_A14B.dit.replace(num_layers=A14B_LAYERS))
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
    # generate's own draw from gen, made here so the stream phase can reuse it
    noise = torch.randn((1,) + pipe._latent_shape(SIZE, FRAMES), generator=gen, device="cuda",
                        dtype=torch.float32)
    inputs = dict(precomputed_context=context, precomputed_context_null=context_null,
                  ar_vision_input=ar_vision, visual_emb=visual_emb, noise=noise)
    _reset_launches()
    latents = pipe.generate(size=SIZE, frame_num=FRAMES, sampling_steps=A14B_STEPS,
                            shift=cfg.sample_shift, guide_scale=cfg.sample_guide_scale,
                            decode=False, **inputs)
    launches = _launches()
    per_forward = {k: list(v) for k, v in counts.per_forward.items()}
    timings = dict(pipe.timings)
    per_fwd = 3 * cfg.dit.num_layers + 1
    expect = {"qk_prep": 4 * cfg.dit.num_layers * A14B_STEPS,
              "flash_fwd": 2 * cfg.dit.num_layers * A14B_STEPS, "flash_causal": 0,
              "flash_d72": 0, "fused_adaln": per_fwd * A14B_STEPS, "ring_step": 0, "flash_pair": 0}
    dit = pipe.high_noise.wan
    with torch.inference_mode():
        x2 = torch.cat([latents, latents]).bfloat16()
        ctx2 = dit.embed_context(torch.randn(2, cfg.max_context_len, cfg.dit.text_dim,
                                             generator=gen, device="cuda").bfloat16())
        t = torch.full((2,), 999.0, device="cuda")
        profile = _profile(lambda: dit(x2, t, ctx2, context_embedded=True, ew_impl="kernel"))
    del x2, ctx2, dit
    denoise_peak = torch.cuda.max_memory_allocated() / 1e9
    stream = None
    if keep_host:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e in (pipe.high_noise, pipe.low_noise):
            split_host_params(e.wan)
        stream = {"experts": (pipe.high_noise, pipe.low_noise), "inputs": inputs,
                  "latents": latents, "launches": expect, "timings": dict(timings),
                  "split_s": time.perf_counter() - t0, "denoise_peak_gb": denoise_peak}
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
           "step_s": timings["step_s"],
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
    rec["stream"] = stream
    return rec


I2V_STEPS = 2  # of 40: t = 999 and the step after it at shift 5
I2V_TOL = 5e-2  # tiny i2v, card vs CPU, latents of scale (bf16 q/k/v in the card's flash
# kernels where the CPU's plain twins compute in f32, as the tiny generate's limit)
VAE22_TOL = 1e-3  # tiny VAE 2.2, card vs CPU, of scale: f32 convolutions (TF32 off) summed in
# other orders by cuDNN and oneDNN, as ENCODE_TOL
XLM_TOL = 1e-4  # XLM-R large, card vs CPU, of scale: f32 GEMMs (TF32 off) in other orders
XLM_IDS = (2, 512)  # a CLIP text batch at the 512 tokens the reference pads to
I2V_SOURCE = (720, 1280, 3)  # the first frame: a 1280x720 still, so both resizes run


def _tiny_i2v_config() -> PipelineConfig:
    """An i2v model at head dim 128 (the kernels' head dim) with a 2.1 VAE
    of width 8."""
    return PipelineConfig(
        name="tiny-i2v",
        dit=WanDiTConfig(model_type="i2v", patch_size=(1, 2, 2), text_len=16, in_dim=12, dim=256,
                         ffn_dim=512, freq_dim=32, text_dim=48, out_dim=4, num_heads=2,
                         num_layers=2),
        vae=VAEConfig(dim=8, z_dim=4), max_context_len=16)


TINY_CLIP = CLIPVisionConfig(image_size=32, patch_size=2, dim=1280, mlp_ratio=1.0, num_heads=16,
                             num_layers=2)  # img_emb's width, 257 tokens


class _PerForward:
    """Each kernel's launches per forward of one DiT (hooks)."""

    def __init__(self, dit):
        self.per_forward = []
        dit.register_forward_pre_hook(lambda *a: setattr(self, "start", _launches()))
        dit.register_forward_hook(lambda *a: self.per_forward.append(
            {k: v - self.start[k] for k, v in _launches().items() if v != self.start[k]}))


def _i2v_expect(cfg: PipelineConfig) -> dict:
    """Launches per i2v forward: per block the fused prologue (qk_prep on the
    self-attention's q and k, the cross-attention's q, text and image keys),
    the self-attention's flash launch, the cross-attention's one pair launch
    (text and image keys), the three AdaLN sandwiches; and the head's."""
    n = cfg.dit.num_layers
    return {"qk_prep": 5 * n, "flash_fwd": n, "flash_pair": n, "fused_adaln": 3 * n + 1}


def phase_tiny_i2v() -> dict:
    """WanI2V.generate at tiny width on the card (kernels) vs the CPU (plain
    twins) from the same weights, first frame, contexts and noise: latents
    and the decoded video, and the launches per forward."""
    cfg = _tiny_i2v_config()
    gen = torch.Generator().manual_seed(41)
    pipes = {}
    for dev in ("cpu", "cuda"):
        g = torch.Generator(device=dev).manual_seed(6)
        wan = WanDiT(cfg.dit, dtype=cfg.torch_param_dtype, device=dev, generator=g)
        clip = init_clip_vision(TINY_CLIP, device=dev, generator=g)
        vae = Wan21VAE.create(init_vae(cfg.vae, device=dev, generator=g), cfg.vae)
        pipes[dev] = WanI2V(cfg, wan, vae, clip, TINY_CLIP, ew_impl="kernel")
    with torch.no_grad():  # init zero-fills the head: make velocities non-zero
        pipes["cpu"].wan.head.head.weight.normal_(0.0, 0.1, generator=gen)
    pipes["cuda"].wan.load_state_dict(pipes["cpu"].wan.state_dict())
    pipes["cuda"].clip.load_state_dict(pipes["cpu"].clip.state_dict())
    _copy_tree(pipes["cpu"].vae.params, pipes["cuda"].vae.params)
    img = torch.randint(0, 256, (48, 80, 3), generator=gen, dtype=torch.uint8)
    ctx = torch.randn(12, cfg.dit.text_dim, generator=gen)
    noise = torch.randn(1, 4, 3, 8, 8, generator=gen)
    kw = dict(precomputed_context=ctx, precomputed_context_null=torch.zeros_like(ctx),
              size=(64, 64), frame_num=9, sampling_steps=3, guide_scale=5.0, shift=5.0,
              noise=noise)
    counts = _PerForward(pipes["cuda"].wan)
    lat_c = pipes["cpu"].generate(img, decode=False, **kw)
    _reset_launches()
    lat_g = pipes["cuda"].generate(img, decode=False, **kw).cpu()
    launches = _launches()
    per_forward = list(counts.per_forward)
    # the two decoders on the same latents (the CPU's); then the CPU decoder
    # on both sets of latents, the witness of how far it carries their gap,
    # which sets the limit for each device's own video
    vid_c, vid_g = pipes["cpu"].decode(lat_c), pipes["cuda"].decode(lat_c).cpu()
    witness = float((pipes["cpu"].decode(lat_g) - vid_c).abs().max())
    own = float((pipes["cuda"].decode(lat_g).cpu() - vid_c).abs().max())
    frames = pipes["cuda"].decode(lat_g, output_uint8=True)
    expect = _i2v_expect(cfg)
    rec = {"phase": "tiny_i2v", "latent_rel_err": float((lat_g - lat_c).abs().max()
                                                        / lat_c.abs().max()),
           "latent_max_abs_err": float((lat_g - lat_c).abs().max()),
           "tolerance_rel": I2V_TOL, "decode_max_abs_err": float((vid_g - vid_c).abs().max()),
           "decode_tolerance": ENCODE_TOL, "cpu_decode_latent_gap": witness,
           "own_video_max_abs_err": own, "own_video_tolerance": witness + ENCODE_TOL,
           "first_frame": list(img.shape),
           "clip_tokens": TINY_CLIP.num_tokens, "frames_shape": list(frames.shape),
           "launches": launches, "per_forward": per_forward, "expected_per_forward": expect}
    emit(rec)
    if (not torch.isfinite(lat_g).all() or rec["latent_rel_err"] > I2V_TOL
            or rec["decode_max_abs_err"] > ENCODE_TOL or own > witness + ENCODE_TOL
            or per_forward != [expect] * 3 or tuple(frames.shape) != (9, 64, 64, 3)):
        raise AssertionError(f"tiny_i2v: {rec}")
    return rec


def phase_i2v() -> dict:
    """I2V-14B at full width and depth from seeded bf16 weights, with the
    full ViT-H/14 CLIP and Wan2.1 VAE: a seeded 1280x720 first frame,
    832x480x81, seeded 512x4096 contexts, I2V_STEPS UniPC steps at shift 5,
    CFG 5.0, f32 residual, both fused kernels; launches per forward
    asserted, one profiled forward, the DiT freed, the decode to uint8."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = I2V_14B
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(15)
    t0 = time.perf_counter()
    wan = WanDiT(cfg.dit, dtype=torch.bfloat16, device="cuda", generator=gen)
    with torch.no_grad():  # init zero-fills the head: make velocities non-zero
        wan.head.head.weight.normal_(0.0, cfg.dit.dim**-0.5, generator=gen)
    clip_cfg = CLIPVisionConfig()
    clip = init_clip_vision(clip_cfg, dtype=torch.bfloat16, device="cuda", generator=gen)
    vae = Wan21VAE.create(init_vae(cfg.vae, device="cuda", generator=gen), cfg.vae)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in wan.parameters())
    wan_gb = sum(p.numel() * p.element_size() for p in wan.parameters()) / 1e9
    clip_params = sum(p.numel() for p in clip.parameters())
    pipe = WanI2V(cfg, wan, vae, clip, clip_cfg, qk_impl="kernel", ew_impl="kernel")
    del wan, clip  # the pipeline holds them until free_model()
    img = torch.randint(0, 256, I2V_SOURCE, generator=gen, device="cuda", dtype=torch.uint8)
    ctx = torch.randn(CTX_LEN, cfg.dit.text_dim, generator=gen, device="cuda")
    ctx_null = torch.randn(CTX_LEN, cfg.dit.text_dim, generator=gen, device="cuda")
    counts = _PerForward(pipe.wan)
    _reset_launches()
    latents = pipe.generate(img, precomputed_context=ctx, precomputed_context_null=ctx_null,
                            size=SIZE, frame_num=FRAMES, shift=5.0, sampling_steps=I2V_STEPS,
                            guide_scale=5.0, decode=False, generator=gen)
    launches = _launches()
    per_forward = list(counts.per_forward)
    timings = dict(pipe.timings)
    expect = _i2v_expect(cfg)
    dit = pipe.wan
    with torch.inference_mode():
        x2 = torch.cat([latents, latents]).bfloat16()
        y2 = torch.randn(2, 4 + cfg.vae.z_dim, *latents.shape[2:], generator=gen,
                         device="cuda").bfloat16()
        clip2 = torch.randn(2, clip_cfg.num_tokens, clip_cfg.dim, generator=gen,
                            device="cuda").bfloat16()
        ctx2 = dit.embed_context(torch.randn(2, CTX_LEN, cfg.dit.text_dim, generator=gen,
                                             device="cuda").bfloat16())
        t = torch.full((2,), 999.0, device="cuda")
        profile = _profile(lambda: dit(x2, t, ctx2, context_embedded=True, ew_impl="kernel",
                                       y=y2, clip_fea=clip2))
    del x2, y2, clip2, ctx2, dit
    counts = None
    denoise_peak = torch.cuda.max_memory_allocated() / 1e9
    pipe.free_model()
    after_free_gb = torch.cuda.memory_allocated() / 1e9
    frames = pipe.decode(latents, output_uint8=True)
    shape = tuple(frames.shape)
    rec = {"phase": "i2v", "config": "I2V_14B", "layers": cfg.dit.num_layers, "dim": cfg.dit.dim,
           "heads": cfg.dit.num_heads, "ffn_dim": cfg.dit.ffn_dim, "in_dim": cfg.dit.in_dim,
           "params": n_params, "weights_gb": wan_gb, "clip_params": clip_params,
           "init_s": init_s, "first_frame": list(I2V_SOURCE), "seq_len": SEQ,
           "context_len": clip_cfg.num_tokens + CTX_LEN, "size": list(SIZE), "frames": FRAMES,
           "steps": I2V_STEPS, "shift": 5.0, "guide_scale": 5.0, "residual_dtype": "float32",
           "latents": list(latents.shape), **timings, "decode_s": pipe.timings["decode_s"],
           "launches": launches,
           "per_forward": per_forward, "expected_per_forward": expect,
           "frames_shape": list(shape), "frames_mean": float(frames.float().mean()),
           "step_s_beside_profiled_forward": {
               "step_s": timings["step_s"],
               "profiled_forward_wall_ms": profile["wall_ms_traced"],
               "profiled_forward_busy_ms": profile["device_busy_ms"]},
           "denoise_peak_gb": denoise_peak, "allocated_after_free_gb": after_free_gb,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "profile_one_forward": profile}
    emit(rec)
    want = {"qk_prep": expect["qk_prep"] * I2V_STEPS, "flash_fwd": expect["flash_fwd"] * I2V_STEPS,
            "flash_pair": expect["flash_pair"] * I2V_STEPS, "flash_causal": 0, "flash_d72": 0,
            "fused_adaln": expect["fused_adaln"] * I2V_STEPS, "ring_step": 0}
    if (launches != want or per_forward != [expect] * I2V_STEPS
            or shape != (FRAMES, SIZE[1], SIZE[0], 3) or rec["max_memory_allocated_gb"] >= 80.0
            or after_free_gb > 2.0
            or tuple(latents.shape) != (1, cfg.vae.z_dim, GRID[0], SIZE[1] // 8, SIZE[0] // 8)):
        raise AssertionError(f"i2v: launches {launches} (expected {want}), per forward "
                             f"{per_forward}, frames {shape}, latents {tuple(latents.shape)}")
    del pipe, vae, latents, frames
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _vae22_sd(cfg: VAE22Config, device, gen) -> dict:
    """A seeded reference-layout Wan2.2 VAE state dict: conv weights
    N(0, 1/fan_in), biases zero, norm gains one."""
    sd = {}
    for name, shape in vae22_reference_shapes(cfg).items():
        if name.endswith(".gamma"):
            sd[name] = torch.ones(shape, device=device)
        elif name.endswith(".bias"):
            sd[name] = torch.zeros(shape, device=device)
        else:
            fan_in = int(np.prod(shape[1:]))
            sd[name] = torch.randn(shape, generator=gen, device=device) * fan_in**-0.5
    return sd


def phase_vae22() -> dict:
    """The Wan2.2 VAE: at tiny width, encode and decode on the card against
    the CPU from one seeded state dict; at full width (VAE22Config()), a
    seeded state dict through vae22_state_dict_to_params, a seeded 832x480
    clip encoded and decoded back: shapes, finite values, seconds, peak."""
    gc.collect()
    torch.cuda.empty_cache()
    tiny = VAE22Config(dim=8, dec_dim=12, z_dim=6)
    sd = _vae22_sd(tiny, "cpu", torch.Generator().manual_seed(22))
    x = torch.rand(1, 3, 9, 64, 64, generator=torch.Generator().manual_seed(23)) * 2 - 1
    cpu = Wan22VAE.create(vae22_state_dict_to_params(sd, tiny, device="cpu"), tiny)
    gpu = Wan22VAE.create(vae22_state_dict_to_params(sd, tiny, device="cuda"), tiny)
    z_c, z_g = cpu.encode(x), gpu.encode(x.cuda()).cpu()
    r_c, r_g = cpu.decode(z_c), gpu.decode(z_c.cuda()).cpu()
    tiny_rec = {"encode_rel_err": float((z_g - z_c).abs().max() / z_c.abs().max()),
                "decode_rel_err": float((r_g - r_c).abs().max() / r_c.abs().max()),
                "latents": list(z_g.shape), "tolerance_rel": VAE22_TOL}

    cfg = VAE22Config()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(24)
    vae = Wan22VAE.create(vae22_state_dict_to_params(_vae22_sd(cfg, "cuda", gen), cfg), cfg)
    n_params = sum(t.numel() for t in _flat(vae.params).values())
    clip = torch.rand(1, 3, FRAMES, SIZE[1], SIZE[0], generator=gen, device="cuda") * 2 - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = vae.encode(clip)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    enc_peak = torch.cuda.max_memory_allocated() / 1e9
    del clip
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    video = vae.decode(z)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    lat = (cfg.z_dim, (FRAMES - 1) // 4 + 1, SIZE[1] // 16, SIZE[0] // 16)
    rec = {"phase": "vae22", "tiny": tiny_rec, "config": "VAE22Config()", "params": n_params,
           "frames": FRAMES, "size": list(SIZE), "latents": list(z.shape[1:]),
           "video": list(video.shape[1:]), "finite": bool(torch.isfinite(z).all()
                                                          and torch.isfinite(video).all()),
           "encode_s": encode_s, "decode_s": decode_s, "encode_peak_gb": enc_peak,
           "decode_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(rec)
    if (tiny_rec["encode_rel_err"] > VAE22_TOL or tiny_rec["decode_rel_err"] > VAE22_TOL
            or tuple(z.shape[1:]) != lat or not rec["finite"]
            or tuple(video.shape[1:]) != (3, FRAMES, SIZE[1], SIZE[0])):
        raise AssertionError(f"vae22: {rec}")
    del vae, z, video
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_xlm() -> dict:
    """XLM-Roberta large with the CLIP head (out_dim 1024) at full width, f32,
    on the card against the same weights on the host CPU: XLM_IDS
    seeded ids with pad tails; hidden states and the pooled output."""
    params_c = init_xlm_roberta(out_dim=1024, device="cpu",
                                generator=torch.Generator().manual_seed(25))
    params_g = to_torch(params_c, "cuda")
    rng = np.random.default_rng(26)
    ids = torch.from_numpy(rng.integers(3, 250002, XLM_IDS))
    ids[:, 0] = 0
    for b, n in enumerate((400, 137)):  # each row's tokens, then pads
        ids[b, n - 1] = 2
        ids[b, n:] = PAD_ID
    t0 = time.perf_counter()
    h_c = xlm_roberta_apply(params_c, ids)
    p_c = xlm_roberta_with_head_apply(params_c, ids)
    cpu_s = time.perf_counter() - t0
    h_g = xlm_roberta_apply(params_g, ids).cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_g = xlm_roberta_with_head_apply(params_g, ids)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    p_g = p_g.cpu()
    live = ids != PAD_ID
    rec = {"phase": "xlm", "config": "XLM-R large (vocab 250002, 514 positions, dim 1024, 16 "
           "heads, 24 layers) + head 1024", "params": sum(t.numel() for t in _flat(params_c).values()),
           "ids": list(ids.shape), "tokens": live.sum(1).tolist(),
           "hidden_rel_err": float((h_g - h_c)[live].abs().max() / h_c[live].abs().max()),
           "pooled_rel_err": float((p_g - p_c).abs().max() / p_c.abs().max()),
           "tolerance_rel": XLM_TOL, "with_head_s": card_s, "cpu_s": cpu_s}
    emit(rec)
    if rec["hidden_rel_err"] > XLM_TOL or rec["pooled_rel_err"] > XLM_TOL:
        raise AssertionError(f"xlm: {rec}")
    del params_g
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


def _flash_train_case(name, B, Lq, Lk, lens, gen, reps, N=12):
    D = 128
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
    """Rows 3b, 4 and 5 at the training path's shapes: T2V-1.3B's 12 heads
    (self, cross over its 6,272-token context, ragged), then T2V-A14B's 40
    (self, cross over the streamed LoRA step's CTX_LEN context); returns the
    12-head self-attention case (the kernels line reads it)."""
    main = _flash_train_case("self", 1, SEQ, SEQ, None, gen, reps=3)
    _flash_train_case("cross", 1, SEQ, 6272, None, gen, reps=5)
    _flash_train_case("kv_lens_ragged", 2, 4100, 8190, [5001, 0], gen, reps=5)
    _flash_train_case("self_n40", 1, SEQ, SEQ, None, gen, reps=2, N=40)
    _flash_train_case("cross_n40", 1, SEQ, CTX_LEN, None, gen, reps=3, N=40)
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
    """The DiT trainer's kernels (rows 3b, 4 and 5)."""
    return {k: flash_attention_train.launches[k] for k in TRAIN_ROWS}


def _bwd_f32_launches() -> dict:
    """Rows 4 and 5 on f32 operands (the f32 ring backward's earlier shards)."""
    return {k: flash_attention_train.launches[k] for k in BWD_F32_ROWS}


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


def _train_setup(device="cuda", layers: int = TRAIN_LAYERS):
    """The train phase's T2V_1_3B model (`layers` deep), config and data,
    from fixed seeds: (cfg, tc, params, batch, draws)."""
    cfg = T2V_1_3B.replace(dit=T2V_1_3B.dit.replace(num_layers=layers))
    # the JAX CLI's learning rate, 3e-6: Adam's first step moves every param by ~lr,
    # and 1e-4 on all 1.43B params overshoots (loss 2.87 → 17.6 on this batch)
    tc = TrainConfig(warmup_steps=0, total_steps=1000, remat=True)
    params = init_unified_params(cfg, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    with torch.no_grad():  # init zero-fills the head: every block gradient would be 0
        params.wan.head.head.weight.normal_(0.0, cfg.dit.dim**-0.5, generator=gen)
    lat = (1, cfg.dit.in_dim, GRID[0], GRID[1] * 2, GRID[2] * 2)
    batch = {"latents": torch.randn(lat, generator=gen, device=device),
             "context": torch.randn(1, CTX_LEN, cfg.dit.text_dim, generator=gen, device=device),
             "vlm": torch.randn(1, CTX_LEN, cfg.vlm_in_dim, generator=gen, device=device),
             "visual_emb": torch.randn(lat, generator=gen, device=device)}
    return cfg, tc, params, batch, sample_draws(gen, lat, tc)


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


class GradSpy:
    """Wraps tx.update: per call, the grads the optimizer gets, either kept
    on the host ("capture") or held leaf by leaf to captured ones
    ("compare": ‖g − g_ref‖/‖g_ref‖). `seconds` is its own time, which the
    step times leave out."""

    def __init__(self, tx, ref=None, keep: int = 2):
        self.update, self.ref, self.keep = tx.update, ref, keep
        self.grads, self.worst, self.seconds, self.calls = [], [], 0.0, 0
        tx.update = self

    def __call__(self, model, grads, opt_state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if self.calls < (self.keep if self.ref is None else min(self.keep, len(self.ref))):
            if self.ref is None:
                self.grads.append({n: _full(g).detach().to("cpu", copy=True)
                                   for n, g in grads.items()})
            else:
                worst = (0.0, "")
                for n, g in grads.items():
                    r = self.ref[self.calls][n].to(g.device, non_blocking=True)
                    g = _full(g).float()
                    rel = float((g - r).norm() / r.norm().clamp_min(1e-30))
                    worst = max(worst, (rel, n))
                self.worst.append(worst)
        self.calls += 1
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        return self.update(model, grads, opt_state)


def phase_train() -> dict:
    """make_unified_train_step on T2V_1_3B at full width, TRAIN_LAYERS
    deep; the record keeps the first two steps' grads ("ref_grads", on the host) for
    the sp_train phase."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, tc, params, batch, draws = _train_setup()
    lat = tuple(batch["latents"].shape)
    tx = make_optimizer(tc, params)
    state = init_train_state(params, tx)
    step = make_unified_train_step(cfg, tc, tx)
    spy = GradSpy(tx)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    rows, step_s, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        _reset_launches()
        _reset_train_launches()
        torch.cuda.synchronize()
        t0, spy_s = time.perf_counter(), spy.seconds
        state, m = step(state, batch, draws)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0 - (spy.seconds - spy_s))
        rows.append((loss, gnorm))
        per_step.append({**_train_launches(), **_launches()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state_bytes = sum(t.numel() * t.element_size() for k in ("mu", "nu")
                      for t in state.opt_state[k].values())
    expect = _train_expect(cfg)
    profile = _profile(lambda: step(state, batch, draws))
    rec = {"phase": "train", "config": "T2V_1_3B", "layers": cfg.dit.num_layers,
           "dim": cfg.dit.dim, "params": n_params, "latents": list(lat), "seq_len": SEQ,
           "context_len": cfg.max_context_len, "remat": tc.remat, "carry_dtype": tc.carry_dtype,
           "lr": tc.learning_rate, "tid": int(draws[0][0]), "cfg_drop": bool(draws[2][0]),
           "init_s": init_s, "loss": [r[0] for r in rows], "grad_norm": [r[1] for r in rows],
           "step_s": step_s, "train_step_s": sum(step_s[1:]) / (len(step_s) - 1),
           "max_memory_allocated_gb": peak_gb, "optimizer_state_bytes": state_bytes,
           "launches_per_step": per_step, "profile_one_step": profile}
    emit(rec)
    finite = all(np.isfinite(r[0]) and np.isfinite(r[1]) for r in rows)
    if (not finite or not rows[-1][0] < rows[0][0] or any(p != expect for p in per_step)
            or peak_gb >= 80.0):
        raise AssertionError(f"train: {rec} (launches expected {expect} per step)")
    rec["launches"] = per_step[0]
    del state, params, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    rec["ref"] = {"loss": [r[0] for r in rows], "grad_norm": [r[1] for r in rows],
                  "grads": spy.grads}
    return rec


SP_TRAIN_STEPS = 2
SP_LOSS_TOL = 2e-3  # rel, a mesh step's loss vs the single-card step's: the same kernels on
# the same tokens, sums over ranks in another order (the tiny train's card-vs-CPU limit)
SP_GNORM_TOL = 1e-2  # rel, grad_norm; and per leaf ‖g − g_ref‖/‖g_ref‖ (the flash_train
# limit: the ring's backward recomputes p from its own LSE, bf16 p and ds at other points)
BWD_F32_TOL = 1e-5  # ‖g − g_plain‖/‖g_plain‖ per (batch row, head), rows 4 and 5 on f32
# operands vs flash_bwd_plain on f32 (TF32 off): f32-accurate products (three tf32 products,
# tests/test_torch_flash_bwd_f32_split.py) summed in other orders
BWD_F32_DENSE_TOL = 1e-4  # the f32 ring backward vs the dense f32 causal backward, the same
# norm: the ring's forward LSE comes from the f32 step kernel (RING_F32_TOL)


def _ring_bwd_case(name, q, k, v, do, n, kv=None, causal=None, reps=3) -> dict:
    """The ring backward over n in-process shards (ring_flash_backward_shards,
    rows 4 and 5 per step: on bf16 operands, or on f32 operands, as q/k/v/dO
    come) from the ring forward's outputs and LSEs, held per (batch row,
    head) to the same loop with flash_bwd_plain (GRAD_TOL for bf16,
    BWD_F32_TOL for f32) and, for the non-causal bf16 cases, to flash_bwd
    over the whole sequence (row 3b's LSE); the dtype's row 4 and row 5
    launches per ring backward asserted, the other dtype's none."""
    B, L, N, D = q.shape
    f32 = q.dtype == torch.float32
    names = BWD_KERNELS[q.dtype]
    others = BWD_KERNELS[torch.bfloat16 if f32 else torch.float32]
    tol = BWD_F32_TOL if f32 else GRAD_TOL
    qs, ks, vs, dos = (_shards(t, n) for t in (q, k, v, do))
    fwd = ring_flash_attention_shards(qs, ks, vs, kv_lens=kv, causal=causal, return_lse=True)
    outs, lses = [f[0] for f in fwd], [f[1] for f in fwd]
    _reset_train_launches()
    grads = ring_flash_backward_shards(qs, ks, vs, outs, lses, dos, kv, causal)
    torch.cuda.synchronize()
    launches = dict(flash_attention_train.launches)
    steps = {None: n * n, "block": n * (n + 1) // 2, "token": n * (n - 1) // 2}[causal]
    plain = ring_flash_backward_shards(qs, ks, vs, outs, lses, dos, kv, causal,
                                       bwd=flash_bwd_plain)
    cat = lambda gs, i: torch.cat([g[i] for g in gs], 1)  # noqa: E731
    err_plain = {t: float(_grad_rel(cat(grads, i), cat(plain, i)).max())
                 for i, t in enumerate(("dq", "dk", "dv"))}
    err_whole = None
    if causal is None and not f32:
        o_w, lse_w = flash_fwd_lse(q, k, v, kv)
        whole = flash_bwd(q, k, v, do, lse_w, flash_delta(do, o_w), kv)
        err_whole = {t: float(_grad_rel(cat(grads, i), whole[i]).max())
                     for i, t in enumerate(("dq", "dk", "dv"))}
        del o_w, lse_w, whole
    rec = {"phase": "sp_train", "part": "ring_backward", "case": name, "q": [B, L, N, D],
           "dtype": str(q.dtype).replace("torch.", ""), "shards": n,
           "kv_lens": kv.tolist() if kv is not None else None, "causal": causal,
           "launches": {k: launches[k] for k in names}, "launches_expected": steps,
           "launches_other_dtype": {k: launches[k] for k in others},
           "max_rel_err_per_head_vs_plain": err_plain,
           "max_rel_err_per_head_vs_whole": err_whole, "tolerance": tol,
           "max_abs_err": max(float((cat(grads, i) - cat(plain, i)).abs().max())
                              for i in range(3))}
    bad = (max(err_plain.values()) > tol
           or (err_whole is not None and max(err_whole.values()) > GRAD_TOL)
           or any(launches[k] != steps for k in names) or any(launches[k] for k in others)
           or not all(torch.isfinite(g).all() for gs in grads for g in gs))
    if bad:
        raise AssertionError(f"sp_train ring backward {name}: {rec}")
    del plain
    rec["ms_per_rank"] = cuda_ms(lambda: ring_flash_backward_shards(
        qs, ks, vs, outs, lses, dos, kv, causal), reps) / n
    rec["plain_ms_per_rank"] = cuda_ms(lambda: ring_flash_backward_shards(
        qs, ks, vs, outs, lses, dos, kv, causal, bwd=flash_bwd_plain), 1, 0) / n
    # bound per rank from this run's data: the kernels' steps (the token mode's own-shard
    # step is plain torch), each operand read once per step; f32 operands take three tf32
    # products each at the tf32 rate
    Ls = L // n
    pairs = 0
    for r in range(n):
        for s in range(n):
            src = (r - s) % n
            if (causal == "block" and src > r) or (causal == "token" and src >= r):
                continue
            live = Ls if kv is None else int(step_lens_for(kv, src, Ls, n).sum()) // B
            pairs += B * Ls * live
    row = N * D
    stat = B * N * Ls * 4
    esize, flop_per, rate = (4, 3 * 14, TF32_FLOPS) if f32 else (2, 14, BF16_FLOPS)
    nbytes = steps * ((4 * B * Ls) * row * esize + 2 * stat + 3 * B * Ls * row * 4)
    t_ops = flop_per * N * D * pairs / rate * 1e3 / n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3 / n
    rec.update(bound_ms_per_rank=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    emit(rec)
    del grads
    return rec


def _sp_train_ring_backward(gen: torch.Generator) -> dict:
    """(a): the ring backward at a 4-card run's per-rank shapes."""
    recs = {}

    def dit(name, L, lens):
        q, k = _normed(1, L, 12, 128, gen), _normed(1, L, 12, 128, gen)
        v = torch.randn(1, L, 12, 128, generator=gen, device="cuda").to(torch.bfloat16)
        do = torch.randn(1, L, 12, 128, generator=gen, device="cuda").to(torch.bfloat16)
        kv = None
        if lens is not None:  # padded query rows' outputs are dropped: no grad reaches them
            kv = torch.tensor([lens], dtype=torch.int32, device="cuda")
            do[:, lens:] = 0
        recs[name] = _ring_bwd_case(name, q, k, v, do, RING_N, kv)

    dit("sp4", SEQ, None)  # 4 shards of 8,190
    dit("sp4_pad8", 32768, 32760)  # the last shard ends in 8 pad keys
    dit("sp4_empty_shard", 32768, 24576)  # the last shard is all padding
    B, L, N, D = CAUSAL_Q
    q, k = _normed(B, L, N, D, gen), _normed(B, L, N, D, gen)
    v = torch.randn(B, L, N, D, generator=gen, device="cuda").to(torch.bfloat16)
    do = torch.randn(B, L, N, D, generator=gen, device="cuda").to(torch.bfloat16)
    for causal in ("block", "token"):
        recs[causal] = _ring_bwd_case(causal, q, k, v, do, RING_N, causal=causal)
    torch.cuda.empty_cache()
    return recs


def _mode_mesh(mode: str, world: int, device: str):
    """(mesh, SPConfig or None, shard the params?) of a train/generate mode."""
    if mode in ("ring", "ulysses"):
        mesh = create_mesh(sp=world, device=device)
        return mesh, SPConfig(mesh, mode), False
    if mode == "fsdp":
        return create_mesh(fsdp=world, device=device), None, True
    if mode == "tp":
        mesh = create_mesh(tp=world, device=device)
        return mesh, SPConfig(mesh, "tp"), True
    if mode == "dp2_fsdp2":
        return create_mesh(dp=2, fsdp=world // 2, device=device), None, True
    raise ValueError(mode)


def _train_mode(mode: str, world: int, ref: dict, device: str = "cuda") -> dict:
    """SP_TRAIN_STEPS steps of the train phase's step under `mode` on a
    `world`-rank mesh, each held to the single-card step's loss and
    grad_norm, and step 1 to its per-leaf grads (`ref`); under dp2_fsdp2
    the global batch is the train batch twice with the same draws, so its
    numbers are one row's."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, tc, params, batch, draws = _train_setup(device)
    mesh, sp, shard = _mode_mesh(mode, world, device)
    if shard:
        shard_params(params, mesh)
    tx = make_optimizer(tc, params)
    state = init_train_state(params, tx)
    step = make_unified_train_step(cfg, tc, tx, mesh=mesh, sp=sp)
    spy = GradSpy(tx, ref=ref["grads"], keep=SP_TRAIN_STEPS)
    if mode == "dp2_fsdp2":
        draws = tuple(None if d is None else torch.cat([d, d]) for d in draws)
    rows, step_s, per_step = [], [], []
    for _ in range(SP_TRAIN_STEPS):
        _reset_launches()
        _reset_train_launches()
        torch.cuda.synchronize()
        t0, spy_s = time.perf_counter(), spy.seconds
        state, m = step(state, batch, draws)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0 - (spy.seconds - spy_s))
        rows.append((loss, gnorm))
        per_step.append({**_train_launches(), **_launches()})
    layers, n = cfg.dit.num_layers, world if mode == "ring" else 1
    ring = mode == "ring"
    expect = {"flash_fwd_lse": (2 if ring else 4) * layers,
              "flash_bwd_dq": (1 + n if ring else 2) * layers,
              "flash_bwd_dkv": (1 + n if ring else 2) * layers,
              "ring_step": 2 * n * layers if ring else 0,
              "qk_prep": 0, "flash_fwd": 0, "flash_causal": 0, "flash_d72": 0, "fused_adaln": 0,
              "flash_pair": 0}
    rec = {"mode": mode, "world": world, "loss": [r[0] for r in rows],
           "grad_norm": [r[1] for r in rows], "step_s": step_s, "train_step_s": step_s[-1],
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_step": per_step, "launches_expected": expect,
           "loss_rel_err": [abs(r[0] / ref["loss"][i] - 1) for i, r in enumerate(rows)],
           "grad_norm_rel_err": [abs(r[1] / ref["grad_norm"][i] - 1) for i, r in enumerate(rows)],
           "worst_leaf_grad_rel_err": spy.worst}
    # per-leaf grads are held at step 1, from the same params: Adam's first update moves
    # each element by ~lr whatever its grad's size, so an element whose grad is nearly 0
    # (the self-attention k bias: the softmax all but ignores it) may step either way
    # under a last-bit difference, and step 2's leaf then differs by more (reported)
    rec["ok"] = (max(rec["loss_rel_err"]) <= SP_LOSS_TOL
                 and max(rec["grad_norm_rel_err"]) <= SP_GNORM_TOL
                 and spy.worst[0][0] <= SP_GNORM_TOL
                 and all(p == expect for p in per_step))
    del state, params, step, batch, tx
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _sp_train_rank(rank, world, port, tmp, modes, gen_modes, sft_modes):
    """One rank of sp_train's multi-card part: the train modes on this card,
    then the SFT modes, then the generate modes; rank 0 writes the records
    and latents."""
    maybe_initialize_distributed(f"localhost:{port}", world, rank, device="cuda", local_rank=rank)
    try:
        ref = torch.load(Path(tmp) / "ref.pt", mmap=True)
        recs = {m: _train_mode(m, world, ref) for m in modes}
        sft_ref = torch.load(Path(tmp) / "sft_ref.pt", mmap=True)
        recs.update({"sft_" + m: _sft_mode(m, world, sft_ref) for m in sft_modes})
        recs.update(_qwen3_sp_modes(world))
        lats = {}
        if gen_modes:
            base, ctx, _ = t2v_pipeline(T2V_1_3B, "cuda", with_vae=False)
            features = torch.load(Path(tmp) / "features.pt").to(ctx.device)
        for mode in gen_modes:
            mesh, sp, shard = _mode_mesh(mode, world, "cuda")
            wan = base.low_noise.wan  # a fresh copy of the seeded expert, to shard
            expert = ExpertParams(wan=type(wan)(wan.cfg, wan.param_dtype, "cuda"),
                                  companions=base.low_noise.companions)
            expert.wan.load_state_dict(wan.state_dict())
            pipe = OmniVideoX2XUnified(T2V_1_3B, expert, residual_dtype="bfloat16",
                                       qk_impl="unfused", sp=sp)
            if shard:
                pipe.shard(mesh)
            _sp_generate(pipe, ctx, features, SIZE, FRAMES, steps=1)  # warm-up
            lat, step_s, _ = _sp_generate(pipe, ctx, features, SIZE, FRAMES)
            lats[mode] = lat.cpu()
            recs["generate_" + mode] = {"denoise_step_s": step_s,
                                        "max_memory_allocated_gb":
                                            torch.cuda.max_memory_allocated() / 1e9}
            del pipe, expert
            gc.collect()
            torch.cuda.empty_cache()
        if rank == 0:
            torch.save(lats, Path(tmp) / "latents.pt")
            (Path(tmp) / "records.json").write_text(json.dumps(recs))
    finally:
        dist.destroy_process_group()


def _qwen3_sp_modes(world: int) -> dict:
    """On each of `world` NCCL ranks: qwen3_forward_sp on the sp_train SFT
    model (SFT_MESH_CFG, seeded weights) in f32 and in bf16 over the 2 ×
    SFT_SEQ ids, as a ring of `world` and, on 4 cards, as ring 2 × Ulysses
    2, each held to this card's own one-card qwen3_forward on the same
    weights within SP_TOL of scale (f32 through the dense causal path, which
    the causal flash kernel's bf16 operands would round; bf16 through row
    2), with the one-card run's routing replayed on the rank's tokens (in
    bf16 the two attention kernels round differently, which flips router
    near-ties: the gap with the rank's own routing is reported beside it),
    and the dtype's ring step kernel launched world × ring × layers times
    over the ranks in the timed run and the other dtype's never."""
    layers = SFT_MESH_CFG.num_hidden_layers
    gen = torch.Generator(device="cuda").manual_seed(SP_SEED)
    ids = torch.randint(SFT_MESH_CFG.vocab_size, (2, SFT_SEQ), generator=gen, device="cuda")
    meshes = {f"ring{world}": (dict(sp=world), None)}
    if world == 4:
        meshes["ring2_ulysses2"] = (dict(fsdp=2, sp=2), "fsdp")
    recs = {}
    f32 = _sft_model(SFT_MESH_CFG, 1).lm.requires_grad_(False)
    for dtype in (torch.float32, torch.bfloat16):
        model = f32 if dtype == torch.float32 else f32.to(torch.bfloat16)  # in place
        kernel, other = (("ring_step_f32", "ring_step") if dtype == torch.float32
                         else ("ring_step", "ring_step_f32"))
        mask = torch.ones_like(ids) if dtype == torch.float32 else None
        with _Routing() as routing:
            ref = qwen3_forward(model, ids, mask)[1]
        for name, (kw, ulysses) in meshes.items():
            mesh = create_mesh(**kw)
            Ll = SFT_SEQ // world  # this rank's tokens of each batch row, from `start`
            nu, iu = (1, 0) if ulysses is None else (kw[ulysses], mesh.get_local_rank(ulysses))
            start = (mesh.get_local_rank("seq") * nu + iu) * Ll
            rows = (torch.arange(ids.shape[0])[:, None] * SFT_SEQ + start
                    + torch.arange(Ll)[None, :]).reshape(-1)
            with torch.inference_mode():
                qwen3_forward_sp(model, ids, mesh, ulysses_axis=ulysses)  # warm-up
                _reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, own = qwen3_forward_sp(model, ids, mesh, ulysses_axis=ulysses)
                torch.cuda.synchronize()
                sp_s = time.perf_counter() - t0
                local = {"ring_step": ring_step.launches, "ring_step_f32": ring_step.launches_f32}
                with _Routing(routing.calls, rows):
                    _, logits = qwen3_forward_sp(model, ids, mesh, ulysses_axis=ulysses)
            counts = torch.tensor([local[k] for k in sorted(local)], device="cuda")
            dist.all_reduce(counts)
            launches = dict(zip(sorted(local), counts.tolist()))
            rel = _scale_rel(logits, ref)
            expect = world * kw["sp"] * layers
            recs[f"qwen3_sp_{name}_{str(dtype).replace('torch.', '')}"] = {
                "world": world, "mesh": kw, "ulysses_axis": ulysses, "seq_len": SFT_SEQ,
                "forward_s": sp_s, "logits_rel_err": rel,
                "logits_rel_err_own_routing": _scale_rel(own, ref), "tolerance_rel": SP_TOL,
                "launches_all_ranks": launches, "launches_expected": {kernel: expect, other: 0},
                "ok": (rel <= SP_TOL and bool(torch.isfinite(logits).all())
                       and launches[kernel] == expect and launches[other] == 0)}
            del logits, own
        del ref
    del model, f32
    gc.collect()
    torch.cuda.empty_cache()
    return recs


def _sp_train_multi_card(world: int, ref: dict | None, sft_ref: dict) -> dict:
    """(c): spawn `world` NCCL ranks, one card each: the train modes (sp
    ring, sp Ulysses, fsdp, tp where the heads and FFN divide, dp2×fsdp2 on
    4 cards) held to the single-card step, the SFT modes (sp, fsdp,
    dp2×fsdp2 on 4 cards) held to the single-card SFT step, qwen3_forward_sp
    in f32 and bf16 (`_qwen3_sp_modes`), then generate under fsdp and tp
    held to the non-SP generate (SP_TOL of scale). Without `ref` (the train
    phase's step) only the SFT modes and qwen3_forward_sp run."""
    cfg = T2V_1_3B
    modes, gen_modes = [], []
    if ref is not None:
        modes = ["ring", "ulysses", "fsdp"]
        if cfg.dit.num_heads % world == 0 and cfg.dit.ffn_dim % world == 0:
            modes.append("tp")
        if world == 4:
            modes.append("dp2_fsdp2")
        gen_modes = ["fsdp"] + (["tp"] if "tp" in modes else [])
    sft_modes = ["sp", "fsdp"] + (["dp2_fsdp2"] if world == 4 else [])
    if gen_modes:
        pipe, ctx, gen = t2v_pipeline(cfg, "cuda", with_vae=False, qk_impl="unfused")
        features = torch.randn(1450, QWEN3_VL_30B_A3B.text.hidden_size, generator=gen,
                               device="cuda")
        lat_ref, _, _ = _sp_generate(pipe, ctx, features, SIZE, FRAMES)
        lat_ref = lat_ref.float().cpu()
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sp_train"))
    try:
        if gen_modes:
            torch.save(features.cpu(), tmp / "features.pt")
        # leaves: step 1
        torch.save(dict(ref, grads=ref["grads"][:1]) if ref else {}, tmp / "ref.pt")
        torch.save(sft_ref, tmp / "sft_ref.pt")
        mp.spawn(_sp_train_rank, args=(world, _free_port(), str(tmp), modes, gen_modes,
                                       sft_modes), nprocs=world)
        lats = torch.load(tmp / "latents.pt")
        recs = json.loads((tmp / "records.json").read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for mode in gen_modes:
        rec = recs["generate_" + mode]
        rec["latent_rel_err"] = float((lats[mode] - lat_ref).abs().max() / lat_ref.abs().max())
        rec["ok"] = rec["latent_rel_err"] <= SP_TOL
    return recs


def phase_sp_train(ref: dict, gen: torch.Generator) -> dict:
    """Training across cards. (a) the ring backward over 4 in-process shards
    of [1, 8190, 12, 128] (no padding, 8 pad keys, the last shard all
    padding) and the block and token layouts at [1, 4096, 32, 128]; (b) on
    this card, a NCCL group of world 1: the train phase's step under the
    ring, Ulysses and shard_params (FSDP2), two steps each, held to the
    single-card step (`ref`: phase_train's loss, grad_norm and grads of its
    first two steps); (c) with 2+ cards, min(4, count) spawned ranks."""
    ring_bwd = _sp_train_ring_backward(gen)
    ring_bwd["sft_token"] = _sft_ring_backward(gen)
    ring_bwd["sft_token_f32"] = _sft_ring_backward(gen, torch.float32)
    bwd_f32 = _bwd_f32_case(gen)
    ring_f32 = _ring_f32_case(gen)
    sft_ref = _sft_reference()
    recs = {}
    maybe_initialize_distributed(f"localhost:{_free_port()}", 1, 0, device="cuda")
    try:
        for mode in ("ring", "ulysses", "fsdp"):
            recs[mode] = _train_mode(mode, 1, ref)
        recs["sft_sp"] = _sft_mode("sp", 1, sft_ref)
    finally:
        dist.destroy_process_group()
    count = torch.cuda.device_count()
    multi = None
    if count >= 2:
        multi = _sp_train_multi_card(min(4, count), ref, sft_ref)
    else:
        print(f"sp_train: the multi-card part did not run: this machine has {count} CUDA device "
              "(it needs 2 or more, one per rank)", flush=True)
    rec = {"phase": "sp_train", "config": "T2V_1_3B", "seq_len": SEQ, "steps": SP_TRAIN_STEPS,
           "sft_config": "QWEN3_VL_30B_A3B.text, 2 layers, 16 experts", "sft_seq_len": SFT_SEQ,
           "sft_single_card": {"loss": sft_ref["loss"], "grad_norm": sft_ref["grad_norm"]},
           "tolerance": {"loss_rel": SP_LOSS_TOL, "grad_norm_rel": SP_GNORM_TOL,
                         "leaf_grad_rel": SP_GNORM_TOL},
           "single_card": {"loss": ref["loss"][:SP_TRAIN_STEPS],
                           "grad_norm": ref["grad_norm"][:SP_TRAIN_STEPS]},
           "world1": recs, "multi_card": multi}
    emit(rec)
    bad = [m for m, r in {**recs, **(multi or {})}.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"sp_train: modes {bad} failed: {rec}")
    return {"ring_backward": ring_bwd, "flash_bwd_f32": bwd_f32, "ring_step_f32": ring_f32,
            **rec}



# --- LoRA, adafactor, the text-only Qwen3 ---------------------------------

LORA_RANK = 16
LORA_LR = 1e-4  # a LoRA finetune's usual rate (the base is frozen)
ADAFACTOR_LR = 1e-3  # adafactor's step is relative (lr · the leaf's RMS): 3e-6 would move
# a leaf by ~6e-8, under a 0.02-sized f32 parameter's ulp resolution for the update check
BUMP = 0.02  # B += BUMP · N(0, 1), seeded, where a check needs adapters that act
MERGE_TOL = 5e-2  # merged vs adapter, of scale: the merged weight rounds W + scale·AB to
# bf16 once, the adapter path adds an f32 delta to a bf16 product (SP_TOL's limit)
UPDATE_TOL = 1e-3  # adafactor's update vs the f64 reference: f32 statistics and sums, the
# update read back as p_after − p_before from f32 parameters (~1e-4 of it)
FOLD_ULPS = 1.0  # a merged weight vs the f32 fold on the host (JAX `_fold`), in bf16 ulps
# of the tensor's largest |value|: the two f32 products of A·B sum in other orders


def _bump_b(model: torch.nn.Module, seed: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if has_lora(m):
                m.lora_b.add_(BUMP * torch.randn(m.lora_b.shape, generator=gen, device="cuda"))


def _fingerprint(t: torch.Tensor) -> torch.Tensor:
    """Three sums of a tensor's bits: any change of any element changes them."""
    b = _bits(t.detach()).long()
    return torch.stack([b.sum(), (b & 0xFFFF).square().sum(), (b >> 16).square().sum()])


def _scale_rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.float() - ref.float()).abs().max() / ref.float().abs().max())


def _timed_steps(step, state, batch, draws, n):
    """n train steps: (state, [(loss, grad_norm)], step seconds, launches per step)."""
    rows, step_s, per_step = [], [], []
    for _ in range(n):
        _reset_launches()
        _reset_train_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, draws)
        rows.append((float(m["loss"]), float(m["grad_norm"])))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append({**_train_launches(), **_launches()})
    return state, rows, step_s, per_step


def _train_expect(cfg) -> dict:
    n_attn = 2 * cfg.dit.num_layers
    return {"flash_fwd_lse": 2 * n_attn, "flash_bwd_dq": n_attn, "flash_bwd_dkv": n_attn,
            "qk_prep": 0, "flash_fwd": 0, "flash_causal": 0, "flash_d72": 0, "fused_adaln": 0,
            "ring_step": 0, "flash_pair": 0}


def phase_lora(adamw: dict, tmp: Path) -> dict:
    """The train phase's T2V-1.3B step at full depth with rank-16 LoRA on
    DEFAULT_TARGETS (the base frozen, AdamW on the adapters alone, lr
    LORA_LR), 3 steps: step time, peak memory and optimizer-state bytes
    beside the train phase's AdamW step (`adamw`, same call, TRAIN_LAYERS
    deep); the adapters moved, the base
    bit-equal. Then the adapters (B perturbed) through generate: latents
    merged against unmerged (the delta in `dense`, ahead of rows 6 and 1)
    and against none, the merged weights held to the f64 fold, the generate
    CLI's `run` with --lora_adapters (rows 1 and 6 counted) and a short
    finetune CLI run from a YAML --config (LoRA, adafactor)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, tc, params, batch, draws = _train_setup(layers=T2V_1_3B.dit.num_layers)
    tc = dataclasses.replace(tc, learning_rate=LORA_LR, trainable_filters=LORA_FILTERS)
    inject_lora(params.wan, LORA_RANK, generator=torch.Generator(device="cuda").manual_seed(7))
    trained = freeze_base(params)
    base = {n: _fingerprint(p) for n, p in params.named_parameters() if n not in trained}
    start = {n: p.detach().clone() for n, p in params.named_parameters() if n in trained}
    tx = make_optimizer(tc, params)
    state = init_train_state(params, tx)
    step = make_unified_train_step(cfg, tc, tx)
    state, rows, step_s, per_step = _timed_steps(step, state, batch, draws, TRAIN_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state_bytes = sum(t.numel() * t.element_size() for k in ("mu", "nu")
                      for t in state.opt_state[k].values())
    named = dict(params.named_parameters())
    moved = sum(not torch.equal(named[n], t) for n, t in start.items())
    base_equal = all(torch.equal(_fingerprint(named[n]), f) for n, f in base.items())
    n_adapter = count_lora_params(params.wan)
    _bump_b(params.wan, 11)
    ad_path = tmp / "lora_adapters.npz"
    save_adapters_npz(params.wan, ad_path)
    adapters = load_adapters_npz(ad_path)
    del state, params, step, batch, tx, start, named
    gc.collect()
    torch.cuda.empty_cache()
    expect = _train_expect(cfg)
    rec = {"phase": "lora", "config": "T2V_1_3B", "rank": LORA_RANK, "targets": DEFAULT_TARGETS,
           "lr": LORA_LR, "adapter_params": n_adapter, "trainable_tensors": len(trained),
           "loss": [r[0] for r in rows], "grad_norm_adapters": [r[1] for r in rows],
           "step_s": step_s, "train_step_s": sum(step_s[1:]) / (len(step_s) - 1),
           "adamw_train_step_s": adamw["train_step_s"], "max_memory_allocated_gb": peak_gb,
           "adamw_max_memory_allocated_gb": adamw["max_memory_allocated_gb"],
           "optimizer_state_bytes": state_bytes,
           "adamw_optimizer_state_bytes": adamw["optimizer_state_bytes"],
           "adapters_moved": moved, "base_bit_equal": base_equal,
           "launches_per_step": per_step}
    emit(rec)
    finite = all(np.isfinite(r[0]) and np.isfinite(r[1]) for r in rows)
    if (not finite or not base_equal or moved == 0 or any(p != expect for p in per_step)
            or peak_gb >= 80.0):
        raise AssertionError(f"lora: {rec} (launches expected {expect} per step)")
    rec["launches"] = {k: sum(p[k] for p in per_step) for k in TRAIN_ROWS}
    rec["generate"] = _lora_generate(adapters, ad_path, tmp)
    rec["finetune_cli"] = _lora_finetune_cli(tmp)
    return rec


def _lora_generate(adapters: dict, ad_path: Path, tmp: Path) -> dict:
    """2 steps of the 1.3B generate at 832x480x81 with no adapters, with the
    adapters grafted (unmerged) and merged; the merged weights at three
    sites against the f64 fold; then the CLI with --lora_adapters."""
    pipe, ctx, gen = t2v_pipeline(T2V_1_3B, "cuda")
    features = torch.randn(1450, QWEN3_VL_30B_A3B.text.hidden_size, generator=gen, device="cuda")
    wan = pipe.low_noise.wan
    _sp_generate(pipe, ctx, features, SIZE, FRAMES, steps=1)  # warm-up
    lat_none, step_none, _ = _sp_generate(pipe, ctx, features, SIZE, FRAMES)
    apply_lora_state(wan, adapters)
    _reset_launches()
    lat_unmerged, step_unmerged, _ = _sp_generate(pipe, ctx, features, SIZE, FRAMES)
    unmerged_launches = _launches()
    last = len(wan.blocks) - 1
    sites = ("blocks.0.self_attn.q", f"blocks.{last // 2}.cross_attn.o", f"blocks.{last}.ffn.2")
    refs = {}
    for name in sites:  # JAX's `_fold` in numpy f32 on the host
        lin = wan.get_submodule(name)
        a, b, w = (t.detach().float().cpu().numpy() for t in (lin.lora_a, lin.lora_b, lin.weight))
        fold = w + ((a @ b) * np.float32(lin.lora_scale.item())).T
        refs[name] = torch.from_numpy(fold).to(torch.bfloat16).float()
    merge_lora(wan)
    fold_ulps = max(float((wan.get_submodule(n).weight.float().cpu() - r).abs().max()
                          / bf16_ulp(r.abs().max())) for n, r in refs.items())
    lat_merged, step_merged, _ = _sp_generate(pipe, ctx, features, SIZE, FRAMES)
    del pipe, wan, refs
    gc.collect()
    torch.cuda.empty_cache()
    rows = tmp / "lora_rows.jsonl"
    rows.write_text(json.dumps({"sample_id": "t2v_lora", "prompt": EDIT_PROMPT}) + "\n")
    argv = ["--task", "t2v-1.3B", "--random_weights", "--sample_steps", str(STEPS),
            "--size", f"{SIZE[0]}*{SIZE[1]}", "--frame_num", str(FRAMES), "--input", str(rows),
            "--output_dir", str(tmp / "lora_out"), "--device", "cuda",
            "--lora_adapters", str(ad_path)]
    _reset_launches()
    t0 = time.perf_counter()
    (res,) = generate_cli.run(generate_cli.parse_args(argv))
    wall_s = time.perf_counter() - t0
    cli_launches = _launches()
    shutil.rmtree(tmp / "lora_out", ignore_errors=True)
    layers = T2V_1_3B.dit.num_layers
    expect = {**{k: 0 for k in cli_launches}, "qk_prep": 4 * layers * STEPS,
              "flash_fwd": 2 * layers * STEPS}
    rec = {"phase": "lora_generate", "sites": len(adapters),
           "merged_vs_unmerged_rel": _scale_rel(lat_merged, lat_unmerged),
           "merged_vs_none_rel": _scale_rel(lat_merged, lat_none), "tolerance_rel": MERGE_TOL,
           "fold_max_bf16_ulps": fold_ulps, "fold_tolerance_ulps": FOLD_ULPS,
           "denoise_step_s": {"none": step_none, "unmerged": step_unmerged,
                              "merged": step_merged},
           "unmerged_launches": unmerged_launches, "cli_wall_s": wall_s,
           "cli_timings": {k: res["timings"].get(k) for k in ("denoise_step_s", "decode_s")},
           "cli_launches": cli_launches}
    emit(rec)
    finite = all(bool(torch.isfinite(t).all()) for t in (lat_none, lat_unmerged, lat_merged))
    if (not finite or rec["merged_vs_unmerged_rel"] > MERGE_TOL or fold_ulps > FOLD_ULPS
            or cli_launches != expect or unmerged_launches != expect):
        raise AssertionError(f"lora generate: {rec} (launches expected {expect})")
    return rec


def _lora_finetune_cli(tmp: Path) -> dict:
    """tools/finetune.py main from a YAML --config: T2V-1.3B at full width
    on its dummy data (its latents are 21 × 8 × 8), LoRA rank 16 with
    adafactor, 2 steps, the adapters exported."""
    from omnivideo_tpu_torch.tools import finetune as finetune_cli

    out = tmp / "ft"
    yml = tmp / "run.yaml"
    yml.write_text(write_yaml({"task": "t2v-1.3B", "lora_rank": LORA_RANK,
                               "optimizer": "adafactor", "total_steps": 2, "log_interval": 1,
                               "save_interval": 1000, "output_dir": str(out),
                               "lora_adapter_export": str(out / "ad.npz"), "device": "cuda"}))
    _reset_train_launches()
    t0 = time.perf_counter()
    rc = finetune_cli.main(["--config", str(yml), "--dummy_data"])
    wall_s = time.perf_counter() - t0
    launches = _train_launches()
    losses = [json.loads(x)["loss/t2v"] for x in (out / "metrics.jsonl").read_text().splitlines()]
    ad = load_adapters_npz(out / "ad.npz")
    written = (out / "run_config.yaml").exists()
    shutil.rmtree(out, ignore_errors=True)
    rec = {"phase": "lora_finetune_cli", "rc": rc, "wall_s": wall_s, "losses": losses,
           "adapter_sites": len(ad), "run_config_yaml": written, "launches": launches}
    emit(rec)
    if (rc != 0 or len(losses) != 2 or not all(np.isfinite(losses)) or not written
            or len(ad) != 10 or min(launches.values()) == 0):
        raise AssertionError(f"lora finetune CLI: {rec}")
    return rec


def _adafactor_reference(names, p0, g, st, count, gscale, lr, wd) -> torch.Tensor:
    """optax.adafactor's update (defaults) then the lr-scaled decay, in f64,
    written on JAX's leaf: the layers stacked, Linear weights as [d_in,
    d_out] kernels. `g` are the raw grads and gscale the global clip's
    factor. Returns the update in that layout."""
    def jax_view(n, t):
        return t.double().T if n.endswith(".weight") and t.ndim == 2 else t.double()

    stack = (lambda ts: torch.stack(ts)) if len(names) > 1 else (lambda ts: ts[0])
    P = stack([jax_view(n, p0[n]) for n in names])
    G = stack([jax_view(n, g[n]) for n in names]) * gscale
    dims = None
    order = np.argsort(P.shape)
    if len(P.shape) >= 2 and P.shape[order[-2]] >= 128:
        dims = int(order[-2]), int(order[-1])
    dr = 1.0 - (count + 1.0) ** -0.8
    g2 = G.square() + 1e-30
    if dims is None:
        V = dr * stack([jax_view(n, st["v"][n]) for n in names])
        V = V + (1 - dr) * g2
        U = G * V.pow(-0.5)
    else:
        d1, d0 = dims
        VR = dr * stack([st["v_row"][n].double() for n in names]) + (1 - dr) * g2.mean(d0)
        VC = dr * stack([st["v_col"][n].double() for n in names]) + (1 - dr) * g2.mean(d1)
        rcm = VR.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
        U = G * (VR / rcm).pow(-0.5).unsqueeze(d0) * VC.pow(-0.5).unsqueeze(d1)
    U = U / max(1.0, float(U.square().mean().sqrt()))
    rms = float(P.square().mean().sqrt())
    return -(U * lr) * (rms if rms > 1e-3 else 1e-3) - lr * wd * P


def phase_adafactor(adamw: dict) -> dict:
    """The train phase's step with --optimizer adafactor (every parameter,
    lr ADAFACTOR_LR), 3 steps: step time, peak memory and optimizer-state
    bytes beside AdamW's (`adamw`, same call); step 2's update of three JAX
    leaves (factored across the layers, unfactored across the layers,
    one factored unstacked kernel) against the f64 reference of the same
    rule on the same grads and state."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, tc, params, batch, draws = _train_setup()
    tc = dataclasses.replace(tc, optimizer="adafactor", learning_rate=ADAFACTOR_LR)
    tx = make_optimizer(tc, params)
    state = init_train_state(params, tx)
    step = make_unified_train_step(cfg, tc, tx)
    chosen = {"factored_stacked": "wan/blocks/cross_attn/k/kernel",
              "unfactored_stacked": "wan/blocks/ffn/fc1/bias",
              "factored_single": "wan/text_embedding/fc1/kernel"}
    members = {k: [n for n, _ in params.named_parameters() if jax_path(n) == path]
               for k, path in chosen.items()}
    watched = [n for ns in members.values() for n in ns]
    named = dict(params.named_parameters())
    seen = {}
    update = tx.update

    def spy(model, grads, opt_state):
        second = opt_state["count"] == 1  # the second update: decayed statistics
        if second:
            seen["g"] = {n: grads[n].detach().clone() for n in watched}
            seen["p0"] = {n: named[n].detach().clone() for n in watched}
            seen["st"] = {k: {n: t.detach().clone() for n, t in opt_state[k].items()
                              if n in watched} for k in ("v", "v_row", "v_col")}
            seen["gnorm"] = float(global_norm(grads.values()))
        moved = update(model, grads, opt_state)
        if second:
            seen["p1"] = {n: named[n].detach().clone() for n in watched}
        return moved

    tx.update = spy
    state, rows, step_s, per_step = _timed_steps(step, state, batch, draws, TRAIN_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state_bytes = sum(t.numel() * t.element_size() for k in ("v", "v_row", "v_col")
                      for t in state.opt_state[k].values())
    factored = len(state.opt_state["factored"])
    gscale = min(1.0, tc.grad_clip / seen["gnorm"]) if tc.grad_clip else 1.0
    lr = tx.sched(1)
    checks = {}
    with torch.no_grad():
        for label, ns in members.items():
            ref = _adafactor_reference(ns, seen["p0"], seen["g"], seen["st"], 1, gscale, lr,
                                       tc.weight_decay)
            got = torch.stack([(seen["p1"][n].double() - seen["p0"][n].double()).T
                               if n.endswith(".weight") else
                               seen["p1"][n].double() - seen["p0"][n].double() for n in ns])
            got = got if len(ns) > 1 else got[0]
            checks[label] = {"path": chosen[label], "layers": len(ns),
                             "factored": any(n in state.opt_state["factored"] for n in ns),
                             "update_rel_err": _scale_rel(got, ref),
                             "update_rms": float(ref.square().mean().sqrt())}
    del state, params, step, batch, tx, named, seen
    gc.collect()
    torch.cuda.empty_cache()
    expect = _train_expect(cfg)
    rec = {"phase": "adafactor", "config": "T2V_1_3B", "lr": ADAFACTOR_LR,
           "loss": [r[0] for r in rows], "grad_norm": [r[1] for r in rows], "step_s": step_s,
           "train_step_s": sum(step_s[1:]) / (len(step_s) - 1),
           "adamw_train_step_s": adamw["train_step_s"], "max_memory_allocated_gb": peak_gb,
           "adamw_max_memory_allocated_gb": adamw["max_memory_allocated_gb"],
           "optimizer_state_bytes": state_bytes,
           "adamw_optimizer_state_bytes": adamw["optimizer_state_bytes"],
           "factored_tensors": factored, "update_checks": checks, "tolerance_rel": UPDATE_TOL,
           "launches_per_step": per_step}
    emit(rec)
    finite = all(np.isfinite(r[0]) and np.isfinite(r[1]) for r in rows)
    wrong = [k for k, c in checks.items() if not c["update_rel_err"] <= UPDATE_TOL]
    if (not finite or wrong or any(p != expect for p in per_step) or peak_gb >= 80.0
            or not checks["factored_stacked"]["factored"]
            or checks["unfactored_stacked"]["factored"]):
        raise AssertionError(f"adafactor: {rec} (launches expected {expect} per step)")
    rec["launches"] = {k: sum(p[k] for p in per_step) for k in TRAIN_ROWS}
    return rec


def phase_text_only(model: Qwen3VLModel, ids: np.ndarray, patches: torch.Tensor, grid) -> dict:
    """The text-only Qwen3 on the vlm phase's text stack (VLM_LAYERS): the
    causal forward on the prompt's L ids and a 16-token greedy decode, base
    and with rank-16 bare adapters (q k v o: the MoE layers' router and
    experts are never adapted): B = 0 bit-equal, B perturbed, merged
    against the adapters; row 2 counted per pass; qwen3_forward_sp on a
    world-1 NCCL group against the adapter forward (`phase_qwen3_sp`);
    then the vision tower once with VISION_BARE_NAMES adapters (row 3a).
    Leaves the model's text weights merged."""
    layers = model.cfg.text.num_hidden_layers
    ids_t = torch.as_tensor(ids, device="cuda")
    per = {"flash_causal": layers, "flash_fwd": 0, "qk_prep": 0, "fused_adaln": 0,
           "flash_d72": 0, "ring_step": 0, "flash_pair": 0}
    counts, moe_counts, out = [], [], {}

    def run(tag):
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = qwen3_forward(model, ids_t)[1]
        torch.cuda.synchronize()
        out[f"{tag}_forward_s"] = time.perf_counter() - t0
        counts.append(_launches())
        moe_counts.append(_moe_launches())
        _reset_launches()
        t0 = time.perf_counter()
        toks = qwen3_greedy_decode(model, ids_t, VLM_NEW_TOKENS)
        torch.cuda.synchronize()
        out[f"{tag}_decode_s"] = time.perf_counter() - t0
        counts.append(_launches())
        moe_counts.append(_moe_launches())
        return logits, toks

    logits0, toks0 = run("base")
    again, toks_again = run("base_again")  # the forward is repeatable bit for bit
    repeatable = torch.equal(again, logits0) and torch.equal(toks_again, toks0)
    del again
    inject_lora_bare(model, LORA_RANK, generator=torch.Generator(device="cuda").manual_seed(9))
    sites = sum(1 for s in lora_sites(model) if has_lora(s.lin))
    logits_b0, toks_b0 = run("b0")
    b0_equal = torch.equal(logits_b0, logits0) and torch.equal(toks_b0, toks0)
    del logits_b0
    _bump_b(model, 13)
    logits_ad, toks_ad = run("adapters")
    sp = phase_qwen3_sp(model, ids_t, logits_ad)
    merge_lora(model)
    logits_m, toks_m = run("merged")
    rel_m, rel_ad = _scale_rel(logits_m, logits_ad), _scale_rel(logits_ad, logits0)
    del logits0, logits_m
    with torch.inference_mode():
        y0, _ = model.visual(patches, grid)
        inject_lora_bare(model.visual, LORA_RANK, names=VISION_BARE_NAMES,
                         generator=torch.Generator(device="cuda").manual_seed(15))
        _bump_b(model.visual, 17)
        _reset_launches()
        y_ad, _ = model.visual(patches, grid)
        vis_launches = _launches()
    vis_rel = _scale_rel(y_ad, y0)
    rec = {"phase": "text_only", "config": "QWEN3_VL_30B_A3B (text stack)", "seq_len": ids.shape[1],
           "layers": layers, "rank": LORA_RANK, "adapted_sites": sites,
           "base_repeatable": repeatable, "b0_bit_equal": b0_equal, "merged_vs_adapters_rel": rel_m,
           "adapters_vs_base_rel": rel_ad, "tolerance_rel": MERGE_TOL,
           "tokens_base": toks0[0].tolist(), "tokens_adapters": toks_ad[0].tolist(),
           "tokens_merged": toks_m[0].tolist(), **out, "launches_per_pass": counts,
           "vision_adapter_rel": vis_rel, "vision_launches": vis_launches}
    emit(rec)
    rec["qwen3_sp"] = sp
    vis_expect = {**per, "flash_causal": 0, "flash_d72": model.cfg.vision.depth}
    if (not repeatable or not b0_equal or rel_m > MERGE_TOL or any(c != per for c in counts)
            or vis_launches != vis_expect or not torch.isfinite(y_ad).all()):
        raise AssertionError(f"text_only: {rec} (launches expected {per} per pass)")
    for c in moe_counts:
        _check_moe_launches("text_only pass", c, layers)
    rec["launches"] = {"flash_causal": sum(c["flash_causal"] for c in counts),
                       "flash_d72": vis_launches["flash_d72"]}
    rec["moe_launches"] = {k: sum(c[k] for c in moe_counts) for k in ("gmm", "tgmm")}
    return rec


def phase_qwen3_sp(model, ids_t: torch.Tensor, ref_logits: torch.Tensor) -> dict:
    """qwen3_forward_sp on a NCCL group of world 1 (the token-causal ring
    step, row 8, one step a layer) against `ref_logits`, qwen3_forward on
    the same weights (row 2)."""
    layers = model.language_model.cfg.num_hidden_layers
    maybe_initialize_distributed(f"localhost:{_free_port()}", 1, 0, device="cuda")
    try:
        mesh = create_mesh(sp=1, device="cuda")
        qwen3_forward_sp(model, ids_t, mesh)  # warm-up: NCCL's communicator
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, logits = qwen3_forward_sp(model, ids_t, mesh)
        torch.cuda.synchronize()
        sp_s = time.perf_counter() - t0
        launches, moe = _launches(), _moe_launches()
    finally:
        dist.destroy_process_group()
    rel = _scale_rel(logits, ref_logits)
    expect = {"ring_step": layers, "flash_causal": 0, "flash_fwd": 0, "qk_prep": 0,
              "flash_d72": 0, "fused_adaln": 0, "flash_pair": 0}
    count = torch.cuda.device_count()
    rec = {"phase": "qwen3_sp", "world": 1, "seq_len": int(ids_t.shape[1]), "forward_s": sp_s,
           "logits_rel_err": rel, "tolerance_rel": SP_TOL, "launches": launches,
           "moe_launches": moe, "multi_card": None}
    if count >= 2:
        print(f"qwen3_sp: the {min(4, count)}-rank run is in sp_train's multi-card part "
              "(on the SFT model, f32 and bf16)", flush=True)
    emit(rec)
    if (launches != expect or moe != {"gmm": 3 * layers, "tgmm": 0} or rel > SP_TOL
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"qwen3_sp: {rec} (launches expected {expect})")
    return rec


# --- the VLM's SFT, the image path and the data pipeline -------------------

SFT_STEPS = 3
SFT_TOL = 2e-3  # tiny SFT, card vs CPU, relative loss and grad_norm gaps: f32 both sides
# (TF32 off), the MoE-free dense attention summed in other orders
SFT_SEQ = 2048
SFT_CFG = dataclasses.replace(QWEN3_VL_30B_A3B.text, num_hidden_layers=4)  # 4 of 48 layers
# the sp_train SFT model: full width but 2 layers of 16 experts, so every rank also
# holds the single-card reference's grads cheaply
SFT_MESH_CFG = dataclasses.replace(QWEN3_VL_30B_A3B.text, num_hidden_layers=2, num_experts=16)
SFT_LORA_NAMES = ("q", "k", "v", "o")
SFT_RING_Q = (1, 2048, 32, 128)  # a 2,048-token SFT batch's attention, 4 ring shards of 512
STILL_SHAPE = (720, 1280, 3)  # the engine's seeded still image


def _sft_counts(model) -> dict:
    n = sum(p.numel() for p in model.parameters())
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    return {"params": n, "trainable": trainable,
            "f32_state_gb": (4 * n + 12 * trainable) / 1e9}  # params; grads, mu, nu


def _sft_batch(cfg, B: int, L: int, seed: int, lens=None, align: bool = False,
               device="cuda") -> dict:
    """A fixed seeded batch through sft_collate: row b holds lens[b] tokens
    (default L), the first third of each masked as prompt; with `align` the
    tiny chain's VLM features and targets."""
    rng = np.random.default_rng(seed)
    lens = lens or [L] * B
    samples = [{"ids": rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                "prompt_len": np.array(n // 3)} for n in lens]
    if align:
        for s_ in samples:
            s_["vlm"] = rng.standard_normal((sft_vlm.DUMMY_VLM_LEN, cfg.hidden_size)
                                            ).astype(np.float32)
            s_["target"] = (0.1 * rng.standard_normal((sft_vlm.CHAIN_QUERIES,
                                                       sft_vlm.CHAIN_OUT))).astype(np.float32)
    return {k: v.to(device) for k, v in sft_collate(samples, L).items()}


def _sft_model(cfg, seed: int, lora: int = 0, align: float = 0.0, device="cuda") -> SFTParams:
    """Seeded f32 SFT params: the Qwen3 (N(0, 0.02²)), bare LoRA on q/k/v/o
    with the base frozen when `lora`, the CLI's alignment chain when `align`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lm = Qwen3LM(cfg, torch.float32, device, gen)
    chain = sft_vlm.tiny_chain(cfg.hidden_size, gen, device) if align else None
    if lora:
        inject_lora_bare(lm, lora, names=SFT_LORA_NAMES, generator=gen)
        freeze_base(lm)
    return SFTParams(lm, chain)


def _tiny_sft_case(name: str, lora: int, align: float) -> dict:
    """SFT_STEPS steps of the CLI's --tiny SFT on the CPU and on the card from
    the same weights (built on the CPU, copied) and batch."""
    import copy

    cfg = sft_vlm.tiny_config()
    cpu = _sft_model(cfg, 0, lora, align, device="cpu")
    if lora:  # B off zero, so A's gradient is not zero either
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for m in cpu.lm.modules():
                if has_lora(m):
                    m.lora_b.add_(BUMP * torch.randn(m.lora_b.shape, generator=gen))
    card = copy.deepcopy(cpu).to("cuda")
    tc = SFTConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, align_weight=align,
                   cosine_weight=0.5 if align else 0.0)
    rows = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        tx = make_sft_optimizer(tc)
        state, step = init_sft_state(model, tx), make_sft_step(tc, tx)
        batch = _sft_batch(cfg, 2, 32, 5, lens=[32, 23], align=align > 0, device=dev)
        rows[dev] = []
        for _ in range(SFT_STEPS):
            state, m = step(state, batch)
            rows[dev].append((float(m["loss"]), float(m["grad_norm"])))
    gaps = [(abs(a[0] / b[0] - 1), abs(a[1] / b[1] - 1)) for a, b in zip(rows["cuda"], rows["cpu"])]
    return {"case": name, "loss_cuda": [r[0] for r in rows["cuda"]],
            "loss_cpu": [r[0] for r in rows["cpu"]], "grad_norm_cuda": [r[1] for r in rows["cuda"]],
            "loss_rel_gap": max(g[0] for g in gaps), "grad_norm_rel_gap": max(g[1] for g in gaps)}


def phase_tiny_sft() -> dict:
    """The sft_vlm CLI's --tiny SFT step (JAX's `_tiny_cfg` and tiny chain) on
    the card against the CPU: LM-only, combined (align_weight 1) and bare
    LoRA rank 4, loss and grad_norm within SFT_TOL."""
    cases = [_tiny_sft_case("lm_only", 0, 0.0), _tiny_sft_case("combined", 0, 1.0),
             _tiny_sft_case("lora4", 4, 0.0)]
    rec = {"phase": "tiny_sft", "steps": SFT_STEPS, "tolerance": SFT_TOL, "cases": cases}
    emit(rec)
    if any(c["loss_rel_gap"] > SFT_TOL or c["grad_norm_rel_gap"] > SFT_TOL for c in cases):
        raise AssertionError(f"tiny_sft: {rec}")
    return rec


def _sft_full_case(name: str, lora: int = 0, align: float = 0.0) -> dict:
    """SFT_STEPS steps of make_sft_step on SFT_CFG (full width, 4 layers) in
    f32 at batch 1 × SFT_SEQ, SFTConfig's defaults but warmup 0, one fixed
    seeded batch (a third of it prompt), then one profiled step."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _sft_model(SFT_CFG, 0, lora, align)
    tc = SFTConfig(warmup_steps=0, align_weight=align)
    tx = make_sft_optimizer(tc)
    state, step = init_sft_state(params, tx), make_sft_step(tc, tx)
    batch = _sft_batch(SFT_CFG, 1, SFT_SEQ, 7, align=align > 0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, step_s = [], []
    _reset_launches()
    _reset_train_launches()
    for _ in range(SFT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = {**_launches(), **_train_launches(), **_bwd_f32_launches(),
                "ring_step_f32": ring_step.launches_f32}
    moe = _moe_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = _profile(lambda: step(state, batch))
    rec = {"case": name, "lora_rank": lora, "align_weight": align, **_sft_counts(params),
           "init_s": init_s, "loss": losses, "grad_norm": float(m["grad_norm"]),
           "num_targets": float(m["num_targets"]), "step_s": step_s,
           "sft_step_s": sum(step_s[1:]) / (len(step_s) - 1), "max_memory_allocated_gb": peak_gb,
           "idle_share": profile["idle_share"], "profile_one_step": profile,
           "launches": launches, "moe_launches": moe}
    if "align_loss" in m:
        rec["align_loss"] = float(m["align_loss"])
    del state, params, step, tx, batch
    gc.collect()
    torch.cuda.empty_cache()
    bad = (not all(np.isfinite(losses)) or not all(b < a for a, b in zip(losses, losses[1:]))
           or peak_gb >= 80.0 or any(launches.values()))
    if bad:  # the single-card SFT's masked attention is the dense path: no attention kernel
        raise AssertionError(f"sft {name}: {rec}")
    # the MoE: gmm forward and for the input's gradient; tgmm for the banks' unless frozen (LoRA)
    _check_moe_launches(f"sft {name}", moe, SFT_CFG.num_hidden_layers, backward=not lora)
    return rec


def _sft_text_dir(d: Path, cfg) -> Path:
    """An HF text-only Qwen3 dir (config.json, one safetensors file) of
    seeded f32 weights at `cfg`."""
    lm = Qwen3LM(cfg, torch.float32, "cuda", torch.Generator(device="cuda").manual_seed(4))
    d.mkdir(parents=True, exist_ok=True)
    write_safetensors(d / "model.safetensors",
                      {("model." + k[len("language_model."):] if k.startswith("language_model.")
                        else k): v for k, v in lm.state_dict().items()})
    (d / "config.json").write_text(json.dumps({
        "model_type": "qwen3", "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads, "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": False}))
    return d


def _sft_cli(tmp: Path) -> dict:
    """sft_tokenize's `tokenize_dataset` over seeded chat transcripts through
    the stand-in tokenizer (ChatML, rendered natively), then the sft_vlm CLI
    in-process from a YAML --config on that --data_dir and a --model_path of
    the real vocabulary (151,936) at a narrow width."""
    rng = np.random.default_rng(8)
    words = lambda n: " ".join(f"w{int(i)}" for i in rng.integers(0, 999, n))  # noqa: E731
    recs = [{"conversations": [{"from": "system", "value": words(5)}]
             + [{"from": "human" if j % 2 == 0 else "gpt", "value": words(int(rng.integers(4, 30)))}
                for j in range(2 * (1 + i % 2))]} for i in range(6)]
    conv = tmp / "sft_conv.jsonl"
    conv.write_text("\n".join(json.dumps(r) for r in recs))
    data = tmp / "sft_data"
    kept = sft_tokenize.tokenize_dataset(ConversationDataset(str(conv), StandInTokenizer()),
                                         str(data), max_len=4096)
    cfg = Qwen3TextConfig(vocab_size=151936, hidden_size=256, intermediate_size=512,
                          num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
                          head_dim=128)
    model_dir = _sft_text_dir(tmp / "sft_model", cfg)
    out = tmp / "sft_out"
    yml = tmp / "sft.yaml"
    yml.write_text(write_yaml({"model_path": str(model_dir), "data_dir": str(data),
                               "total_steps": 3, "warmup_steps": 1, "lr": 1e-4,
                               "batch_size": 2, "seq_len": 512, "log_interval": 1,
                               "output_dir": str(out), "device": "cuda"}))
    t0 = time.perf_counter()
    metrics = sft_vlm.run(sft_vlm.parse_args(["--config", str(yml)]))
    wall_s = time.perf_counter() - t0
    rec = {"part": "sft_vlm_cli", "samples": kept, "wall_s": wall_s,
           "loss": [r["loss"] for r in metrics], "num_targets": [r["num_targets"] for r in metrics],
           "run_config_yaml": (out / "run_config.yaml").exists(),
           "checkpoint": (out / "checkpoints" / "3" / "state.pt").exists()}
    shutil.rmtree(out, ignore_errors=True)
    if (kept != 6 or len(metrics) != 3 or not all(np.isfinite(rec["loss"]))
            or not rec["run_config_yaml"] or not rec["checkpoint"]
            or min(rec["num_targets"]) <= 0):
        raise AssertionError(f"sft_vlm CLI: {rec}")
    return rec


def phase_sft(tmp: Path) -> dict:
    """SFT at full width: SFT_CFG (Qwen3-VL-30B-A3B's text stack, 4 of 48
    layers) in f32, 3 steps each of the full finetune, bare LoRA rank 16 on
    q/k/v/o and the combined loss (align_weight 1, the CLI's chain): the
    loss falls, peak under 80 GB; then the CLI (`_sft_cli`)."""
    cases = [_sft_full_case("full"), _sft_full_case("lora16", lora=LORA_RANK),
             _sft_full_case("combined", align=1.0)]
    cli = _sft_cli(tmp)
    rec = {"phase": "sft", "config": "QWEN3_VL_30B_A3B.text, 4 of 48 layers",
           "seq_len": SFT_SEQ, "batch": 1, "steps": SFT_STEPS, "cases": cases, "cli": cli}
    emit(rec)
    return rec


def _sft_ring_backward(gen: torch.Generator, dtype=torch.bfloat16) -> dict:
    """The token-causal ring backward (rows 4 and 5 on the earlier shards)
    over RING_N in-process shards of an SFT batch's attention, SFT_RING_Q:
    against the plain loop (`_ring_bwd_case`) and, per (batch row, head),
    against the dense causal backward of the whole sequence in f32
    (autograd, TF32 off): bf16 q/k/v/dO within GRAD_TOL of its norm; f32
    ones, as the f32 LM's ring gives them (rows 4 and 5 on f32 operands),
    within BWD_F32_DENSE_TOL."""
    B, L, N, D = SFT_RING_Q
    if dtype == torch.float32:
        q, k, v, do = (torch.randn(B, L, N, D, generator=gen, device="cuda") for _ in range(4))
        name, tol = "sft_token_f32", BWD_F32_DENSE_TOL
    else:
        q, k = _normed(B, L, N, D, gen), _normed(B, L, N, D, gen)
        v = torch.randn(B, L, N, D, generator=gen, device="cuda").to(torch.bfloat16)
        do = torch.randn(B, L, N, D, generator=gen, device="cuda").to(torch.bfloat16)
        name, tol = "sft_token", GRAD_TOL
    rec = _ring_bwd_case(name, q, k, v, do, RING_N, causal="token")
    qs, ks, vs, dos = (_shards(t, RING_N) for t in (q, k, v, do))
    fwd = ring_flash_attention_shards(qs, ks, vs, causal="token", return_lse=True)
    grads = ring_flash_backward_shards(qs, ks, vs, [f[0] for f in fwd], [f[1] for f in fwd],
                                       dos, None, "token")
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    s_ = torch.einsum("bind,bjnd->bnij", leaves[0], leaves[1]) * D**-0.5
    s_ = s_.masked_fill(torch.ones(L, L, dtype=torch.bool, device="cuda").triu(1), float("-inf"))
    o = torch.einsum("bnij,bjnd->bind", torch.softmax(s_, -1), leaves[2])
    o.backward(do.float())
    err = {t: float(_grad_rel(torch.cat([g[i] for g in grads], 1), leaves[i].grad).max())
           for i, t in enumerate(("dq", "dk", "dv"))}
    rec["max_rel_err_per_head_vs_dense_causal"] = err
    rec["tolerance_vs_dense_causal"] = tol
    del leaves, s_, o, grads, fwd
    torch.cuda.empty_cache()
    if max(err.values()) > tol:
        raise AssertionError(f"sp_train SFT ring backward: {rec}")
    return rec


BWD_F32_CASES = (  # (case, q = k = v = dO shape): every key visible, no kv_lens
    ("rank4_earlier", (2, SFT_SEQ // 4, 32, 128)),  # the 4-card SFT --sp step's earlier shards
    ("in_process", (1, SFT_SEQ // 4, 32, 128)),  # sft_token_f32's shards (SFT_RING_Q / 4)
)


def _bwd_f32_case(gen: torch.Generator) -> dict:
    """Rows 4 and 5 on f32 operands at the shapes the f32 ring backward gives
    them (BWD_F32_CASES): flash_bwd launches the f32 kernels (and no bf16
    one), held per (batch row, head) to flash_bwd_plain on the same f32
    inputs (TF32 off) within BWD_F32_TOL, bit-equal on a rerun; each kernel
    timed alone, beside the plain twin and f32 SDPA's backward on the same
    q/k/v (its kernel named by the profiler), with each kernel's registers
    and spill bytes from the build's -Xptxas -v report. Bound: three tf32 products of
    6·B·N·L²·D (dq) and 8·B·N·L²·D (dk/dv) FLOPs at the tf32 rate, or the
    f32 bytes (q, k, v, dO, LSE and delta read once, the gradients written
    once) where those take longer. The first case is the kernels line's."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("sp_train flash_bwd_f32: the plain twin must run in full f32")
    by_kernel = ptxas_by_kernel(_kernels.build_log)
    ptxas = {kn: by_kernel.get(kn, "not reported") for kn in BWD_F32_ROWS}
    cases = []
    for name, (B, L, N, D) in BWD_F32_CASES:
        q, k, v, do = (torch.randn(B, L, N, D, generator=gen, device="cuda") for _ in range(4))
        o, lse = flash_fwd_lse_plain(q, k, v)
        delta = flash_delta(do, o)
        _reset_train_launches()
        grads = flash_bwd(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        launches = dict(flash_attention_train.launches)
        ref = flash_bwd_plain(q, k, v, do, lse, delta)
        err = {t: float(_grad_rel(g, r).max()) for t, g, r in zip(("dq", "dk", "dv"), grads, ref)}
        again = flash_bwd(q, k, v, do, lse, delta)
        deterministic = all(torch.equal(a, b) for a, b in zip(grads, again))
        rec = {"phase": "sp_train", "part": "flash_bwd_f32", "case": name, "q": [B, L, N, D],
               "launches": launches, "max_rel_err_per_head": err, "tolerance": BWD_F32_TOL,
               "deterministic": deterministic, "ptxas": ptxas,
               "max_abs_err": {t: float((g - r).abs().max())
                               for t, g, r in zip(("dq", "dk", "dv"), grads, ref)}}
        want = {**{kn: 0 for kn in flash_attention_train.launches}, **{kn: 1 for kn in BWD_F32_ROWS}}
        if (max(err.values()) > BWD_F32_TOL or launches != want or not deterministic
                or not all(torch.isfinite(g).all() for g in grads)):
            raise AssertionError(f"sp_train flash_bwd_f32 {name}: {rec}")
        del again, ref
        outs = {"flash_bwd_dq_f32": (torch.empty_like(q),),
                "flash_bwd_dkv_f32": (torch.empty_like(k), torch.empty_like(v))}
        rec["ms"] = {kn: cuda_ms(_bwd_launcher(kn, q, k, v, do, lse, delta, None, outs[kn],
                                               D**-0.5), 20) for kn in BWD_F32_ROWS}
        rec["plain_ms"] = cuda_ms(lambda: flash_bwd_plain(q, k, v, do, lse, delta), 1, 0)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2).contiguous()
        sdpa_bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,  # noqa: E731
                                               retain_graph=True)
        rec["library_ms"] = cuda_ms(sdpa_bwd, 10)
        top = _profile(sdpa_bwd)["top_kernels_ms"]  # empty where the profiler traced no kernel
        rec["library_kernel"] = top[0][0] if top else "not traced"
        stat = B * N * L * 4
        nbytes = {"flash_bwd_dq_f32": 4 * B * L * N * D * 4 + 2 * stat + B * L * N * D * 4,
                  "flash_bwd_dkv_f32": 4 * B * L * N * D * 4 + 2 * stat + 2 * B * L * N * D * 4}
        flop = {"flash_bwd_dq_f32": 6 * B * N * L * L * D, "flash_bwd_dkv_f32": 8 * B * N * L * L * D}
        rec["bound_ms"], rec["bound_by"], rec["share_of_bound"] = {}, {}, {}
        for kn in BWD_F32_ROWS:
            t_ops = 3 * flop[kn] / TF32_FLOPS * 1e3
            t_bytes = nbytes[kn] / HBM_BYTES_PER_S * 1e3
            rec["bound_ms"][kn] = max(t_ops, t_bytes)
            rec["bound_by"][kn] = "operations" if t_ops >= t_bytes else "bytes"
            rec["share_of_bound"][kn] = rec["bound_ms"][kn] / rec["ms"][kn]
        emit(rec)
        cases.append(rec)
        del q, k, v, do, o, grads, qt, kt, vt, out
    torch.cuda.empty_cache()
    return {**cases[0], "cases": cases}


RING_F32_TOL = 1e-5  # of each output row's max |plain| and |LSE − LSE_plain|, the f32 step
# kernel vs ring_step_plain on f32 inputs: f32-accurate products (three tf32 products,
# tests/test_torch_ring_f32_split.py) summed in other orders
RING_F32_CASES = (  # (case, q rows = keys, my, src, n): token-causal steps
    ("sft_world1", SFT_SEQ, 0, 0, 1),  # the world-1 --sp SFT step: own shard
    ("rank4_own", SFT_SEQ // 4, 1, 1, 4),  # a 4-card run's per-rank step, own shard
    ("rank4_earlier", SFT_SEQ // 4, 2, 1, 4),  # an earlier shard: every key visible
)


def _ring_f32_case(gen: torch.Generator) -> dict:
    """The f32 step kernel at the SFT's --sp shapes (SFT_MESH_CFG's attention
    over the 2 × SFT_SEQ batch: RING_F32_CASES) against ring_step_plain on the
    same f32 inputs, TF32 off: each output row within RING_F32_TOL of its
    max, and the LSE; each case timed beside f32 SDPA on the same q/k/v
    (causal on an own shard), whose kernel the profiler names (inside the
    whole run, after the earlier phases, it has traced none there), and the plain
    twin at the first. Bound: the larger of the bytes at the HBM rate and
    three tf32 products of the visible pairs' FLOPs at the tf32 rate (the
    FFMA figure beside it). The first case is the kernel line's."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("sp_train ring_step_f32: the plain twin must run in full f32")
    B, N, D = 2, SFT_MESH_CFG.num_attention_heads, SFT_MESH_CFG.head_dim
    cases = []
    for name, L, my, src, n in RING_F32_CASES:
        kw = dict(causal="token", my=my, src=src, n=n)
        q, k, v = (torch.randn(B, L, N, D, generator=gen, device="cuda") for _ in range(3))
        carry = ring_carry(B, L, N, D, "cuda")
        n0 = ring_step.launches_f32
        out, lse = ring_finish(*ring_step(q, k, v, *carry, **kw), torch.float32, return_lse=True)
        torch.cuda.synchronize()
        launched = ring_step.launches_f32 - n0
        ref, lse_ref = ring_finish(*ring_step_plain(q, k, v, *ring_carry(B, L, N, D, "cuda"), **kw),
                                   torch.float32, return_lse=True)
        err = (out - ref).abs()
        rel = float((err / ref.abs().amax(-1, keepdim=True).clamp_min(1e-30)).max())
        lse_err = float((lse - lse_ref).abs().max())
        rec = {"case": name, "q": [B, L, N, D], **kw, "launched": launched,
               "max_abs_err": float(err.max()), "max_rel_err_of_row_max": rel,
               "lse_max_abs_err": lse_err, "tolerance": RING_F32_TOL}
        if launched != 1 or rel > RING_F32_TOL or lse_err > RING_F32_TOL or not torch.isfinite(
                out).all():
            raise AssertionError(f"sp_train ring_step_f32: {rec}")
        rec["ms"] = cuda_ms(lambda: ring_step(q, k, v, *carry, **kw), 20)
        if not cases:
            rec["plain_ms"] = cuda_ms(lambda: ring_step_plain(q, k, v, *carry, **kw), 1, 0)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=my == src)
        rec["library_ms"] = cuda_ms(sdpa, 10)
        top = _profile(sdpa)["top_kernels_ms"]  # empty where the profiler traced no kernel
        rec["library_kernel"] = top[0][0] if top else "not traced"
        pairs = B * (L * (L + 1) // 2 if my == src else L * L)
        nbytes = 3 * B * L * N * D * 4 + 2 * (2 * B * N * L * 4 + B * L * N * D * 4)
        t_ops = 3 * 4 * N * D * pairs / TF32_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rec.update(bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   bound_ffma_ms=4 * N * D * pairs / F32_FLOPS * 1e3)
        emit({"phase": "sp_train", "part": "ring_step_f32", **rec})
        cases.append(rec)
        del q, k, v, qt, kt, vt, carry, out, ref
    torch.cuda.empty_cache()
    return {**cases[0], "cases": cases}


def _sft_mesh_setup(mode: str, world: int, device: str = "cuda"):
    """(mesh, sp?, shard?) of an SFT mode."""
    if mode == "sp":
        return create_mesh(sp=world, device=device), True, False
    if mode == "fsdp":
        return create_mesh(fsdp=world, device=device), False, True
    if mode == "dp2_fsdp2":
        return create_mesh(dp=2, fsdp=world // 2, device=device), False, True
    raise ValueError(mode)


def _sft_mesh_batch(device="cuda") -> dict:
    """The sp_train SFT batch: 2 rows of SFT_SEQ, the second padded at the
    tail (1,500 tokens), so the rows hold unequal target counts."""
    return _sft_batch(SFT_MESH_CFG, 2, SFT_SEQ, 9, lens=[SFT_SEQ, 1500], device=device)


def _sft_reference() -> dict:
    """The single-card SFT step on SFT_MESH_CFG: loss and grad_norm of
    SP_TRAIN_STEPS steps and step 1's leaf grads (on the host)."""
    params = _sft_model(SFT_MESH_CFG, 1)
    tc = SFTConfig(warmup_steps=0)
    tx = make_sft_optimizer(tc)
    state, step = init_sft_state(params, tx), make_sft_step(tc, tx)
    spy = GradSpy(tx, keep=1)
    batch = _sft_mesh_batch()
    rows = []
    for _ in range(SP_TRAIN_STEPS):
        state, m = step(state, batch)
        rows.append((float(m["loss"]), float(m["grad_norm"])))
    del state, params, step, tx
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": [r[0] for r in rows], "grad_norm": [r[1] for r in rows],
            "grads": spy.grads}


def _sft_mode(mode: str, world: int, ref: dict, device: str = "cuda") -> dict:
    """SP_TRAIN_STEPS SFT steps under `mode` on a `world`-rank mesh, held to
    the single-card step (`ref`): loss within SP_LOSS_TOL, grad_norm and
    step 1's leaf grads within SP_GNORM_TOL. Launches are summed over the
    ranks (under --sp each rank runs its own share of the ring)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = _sft_model(SFT_MESH_CFG, 1)
    mesh, sp, shard = _sft_mesh_setup(mode, world, device)
    if shard:
        shard_params(params, mesh)
    tc = SFTConfig(warmup_steps=0)
    tx = make_sft_optimizer(tc)
    state = init_sft_state(params, tx)
    step = make_sft_step(tc, tx, sp_mesh=mesh if sp else None, mesh=mesh)
    spy = GradSpy(tx, ref=ref["grads"], keep=1)
    batch = _sft_mesh_batch(device)
    rows, step_s = [], []
    _reset_launches()
    _reset_train_launches()
    for _ in range(SP_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0, spy_s = time.perf_counter(), spy.seconds
        state, m = step(state, batch)
        rows.append((float(m["loss"]), float(m["grad_norm"])))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0 - (spy.seconds - spy_s))
    local = {**_launches(), **_train_launches(), **_bwd_f32_launches(),
             "ring_step_f32": ring_step.launches_f32, **_moe_launches()}
    counts = torch.tensor([local[k] for k in sorted(local)], device=device)
    dist.all_reduce(counts)
    launches = dict(zip(sorted(local), counts.tolist()))
    rec = {"mode": "sft_" + mode, "world": world, "loss": [r[0] for r in rows],
           "grad_norm": [r[1] for r in rows], "step_s": step_s,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_all_ranks": launches,
           "loss_rel_err": [abs(r[0] / ref["loss"][i] - 1) for i, r in enumerate(rows)],
           "grad_norm_rel_err": [abs(r[1] / ref["grad_norm"][i] - 1) for i, r in enumerate(rows)],
           "worst_leaf_grad_rel_err": spy.worst}
    layers = SFT_MESH_CFG.num_hidden_layers
    # the f32 LM's ring: the f32 step kernel forward; backward, the own shard in plain
    # torch and rows 4 and 5 on f32 operands on each rank's earlier shards, no bf16 kernel
    earlier = SP_TRAIN_STEPS * layers * world * (world - 1) // 2
    ring_ok = not sp or (launches["ring_step_f32"] > 0 and launches["flash_bwd_dq"] == 0
                         and launches["flash_bwd_dkv"] == 0
                         and launches["flash_bwd_dq_f32"] == earlier
                         and launches["flash_bwd_dkv_f32"] == earlier)
    moe_ok = (launches["gmm"] > 0 and launches["tgmm"] > 0  # the MoE's forward and backward
              and launches["gmm"] % (3 * layers) == 0)
    rec["ok"] = (max(rec["loss_rel_err"]) <= SP_LOSS_TOL
                 and max(rec["grad_norm_rel_err"]) <= SP_GNORM_TOL
                 and spy.worst[0][0] <= SP_GNORM_TOL and ring_ok and moe_ok)
    del state, params, step, batch, tx
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# --- the image path and the data pipeline (inside the vlm phase) ------------

def _vae_extract(clip: Path, tmp: Path) -> dict:
    """vae_feature_extract --random_weights on the 720p clip file at
    832x480x81 (stage 1), before the VLM is built: one V2V row whose source
    is the same clip."""
    fdir, manifest = tmp / "features", tmp / "manifest.jsonl"
    manifest.write_text(json.dumps({"id": "clip720", "video": str(clip),
                                    "source_video": str(clip), "caption": EDIT_PROMPT}))
    args = vae_feature_extract.parse_args(
        ["--manifest", str(manifest), "--output_dir", str(fdir), "--size", "832*480",
         "--frame_num", str(FRAMES), "--random_weights", "--device", "cuda"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = vae_feature_extract.run(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with np.load(written[0]) as f:
        keys, shape = sorted(f.files), list(f["latent_feature_tgt"].shape)
        finite = bool(np.isfinite(f["latent_feature_tgt"]).all())
    rec = {"file": written[0].name, "keys": keys, "latent_shape": shape, "wall_s": wall_s}
    gc.collect()
    torch.cuda.empty_cache()
    if (keys != ["latent_feature", "latent_feature_tgt", "prompt"] or not finite
            or shape != [16, GRID[0], GRID[1] * 2, GRID[2] * 2]):
        raise AssertionError(f"vae_feature_extract: {rec}")
    return {**rec, "dir": fdir, "manifest": manifest}


def _image_pass(model: Qwen3VLModel, tmp: Path) -> dict:
    """The engine's image message on a seeded 1280x720 still (a PNG through
    utils/png.py): its grid at the caption budget, prompt length, the
    caption's launches and seconds, then the image features
    (qwen3vl_forward, is_video=False) and their shape."""
    vc, tok = model.cfg.vision, _image_tokenizer()
    path = write_png(tmp / "still.png", np.random.default_rng(12).integers(
        0, 256, STILL_SHAPE, dtype=np.uint8))
    engine = Qwen3VLEngine.from_model(model, VLMConfig(max_new_tokens=VLM_NEW_TOKENS), tok)
    msg = [{"role": "system", "content": [{"type": "text", "text": "Describe the image."}]},
           {"role": "user", "content": [{"type": "image", "image": str(path)},
                                        {"type": "text", "text": EDIT_PROMPT}]}]
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    caption = engine._generate(msg)
    torch.cuda.synchronize()
    caption_s = time.perf_counter() - t0
    launches, moe = _launches(), _moe_launches()
    budget = (480 * 480, 4 * 480 * 480)
    patches, grid = preprocess_image(str(path), vc.patch_size, vc.temporal_patch_size,
                                     vc.spatial_merge_size, *budget, device="cuda")
    ids = build_chat_ids(tok, EDIT_PROMPT, grid=grid, merge_size=vc.spatial_merge_size,
                         is_video=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = qwen3vl_forward(model, ids, torch.from_numpy(patches).cuda(), grid, is_video=False)
    torch.cuda.synchronize()
    features_s = time.perf_counter() - t0
    n_vis = int(np.prod(grid)) // vc.spatial_merge_size**2
    rec = {"image": list(STILL_SHAPE), "grid": list(grid), "visual_tokens": n_vis,
           "prompt_len": int(ids.shape[1]), "features_shape": list(h.shape),
           "caption_s": caption_s, "features_s": features_s, "caption_chars": len(caption),
           "launches": launches, "moe_launches": moe}
    want = {**{k: 0 for k in launches}, "flash_d72": vc.depth,
            "flash_causal": model.cfg.text.num_hidden_layers}
    size = smart_resize(STILL_SHAPE[0], STILL_SHAPE[1], vc.patch_size * vc.spatial_merge_size,
                        *budget)
    if (tuple(grid) != (1, size[0] // vc.patch_size, size[1] // vc.patch_size) or launches != want
            or int((ids == SPECIAL_TOKEN_IDS["<|image_pad|>"]).sum()) != n_vis
            or tuple(h.shape) != (1, ids.shape[1], model.cfg.text.hidden_size)
            or not torch.isfinite(h).all()):
        raise AssertionError(f"vlm image pass: {rec}")
    _check_moe_launches("vlm image pass", moe, model.cfg.text.num_hidden_layers)
    return rec


def _ar_extract(model: Qwen3VLModel, vae: dict) -> dict:
    """ar_feature_extract's per-row function with the engine over this model
    (stage 2): the row's stage-1 file gains the VLM features and captions."""
    engine = Qwen3VLEngine.from_model(model, VLMConfig(max_new_tokens=VLM_NEW_TOKENS),
                                      StandInTokenizer())
    row = json.loads(vae["manifest"].read_text())
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ar_feature_extract.extract_row(engine, row, 0, vae["dir"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, moe = _launches(), _moe_launches()
    with np.load(path, allow_pickle=True) as f:
        keys = sorted(f.files)
        shape = list(f["vlm_last_hidden_states"].shape)
    rec = {"keys": keys, "vlm_shape": shape, "wall_s": wall_s, "launches": launches,
           "moe_launches": moe}
    # source caption and features read the clip, the target caption is text only
    want = {**{k: 0 for k in launches}, "flash_d72": 2 * model.cfg.vision.depth,
            "flash_causal": 3 * model.cfg.text.num_hidden_layers}
    if (launches != want or shape[1:] != [model.cfg.text.hidden_size]
            or not {"vlm_last_hidden_states", "source_caption", "target_caption"} <= set(keys)):
        raise AssertionError(f"ar_feature_extract: {rec}")
    _check_moe_launches("ar_feature_extract", moe, model.cfg.text.num_hidden_layers)
    return rec


def _pipeline_train_step(fdir: Path) -> dict:
    """One T2V-1.3B finetune step (the train phase's settings) on the batch
    training/dataset.py reads from the extracted features: the latents and
    the source latents from stage 1, the VLM features from stage 2.
    --random_weights has no umT5 and writes no text_emb (as JAX's), so the
    text context is the train phase's seeded one."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, tc, params, batch, draws = _train_setup()
    ds = OmniVideoDataset(str(fdir))
    got = collate([ds[0]], PadSpec(text_len=CTX_LEN, vlm_len=CTX_LEN, latent_frames=GRID[0]))
    read = {k: torch.from_numpy(v).cuda() for k, v in got.items()}
    batch.update(read)
    tx = make_optimizer(tc, params)
    state = init_train_state(params, tx)
    step = make_unified_train_step(cfg, tc, tx)
    _reset_launches()
    _reset_train_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch, draws)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    rec = {"read": {k: list(v.shape) for k, v in read.items()}, "loss": loss,
           "grad_norm": float(m["grad_norm"]), "step_s": time.perf_counter() - t0,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": {**_train_launches(), **_launches()}}
    del state, params, step, batch, tx, read
    gc.collect()
    torch.cuda.empty_cache()
    if (not np.isfinite(loss) or rec["launches"] != _train_expect(cfg)
            or sorted(rec["read"]) != ["latents", "visual_emb", "vlm"]):
        raise AssertionError(f"data pipeline finetune step: {rec}")
    return rec


def _sft_sp_alone() -> int:
    """`chip_smoke.py sft_sp`: the f32 ring step's cases, rows 4 and 5 on f32
    operands and the f32 SFT ring backward, then the SFT step under --sp on
    a NCCL group of world 1 beside the single-card step; with 2+ cards also
    the SFT modes and qwen3_forward_sp across min(4, count) ranks."""
    phase_device()
    gen = torch.Generator(device="cuda").manual_seed(0)
    _ring_f32_case(gen)
    _bwd_f32_case(gen)
    _sft_ring_backward(gen, torch.float32)
    sft_ref = _sft_reference()
    maybe_initialize_distributed(f"localhost:{_free_port()}", 1, 0, device="cuda")
    try:
        rec = _sft_mode("sp", 1, sft_ref)
    finally:
        dist.destroy_process_group()
    emit({"phase": "sft_sp", "sft_config": "QWEN3_VL_30B_A3B.text, 2 layers, 16 experts",
          "sft_seq_len": SFT_SEQ, "single_card": {"loss": sft_ref["loss"],
                                                  "grad_norm": sft_ref["grad_norm"]}, **rec})
    multi = {}
    count = torch.cuda.device_count()
    if count >= 2:
        multi = _sp_train_multi_card(min(4, count), None, sft_ref)
        emit({"phase": "sft_sp", "multi_card": multi})
    bad = [m for m, r in {"sft_sp": rec, **multi}.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"sft_sp: modes {bad} failed")
    return 0


def _i2v_alone() -> int:
    """`chip_smoke.py i2v`: the flash phase (with its i2v cross-attention
    cases), then tiny_i2v, i2v, vae22 and xlm."""
    phase_device()
    phase_flash(torch.Generator(device="cuda").manual_seed(0))
    phase_tiny_i2v()
    phase_i2v()
    phase_vae22()
    phase_xlm()
    return 0


def _sp_train_alone() -> int:
    """`chip_smoke.py sp_train`: the train phase for its reference, then sp_train."""
    phase_device()
    ref = phase_train().pop("ref")
    phase_sp_train(ref, torch.Generator(device="cuda").manual_seed(0))
    return 0


STREAM_TOL = 1e-5  # streamed vs resident A14B latents, of scale: the same kernels on the same
# inputs (predicted bit-equal; the bound covers a different cuBLAS algorithm per call)
STREAM_Q8_TOL = 5e-2  # int8-streamed vs resident latents, of scale (JAX's bound for its int8
# stream, tests/test_streaming.py)
STREAM_Q8_BYTES = 0.51  # an int8 block's bytes over a bf16 block's, at most
STREAM_TRAIN_LOSS_TOL = 2e-3  # rel, streamed vs resident train step: the same kernels on the
# same tokens, sums (d_e0, d_ctx, the norm) in another order (SP_LOSS_TOL's reasoning)
STREAM_TRAIN_GNORM_TOL = 1e-2  # rel, grad_norm (SP_GNORM_TOL)
STREAM_LORA_Q8_TOL = 0.1  # rel, int8-base LoRA loss vs the bf16 base's (JAX's rtol)
STREAM_VARIANT_STEPS = 2  # steps of the fused and adafactor cases (full depth), to fit the run time
STREAM_LORA_STEPS = 3  # A14B LoRA steps: resident, bf16 base, int8 base
STREAM_RULE_LEAVES = ("blocks.0.cross_attn.k.weight", "blocks.29.ffn.0.weight",  # factored
                      "blocks.0.ffn.0.bias", "blocks.29.self_attn.norm_q.weight")  # unfactored
STREAM_PARAM_TOL = 5e-2  # ‖Δ_streamed − Δ_resident‖/‖Δ_resident‖ of each leaf's parameter change
# over the run: a block whose last write-back is dropped or stale reads ~1/steps (the control,
# from the resident run's last step), a skipped block 1


def _stream_generate(cfg, experts, inputs, timing=False, prepare=None, **stream_kw) -> tuple:
    """One streamed A14B generate from the a14b phase's inputs: (latents,
    record). A non-finite result raises (FloatingPointError, from generate)."""
    high, low = experts
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pipe = OmniVideoX2XUnified(cfg, low, high, qk_impl="kernel", ew_impl="kernel",
                               layer_stream=True, **stream_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for e in (high, low):
        pipe.executor(e.wan).timing = timing
        if prepare is not None:
            prepare(e, pipe.executor(e.wan))
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    executors = [pipe.executor(e.wan) for e in (high, low)]
    _reset_launches()
    gen_kw = dict(size=SIZE, frame_num=FRAMES, sampling_steps=A14B_STEPS, shift=cfg.sample_shift,
                  guide_scale=cfg.sample_guide_scale, decode=False, **inputs)
    with RssSampler() as rss:
        lat = pipe.generate(**gen_kw)
    rec = {"kw": dict(stream_kw), "window": executors[0].window, "launches": _launches(),
           "step_s": pipe.timings["step_s"], "denoise_step_s": pipe.timings["denoise_step_s"],
           "prepare_s": prep_s, "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
           "host_rss_peak_gb": rss.peak_gb, "pinned_gb": HostBuffer.pinned_bytes / 1e9,
           "block_bytes": executors[0].block_bytes}
    if timing:
        rec["overlap"] = [st for ex in executors for st in ex.stats]
    pipe.release_streams()
    return lat, rec


def phase_stream(a14b: dict, cli: dict, tmp: Path) -> dict:
    """T2V-A14B generate with both experts' blocks in page-locked host
    memory, streamed through the card (pipelines/streaming.py), from the
    a14b phase's weights and inputs: window 2 (copy and compute overlap
    timed with CUDA events), window 1 and group 4 bit-equal to it, int8 (each
    expert quantised on the card, then its bf16 host copy dropped); then the
    cli phase's row through the generate CLI again, resident and with
    --layer_stream: both rows' latents bit-equal to the cli phase's, the
    streamed row's frames within 1 level of the resident row's."""
    cfg = T2V_A14B.replace(dit=T2V_A14B.dit.replace(num_layers=A14B_LAYERS))
    st = a14b["stream"]
    experts, inputs, ref, expect = st["experts"], st["inputs"], st["latents"], st["launches"]
    runs = {}
    lat, runs["window2"] = _stream_generate(cfg, experts, inputs, timing=True)
    emit({"phase": "stream", "run": "window2", "latent_rel_err": _scale_rel(lat, ref),
          **{k: v for k, v in runs["window2"].items() if k != "overlap"}})
    lat1, runs["window1"] = _stream_generate(
        cfg, experts, inputs, prepare=lambda e, ex: setattr(ex, "window", 1))
    emit({"phase": "stream", "run": "window1", "equal": bool(torch.equal(lat1, lat)),
          **runs["window1"]})
    lat4, runs["group4"] = _stream_generate(cfg, experts, inputs, stream_group=4)
    emit({"phase": "stream", "run": "group4", "equal": bool(torch.equal(lat4, lat)),
          **runs["group4"]})
    bf16_block = runs["window2"]["block_bytes"]

    def drop_bf16(expert, ex):  # only the int8 copies stay on the host
        expert.wan.host_blocks = ex.host_blocks

    latq, runs["int8"] = _stream_generate(cfg, experts, inputs, prepare=drop_bf16,
                                          stream_quant="int8")
    rel = _scale_rel(lat, ref)
    rel_q8 = _scale_rel(latq, ref)
    overlap = runs["window2"].pop("overlap")
    if not overlap:
        raise AssertionError("stream: no copy was timed")
    copy_ms = sum(o["copy_ms"] for o in overlap)
    exposed_ms = sum(o["copy_ms"] * (1 - o["hidden_share"]) for o in overlap)
    # the cli phase's row again, resident then streamed: the VAE decode of bit-equal latents
    # moves with the process's state (the cli phase's own frames, decoded earlier, read 1
    # level apart in a `stream` run alone, 12 once), so the frames are held to the resident
    # row decoded here
    rows = {}
    for key, extra in (("resident", []), ("streamed", ["--layer_stream"])):
        argv = list(cli["argv"]) + extra
        argv[argv.index("--output_dir") + 1] = str(tmp / f"cli_{key}")
        _reset_launches()
        with _CapturedFrames() as written:
            (res,) = generate_cli.run(generate_cli.parse_args(argv))
        rows[key] = (argv, _launches(), res, written.frames["v2v_0"])
        shutil.rmtree(tmp / f"cli_{key}", ignore_errors=True)
    argv, cli_launches, res, frames = rows["streamed"]
    levels = lambda a, b: int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())  # noqa: E731
    cli_rec = {"argv": argv, "launches": cli_launches, "step_s": res["timings"]["step_s"],
               "latents_equal": bool(torch.equal(res["latents"], cli["latents"])
                                     and torch.equal(rows["resident"][2]["latents"],
                                                     cli["latents"])),
               "frames_max_levels": levels(frames, rows["resident"][3]),
               "frames_vs_cli_phase_levels": levels(frames, cli["frames"])}
    del rows
    rec = {"phase": "stream", "config": "T2V_A14B", "resident_step_s": st["timings"]["step_s"],
           "resident_denoise_peak_gb": st["denoise_peak_gb"], "split_s": st["split_s"],
           "latent_rel_err": rel, "tolerance": STREAM_TOL,
           "window1_equal": bool(torch.equal(lat1, lat)), "group4_equal": bool(torch.equal(lat4, lat)),
           "int8_latent_rel_err": rel_q8, "int8_tolerance": STREAM_Q8_TOL,
           "int8_block_bytes_ratio": runs["int8"]["block_bytes"] / bf16_block,
           "copy_gb_per_s": sum(o["copy_gb"] for o in overlap) / (copy_ms / 1e3),
           "hidden_share": 1 - exposed_ms / copy_ms, "copy_ms_total": copy_ms,
           "compute_ms_total": sum(o["compute_ms"] for o in overlap),
           "forwards_timed": len(overlap), "runs": runs, "expected_launches": expect,
           "cli": cli_rec}
    emit(rec)
    bad = [k for k, r in runs.items() if r["launches"] != expect]
    if (rel > STREAM_TOL or not rec["window1_equal"] or not rec["group4_equal"]
            or not 0 < rel_q8 <= STREAM_Q8_TOL or rec["int8_block_bytes_ratio"] > STREAM_Q8_BYTES
            or bad or cli_launches != cli["expect"] or not cli_rec["latents_equal"]
            or cli_rec["frames_max_levels"] > 1):
        raise AssertionError(f"stream: {rec} (launches off in {bad})")
    rec["launches"] = runs["window2"]["launches"]
    del st["experts"], experts
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _plain_train_setup(cfg, seed: int = 0):
    """A seeded DiT of `cfg` (f32 masters, head filled), a batch at
    832x480x81 with the full context, and one set of draws."""
    tc = TrainConfig(warmup_steps=0, total_steps=1000, remat=True)
    dit_cfg = cfg.dit.replace(text_len=cfg.max_context_len)
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    wan = WanDiT(dit_cfg, dtype=torch.float32, device="cuda",
                 generator=torch.Generator(device="cuda").manual_seed(seed))
    with torch.no_grad():  # init zero-fills the head: every block gradient would be 0
        wan.head.head.weight.normal_(0.0, cfg.dit.dim**-0.5, generator=gen)
    lat = (1, cfg.dit.in_dim, GRID[0], GRID[1] * 2, GRID[2] * 2)
    batch = {"latents": torch.randn(lat, generator=gen, device="cuda"),
             "context": torch.randn(1, cfg.max_context_len, cfg.dit.text_dim, generator=gen,
                                    device="cuda")}
    return tc, wan, batch, sample_draws(gen, lat, tc)


def _change_gaps(got: dict, ref: dict, prev: dict, base: dict) -> dict:
    """How far the streamed run's parameters `got` depart from the resident
    run's `ref`, as a share of the resident change ref − base (f64 sums; a
    leaf the resident run left unmoved is skipped): per leaf, and per group
    (a block's leaves together, the resident leaves together); beside the
    control, the same share for ref's last step (ref − prev), which is what a
    leaf or group whose last write-back was dropped would read."""
    sq = {"gap": {}, "ctrl": {}, "moved": {}}
    for n, r in ref.items():
        moved = float((r - base[n]).double().square().sum())
        if moved == 0.0:
            continue
        g = got[n].to(r.device, non_blocking=True)
        sq["moved"][n] = moved
        sq["gap"][n] = float((g - r).double().square().sum())
        sq["ctrl"][n] = float((r - prev[n]).double().square().sum())
    groups = {}
    for n in sq["moved"]:
        parts = n.split(".")
        groups.setdefault(".".join(parts[:2]) if parts[0] == "blocks" else "resident", []).append(n)
    out = {"leaves": len(sq["moved"]), "skipped_unmoved": len(ref) - len(sq["moved"])}
    for level, members in (("leaf", {n: [n] for n in sq["moved"]}), ("group", groups)):
        share = {k: {q: math.sqrt(sum(sq[q][n] for n in ns) / sum(sq["moved"][n] for n in ns))
                     for q in ("gap", "ctrl")} for k, ns in members.items()}
        worst = max(share, key=lambda k: share[k]["gap"])
        least = min(share, key=lambda k: share[k]["ctrl"])
        out[level] = {"worst": worst, "worst_gap": share[worst]["gap"],
                      "median_gap": float(np.median([v["gap"] for v in share.values()])),
                      "control_least": least, "control_least_share": share[least]["ctrl"],
                      "control_median": float(np.median([v["ctrl"] for v in share.values()]))}
    return out


def _stream_train_case(name: str, steps: int, hold_params: bool, rule_leaves=(),
                       **tc_kw) -> dict:
    """make_train_step (resident) and StreamedTrainer from the same T2V-1.3B
    weights (full depth), batch and draws, `steps` steps each: loss and
    grad_norm per step; with `hold_params`, each leaf's parameter change
    over the run against the resident run's (_change_gaps); `rule_leaves`
    (block leaves, adafactor): the streamed trainer's first update of each
    against the f64 reference of the rule on that leaf alone
    (_adafactor_reference) from the gradient the rule was given, and that
    gradient against the resident step's (clipped alike)."""
    cfg = T2V_1_3B
    out = {"case": name, "layers": cfg.dit.num_layers, "steps": steps, **tc_kw}
    ref, seen = {}, {}
    for mode in ("resident", "streamed"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tc, wan, batch, draws = _plain_train_setup(cfg)
        tc = dataclasses.replace(tc, **tc_kw)
        t0 = time.perf_counter()
        if mode == "resident":
            tx = make_optimizer(tc, wan)
            state = init_train_state(wan, tx)
            step = make_train_step(cfg, tc, tx)
            if rule_leaves:
                update = tx.update

                def spy(model, grads, opt_state):
                    if opt_state["count"] == 0:
                        gnorm = float(global_norm(grads.values()))
                        scale = min(1.0, tc.grad_clip / gnorm) if tc.grad_clip else 1.0
                        seen["g_resident"] = {n: grads[n].detach() * scale for n in rule_leaves}
                    return update(model, grads, opt_state)

                tx.update = spy
        else:
            trainer = StreamedTrainer(cfg, tc, device="cuda")
            state = trainer.init_state(wan)
            step = trainer.train_step
            if rule_leaves:  # pass B updates the blocks in order, after the resident leaves
                apply, blocks = trainer.rule.apply, [-1]
                block_names, watch = set(state.host_blocks[0].block()), {}
                for n in rule_leaves:
                    _, i, local = n.split(".", 2)
                    watch.setdefault(int(i), {})[local] = n

                def spy_rule(leaves, g, opt, count):
                    if count == 0 and leaves[0][0] in block_names:
                        blocks[0] += 1
                        own = dict(leaves)
                        for local, n in watch.get(blocks[0], {}).items():
                            seen.setdefault("g", {})[n] = g[local].detach().clone()
                            seen.setdefault("p0", {})[n] = own[local].detach().clone()
                            seen["lr"] = trainer.rule.sched(count)
                    apply(leaves, g, opt, count)
                    if count == 0:
                        own = dict(leaves)
                        for local, n in watch.get(blocks[0], {}).items():
                            seen.setdefault("p1", {})[n] = own[local].detach().clone()

                trainer.rule.apply = spy_rule
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        with RssSampler() as rss:
            if mode == "resident" and hold_params:  # the start and the last step's start kept
                ref["base"] = {n: p.detach().clone() for n, p in wan.named_parameters()}
                state, rows, step_s, per_step = _timed_steps(step, state, batch, draws,
                                                             steps - 1)
                ref["prev"] = {n: p.detach().clone() for n, p in wan.named_parameters()}
                state, *last = _timed_steps(step, state, batch, draws, 1)
                rows, step_s, per_step = (a + b for a, b in zip((rows, step_s, per_step), last))
            else:
                state, rows, step_s, per_step = _timed_steps(step, state, batch, draws, steps)
        out[mode] = {"loss": [r[0] for r in rows], "grad_norm": [r[1] for r in rows],
                     "step_s": step_s, "init_s": init_s,
                     "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "host_rss_peak_gb": rss.peak_gb, "pinned_gb": HostBuffer.pinned_bytes / 1e9,
                     "launches_ok": all(p == _train_expect(cfg) for p in per_step),
                     "launches": {k: sum(p[k] for p in per_step) for k in TRAIN_ROWS}}
        if hold_params:
            with torch.no_grad():
                if mode == "resident":
                    ref["params"] = {n: p.detach().clone() for n, p in wan.named_parameters()}
                else:
                    got = {**dict(state.resident.resident_parameters()),
                           **host_block_targets(state.resident)}
                    out["params"] = _change_gaps(got, ref["params"], ref["prev"], ref["base"])
                    out["params"]["tolerance"] = STREAM_PARAM_TOL
            torch.cuda.synchronize()
        del state, step, wan, batch
    ref.clear()
    r, s_ = out["resident"], out["streamed"]
    out["loss_rel"] = [abs(a / b - 1) for a, b in zip(s_["loss"], r["loss"])]
    out["grad_norm_rel"] = [abs(a / b - 1) for a, b in zip(s_["grad_norm"], r["grad_norm"])]
    # adafactor's update takes a leaf's RMS over the leaf: the resident rule over a JAX
    # leaf's every layer, the streamed one per block (as JAX's streamed trainer does), so
    # after the first update the two steps differ by design (at 30 layers the second
    # step's loss by ~2e-2): loss and grad_norm are held at step 1, where both take the
    # same parameters, and the streamed update to its own rule (rule_leaves)
    held = 1 if tc.optimizer == "adafactor" else steps
    out["steps_held"] = held
    rule_ok = True
    if rule_leaves:
        zero = torch.zeros((), dtype=torch.float64)
        st = {k: {n: zero for n in rule_leaves} for k in ("v", "v_row", "v_col")}
        out["rule"], out["rule_grad"] = {}, {}
        for n in rule_leaves:
            want = _adafactor_reference([n], seen["p0"], seen["g"], st, 0, 1.0, seen["lr"],
                                        tc.weight_decay)
            got = seen["p1"][n].double() - seen["p0"][n].double()
            got = got.T if n.endswith(".weight") and got.ndim == 2 else got
            out["rule"][n] = _scale_rel(got, want)
            g_r = seen["g_resident"][n].float()
            out["rule_grad"][n] = float((seen["g"][n].float() - g_r).norm() / g_r.norm())
        out["rule_tolerance"], out["rule_grad_tolerance"] = UPDATE_TOL, SP_GNORM_TOL
        rule_ok = (max(out["rule"].values()) <= UPDATE_TOL
                   and max(out["rule_grad"].values()) <= SP_GNORM_TOL)
    params_ok = (not hold_params or (out["params"]["leaf"]["worst_gap"] <= STREAM_PARAM_TOL
                                     < out["params"]["leaf"]["control_least_share"]))
    out["ok"] = (max(out["loss_rel"][:held]) <= STREAM_TRAIN_LOSS_TOL
                 and max(out["grad_norm_rel"][:held]) <= STREAM_TRAIN_GNORM_TOL
                 and params_ok and rule_ok and r["launches_ok"] and s_["launches_ok"]
                 and all(np.isfinite(s_["loss"])) and s_["loss"][-1] != s_["loss"][0])
    return out


def _stream_lora() -> dict:
    """One T2V-A14B expert at full width, A14B_LAYERS deep, rank-16 LoRA on
    DEFAULT_TARGETS, batch 1 at 832x480x81 with a 512-token context: the
    resident LoRA step (make_train_step, freeze_base), then
    StreamedLoRATrainer from the same base, adapters and draws (bf16 base,
    then int8 base), STREAM_LORA_STEPS steps each, timed."""
    cfg = T2V_A14B.replace(dit=T2V_A14B.dit.replace(num_layers=A14B_LAYERS))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dit_cfg = cfg.dit.replace(text_len=CTX_LEN)
    gen = torch.Generator(device="cuda").manual_seed(5)
    t0 = time.perf_counter()
    wan = WanDiT(dit_cfg, dtype=torch.bfloat16, device="cuda",
                 generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        wan.head.head.weight.normal_(0.0, cfg.dit.dim**-0.5, generator=gen)
    adapters = draw_lora(wan, LORA_RANK, generator=torch.Generator(device="cuda").manual_seed(7))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tc = TrainConfig(warmup_steps=0, total_steps=1000, remat=True, learning_rate=LORA_LR,
                     trainable_filters=LORA_FILTERS)
    lat = (1, cfg.dit.in_dim, GRID[0], GRID[1] * 2, GRID[2] * 2)
    batch = {"latents": torch.randn(lat, generator=gen, device="cuda"),
             "context": torch.randn(1, CTX_LEN, cfg.dit.text_dim, generator=gen, device="cuda")}
    draws = sample_draws(gen, lat, tc)
    n_layers = cfg.dit.num_layers
    out = {"config": "T2V_A14B", "layers": n_layers, "rank": LORA_RANK,
           "sites_per_block": len(adapters) // n_layers, "context_len": CTX_LEN,
           "init_s": init_s, "lr": LORA_LR}
    # resident reference (base 28.6 GB + f32 remat inputs 26.8 GB)
    for name, (a, b, sc) in adapters.items():
        set_adapter(wan.get_submodule(name), a, b, sc)
    freeze_base(wan)
    tx = make_optimizer(tc, wan)
    state = init_train_state(wan, tx)
    state, rows, step_s, per_step = _timed_steps(make_train_step(cfg, tc, tx), state, batch,
                                                 draws, STREAM_LORA_STEPS)
    out["resident"] = {"loss": [r[0] for r in rows], "grad_norm": [r[1] for r in rows],
                       "step_s": step_s,
                       "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    del state, tx
    strip_lora(wan)
    gc.collect()
    torch.cuda.empty_cache()
    for key, quant in (("bf16", None), ("int8", "int8")):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = StreamedLoRATrainer(cfg, tc, device="cuda", base_quant=quant)
        state = trainer.init_state(wan, adapters)
        start = {k: v.detach().clone() for k, v in state.lora.items()}
        torch.cuda.synchronize()
        init = time.perf_counter() - t0
        with RssSampler() as rss:
            state, rows, step_s, per_step = _timed_steps(trainer.train_step, state, batch,
                                                         draws, STREAM_LORA_STEPS)
        moved = sum(not torch.equal(state.lora[k], v) for k, v in start.items())
        out[key] = {"loss": [r[0] for r in rows], "grad_norm": [r[1] for r in rows],
                    "step_s": step_s, "init_s": init, "adapters_moved": moved,
                    "adapter_tensors": len(start),
                    "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "host_rss_peak_gb": rss.peak_gb, "pinned_gb": HostBuffer.pinned_bytes / 1e9,
                    "launches": {k: sum(p[k] for p in per_step) for k in TRAIN_ROWS},
                    "launches_ok": all(p == _train_expect(cfg) for p in per_step)}
        del state, trainer, start
    r, b, q = out["resident"], out["bf16"], out["int8"]
    out["loss_rel"] = [abs(x / y - 1) for x, y in zip(b["loss"], r["loss"])]
    out["grad_norm_rel"] = [abs(x / y - 1) for x, y in zip(b["grad_norm"], r["grad_norm"])]
    out["int8_loss_rel"] = [abs(x / y - 1) for x, y in zip(q["loss"], b["loss"])]
    out["ok"] = (max(out["loss_rel"]) <= STREAM_TRAIN_LOSS_TOL
                 and max(out["grad_norm_rel"]) <= STREAM_TRAIN_GNORM_TOL
                 and max(out["int8_loss_rel"]) <= STREAM_LORA_Q8_TOL
                 and b["adapters_moved"] > 0 and q["adapters_moved"] > 0
                 and all(np.isfinite(b["loss"] + q["loss"]))
                 and b["launches_ok"] and q["launches_ok"])
    del wan, batch
    return out


def phase_stream_train() -> dict:
    """(a) StreamedTrainer on T2V-1.3B at full width and depth against the
    resident make_train_step (f32 masters, AdamW lr 3e-6, clip 0.1, remat,
    3 steps from one batch and set of draws), then its fused (grad_clip 0)
    and adafactor modes, STREAM_VARIANT_STEPS steps each; (b)
    StreamedLoRATrainer on one T2V-A14B expert (_stream_lora). The record's
    "launches" holds each streamed run's own count (reset before each step,
    summed over the run)."""
    cases = [_stream_train_case("adamw", TRAIN_STEPS, True),
             _stream_train_case("fused", STREAM_VARIANT_STEPS, True, grad_clip=0.0),
             _stream_train_case("adafactor", STREAM_VARIANT_STEPS, False, STREAM_RULE_LEAVES,
                                optimizer="adafactor", learning_rate=ADAFACTOR_LR)]
    lora = _stream_lora()
    rec = {"phase": "stream_train", "full": cases, "lora": lora,
           "train_step_s": sum(cases[0]["streamed"]["step_s"][1:]) / (TRAIN_STEPS - 1),
           "resident_train_step_s": sum(cases[0]["resident"]["step_s"][1:]) / (TRAIN_STEPS - 1)}
    emit(rec)
    if not all(c["ok"] for c in cases) or not lora["ok"]:
        raise AssertionError(f"stream_train: {rec}")
    rec["launches"] = {"stream_train": cases[0]["streamed"]["launches"],
                       "stream_train_fused": cases[1]["streamed"]["launches"],
                       "stream_train_adafactor": cases[2]["streamed"]["launches"],
                       "stream_lora": lora["bf16"]["launches"],
                       "stream_lora_int8": lora["int8"]["launches"]}
    return rec


def _stream_alone() -> int:
    """`chip_smoke.py stream`: the cli phase (its row is the yardstick of the
    CLI's --layer_stream), the a14b phase keeping its experts on the host,
    then stream."""
    phase_device()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        cli = phase_cli(write_clip(tmp / "clip_720p.npz"), tmp)
        gen = torch.Generator(device="cuda").manual_seed(0)
        a14b = phase_a14b(torch.randn(1450, QWEN3_VL_30B_A3B.text.hidden_size, generator=gen,
                                      device="cuda"), keep_host=True)
        phase_stream(a14b, cli, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def _stream_train_alone() -> int:
    """`chip_smoke.py stream_train`: the streamed trainers' phase alone."""
    phase_device()
    phase_stream_train()
    return 0


SERVE_CTX = (64, 4096)  # a short JSON context: the DiT pads it to text_len 6,272
SERVE_SHORT_FRAMES = 17
SERVE_SEED = 7
SERVE_GUIDE = 5.0
METRIC_REL_TOL = 1e-5  # eval_videos, card vs CPU, relative: f64 sums in another order
PV_MAX_LEVELS = 2.0  # preprocess_video, card vs CPU, in uint8 levels: two resizes, each
# rounding after its width and height passes; one level of the first carried by the second's
# bicubic taps (absolute sum > 1) reads up to 2
PV_OVER1_SHARE = 1e-4  # share of patch values allowed more than 1 level apart
EVAL_NEW_TOKENS = 8  # eval_vlm --max_new_tokens (its MC row widens it to 12, as JAX's)


def _http(url: str, body=None):
    """(status, JSON reply) of a GET, or of a POST with `body`."""
    req = urllib.request.Request(url, data=body, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _ServedFrames:
    """Inside the `with`, the frames the server's `save_video` gets (before
    the lossy writer), by file stem."""

    def __enter__(self):
        self.frames, self._real = {}, serve_tool.save_video

        def capture(path, video, **kw):
            self.frames[Path(path).stem] = torch.as_tensor(video).cpu()
            return self._real(path, video, **kw)

        serve_tool.save_video = capture
        return self

    def __exit__(self, *exc):
        serve_tool.save_video = self._real


def phase_serve(pipe, tmp: Path) -> dict:
    """tools/serve.py's `Server` on the e2e phase's pipeline (no second
    init) behind http.server on 127.0.0.1:0, driven by urllib: request (a)
    832x480x81, STEPS UniPC steps, a seeded 64x4096 context; then the same
    generate called directly (its frames bit-equal to the ones (a) wrote,
    the same launches); request (b) 832x480x17 with the id "../../evil" (the
    file keeps inside the output dir under a server id); a malformed body (a
    500) and /healthz after it. Launches per request, latencies."""
    out_dir = tmp / "serve_out"
    server = serve_tool.Server(serve_tool.parse_args(["--output_dir", str(out_dir)]), pipe=pipe)
    httpd = HTTPServer(("127.0.0.1", 0), serve_tool.make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    ctx = np.random.default_rng(21).standard_normal(SERVE_CTX).astype(np.float32)

    def body(**kw):
        return json.dumps({"context": ctx.tolist(), "size": list(SIZE), "sampling_steps": STEPS,
                           "seed": SERVE_SEED, "guide_scale": SERVE_GUIDE, **kw}).encode()

    layers = T2V_1_3B.dit.num_layers
    expect = {"qk_prep": 4 * layers * STEPS, "flash_fwd": 2 * layers * STEPS, "flash_causal": 0,
              "flash_d72": 0, "fused_adaln": 0, "ring_step": 0, "flash_pair": 0}
    reqs = {}
    try:
        with _ServedFrames() as written:
            for name, kw in (("a", {"id": "req_a", "frame_num": FRAMES}),
                             ("b", {"id": "../../evil", "frame_num": SERVE_SHORT_FRAMES})):
                payload = body(**kw)
                _reset_launches()
                t0 = time.perf_counter()
                code, reply = _http(base + "/generate", payload)
                reqs[name] = {"status": code, "reply": reply, "wall_s": time.perf_counter() - t0,
                              "launches": _launches(), "body_bytes": len(payload)}
                if name == "a":  # the direct call, decoded beside the served one
                    ctx_t = torch.from_numpy(ctx).cuda()
                    _reset_launches()
                    t0 = time.perf_counter()
                    direct = pipe.generate(
                        precomputed_context=ctx_t, precomputed_context_null=torch.zeros_like(ctx_t),
                        size=SIZE, frame_num=FRAMES, sampling_steps=STEPS, guide_scale=SERVE_GUIDE,
                        generator=torch.Generator(device="cuda").manual_seed(SERVE_SEED),
                        output_uint8=True).cpu()
                    direct_s = time.perf_counter() - t0
                    direct_launches = _launches()
        bad = _http(base + "/generate", b"{not json")
        health = _http(base + "/healthz")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    a, b = reqs["a"]["reply"], reqs["b"]["reply"]
    paths = {k: Path(r["reply"].get("path", "")) for k, r in reqs.items()}
    served_a = written.frames.get(a.get("file_id"))
    rec = {"phase": "serve", "config": "T2V_1_3B", "size": list(SIZE), "steps": STEPS,
           "context": list(SERVE_CTX), "frames": {"a": FRAMES, "b": SERVE_SHORT_FRAMES},
           "latency_s": {k: r["reply"].get("latency_s") for k, r in reqs.items()},
           "wall_s": {k: r["wall_s"] for k, r in reqs.items()},
           "body_bytes": {k: r["body_bytes"] for k, r in reqs.items()},
           "direct_generate_s": direct_s, "denoise_step_s": pipe.timings.get("denoise_step_s"),
           "launches_per_request": {k: r["launches"] for k, r in reqs.items()},
           "direct_launches": direct_launches,
           "bit_equal_to_direct": served_a is not None and torch.equal(served_a, direct),
           "b_file_id": b.get("file_id"), "written": {k: p.name for k, p in paths.items()},
           "malformed_status": bad[0], "healthz": health}
    emit(rec)
    inside = all(p.exists() and p.resolve().parent == out_dir.resolve() for p in paths.values())
    if (any(r["status"] != 200 for r in reqs.values()) or not rec["bit_equal_to_direct"]
            or a.get("file_id") != "req_a" or b.get("id") != "../../evil"
            or b.get("file_id") == b.get("id") or not inside
            or any(r["launches"] != expect for r in reqs.values()) or direct_launches != expect
            or bad[0] != 500 or health != (200, {"status": "ok",
                                                 "backend": torch.cuda.get_device_name(0),
                                                 "task": "t2v-1.3B"})):
        raise AssertionError(f"serve: {rec} (launches expected {expect})")
    rec["paths"] = paths
    rec["launches"] = {k: reqs["a"]["launches"][k] + reqs["b"]["launches"][k] for k in expect}
    return rec


def phase_export(pipe, tmp: Path) -> dict:
    """tools/export_aot.py on the e2e phase's expert at 832x480x81 (bf16
    latents [2, 16, 21, 60, 104], t [2], a seeded context [2, 6272, 4096]):
    export, save into the run's temp dir, load, call once; the loaded
    program held to the eager forward on the same inputs (bit-equal, else
    within FLASH_ULPS of each output row's max) with the same qk_prep and
    flash_fwd launches; export, save and load seconds, the artifact's bytes,
    and the program's ms beside the eager forward's."""
    dit = pipe.low_noise.wan
    gen = torch.Generator(device="cuda").manual_seed(23)
    xs, ts, cs = export_aot.input_shapes(T2V_1_3B, SIZE, FRAMES)
    x = torch.randn(xs, generator=gen, device="cuda").bfloat16()
    t = torch.full(ts, 937.0, device="cuda")
    ctx = torch.randn(cs, generator=gen, device="cuda").bfloat16()
    t0 = time.perf_counter()
    prog = export_aot.export_denoise(dit, x, t, ctx, torch.bfloat16)
    export_s = time.perf_counter() - t0
    path = tmp / "dit_t2v_1_3b.pt2"
    t0 = time.perf_counter()
    nbytes = export_aot.save_program(prog, path)
    save_s = time.perf_counter() - t0
    del prog
    t0 = time.perf_counter()
    loaded = torch.export.load(str(path)).module()
    load_s = time.perf_counter() - t0
    params = export_aot.dit_params(dit)
    kw = dict(residual_dtype=torch.bfloat16, qk_impl="kernel",
              ew_impl=export_aot.ew_impl_for(torch.bfloat16))
    with torch.no_grad():
        _reset_launches()
        out = loaded(params, x, t, ctx)
        torch.cuda.synchronize()
        prog_launches = _launches()
        _reset_launches()
        ref = dit(x, t, ctx, **kw)
        torch.cuda.synchronize()
        eager_launches = _launches()
        prog_ms = cuda_ms(lambda: loaded(params, x, t, ctx), reps=2, warmup=0)
        eager_ms = cuda_ms(lambda: dit(x, t, ctx, **kw), reps=2, warmup=0)
    ulps = float(row_ulps(out, ref).max())
    layers = T2V_1_3B.dit.num_layers
    expect = {"qk_prep": 4 * layers, "flash_fwd": 2 * layers, "flash_causal": 0, "flash_d72": 0,
              "fused_adaln": 0, "ring_step": 0, "flash_pair": 0}
    rec = {"phase": "export", "config": "T2V_1_3B", "x": list(xs), "ctx": list(cs),
           "residual_dtype": "bfloat16", "export_s": export_s, "save_s": save_s,
           "load_s": load_s, "artifact_bytes": nbytes, "program_ms": prog_ms,
           "eager_ms": eager_ms, "bit_equal": bool(torch.equal(out, ref)),
           "max_row_ulps": ulps, "tolerance_row_ulps": FLASH_ULPS,
           "launches": prog_launches, "eager_launches": eager_launches,
           "out_shape": list(out.shape)}
    emit(rec)
    if (prog_launches != eager_launches or prog_launches != expect or ulps > FLASH_ULPS
            or tuple(out.shape) != (2, 16) + tuple(xs[2:]) or not torch.isfinite(out).all()):
        raise AssertionError(f"export: {rec} (launches expected {expect})")
    path.unlink()
    return rec


def phase_eval_videos(served: dict, tmp: Path) -> dict:
    """tools/eval_videos.py over the serve phase's two clips on the card,
    each its own reference (PSNR infinite, SSIM 1), then the two requests'
    first 17 frames as a pair: the metrics on the card within
    METRIC_REL_TOL of the same on the CPU."""
    d = tmp / "eval_videos"
    d.mkdir()
    for p in served["paths"].values():
        shutil.copy(p, d / p.name)
    t0 = time.perf_counter()
    report = eval_videos_tool.main(["--generated", str(d), "--reference", str(d), "--report",
                                    str(tmp / "eval_videos.json"), "--device", "cuda"])
    report_s = time.perf_counter() - t0
    a = read_video_frames(str(served["paths"]["a"]))[0]
    b = read_video_frames(str(served["paths"]["b"]))[0]
    n = min(len(b), SERVE_SHORT_FRAMES)
    t0 = time.perf_counter()
    card = evaluate_pair(torch.from_numpy(b[:n]).cuda(), torch.from_numpy(a[:n]).cuda())
    card_s = time.perf_counter() - t0
    host = evaluate_pair(torch.from_numpy(b[:n]), torch.from_numpy(a[:n]))
    gaps = {k: abs(card[k] - host[k]) / max(abs(host[k]), 1e-12) for k in host}
    rec = {"phase": "eval_videos", "files": sorted(report["per_sample"]), "n": report["n"],
           "self_reference": report["per_sample"], "pair_frames": n, "pair_card": card,
           "pair_cpu": host, "pair_rel_gaps": gaps, "tolerance_rel": METRIC_REL_TOL,
           "report_s": report_s, "pair_card_s": card_s}
    emit(rec)
    if (report["n"] != 2 or any(m["psnr"] != float("inf") or abs(m["ssim"] - 1.0) > 1e-12
                                for m in report["per_sample"].values())
            or max(gaps.values()) > METRIC_REL_TOL or len(a) != FRAMES
            or not all(np.isfinite(v) for v in card.values())):
        raise AssertionError(f"eval_videos: {rec}")
    return rec


def _image_tokenizer() -> StandInTokenizer:
    """The stand-in tokenizer with `<|image_pad|>` split out too (image rows)."""
    tok = StandInTokenizer()
    tok.ids["<|image_pad|>"] = SPECIAL_TOKEN_IDS["<|image_pad|>"]
    tok.text[SPECIAL_TOKEN_IDS["<|image_pad|>"]] = "<|image_pad|>"
    tok._split = "(" + "|".join(re.escape(t) for t in tok.ids) + ")"
    return tok


def _eval_vlm_pass(model: Qwen3VLModel, clip: Path) -> dict:
    """tools/eval_vlm.py over a seeded `generic` JSONL of 4 rows with the
    engine over this model: 2 image rows on the image pass's 1280x720 PNG
    and 2 video rows on the 720p clip, one of them multiple-choice,
    --max_new_tokens EVAL_NEW_TOKENS; the summary's keys, each row's
    launches (the vision tower's flash_d72 per block, a flash_causal per
    text layer), and preprocess_video on the card against the CPU."""
    vc = model.cfg.vision
    d = clip.parent
    rows = [{"question_id": "img0", "text": "Is there a red shape?", "image": "still.png",
             "answer": "yes", "category": "image"},
            {"question_id": "img1", "text": "Is there a cat?", "image": "still.png",
             "answer": "no", "category": "image"},
            {"question_id": "vid0", "text": "Is the video dark?", "video": clip.name,
             "answer": "no", "category": "video"},
            {"question_id": "vid1", "text": "What moves?", "video": clip.name,
             "options": ["noise", "a dog", "a car"], "answer": "A", "category": "video"}]
    (d / "eval_questions.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    engine = Qwen3VLEngine.from_model(model, VLMConfig(), _image_tokenizer())
    per_row, moe_rows, real = [], [], eval_vlm_tool.qwen3vl_greedy_decode

    def counted(*args, **kw):
        _reset_launches()
        out = real(*args, **kw)
        per_row.append(_launches())
        moe_rows.append(_moe_launches())
        return out

    args = eval_vlm_tool.parse_args(["--questions", str(d / "eval_questions.jsonl"),
                                     "--format", "generic", "--report", str(d / "eval.json"),
                                     "--max_new_tokens", str(EVAL_NEW_TOKENS)])
    eval_vlm_tool.qwen3vl_greedy_decode = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results, summary = eval_vlm_tool.run(args, engine=engine)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
    finally:
        eval_vlm_tool.qwen3vl_greedy_decode = real
    kw = dict(patch_size=vc.patch_size, temporal_patch_size=vc.temporal_patch_size,
              merge_size=vc.spatial_merge_size)
    p_card, g_card = preprocess_video(str(clip), device="cuda", **kw)
    p_cpu, g_cpu = preprocess_video(str(clip), device="cpu", **kw)
    lv = (np.abs(p_card - p_cpu).reshape(p_cpu.shape[0], 3, -1) * 255
          * CLIP_STD[None, :, None])
    want = {**{k: 0 for k in _launches()}, "flash_d72": vc.depth,
            "flash_causal": model.cfg.text.num_hidden_layers}
    rec = {"rows": len(rows), "summary": summary, "eval_s": eval_s,
           "predictions": [r["prediction"] for r in results], "launches_per_row": per_row,
           "launches": {k: sum(r[k] for r in per_row) for k in want},
           "moe_launches": {k: sum(r[k] for r in moe_rows) for k in ("gmm", "tgmm")},
           "video_grid": list(g_card), "preprocess_video_max_levels": float(lv.max()),
           "preprocess_video_over_1_level_share": float((lv > 1.0 + 1e-4).mean()),
           "tolerance_levels": PV_MAX_LEVELS, "tolerance_over_1_share": PV_OVER1_SHARE}
    if (set(summary) != {"accuracy", "n", "per_category"} or summary["n"] != len(rows)
            or set(summary["per_category"]) != {"image", "video"} or per_row != [want] * len(rows)
            or g_card != g_cpu or lv.max() > PV_MAX_LEVELS + 1e-4
            or (lv > 1.0 + 1e-4).mean() > PV_OVER1_SHARE):
        raise AssertionError(f"vlm eval_vlm: {rec}")
    for r in moe_rows:
        _check_moe_launches("vlm eval_vlm row", r, model.cfg.text.num_hidden_layers)
    return rec


def _serve_alone() -> int:
    """`chip_smoke.py serve`: e2e (VLM features seeded), then serve, export
    and eval_videos on its pipeline."""
    phase_device()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        e2e = phase_e2e(torch.randn(1450, QWEN3_VL_30B_A3B.text.hidden_size, generator=gen,
                                    device="cuda"))
        served = phase_serve(e2e["pipe"], tmp)
        phase_export(e2e["pipe"], tmp)
        phase_eval_videos(served, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def _gmm_alone() -> int:
    """`chip_smoke.py gmm`: the grouped products' phase alone."""
    phase_device()
    phase_gmm(torch.Generator(device="cuda").manual_seed(0))
    return 0


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
    if argv[:1] == ["i2v"]:
        return _i2v_alone()
    if argv[:1] == ["serve"]:
        return _serve_alone()
    if argv[:1] == ["gmm"]:
        return _gmm_alone()
    if argv[:1] == ["vlm_fsdp"]:
        return _vlm_fsdp_alone()
    if argv[:1] == ["sp_train"]:
        return _sp_train_alone()
    if argv[:1] == ["stream"]:
        return _stream_alone()
    if argv[:1] == ["stream_train"]:
        return _stream_train_alone()
    if argv[:1] == ["sft_sp"]:
        return _sft_sp_alone()
    if argv[:1] == ["sft"]:
        phase_device()
        phase_tiny_sft()
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
        try:
            phase_sft(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return 0
    if argv[:1] in (["lora"], ["adafactor"], ["qwen3_sp"]):
        phase_device()
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
        try:
            if argv[0] == "qwen3_sp":  # the vlm phase: its text-only pass runs qwen3_sp
                phase_vlm(write_clip(tmp / "clip_720p.npz"))
            else:
                train = phase_train()
                if argv[0] == "lora":
                    phase_lora(train, tmp)
                else:
                    phase_adafactor(train)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return 0
    if argv:
        raise SystemExit(f"chip_smoke: unknown arguments {argv} (only 'profile', 'sp', "
                         "'sp_train', 'sft_sp', 'sft', 'lora', 'adafactor', 'qwen3_sp', "
                         "'i2v', 'stream', 'stream_train', 'serve', 'gmm' or 'vlm_fsdp')")
    dev = phase_device()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        return _all_phases(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _all_phases(dev: dict, tmp: Path) -> int:
    """Every phase in order, then the kernel summary and the last line."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    seconds = {}

    def T(name, fn, *args, **kw):  # a phase, its synchronized wall time kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    qk = T("qk_prep", phase_qk_prep, gen)
    fl = T("flash", phase_flash, gen)
    ft = T("flash_train", phase_flash_train, gen)
    grouped = T("gmm", phase_gmm, gen)
    T("tiny", phase_tiny)
    T("tiny_vlm", phase_tiny_vlm)
    T("tiny_train", phase_tiny_train)
    T("tiny_sft", phase_tiny_sft)
    clip = write_clip(tmp / "clip_720p.npz")
    vlm = T("vlm", phase_vlm, clip)
    features = vlm.pop("features")
    e2e_rec = T("e2e", phase_e2e, features)
    e2e = e2e_rec["launches"]
    served = T("serve", phase_serve, e2e_rec["pipe"], tmp)
    exported = T("export", phase_export, e2e_rec["pipe"], tmp)
    T("eval_videos", phase_eval_videos, served, tmp)
    T("load", phase_load, e2e_rec["pipe"].low_noise, tmp)
    cli = T("cli", phase_cli, clip, tmp)
    ring = T("ring", phase_ring, gen)
    sp = T("sp", phase_sp, e2e_rec.pop("pipe"), e2e_rec.pop("ctx"), features)
    del e2e_rec
    gc.collect()
    torch.cuda.empty_cache()
    adaln = T("adaln", phase_adaln, gen)["main"]
    T("tiny_a14b", phase_tiny_a14b)
    a14b = T("a14b", phase_a14b, features, keep_host=True)
    del features
    stream = T("stream", phase_stream, a14b, cli, tmp)
    del cli
    tiny_i2v = T("tiny_i2v", phase_tiny_i2v)
    i2v = T("i2v", phase_i2v)
    T("vae22", phase_vae22)
    T("xlm", phase_xlm)
    train = T("train", phase_train)
    sp_train = T("sp_train", phase_sp_train, train.pop("ref"), gen)
    lora = T("lora", phase_lora, train, tmp)
    ada = T("adafactor", phase_adafactor, train)
    sft = T("sft", phase_sft, tmp)
    stream_train = T("stream_train", phase_stream_train)
    emit({"phase": "times", "seconds": seconds, "total_s": sum(seconds.values())})
    text = vlm["text_only"]
    ar = vlm["ar_feature_extract"]
    sft_ring = sp_train["ring_backward"]["sft_token"]
    gen_cli = lora["generate"]["cli_launches"]
    train_rows = {k: sum(p[k] for p in train["launches_per_step"]) for k in TRAIN_ROWS}
    by_path = {  # each path's own count: reset just before it, read just after
        "qk_prep": {"e2e": e2e["qk_prep"], "serve": served["launches"]["qk_prep"],
                    "export": exported["launches"]["qk_prep"],
                    "lora_generate_cli": gen_cli["qk_prep"],
                    "tiny_i2v": tiny_i2v["launches"]["qk_prep"], "i2v": i2v["launches"]["qk_prep"],
                    "stream": stream["launches"]["qk_prep"]},
        "flash_fwd": {"e2e": e2e["flash_fwd"], "serve": served["launches"]["flash_fwd"],
                      "export": exported["launches"]["flash_fwd"],
                      "lora_generate_cli": gen_cli["flash_fwd"],
                      "tiny_i2v": tiny_i2v["launches"]["flash_fwd"],
                      "i2v": i2v["launches"]["flash_fwd"], "stream": stream["launches"]["flash_fwd"]},
        "flash_causal": {"vlm": vlm["launches"]["flash_causal"],
                         "vlm_fsdp": vlm["vlm_fsdp"]["launches"]["flash_causal"],
                         "eval_vlm": vlm["eval_vlm"]["launches"]["flash_causal"],
                         "text_only": text["launches"]["flash_causal"],
                         "vlm_image": vlm["image"]["launches"]["flash_causal"],
                         "ar_feature_extract": ar["launches"]["flash_causal"]},
        "flash_d72": {"vlm": vlm["launches"]["flash_d72"],
                      "vlm_fsdp": vlm["vlm_fsdp"]["launches"]["flash_d72"],
                      "eval_vlm": vlm["eval_vlm"]["launches"]["flash_d72"],
                      "vision_lora": text["launches"]["flash_d72"],
                      "vlm_image": vlm["image"]["launches"]["flash_d72"],
                      "ar_feature_extract": ar["launches"]["flash_d72"]},
        "flash_pair": {"tiny_i2v": tiny_i2v["launches"]["flash_pair"],
                       "i2v": i2v["launches"]["flash_pair"]},
        "fused_adaln": {"a14b": a14b["launches"]["fused_adaln"],
                        "tiny_i2v": tiny_i2v["launches"]["fused_adaln"],
                        "i2v": i2v["launches"]["fused_adaln"],
                        "stream": stream["launches"]["fused_adaln"]},
        "ring_step": {"sp": sp["launches"]["ring_step"],
                      "qwen3_sp": text["qwen3_sp"]["launches"]["ring_step"]},
        "ring_step_f32": {
            "sft_sp": sp_train["world1"]["sft_sp"]["launches_all_ranks"]["ring_step_f32"]},
        "gmm": {"vlm": vlm["moe_launches"]["gmm"],
                "vlm_fsdp": vlm["vlm_fsdp"]["moe_launches"]["gmm"],
                **{f"vlm_fsdp_split{n}": rec["launches"]["gmm"]
                   for n, rec in vlm["vlm_fsdp"]["split_moe"].items()},
                "eval_vlm": vlm["eval_vlm"]["moe_launches"]["gmm"],
                "text_only": text["moe_launches"]["gmm"],
                "qwen3_sp": text["qwen3_sp"]["moe_launches"]["gmm"],
                "vlm_image": vlm["image"]["moe_launches"]["gmm"],
                "ar_feature_extract": ar["moe_launches"]["gmm"],
                "sft": sum(c["moe_launches"]["gmm"] for c in sft["cases"]),
                "sft_sp": sp_train["world1"]["sft_sp"]["launches_all_ranks"]["gmm"]},
        "tgmm": {"sft": sum(c["moe_launches"]["tgmm"] for c in sft["cases"]),
                 "sft_sp": sp_train["world1"]["sft_sp"]["launches_all_ranks"]["tgmm"]},
        **{k: {"train": train_rows[k], "lora": lora["launches"][k], "adafactor": ada["launches"][k],
               "data_pipeline_train": vlm["pipeline_train"]["launches"][k],
               **{path: n[k] for path, n in stream_train["launches"].items()},
               **({"sft_ring_backward": sft_ring["launches"][k]} if k in sft_ring["launches"]
                  else {})}
           for k in TRAIN_ROWS}}
    launches = {k: sum(v.values()) for k, v in by_path.items()}
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
    rec = fl["flash_pair"]
    kernels.append(
        {"name": "flash_pair", "route": "cuda", "source": "omnivideo_tpu_torch/csrc/flash_pair.cu",
         "replaces": "omnivideo_tpu/ops/pallas/flash_attention.py:42",
         "launches": launches["flash_pair"], "max_abs_err": rec["max_abs_err"],
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
         "launches": launches["ring_step"], "max_abs_err": main_ring["max_abs_err"],
         "ms": main_ring["ms"], "plain_ms": main_ring["plain_ms"],
         "bound_ms": main_ring["bound_ms"], "bound_by": main_ring["bound_by"],
         "library_ms": main_ring["library_ms"]})
    f32_ring = sp_train["ring_step_f32"]
    kernels.append(
        {"name": "ring_step_f32", "route": "cuda",
         "source": "omnivideo_tpu_torch/csrc/ring_step_f32.cu",
         "replaces": "omnivideo_tpu/ops/pallas/ring_attention.py:36",
         "launches": launches["ring_step_f32"], "max_abs_err": f32_ring["max_abs_err"],
         "ms": f32_ring["ms"], "plain_ms": f32_ring["plain_ms"], "bound_ms": f32_ring["bound_ms"],
         "bound_by": f32_ring["bound_by"], "library_ms": f32_ring["library_ms"]})
    replaces = {"gmm": "jax/experimental/pallas/ops/tpu/megablox/gmm.py:314 (gmm) via "
                       "omnivideo_tpu/models/qwen3vl/text_model.py:135",
                "tgmm": "jax/experimental/pallas/ops/tpu/megablox/gmm.py:573 (tgmm) via "
                        "omnivideo_tpu/models/qwen3vl/text_model.py:135"}
    for name, rec in (("gmm", grouped["gmm"]), ("tgmm", grouped["tgmm"])):
        kernels.append(
            {"name": name, "route": "cuda", "source": "omnivideo_tpu_torch/csrc/gmm.cu",
             "replaces": replaces[name], "launches": launches[name],
             "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
             "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
             "library_ms": rec["library_ms"]})
    f32_bwd = sp_train["flash_bwd_f32"]
    sft_ring_f32 = sp_train["ring_backward"]["sft_token_f32"]["launches"]
    multi_sft = (sp_train["multi_card"] or {}).get("sft_sp")
    for name, line in (("flash_bwd_dq_f32", "omnivideo_tpu/ops/pallas/flash_attention.py:485"),
                       ("flash_bwd_dkv_f32", "omnivideo_tpu/ops/pallas/flash_attention.py:530")):
        by_path[name] = {"sft_ring_backward_f32": sft_ring_f32[name],
                         **({"sft_sp_multi_card": multi_sft["launches_all_ranks"][name]}
                            if multi_sft else {})}
        outs = ("dq",) if name == "flash_bwd_dq_f32" else ("dk", "dv")
        kernels.append(
            {"name": name, "route": "cuda", "source": "omnivideo_tpu_torch/csrc/flash_train_f32.cu",
             "replaces": line, "launches": sum(by_path[name].values()),
             "max_abs_err": max(f32_bwd["max_abs_err"][o] for o in outs),
             "ms": f32_bwd["ms"][name], "plain_ms": f32_bwd["plain_ms"],
             "bound_ms": f32_bwd["bound_ms"][name], "bound_by": f32_bwd["bound_by"][name],
             "library_ms": f32_bwd["library_ms"]})
    for k in kernels:
        k["launches_by_path"] = by_path[k["name"]]
    idle = {(k["name"], p) for k in kernels for p, n in k["launches_by_path"].items() if n == 0}
    if idle:
        raise AssertionError(f"kernels that a path never launched: {sorted(idle)}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
