"""Stage-1 offline feature extraction: VAE latents and umT5 text embeddings
(port of tools/data_prepare/vae_feature_extract.py).

A JSON/JSONL manifest of {"id", "video", "caption"[, "source_video"]} rows:
each clip is read (utils/video.py `read_video_frames`), sampled to
`--frame_num` frames at the task's fps, resized and center-cropped to
`--size` on the card, encoded by the Wan2.1 VAE, and each caption by umT5;
every row becomes `sample_<id>.npz` with the keys training/dataset.py reads:
`latent_feature_tgt` [C, F, h, w] (the video), `latent_feature` (the source
video, or the video again), `prompt` and, with a text encoder, `text_emb`
[len, 4096]. `--random_weights` runs a seeded VAE and no text encoder (so
no `text_emb`), as JAX's does; else `--ckpt_dir` is the reference
checkpoint dir (pipelines/loading.py: its VAE and umT5 with tokenizer).
Rows are split over hosts by `index % num_hosts == host_id`.

    python -m omnivideo_tpu_torch.tools.data_prepare.vae_feature_extract \
        --manifest data.jsonl --ckpt_dir <ckpts> --output_dir features/ --size 832*480
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from omnivideo_tpu_torch.configs import SIZE_CONFIGS, WAN_CONFIGS
from omnivideo_tpu_torch.device import resolve_device
from omnivideo_tpu_torch.models.vae2_1 import Wan21VAE, init_vae
from omnivideo_tpu_torch.utils.video import read_video_frames, sample_and_transform_frames

log = logging.getLogger("vae_feature_extract")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--manifest", required=True)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--task", default="t2v-1.3B", choices=sorted(WAN_CONFIGS))
    p.add_argument("--size", default="832*480")
    p.add_argument("--frame_num", type=int, default=81)
    p.add_argument("--host_id", type=int, default=0)
    p.add_argument("--num_hosts", type=int, default=1)
    p.add_argument("--random_weights", action="store_true",
                   help="a seeded VAE and no text encoder (pipeline smoke tests)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def models(args, cfg, device):
    """(VAE, text encoder or None) of the run."""
    if args.random_weights:
        gen = torch.Generator(device=device).manual_seed(0)
        return Wan21VAE.create(init_vae(cfg.vae, device=device, generator=gen), cfg.vae), None
    if args.ckpt_dir is None:
        raise SystemExit("--ckpt_dir is required without --random_weights")
    from omnivideo_tpu_torch.pipelines.loading import load_pipeline

    pipe = load_pipeline(cfg, args.ckpt_dir, device=device)
    return pipe.vae, pipe.text_encoder


def _clip(path: str, args, cfg, size, device) -> torch.Tensor:
    frames, fps = read_video_frames(path)
    return sample_and_transform_frames(frames, args.frame_num, size, fps, cfg.sample_fps,
                                       device=device)


@torch.inference_mode()
def run(args, vae=None, text_encoder=None) -> List[Path]:
    """Every row of this host; returns the files written. `vae` (and
    `text_encoder`) replace the ones the flags would build."""
    device = resolve_device(args.device)
    cfg = WAN_CONFIGS[args.task]
    size = SIZE_CONFIGS.get(args.size) or tuple(int(v) for v in args.size.split("*"))
    if vae is None:
        vae, text_encoder = models(args, cfg, device)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    rows = [json.loads(line) for line in Path(args.manifest).read_text().splitlines()
            if line.strip()]
    written = []
    for idx, row in enumerate(rows):
        if idx % args.num_hosts != args.host_id:
            continue
        sid = row.get("id", idx)
        lat = vae.encode(_clip(row["video"], args, cfg, size, device)[None])[0].cpu().numpy()
        sample = {"latent_feature_tgt": lat, "prompt": row.get("caption", "")}
        if "source_video" in row:
            sample["latent_feature"] = vae.encode(
                _clip(row["source_video"], args, cfg, size, device)[None])[0].cpu().numpy()
        else:
            sample["latent_feature"] = lat
        if text_encoder is not None and row.get("caption"):
            sample["text_emb"] = text_encoder([row["caption"]])[0].float().cpu().numpy()
        path = out / f"sample_{sid}.npz"
        np.savez_compressed(path, **sample)
        written.append(path)
        log.info("wrote %s  latent %s", path.name, lat.shape)
    return written


def main(argv: Optional[list] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
