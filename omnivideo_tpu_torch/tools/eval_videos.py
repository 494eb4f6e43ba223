"""Video generation evaluation harness (port of tools/eval_videos.py).

PSNR and SSIM against references (editing fidelity), temporal consistency
(flicker) and motion magnitude (frozen frames) over a directory of
generated clips, as a JSON report {"summary", "per_sample", "n"}; the
summary averages each metric's finite values. Clips are read by
utils/video.py `read_video_frames` (`.mp4` through imageio, MJPEG `.avi`,
`.gif`, `.npz`: what the port's writers leave) and measured by
utils/metrics.py on `--device` (default cuda; `--device cpu` on the host).
A reference is the file of the same stem in --reference, in any of those
formats; without one a clip gets the no-reference metrics.

    python -m omnivideo_tpu_torch.tools.eval_videos --generated outputs/ \\
        [--reference refs/] --report report.json
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from omnivideo_tpu_torch.device import resolve_device
from omnivideo_tpu_torch.utils.metrics import evaluate_pair, evaluate_single
from omnivideo_tpu_torch.utils.video import read_video_frames

EXTS = (".mp4", ".avi", ".gif", ".npz")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--generated", required=True)
    p.add_argument("--reference", default=None)
    p.add_argument("--report", default="eval_report.json")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _reference(ref_dir: str, stem: str):
    for ext in EXTS:
        cand = Path(ref_dir) / (stem + ext)
        if cand.exists():
            return cand
    return None


def run(args) -> Dict:
    """The report of --generated (written to --report)."""
    dev = resolve_device(args.device)
    gen_dir = Path(args.generated)
    files = sorted(f for f in gen_dir.iterdir() if f.suffix in EXTS)
    if not files:
        raise FileNotFoundError(f"no videos in {gen_dir}")

    def frames_of(path) -> torch.Tensor:
        return torch.from_numpy(read_video_frames(str(path))[0]).to(dev)

    per_sample = {}
    for f in files:
        frames = frames_of(f)
        ref_f = _reference(args.reference, f.stem) if args.reference else None
        if args.reference and ref_f is None:
            logging.warning("no reference for %s; no-reference metrics only", f.name)
        if ref_f is None:
            per_sample[f.name] = evaluate_single(frames)
        else:
            per_sample[f.name] = evaluate_pair(frames, frames_of(ref_f))
    keys = sorted({k for m in per_sample.values() for k in m})
    summary = {k: float(np.mean([m[k] for m in per_sample.values()
                                 if k in m and np.isfinite(m[k])]))
               for k in keys}
    report = {"summary": summary, "per_sample": per_sample, "n": len(per_sample)}
    with open(args.report, "w") as fh:
        json.dump(report, fh, indent=2)
    logging.info("summary: %s", summary)
    logging.info("report -> %s", args.report)
    return report


def main(argv=None) -> Dict:
    logging.basicConfig(level=logging.INFO)
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
