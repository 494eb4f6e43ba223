"""MLLM benchmark evaluation over the port's Qwen3-VL decode (port of
tools/eval_vlm.py).

    python -m omnivideo_tpu_torch.tools.eval_vlm --model_path <hf-qwen3vl-dir> \\
        --questions pope.jsonl --format pope --report out.json

--format selects the native record shape, its scoring and its aggregates
(omnivideo_tpu_torch/eval/vqa.py):
  generic    MME/POPE-shaped JSONL (open answers; MC if "options" present)
  pope       label yes/no; adds precision/recall/F1/yes-ratio
  mme        paired yes/no per image; adds per-category MME scores
  videomme   multiple-choice over videos (options list, letter answer)
  mmmu / scienceqa   multiple-choice over images
  textvqa    open answers scored by VQAv2 consensus min(matches/3, 1)
  (and chartqa, docvqa, gqa, vizwiz, mathvista, refcoco)

The answer function runs the port's Qwen3-VL engine
(models/qwen3vl/engine.py `Qwen3VLEngine`: an HF checkpoint dir read by
io/hf_reader.py, its tokenizer.json through `FastTokenizer`; no
transformers). Per row: an image (a PNG, .npy or .npz, resized on the
device) or a video (media.py `fetch_video` and the re-alignment of
`preprocess_video`, resized on the device) becomes patches, the question
goes through `build_vqa_ids`, and `qwen3vl_greedy_decode` answers (the
vision tower on kernel row 3a, the prefill on row 2 on the card). Media
paths are relative to the questions file. A multiple-choice row widens
--max_new_tokens to at least 12 ("The answer is B."). The device defaults
to cuda; `--device cpu` runs the plain twins. `make_answer_fn` takes an
engine already built (`Qwen3VLEngine.from_model`), so a caller holding a
model evaluates it without a second load.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from omnivideo_tpu_torch.eval.vqa import ADAPTERS, adapt_rows, build_prompt, evaluate
from omnivideo_tpu_torch.models.qwen3vl.engine import Qwen3VLEngine, VLMConfig
from omnivideo_tpu_torch.models.qwen3vl.full_model import qwen3vl_greedy_decode
from omnivideo_tpu_torch.models.qwen3vl.preprocess import (build_vqa_ids, preprocess_image,
                                                           preprocess_video)

MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MC_MIN_NEW_TOKENS = 12


def make_answer_fn(engine: Qwen3VLEngine, max_new_tokens: int = 8,
                   min_pixels: int = MIN_PIXELS, max_pixels: int = MAX_PIXELS
                   ) -> Callable[[Dict], str]:
    """row → the model's answer string, over `engine`'s model and tokenizer
    on the model's device."""
    model, tokenizer, eos = engine.model, engine.tokenizer, engine._eos
    vc = model.cfg.vision
    dev = model.device
    kw = dict(patch_size=vc.patch_size, temporal_patch_size=vc.temporal_patch_size,
              merge_size=vc.spatial_merge_size, device=dev)

    def answer(row: Dict) -> str:
        patches = grid = None
        is_video = False
        if row.get("image"):
            patches, grid = preprocess_image(row["image"], min_pixels=min_pixels,
                                             max_pixels=max_pixels, **kw)
        elif row.get("video"):
            patches, grid = preprocess_video(row["video"], **kw)
            is_video = True
        n_vis = 0
        if patches is not None:
            n_vis = (grid[0] * grid[1] * grid[2]) // (vc.spatial_merge_size ** 2)
            patches = torch.from_numpy(patches).to(dev)
        ids = build_vqa_ids(tokenizer, build_prompt(row), n_vis, is_video=is_video)
        toks = qwen3vl_greedy_decode(model, ids, patches, grid, max_new_tokens=max_new_tokens,
                                     eos_token_id=eos, is_video=is_video)
        return tokenizer.decode([int(t) for t in toks.tolist() if t != eos],
                                skip_special_tokens=True).strip()

    return answer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model_path", default=None, help="HF Qwen3-VL checkpoint dir")
    ap.add_argument("--questions", required=True, help="benchmark JSONL")
    ap.add_argument("--format", default="generic", choices=sorted(ADAPTERS),
                    help="benchmark record shape / scoring / aggregates")
    ap.add_argument("--report", default=None, help="write results+summary JSON here")
    ap.add_argument("--max_new_tokens", type=int, default=8)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def load_rows(questions: str, fmt: str, limit: Optional[int] = None) -> List[Dict]:
    """The questions file's rows through the format's adapter, media paths
    made absolute against the file's directory."""
    rows = [json.loads(line) for line in open(questions) if line.strip()]
    if limit:
        rows = rows[:limit]
    rows = adapt_rows(rows, fmt)
    base = Path(questions).parent
    for r in rows:
        for k in ("image", "video"):
            if r.get(k) and not Path(r[k]).is_absolute():
                r[k] = str(base / r[k])
    return rows


def run(args, engine: Optional[Qwen3VLEngine] = None) -> Tuple[List[Dict], Dict]:
    """(results, summary) of the questions file; `engine` (else one loaded
    from --model_path on --device) answers. Writes --report when given."""
    if engine is None:
        if not args.model_path:
            raise ValueError("--model_path is required")
        engine = Qwen3VLEngine(VLMConfig(model_path=args.model_path, device=args.device))
    rows = load_rows(args.questions, args.format, args.limit)
    mnt = (max(args.max_new_tokens, MC_MIN_NEW_TOKENS)
           if any(r.get("mode") == "mc" for r in rows) else args.max_new_tokens)
    results, summary = evaluate(rows, make_answer_fn(engine, mnt), fmt=args.format)
    if args.report:
        Path(args.report).write_text(json.dumps({"summary": summary, "results": results},
                                                indent=1))
    return results, summary


def main(argv=None) -> Dict:
    _, summary = run(parse_args(argv))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
