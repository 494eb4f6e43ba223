"""Stage-2 offline feature extraction: the VLM's conditioning features
(port of tools/data_prepare/ar_feature_extract.py).

For every manifest row whose stage-1 file `sample_<id>.npz` exists
(vae_feature_extract.py), the Qwen3-VL engine (models/qwen3vl/engine.py)
captions the source video, writes the target caption and extracts the
last hidden states; the file gains `vlm_last_hidden_states` [L, D] f32,
`source_caption` and `target_caption`. The engine's backend defaults to
the native one ("jax", the JAX engine's name for it), as the port's
generate does; JAX's CLI defaults to "hf", which the port does not run.

    python -m omnivideo_tpu_torch.tools.data_prepare.ar_feature_extract \
        --features_dir features/ --manifest data.jsonl --vlm_path <qwen3-vl dir>
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import List, Optional

import numpy as np

log = logging.getLogger("ar_feature_extract")


def extract_row(engine, row: dict, idx: int, features_dir: Path) -> Optional[Path]:
    """One row through `engine` into its stage-1 file; None when that file
    is missing."""
    sid = row.get("id", idx)
    path = Path(features_dir) / f"sample_{sid}.npz"
    if not path.exists():
        log.warning("missing stage-1 features for %s; skipping", sid)
        return None
    feats = engine.generate_caption_and_extract_features(
        row.get("source_video"), row.get("caption", row.get("edit_prompt", "")))
    with np.load(path, allow_pickle=True) as f:
        data = dict(f)
    data["vlm_last_hidden_states"] = feats["vlm_last_hidden_states"].float().cpu().numpy()
    data["source_caption"] = feats["source_caption"]
    data["target_caption"] = feats["target_caption"]
    np.savez_compressed(path, **data)
    log.info("updated %s (vlm seq_len %d)", path.name, feats["seq_len"])
    return path


def run(args, engine=None) -> List[Path]:
    """Every row of this host; `engine` replaces the one --vlm_path builds."""
    if engine is None:
        from omnivideo_tpu_torch.models.qwen3vl.engine import Qwen3VLEngine, VLMConfig

        engine = Qwen3VLEngine(VLMConfig(model_path=args.vlm_path, backend=args.backend,
                                         device=args.device))
    rows = [json.loads(line) for line in Path(args.manifest).read_text().splitlines()
            if line.strip()]
    out = []
    for idx, row in enumerate(rows):
        if idx % args.num_hosts == args.host_id:
            path = extract_row(engine, row, idx, Path(args.features_dir))
            if path is not None:
                out.append(path)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--features_dir", required=True)
    p.add_argument("--manifest", required=True)
    p.add_argument("--vlm_path", required=True)
    p.add_argument("--backend", default="jax", choices=["hf", "jax"],
                   help="'jax': the native engine; 'hf' is not ported (raises)")
    p.add_argument("--host_id", type=int, default=0)
    p.add_argument("--num_hosts", type=int, default=1)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[list] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
