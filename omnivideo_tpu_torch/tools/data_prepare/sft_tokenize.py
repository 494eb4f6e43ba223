"""Offline conversation tokenization (port of
tools/data_prepare/sft_tokenize.py): chat transcripts in JSON/JSONL → a
directory of per-sample .npz files (`ids`, `labels`) that
training/sft.py `SFTDataset` (sft_vlm `--data_dir`) reads.

The tokenizer is a dir's tokenizer.json through io/hf_reader.py
`FastTokenizer` (ChatML unless its tokenizer_config.json brings a chat
template); `tokenize_dataset` takes any tokenizer of that API.

    python -m omnivideo_tpu_torch.tools.data_prepare.sft_tokenize \
        --input conversations.jsonl --tokenizer <dir> --output_dir out/
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np

from omnivideo_tpu_torch.training.conversation import ConversationDataset


def tokenize_dataset(ds: ConversationDataset, output_dir: str, max_len: int = 0) -> int:
    """Write each sample of `ds` as `sample_<i:06d>.npz`, dropping those
    longer than max_len (0: keep all). Returns the count written."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    kept = 0
    for i in range(len(ds)):
        s = ds[i]
        if max_len and len(s["ids"]) > max_len:
            continue
        np.savez(out / f"sample_{i:06d}.npz", ids=s["ids"], labels=s["labels"])
        kept += 1
    return kept


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True, help="conversation JSON/JSONL")
    p.add_argument("--tokenizer", required=True, help="dir with tokenizer.json")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--max_len", type=int, default=0,
                   help="drop samples longer than this (0 = keep all)")
    args = p.parse_args(argv)
    from omnivideo_tpu_torch.io.hf_reader import FastTokenizer

    ds = ConversationDataset(args.input, FastTokenizer(args.tokenizer))
    kept = tokenize_dataset(ds, args.output_dir, args.max_len)
    print(f"wrote {kept}/{len(ds)} samples to {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
