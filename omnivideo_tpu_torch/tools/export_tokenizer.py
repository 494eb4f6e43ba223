"""Export a fast tokenizer.json from a sentencepiece spiece.model, offline
and without the sentencepiece runtime (port of tools/export_tokenizer.py,
over utils/spm_convert.py).

A reference checkpoint dir (the google/umt5-xxl layout ships spiece.model
only) becomes loadable by models/t5.py's tokenizer after one run:

    python -m omnivideo_tpu_torch.tools.export_tokenizer --dir /path/to/umt5-xxl
    python -m omnivideo_tpu_torch.tools.export_tokenizer --spiece sp.model --out tok.json

The conversion needs `transformers` (its bundled protobuf schema); `--check`
reads the result back with the `tokenizers` package alone.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

from omnivideo_tpu_torch.utils.spm_convert import convert_spiece_to_fast

SAMPLE = "A cinematic shot of a corgi surfing at sunset."


def main(argv=None) -> Optional[List[int]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=None, help="checkpoint dir with spiece.model")
    ap.add_argument("--spiece", default=None, help="explicit spiece.model path")
    ap.add_argument("--out", default=None, help="output tokenizer.json path")
    ap.add_argument("--extra_ids", type=int, default=0,
                    help="number of <extra_id_N> sentinel tokens to append "
                         "(T5 uses 100; umT5 bakes them into the vocab: 0)")
    ap.add_argument("--check", action="store_true",
                    help="encode a sample string with the exported tokenizer, print the ids")
    args = ap.parse_args(argv)
    if not (args.spiece or args.dir):
        ap.error("give --dir or --spiece")
    sp = Path(args.spiece) if args.spiece else Path(args.dir) / "spiece.model"
    if not sp.exists():
        raise FileNotFoundError(f"{sp} not found")
    out = convert_spiece_to_fast(sp, args.out, extra_ids=args.extra_ids)
    print(f"wrote {out}")
    if not args.check:
        return None
    from tokenizers import Tokenizer

    ids = Tokenizer.from_file(str(out)).encode(SAMPLE).ids
    print("ids:", ids)
    return ids


if __name__ == "__main__":
    main()
