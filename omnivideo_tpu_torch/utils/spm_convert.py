"""sentencepiece `spiece.model` → `tokenizer.json`, without the
sentencepiece runtime (the port's own copy of
omnivideo_tpu/utils/spm_convert.py).

The reference loads the umT5 `spiece.model` through the sentencepiece
runtime. `transformers` bundles the ModelProto protobuf schema, and its
T5Converter builds a `tokenizers` Unigram model straight from the serialized
proto; it is fed a small duck-typed stand-in for the slow tokenizer (it
reads only `vocab_file`, `add_prefix_space`, `_extra_ids`,
`convert_tokens_to_ids`). So a checkpoint dir that ships only
`spiece.model` works: models/t5.py's `HuggingfaceTokenizer` converts it on
first load. `transformers` is imported only for this conversion.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)


class _SlowTokenizerStub:
    """Duck-typed stand-in for a slow SP tokenizer: just enough surface for
    transformers.convert_slow_tokenizer.T5Converter."""

    def __init__(self, vocab_file: str, extra_ids: int, pieces):
        self.vocab_file = vocab_file
        self._extra_ids = extra_ids
        self.add_prefix_space = True  # SP add_dummy_prefix semantics
        # final vocab = proto pieces, then <extra_id_{n-1}> ... <extra_id_0>
        self._index = {p: i for i, p in enumerate(pieces)}
        n = len(pieces)
        for i in range(extra_ids - 1, -1, -1):
            self._index[f"<extra_id_{i}>"] = n + (extra_ids - 1 - i)

    def convert_tokens_to_ids(self, token: str) -> int:
        return self._index[token]


def convert_spiece_to_fast(
    spiece_path: str | Path,
    out_path: Optional[str | Path] = None,
    extra_ids: int = 0,
) -> Path:
    """Convert `spiece.model` → `tokenizer.json` next to it (or at out_path).

    Returns the written tokenizer.json path. The result loads with
    `transformers.AutoTokenizer`/`PreTrainedTokenizerFast` and reproduces
    sentencepiece unigram segmentation (same pieces, scores, normalizer
    charsmap, metaspace pre-tokenization, and the T5 `</s>` post-processor).
    """
    from transformers.convert_slow_tokenizer import T5Converter, import_protobuf

    spiece_path = Path(spiece_path)
    out_path = Path(out_path) if out_path else spiece_path.parent / "tokenizer.json"

    pb2 = import_protobuf()
    proto = pb2.ModelProto()
    proto.ParseFromString(spiece_path.read_bytes())
    pieces = [p.piece for p in proto.pieces]

    stub = _SlowTokenizerStub(str(spiece_path), extra_ids, pieces)
    fast = T5Converter(stub).converted()
    fast.save(str(out_path))
    log.info("exported %s (%d pieces + %d extra ids) -> %s",
             spiece_path, len(pieces), extra_ids, out_path)
    return out_path


def ensure_fast_tokenizer(model_dir: str | Path, extra_ids: int = 0) -> Optional[Path]:
    """If `model_dir` has spiece.model but no tokenizer.json, convert in
    place (best effort — returns the tokenizer.json path or None)."""
    model_dir = Path(model_dir)
    fast = model_dir / "tokenizer.json"
    sp = model_dir / "spiece.model"
    if fast.exists() or not sp.exists():
        return fast if fast.exists() else None
    try:
        return convert_spiece_to_fast(sp, fast, extra_ids=extra_ids)
    except PermissionError:
        # read-only checkpoint dir: convert to a cache location instead
        import tempfile

        cache = Path(tempfile.gettempdir()) / f"omnivideo_tok_{abs(hash(str(sp)))}"
        cache.mkdir(parents=True, exist_ok=True)
        return convert_spiece_to_fast(sp, cache / "tokenizer.json", extra_ids=extra_ids)
