"""Conversation-format supervised data (a copy of
omnivideo_tpu/training/conversation.py, which is numpy only; the port keeps
its own): chat tokenization with per-turn loss masks, multimodal placeholder
normalization, and length-grouped batching.

- `preprocess_conversation`: tokenize a chat transcript and mask everything
  except the assistant responses (+ their stop token) to IGNORE_INDEX;
- `preprocess_multimodal`: normalize `<image>` / `<video>` placeholders
  (prepend one to the first turn when media is attached but none is
  present, one newline after each);
- `ConversationDataset`: a lazy JSON/JSONL dataset exposing `lengths` /
  `modality_lengths` for the sampler;
- `split_to_even_chunks`, `get_length_grouped_indices`,
  `get_modality_length_grouped_indices`, `length_grouped_batches`:
  world-aware length-grouped batch ordering, on numpy's RNG as in JAX, so
  the orders equal JAX's.

Each assistant turn's span is the token delta between the chat rendered up
to the turn WITH the generation prompt and rendered THROUGH the turn, which
unmasks exactly the response plus its stop/end tokens. If a template breaks
the prefix property the sample degrades to fully masked with a warning.

Rendering: a tokenizer without a `chat_template` gets ChatML (the Qwen
family's format, JAX's `CHATML_TEMPLATE`), rendered here natively; a
tokenizer that brings its own template is rendered through jinja2 as
transformers renders it, and without jinja2 installed that raises, naming
the package: another template would change the training data. Tokenizers
take the FastTokenizer API (io/hf_reader.py):
`tokenizer(text, add_special_tokens=False)["input_ids"]`.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

IGNORE_INDEX = -100
IMAGE_TOKEN = "<image>"
VIDEO_TOKEN = "<video>"

# ChatML (the Qwen family template) — default for tokenizers that ship no
# chat_template of their own.
CHATML_TEMPLATE = (
    "{% for message in messages %}"
    "{{'<|im_start|>' + message['role'] + '\n' + message['content'] + '<|im_end|>' + '\n'}}"
    "{% endfor %}"
    "{% if add_generation_prompt %}{{'<|im_start|>assistant\n'}}{% endif %}"
)

_ROLE_BY_SENDER = {"human": "user", "gpt": "assistant", "system": "system",
                   "user": "user", "assistant": "assistant"}

logger = logging.getLogger(__name__)


def normalize_messages(messages: Sequence[Dict[str, str]]) -> List[Dict[str, str]]:
    """Accept both the reference's {'from','value'} records and OpenAI-style
    {'role','content'}; return role/content form."""
    out = []
    for m in messages:
        if "role" in m:
            role, content = m["role"], m["content"]
        else:
            sender = m["from"]
            if sender not in _ROLE_BY_SENDER:
                raise ValueError(f"unknown conversation sender {sender!r}")
            role, content = _ROLE_BY_SENDER[sender], m["value"]
        out.append({"role": role, "content": content})
    return out


def render_chatml(messages: Sequence[Dict[str, str]], add_generation_prompt: bool) -> str:
    """CHATML_TEMPLATE's output, without jinja2."""
    text = "".join(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in messages)
    return text + ("<|im_start|>assistant\n" if add_generation_prompt else "")


def render_template(template: str, messages, add_generation_prompt: bool, **special) -> str:
    """A tokenizer's own chat template through jinja2, in the environment
    transformers compiles templates in (sandboxed, trim_blocks,
    lstrip_blocks, `raise_exception` and `tojson`)."""
    try:
        from jinja2.exceptions import TemplateError
        from jinja2.sandbox import ImmutableSandboxedEnvironment
    except ImportError as e:
        raise ImportError("this tokenizer brings its own chat_template, which renders through "
                          "the `jinja2` package; install jinja2 (a tokenizer without a "
                          "template renders ChatML natively)") from e

    def raise_exception(message):
        raise TemplateError(message)

    env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True)
    env.filters["tojson"] = lambda x, **kw: json.dumps(x, ensure_ascii=False, **kw)
    env.globals["raise_exception"] = raise_exception
    return env.from_string(template).render(messages=list(messages),
                                            add_generation_prompt=add_generation_prompt,
                                            **special)


def _render(tokenizer, messages, add_generation_prompt: bool) -> List[int]:
    template = getattr(tokenizer, "chat_template", None)
    if template is None:
        text = render_chatml(messages, add_generation_prompt)
    else:
        text = render_template(template, messages, add_generation_prompt,
                               **getattr(tokenizer, "special_tokens_map", {}))
    return tokenizer(text, add_special_tokens=False)["input_ids"]


def tokenize_conversation(
    messages: Sequence[Dict[str, str]],
    tokenizer,
    add_generation_prompt: bool = False,
) -> np.ndarray:
    """Token ids of the chat-templated conversation (no loss mask)."""
    msgs = normalize_messages(messages)
    return np.asarray(_render(tokenizer, msgs, add_generation_prompt), np.int32)


def preprocess_conversation(
    messages: Sequence[Dict[str, str]],
    tokenizer,
) -> Dict[str, np.ndarray]:
    """Tokenize a (possibly multi-turn) conversation and build labels that
    keep only assistant responses (+ stop tokens) — everything else, including
    system/user turns and assistant headers, is IGNORE_INDEX.

    Returns {'ids': int32 [T], 'labels': int32 [T]}.
    """
    msgs = normalize_messages(messages)
    ids = np.asarray(_render(tokenizer, msgs, False), np.int32)
    labels = np.full_like(ids, IGNORE_INDEX)

    ok = True
    for i, m in enumerate(msgs):
        if m["role"] != "assistant":
            continue
        # span = delta between "conversation up to this turn + assistant
        # header" and "conversation through this turn"
        head = _render(tokenizer, msgs[:i], True)
        full = _render(tokenizer, msgs[: i + 1], False)
        if (
            len(head) <= len(full) <= len(ids)
            and list(ids[: len(full)]) == full
            and full[: len(head)] == head
        ):
            labels[len(head): len(full)] = ids[len(head): len(full)]
        else:
            ok = False
            break
    if not ok:
        # the template diff cannot be matched: train on nothing rather than
        # on wrong spans
        logger.warning("chat template is not prefix-stable for this sample; "
                       "masking all tokens")
        labels[:] = IGNORE_INDEX
    return {"ids": ids, "labels": labels}


def preprocess_multimodal(
    messages: Sequence[Dict[str, str]],
    has_media: bool,
    media_token: str = IMAGE_TOKEN,
) -> List[Dict[str, str]]:
    """Placeholder normalization: when media is attached but no placeholder appears
    anywhere, prepend one to the first turn; every placeholder ends up
    followed by exactly one newline."""
    msgs = [dict(m) for m in normalize_messages(messages)]
    if not has_media:
        return msgs
    if not any(media_token in m["content"] for m in msgs):
        msgs[0]["content"] = f"{media_token}\n{msgs[0]['content']}"
    for m in msgs:
        if media_token in m["content"]:
            parts = [p.strip() for p in m["content"].split(media_token)]
            text = ""
            for p in parts[:-1]:
                text += p + (" " if p else "") + media_token + "\n"
            m["content"] = (text + parts[-1]).strip()
    return msgs


class ConversationDataset:
    """Lazy conversation-format SFT dataset over a JSON list or JSONL file.

    Record form:
      {"conversations": [{"from": "human", "value": ...}, ...],
       "image": optional path, "video": optional path}

    __getitem__ tokenizes on access and returns {'ids','labels'} arrays
    consumable by `sft_collate`. `lengths` / `modality_lengths` are cheap
    word-count estimates for the
    length-grouped sampler: multimodal samples positive, text-only negative
    in `modality_lengths`.
    """

    def __init__(self, path: str, tokenizer, media_token_len: int = 256):
        p = Path(path)
        if p.suffix == ".jsonl":
            self.records = [json.loads(l) for l in p.read_text().splitlines() if l.strip()]
        else:
            self.records = json.loads(p.read_text())
        assert self.records, f"no records in {path}"
        self.tokenizer = tokenizer
        self.media_token_len = media_token_len

    def __len__(self):
        return len(self.records)

    def _has_media(self, r) -> bool:
        return bool(r.get("image") or r.get("video"))

    @property
    def lengths(self) -> List[int]:
        out = []
        for r in self.records:
            n = sum(len(m.get("value", m.get("content", "")).split())
                    for m in r["conversations"])
            out.append(n + (self.media_token_len if self._has_media(r) else 0))
        return out

    @property
    def modality_lengths(self) -> List[int]:
        return [l if self._has_media(r) else -l
                for r, l in zip(self.records, self.lengths)]

    def __getitem__(self, i) -> Dict[str, Any]:
        r = self.records[i]
        token = VIDEO_TOKEN if r.get("video") else IMAGE_TOKEN
        msgs = preprocess_multimodal(r["conversations"], self._has_media(r), token)
        sample = preprocess_conversation(msgs, self.tokenizer)
        for k in ("image", "video"):
            if r.get(k):
                sample[k] = r[k]
        return sample


# ---------------------------------------------------------------------------
# Length-grouped batch ordering
# ---------------------------------------------------------------------------


def split_to_even_chunks(indices: Sequence[int], lengths: Sequence[int],
                         num_chunks: int) -> List[List[int]]:
    """Partition `indices` into `num_chunks` load-balanced chunks: each index
    goes to the currently-lightest chunk until that chunk is full. Uneven
    remainders fall back to strided assignment."""
    if len(indices) % num_chunks != 0:
        return [list(indices[i::num_chunks]) for i in range(num_chunks)]
    per_chunk = len(indices) // num_chunks
    chunks: List[List[int]] = [[] for _ in range(num_chunks)]
    load = np.zeros(num_chunks)
    for idx in indices:
        c = int(np.argmin(load))
        chunks[c].append(idx)
        load[c] += lengths[idx]
        if len(chunks[c]) == per_chunk:
            load[c] = np.inf
    return chunks


def get_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                               world_size: int,
                               rng: Optional[np.random.Generator] = None) -> List[int]:
    """Global sample order such that each world_size x batch_size megabatch
    holds similar-length samples (minimal padding waste) while megabatch
    order stays shuffled."""
    rng = rng or np.random.default_rng(0)
    perm = rng.permutation(len(lengths))
    mb = batch_size * world_size
    megabatches = [perm[i: i + mb].tolist() for i in range(0, len(lengths), mb)]
    megabatches = [sorted(m, key=lambda i: lengths[i], reverse=True)
                   for m in megabatches]
    chunked = [split_to_even_chunks(m, lengths, world_size) for m in megabatches]
    return [i for m in chunked for chunk in m for i in chunk]


def get_modality_length_grouped_indices(
    lengths: Sequence[int], batch_size: int, world_size: int,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    """Like get_length_grouped_indices but multimodal (length > 0) and
    text-only (length < 0) samples never share a megabatch; the two streams'
    megabatches interleave in shuffled order and the leftovers merge into one
    final batch."""
    rng = rng or np.random.default_rng(0)
    assert all(l != 0 for l in lengths), "zero-length sample"
    if all(l > 0 for l in lengths) or all(l < 0 for l in lengths):
        return get_length_grouped_indices(
            [abs(l) for l in lengths], batch_size, world_size, rng)
    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, -l) for i, l in enumerate(lengths) if l < 0]
    mb = batch_size * world_size

    def stream(pairs):
        idx = [p[0] for p in pairs]
        lens = [p[1] for p in pairs]
        order = get_length_grouped_indices(lens, batch_size, world_size, rng)
        shuffled = [idx[i] for i in order]
        return [shuffled[i: i + mb] for i in range(0, len(shuffled), mb)]

    mm_mb, lang_mb = stream(mm), stream(lang)
    leftover = (mm_mb[-1] if mm_mb else []) + (lang_mb[-1] if lang_mb else [])
    megabatches = mm_mb[:-1] + lang_mb[:-1]
    megabatches = [megabatches[i] for i in rng.permutation(len(megabatches))]
    if leftover:
        megabatches.append(sorted(leftover))
    return [i for m in megabatches for i in m]


def length_grouped_batches(
    lengths: Sequence[int], batch_size: int, world_size: int = 1,
    seed: int = 0, by_modality: bool = False,
):
    """Infinite generator of per-step index batches (this process sees its
    local batch; callers shard across dp ranks separately). Re-shuffles with
    a fresh epoch key each pass."""
    epoch = 0
    while True:
        rng = np.random.default_rng((seed, epoch))
        fn = (get_modality_length_grouped_indices if by_modality
              else get_length_grouped_indices)
        order = fn(lengths, batch_size, world_size, rng)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            yield order[i: i + batch_size]
        epoch += 1
