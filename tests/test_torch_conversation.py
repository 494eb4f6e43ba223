"""The port's conversation data (training/conversation.py) against JAX's on
the CPU: the same records through the same tiny tokenizer.json (the port's
FastTokenizer; transformers' fast tokenizer on the JAX side). ChatML is
rendered natively by the port and through jinja2 by JAX; a tokenizer that
brings its own template renders through jinja2 on both sides. Everything
is held exactly: ids, labels, normalized messages, lengths and the
length-grouped orders (numpy's RNG on both sides)."""

import json
import sys

import numpy as np
import pytest

from omnivideo_tpu.training import conversation as jconv
from omnivideo_tpu_torch.io.hf_reader import FastTokenizer
from omnivideo_tpu_torch.training import conversation as pconv
from torch_io_tiny import write_qwen3vl_tokenizer
from torch_sft_tiny import conversations, hf_tokenizer

TEMPLATE = ("{% for m in messages %}<|im_start|>{{ m['role'] }}\n{{ m['content'] | trim }}"
            "<|im_end|>\n{% endfor %}{% if add_generation_prompt %}<|im_start|>assistant\n"
            "{% endif %}")


@pytest.fixture(scope="module", params=["chatml", "own_template"])
def toks(request, tmp_path_factory):
    d = write_qwen3vl_tokenizer(tmp_path_factory.mktemp(request.param))
    if request.param == "own_template":
        conf = json.loads((d / "tokenizer_config.json").read_text())
        (d / "tokenizer_config.json").write_text(json.dumps({**conf, "chat_template": TEMPLATE}))
    return request.param, FastTokenizer(str(d)), hf_tokenizer(d)


def test_preprocess_conversation_matches_jax(toks):
    name, ptok, jtok = toks
    assert (ptok.chat_template is None) == (name == "chatml")
    spans = 0
    for rec in conversations(8, seed=1):
        ref = jconv.preprocess_conversation(rec["conversations"], jtok)
        got = pconv.preprocess_conversation(rec["conversations"], ptok)
        np.testing.assert_array_equal(got["ids"], ref["ids"])
        np.testing.assert_array_equal(got["labels"], ref["labels"])
        spans += int((got["labels"] != pconv.IGNORE_INDEX).sum())
        np.testing.assert_array_equal(pconv.tokenize_conversation(rec["conversations"], ptok, True),
                                      jconv.tokenize_conversation(rec["conversations"], jtok, True))
    assert spans > 0


def test_dataset_and_multimodal_match_jax(toks, tmp_path):
    _, ptok, jtok = toks
    recs = conversations(9, seed=2)
    recs[3]["conversations"][0]["value"] = "tok1 <image> tok2 <image>tok3"
    path = tmp_path / "conv.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in recs))
    for r in recs:
        for tok in (pconv.IMAGE_TOKEN, pconv.VIDEO_TOKEN):
            has = bool(r.get("image") or r.get("video"))
            assert (pconv.preprocess_multimodal(r["conversations"], has, tok)
                    == jconv.preprocess_multimodal(r["conversations"], has, tok))
    pds, jds = pconv.ConversationDataset(str(path), ptok), jconv.ConversationDataset(str(path), jtok)
    assert len(pds) == len(jds) == 9
    assert pds.lengths == jds.lengths and pds.modality_lengths == jds.modality_lengths
    for i in range(len(pds)):
        got, ref = pds[i], jds[i]
        assert set(got) == set(ref)
        for k in ("ids", "labels"):
            np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("world", [1, 2])
def test_length_grouping_matches_jax(world):
    rng = np.random.default_rng(world)
    lengths = rng.integers(1, 300, 41).tolist()
    mixed = [l if i % 4 else -l for i, l in enumerate(lengths)]
    for n in (3, 4):
        assert (pconv.split_to_even_chunks(list(range(12)), lengths, n)
                == jconv.split_to_even_chunks(list(range(12)), lengths, n))
    for fn in ("get_length_grouped_indices", "get_modality_length_grouped_indices"):
        arg = mixed if "modality" in fn else lengths
        got = getattr(pconv, fn)(arg, 3, world, np.random.default_rng(5))
        assert got == getattr(jconv, fn)(arg, 3, world, np.random.default_rng(5))
        assert sorted(got) == list(range(41))
    for by_modality in (False, True):
        arg = mixed if by_modality else lengths
        p = pconv.length_grouped_batches(arg, 4, world, seed=9, by_modality=by_modality)
        j = jconv.length_grouped_batches(arg, 4, world, seed=9, by_modality=by_modality)
        for _ in range(25):  # two epochs
            assert next(p) == next(j)


def test_own_template_needs_jinja2(monkeypatch):
    class Tok:
        chat_template = TEMPLATE

        def __call__(self, text, add_special_tokens=False):
            return {"input_ids": list(text.encode())}

    monkeypatch.setitem(sys.modules, "jinja2", None)
    monkeypatch.setitem(sys.modules, "jinja2.sandbox", None)
    monkeypatch.setitem(sys.modules, "jinja2.exceptions", None)
    with pytest.raises(ImportError, match="jinja2"):
        pconv.tokenize_conversation([{"role": "user", "content": "hi"}], Tok())
    Tok.chat_template = None  # ChatML needs no jinja2
    ids = pconv.tokenize_conversation([{"role": "user", "content": "hi"}], Tok(), True)
    assert bytes(ids.tolist()).decode() == "<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n"
