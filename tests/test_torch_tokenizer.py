"""The port's umT5 tokenizer and text path against the JAX package on the
CPU: `HuggingfaceTokenizer` on a dir with only `spiece.model` (converted
without the sentencepiece runtime) and on a tokenizer.json dir (the layout
transformers' AutoTokenizer loads), ids and masks equal to JAX's, whitespace
cleaning and a prompt longer than 512 tokens (truncated with its `</s>`
kept) included; `T5EncoderModel(texts)` against JAX's on a tiny umT5 (f32,
1e-5 of scale, the encoder's tolerance in tests/test_torch_t5.py); and the
prompt strings, character for character."""

import numpy as np
import pytest
import torch
from torch_io_tiny import write_spiece, write_umt5_tokenizer_dir

from omnivideo_tpu.configs import prompts as jax_prompts
from omnivideo_tpu.configs.base import T5Config as JaxT5Config
from omnivideo_tpu.models.t5 import HuggingfaceTokenizer as JaxTokenizer
from omnivideo_tpu.models.t5 import T5EncoderModel as JaxT5EncoderModel
from omnivideo_tpu.models.t5 import t5_state_dict_to_params as jax_t5_params
from omnivideo_tpu_torch.configs import prompts
from omnivideo_tpu_torch.configs.base import T5Config
from omnivideo_tpu_torch.models.t5 import HuggingfaceTokenizer, T5EncoderModel, init_t5

TEXTS = ["hello world", "  a red\tfox\n\nin the   snow ", "replace the dog with a gray rabbit.",
         "xyz unknown words", "", "hello " * 700]
T5 = dict(vocab_size=64, dim=32, dim_attn=32, dim_ffn=64, num_heads=4, num_layers=2,
          num_buckets=8, text_len=512)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("umt5")
    return {"spiece_only": write_spiece(root / "sp"),
            "tokenizer_json": write_umt5_tokenizer_dir(root / "fast")}


@pytest.mark.parametrize("kind", ["spiece_only", "tokenizer_json"])
@pytest.mark.parametrize("seq_len", [512, 8])
def test_ids_and_mask_equal_jax(dirs, kind, seq_len):
    ours = HuggingfaceTokenizer(str(dirs[kind]), seq_len=seq_len)
    ref_ids, ref_mask = JaxTokenizer(str(dirs[kind]), seq_len=seq_len)(TEXTS)
    ids, mask = ours(TEXTS)
    assert ids.dtype == mask.dtype == torch.int64 and ids.shape == (len(TEXTS), seq_len)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert int(ids[-1, -1]) == 1 and int(mask[-1].sum()) == seq_len  # `</s>` kept at the cut
    assert ours(["hello  world"], return_mask=False).tolist() == ids[:1].tolist()


def test_encoder_model_encodes_strings_as_jax(dirs):
    enc = init_t5(T5Config(**T5), dtype=torch.float32, device="cpu", seed=5)
    ours = T5EncoderModel(enc, tokenizer_path=str(dirs["tokenizer_json"]))
    sd = {k: v.numpy() for k, v in enc.state_dict().items()}
    theirs = JaxT5EncoderModel(jax_t5_params(sd, JaxT5Config(**T5)), JaxT5Config(**T5),
                               tokenizer_path=str(dirs["tokenizer_json"]))
    texts = TEXTS[:3]
    got, ref = ours(texts), theirs(texts)
    assert [tuple(g.shape) for g in got] == [tuple(r.shape) for r in ref]
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float32)
        assert np.abs(g.numpy() - r).max() / np.abs(r).max() < 1e-5
    with pytest.raises(RuntimeError, match="tokenizer"):
        T5EncoderModel(enc)(["a prompt"])


@pytest.mark.parametrize("name", ["SAMPLE_NEG_PROMPT_EN", "SOURCE_CAPTION_SYSTEM_PROMPT",
                                  "TARGET_CAPTION_SYSTEM_PROMPT",
                                  "FEATURE_EXTRACTION_SYSTEM_PROMPT"])
def test_prompts_equal_jax(name):
    assert getattr(prompts, name) == getattr(jax_prompts, name)
