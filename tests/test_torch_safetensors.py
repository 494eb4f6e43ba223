"""The port's safetensors reader (io/safetensors.py, io/hf_reader.py),
written from the file format, against the `safetensors` package and the JAX
package's `load_hf_safetensors`: every dtype it reads, `__metadata__`, a
sharded checkpoint dir with `model.safetensors.index.json` and
`prefix_filter`, a tensor whose offset is not a multiple of its element
size, and entries that do not fit the file. Every tensor bit-equal, BF16
kept as torch.bfloat16."""

import json
import struct

import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from omnivideo_tpu.io.hf_reader import load_hf_safetensors as jax_load_hf_safetensors
from omnivideo_tpu_torch.io.hf_reader import load_hf_safetensors
from omnivideo_tpu_torch.io.safetensors import iter_safetensors, load_safetensors, read_header


def _tensors(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s)  # noqa: E731
    i = lambda lo, hi, *s: rng.integers(lo, hi, s)  # noqa: E731
    return {
        "f64": torch.from_numpy(f(3, 5)),
        "f32": torch.from_numpy(f(7, 4).astype(np.float32)),
        "f16": torch.from_numpy(f(6).astype(np.float16)),
        "bf16": torch.from_numpy(f(5, 3).astype(np.float32)).to(torch.bfloat16),
        "i64": torch.from_numpy(i(-2**40, 2**40, 4, 2)),
        "i32": torch.from_numpy(i(-2**30, 2**30, 9).astype(np.int32)),
        "i16": torch.from_numpy(i(-2**15, 2**15, 3, 3).astype(np.int16)),
        "i8": torch.from_numpy(i(-128, 128, 11).astype(np.int8)),
        "u8": torch.from_numpy(i(0, 256, 2, 5).astype(np.uint8)),
        "bool": torch.from_numpy(i(0, 2, 13).astype(bool)),
        "scalar": torch.tensor(2.5, dtype=torch.float32),
        "empty": torch.zeros(0, 4, dtype=torch.bfloat16),
    }


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    bits = lambda t: t.reshape(-1).view(torch.uint8)  # noqa: E731
    return a.dtype == b.dtype and a.shape == b.shape and (
        a.numel() == 0 or bool((bits(a) == bits(b)).all()))


def test_every_dtype_and_metadata(tmp_path):
    src = _tensors()
    meta = {"format": "pt", "note": "seeded"}
    save_file(src, str(tmp_path / "m.safetensors"), metadata=meta)
    got = load_safetensors(tmp_path / "m.safetensors", device="cpu")
    ref = load_file(str(tmp_path / "m.safetensors"))
    assert set(got) == set(ref) == set(src)
    for k in src:
        assert _bits_equal(got[k], ref[k]), k
        assert _bits_equal(got[k], src[k]), k
    assert got["bf16"].dtype == torch.bfloat16
    entries, got_meta, start = read_header(tmp_path / "m.safetensors")
    assert got_meta == meta and set(entries) == set(src) and start % 8 == 0


def test_prefix_filter_and_file_order(tmp_path):
    src = {"model.a.w": torch.arange(6.0), "model.b.w": torch.ones(2, 2),
           "lm_head.w": torch.ones(3)}
    save_file(src, str(tmp_path / "m.safetensors"))
    names = [n for n, _ in iter_safetensors(tmp_path / "m.safetensors", "cpu", "model.")]
    entries, _, _ = read_header(tmp_path / "m.safetensors")
    assert names == sorted(("model.a.w", "model.b.w"), key=lambda n: entries[n]["data_offsets"][0])


def test_sharded_dir_against_jax_reader(tmp_path):
    """Two shards with an index: every tensor, and the prefix_filter subset,
    as the JAX package's reader gives them (bf16 compared bit for bit)."""
    src = _tensors(1)
    names = sorted(src)
    shards = {"model-00001-of-00002.safetensors": names[::2],
              "model-00002-of-00002.safetensors": names[1::2]}
    weight_map = {}
    for fname, keys in shards.items():
        save_file({f"model.{k}": src[k] for k in keys}, str(tmp_path / fname))
        weight_map.update({f"model.{k}": fname for k in keys})
    save_file({"stray": torch.ones(1)}, str(tmp_path / "not-in-the-index.safetensors"))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    for prefix in (None, "model.b"):
        got = load_hf_safetensors(str(tmp_path), prefix_filter=prefix, device="cpu")
        ref = jax_load_hf_safetensors(str(tmp_path), prefix_filter=prefix)
        assert set(got) == set(ref)
        assert set(got) == ({f"model.{k}" for k in src} if prefix is None else {"model.bf16",
                                                                                 "model.bool"})
        for k, r in ref.items():
            r = np.asarray(r)
            want = (torch.from_numpy(r.view(np.uint16).copy()).view(torch.bfloat16)
                    if r.dtype.name == "bfloat16" else torch.from_numpy(r.copy()))
            assert _bits_equal(got[k], want), k


def _write_raw(path, entries, data: bytes, header_pad: int = 0):
    header = json.dumps(entries).encode() + b" " * header_pad
    path.write_bytes(struct.pack("<Q", len(header)) + header + data)


def test_unaligned_offset_is_copied(tmp_path):
    """A BF16 tensor 3 bytes into the buffer (and a 9-byte header, so odd in
    the file too) reads as its values, into aligned memory of its own."""
    vals = torch.tensor([1.5, -2.0, 3.25, 0.0078125], dtype=torch.bfloat16)
    entries = {"u8": {"dtype": "U8", "shape": [3], "data_offsets": [0, 3]},
               "bf16": {"dtype": "BF16", "shape": [2, 2], "data_offsets": [3, 11]}}
    raw = bytes([7, 8, 9]) + vals.view(torch.uint8).numpy().tobytes()
    for pad in (0, 1):
        _write_raw(tmp_path / "odd.safetensors", entries, raw, pad)
        got = load_safetensors(tmp_path / "odd.safetensors", device="cpu")
        assert _bits_equal(got["bf16"], vals.reshape(2, 2))
        assert got["u8"].tolist() == [7, 8, 9]
        assert got["bf16"].data_ptr() % 2 == 0


@pytest.mark.parametrize("entry,match", [
    ({"dtype": "F32", "shape": [4], "data_offsets": [0, 64]}, "does not fit"),
    ({"dtype": "F32", "shape": [3], "data_offsets": [0, 16]}, "does not fit"),
    ({"dtype": "C64", "shape": [1], "data_offsets": [0, 8]}, "not read"),
])
def test_bad_entries_raise(tmp_path, entry, match):
    _write_raw(tmp_path / "bad.safetensors", {"t": entry}, bytes(16))
    with pytest.raises(ValueError, match=match):
        load_safetensors(tmp_path / "bad.safetensors", device="cpu")
