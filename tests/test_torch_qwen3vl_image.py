"""The port's Qwen3-VL image path against the JAX package on the CPU:

- `read_png` against PNGs written here with numpy and zlib, one per
  scanline filter (0-4), RGB and RGBA, and one Pillow writes; anything but
  8-bit RGB(A), non-interlaced, raises;
- `preprocess_image` gives JAX's grid, and its patches equal JAX's where no
  resize is needed (a PNG, an .npy, an .npz and an array alike) and are
  within one uint8 level (1/255 over the smallest CLIP std) after a resize
  (JAX resizes with Pillow's bicubic, the port on the device);
- `build_vqa_ids` equals JAX's;
- the engine's image message on the tiny checkpoint dir
  (tests/torch_io_tiny.py, f32, the vision rope's f32 parity mode) gives
  the JAX engine's caption token for token, and its prompt carries a
  (1, h, w) grid of `<|image_pad|>` tokens.
"""

import struct
import zlib

import numpy as np
import pytest

from omnivideo_tpu.models.qwen3vl import engine as jengine
from omnivideo_tpu.models.qwen3vl import preprocess as jpre
from omnivideo_tpu_torch.io.hf_reader import FastTokenizer
from omnivideo_tpu_torch.models.qwen3vl import engine, preprocess
from omnivideo_tpu_torch.models.qwen3vl import full_model
from omnivideo_tpu_torch.utils.png import read_png, write_png
from torch_io_tiny import write_qwen3vl_hf_dir

CLIP_STD_MIN = 0.26130258


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png(path, image, filters):
    """A PNG whose row y is written with filter filters[y % len(filters)]."""
    h, w, ch = image.shape
    x = image.reshape(h, w * ch).astype(np.int64)
    rows = []
    for y in range(h):
        f = filters[y % len(filters)]
        cur, up = x[y], (x[y - 1] if y else np.zeros_like(x[y]))
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int64), up[:-ch]])
        pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2, 4: _paeth(left, up, ul)}[f]
        rows.append(np.concatenate([[f], (cur - pred) % 256]).astype(np.uint8))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    colour = {3: 2, 4: 6}[ch]
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(np.concatenate(rows).tobytes()))
                     + chunk(b"IEND", b""))
    return path


@pytest.mark.parametrize("ch", [3, 4])
def test_png_reader(tmp_path, ch):
    img = np.random.default_rng(ch).integers(0, 256, (13, 17, ch), dtype=np.uint8)
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
        got = read_png(_png(tmp_path / "a.png", img, filters))
        np.testing.assert_array_equal(got, img, err_msg=str(filters))
    np.testing.assert_array_equal(read_png(write_png(tmp_path / "b.png", img)), img)
    from PIL import Image

    Image.fromarray(img).save(tmp_path / "c.png", optimize=True)
    np.testing.assert_array_equal(read_png(tmp_path / "c.png"), img)
    Image.fromarray(img[..., 0]).save(tmp_path / "gray.png")
    with pytest.raises(ValueError, match="colour type 0"):
        read_png(tmp_path / "gray.png")


def test_preprocess_image_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    kw = dict(patch_size=4, temporal_patch_size=2, merge_size=2, min_pixels=256,
              max_pixels=4096)
    ref, grid = jpre.preprocess_image(str(write_png(tmp_path / "i.png", img)), **kw)
    np.save(tmp_path / "i.npy", img)
    np.savez(tmp_path / "i.npz", image=img)
    rgba = np.concatenate([img, img[..., :1]], -1)
    for src in (tmp_path / "i.png", str(tmp_path / "i.npy"), tmp_path / "i.npz", img, rgba):
        got, g = preprocess.preprocess_image(src, device="cpu", **kw)
        assert g == grid == (1, 12, 16)
        np.testing.assert_array_equal(got, ref)
    big = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    write_png(tmp_path / "big.png", big)
    kw["max_pixels"] = 1024
    ref, grid = jpre.preprocess_image(str(tmp_path / "big.png"), **kw)
    got, g = preprocess.preprocess_image(tmp_path / "big.png", device="cpu", **kw)
    assert g == grid and grid[1:] != (45 // 4, 70 // 4)
    assert np.abs(got - ref).max() <= 1.0 / 255 / CLIP_STD_MIN + 1e-5


def test_build_vqa_ids_matches_jax(tmp_path):
    d = write_qwen3vl_hf_dir(tmp_path / "tok", transformers=False)
    ours = FastTokenizer(str(d))
    for n, video, sys_prompt in ((0, False, None), (6, False, "tok1 tok2"), (4, True, None)):
        np.testing.assert_array_equal(
            preprocess.build_vqa_ids(ours, "tok3 yes", n, video, sys_prompt),
            jpre.build_vqa_ids(ours, "tok3 yes", n, video, sys_prompt))


def test_engine_image_message_matches_jax(tmp_path):
    d = write_qwen3vl_hf_dir(tmp_path / "hf", transformers=False)
    img = np.random.default_rng(3).integers(0, 256, (24, 32, 3), dtype=np.uint8)
    path = str(write_png(tmp_path / "still.png", img))
    kw = dict(model_path=str(d), backend="jax", max_new_tokens=6, target_short_side=16,
              vision_rope_dtype="float32")
    ours = engine.Qwen3VLEngine(engine.VLMConfig(device="cpu", **kw))
    theirs = jengine.Qwen3VLEngine(jengine.VLMConfig(**kw))
    seen = []
    decode = full_model.qwen3vl_greedy_decode

    def spy(model, ids, patches, grid, **k):
        seen.append((np.asarray(ids), grid, k["is_video"]))
        return decode(model, ids, patches, grid, **k)

    engine.qwen3vl_greedy_decode = spy
    try:
        msg = [{"role": "system", "content": [{"type": "text", "text": "tok5 tok6"}]},
               {"role": "user", "content": [{"type": "image", "image": path},
                                            {"type": "text", "text": "tok7 yes"}]}]
        got = ours._generate(msg)
    finally:
        engine.qwen3vl_greedy_decode = decode
    assert got == theirs._generate(msg)
    ids, grid, is_video = seen[0]
    assert grid == (1, 6, 8) and not is_video
    assert int((ids == 151).sum()) == 6 * 8 // 4  # <|image_pad|> at the tiny config's id
