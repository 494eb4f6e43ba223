"""The port's video files and frame transforms (utils/video.py,
utils/avi.py) against the JAX package's utils/video.py on the CPU:

- `read_video_frames` on .npz, .npy, .avi, .gif and a PNG dir, bit-equal
  frames and the same fps (both packages decode JPEG and GIF with Pillow);
- the MJPEG AVI writer: the port's file is byte-identical to the JAX
  package's, and each package reads the other's;
- `to_uint8` bit-equal to JAX's `_to_uint8`; `save_video` names the file it
  wrote as JAX's does, and writes `.npz` ("frames", "fps") with Pillow and
  imageio hidden;
- `sample_and_transform_frames`: the same frame indices, and where no
  resize is needed the same values to one f32 ulp of 1 (the JAX package's
  native frame ops and its numpy fallback differ by that); after a resize
  (torch's antialiased bicubic in Pillow's two passes, for Pillow's
  BICUBIC) every pixel within 3/127.5
  and the share more than one uint8 level off under 1e-3, on noisy frames
  (1280x720 to 832x480 among them); `resize_frames` alone within one uint8
  level of Pillow.
"""

import sys

import numpy as np
import pytest
import torch
from PIL import Image

from omnivideo_tpu.utils import avi as jax_avi
from omnivideo_tpu.utils import video as jax_video
from omnivideo_tpu_torch.utils import avi, video

LEVEL = 1 / 127.5  # one uint8 level in [-1, 1] units


def _clip(T=6, H=24, W=40, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (T, H, W, 3), dtype=np.uint8)


def _write_all(tmp_path, frames):
    np.savez(tmp_path / "c.npz", frames=frames, fps=24)
    np.save(tmp_path / "c.npy", frames)
    jax_avi.write_mjpeg_avi(str(tmp_path / "c.avi"), frames, fps=12)
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(tmp_path / "c.gif", save_all=True, append_images=imgs[1:], duration=125, loop=0)
    (tmp_path / "png").mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f).save(tmp_path / "png" / f"{i:03d}.png")


@pytest.mark.parametrize("name", ["c.npz", "c.npy", "c.avi", "c.gif", "png"])
def test_read_video_frames_equal_jax(tmp_path, name):
    _write_all(tmp_path, _clip())
    got, fps = video.read_video_frames(str(tmp_path / name))
    ref, ref_fps = jax_video.read_video_frames(str(tmp_path / name))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert fps == ref_fps
    got, _ = video.read_video_frames(str(tmp_path / name), max_frames=2)
    assert len(got) == 2


def test_avi_writer_and_readers_cross(tmp_path):
    frames = _clip(T=5, H=32, W=48, seed=1)
    mine = avi.write_mjpeg_avi(str(tmp_path / "port.avi"), frames, fps=16)
    theirs = jax_avi.write_mjpeg_avi(str(tmp_path / "jax.avi"), frames, fps=16)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    a, fa = jax_avi.read_mjpeg_avi(mine)
    b, fb = avi.read_mjpeg_avi(theirs)
    np.testing.assert_array_equal(a, b)
    assert fa == fb == 16.0 and a.shape == frames.shape
    with pytest.raises(ValueError, match="uint8"):
        avi.write_mjpeg_avi(str(tmp_path / "x.avi"), frames.astype(np.float32))


def test_to_uint8_equals_jax():
    rng = np.random.default_rng(2)
    x = (1.2 * rng.standard_normal((3, 4, 8, 10))).astype(np.float32)
    np.testing.assert_array_equal(video.to_uint8(x), jax_video._to_uint8(x))
    np.testing.assert_array_equal(video.to_uint8(torch.from_numpy(x)), jax_video._to_uint8(x))
    y = rng.uniform(-0.5, 2.5, (3, 4, 8, 10)).astype(np.float32)
    np.testing.assert_array_equal(video.to_uint8(y, (0, 2)), jax_video._to_uint8(y, (0, 2)))
    u = _clip(T=4, H=8, W=10)
    np.testing.assert_array_equal(video.to_uint8(u), jax_video._to_uint8(u))
    np.testing.assert_array_equal(video.to_uint8(u.transpose(3, 0, 1, 2)), u)


@pytest.mark.parametrize("name", ["o.mp4", "o.avi", "o.gif", "o.npz"])
def test_save_video_writes_what_jax_writes(tmp_path, name):
    frames = _clip(T=4, H=16, W=24, seed=3)
    mine = video.save_video(str(tmp_path / "port" / name), frames, fps=8)
    theirs = jax_video.save_video(str(tmp_path / "jax" / name), frames, fps=8)
    assert mine.rsplit("/", 1)[1] == theirs.rsplit("/", 1)[1]
    a, fa = video.read_video_frames(mine)
    b, fb = jax_video.read_video_frames(theirs)
    np.testing.assert_array_equal(a, b)
    assert fa == fb


def test_save_video_npz_without_pillow_or_imageio(tmp_path, monkeypatch):
    frames = _clip(T=3, H=8, W=8, seed=4)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    path = video.save_video(str(tmp_path / "o.mp4"), frames, fps=16)
    assert path == str(tmp_path / "o.npz")
    with np.load(path) as data:
        np.testing.assert_array_equal(data["frames"], frames)
        assert int(data["fps"]) == 16
    path = video.save_image(str(tmp_path / "o.png"), frames[0])
    with np.load(path) as data:
        np.testing.assert_array_equal(data["frames"][0], frames[0])


def test_save_image(tmp_path):
    img = np.random.default_rng(5).uniform(-1, 1, (3, 8, 12)).astype(np.float32)
    mine = video.save_image(str(tmp_path / "a.png"), img)
    theirs = jax_video.save_image(str(tmp_path / "b.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(mine)), np.asarray(Image.open(theirs)))
    u8 = _clip(T=1, H=8, W=12)[0]
    np.testing.assert_array_equal(
        np.asarray(Image.open(video.save_image(str(tmp_path / "c.png"), u8))), u8)


@pytest.mark.parametrize("T,src_fps,num", [(12, 16.0, 9), (10, 32.0, 9), (48, 24.0, 81)])
def test_sample_and_transform_without_resize_equals_jax(T, src_fps, num):
    frames = _clip(T=T, H=16, W=24, seed=6)
    got = video.sample_and_transform_frames(frames, num, (24, 16), src_fps, 16.0, device="cpu")
    ref = jax_video.sample_and_transform_frames(frames, num, (24, 16), src_fps, 16.0)
    assert got.shape == ref.shape == (3, num, 16, 24)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2.0**-23)
    # the indices, read back from a clip whose frame i is filled with i
    ramp = np.broadcast_to(np.arange(T, dtype=np.uint8)[:, None, None, None], (T, 2, 2, 3))
    idx = video.sample_and_transform_frames(ramp, num, (2, 2), src_fps, 16.0, device="cpu")
    ref_idx = jax_video.sample_and_transform_frames(np.ascontiguousarray(ramp), num, (2, 2),
                                                    src_fps, 16.0)
    np.testing.assert_allclose(idx.numpy(), ref_idx, rtol=0, atol=2.0**-23)


@pytest.mark.parametrize("shape,size", [((3, 720, 1280), (832, 480)), ((4, 48, 64), (24, 40)),
                                        ((2, 30, 50), (64, 32))])
def test_sample_and_transform_with_resize_within_tolerance(shape, size):
    frames = _clip(*shape, seed=7)
    got = video.sample_and_transform_frames(frames, shape[0], size, device="cpu").numpy()
    ref = jax_video.sample_and_transform_frames(frames, shape[0], size)
    assert got.shape == ref.shape == (3, shape[0], size[1], size[0])
    err = np.abs(got - ref)
    assert err.max() <= 3 * LEVEL + 1e-6
    assert (err > 1.5 * LEVEL).mean() < 1e-3


def test_resize_frames_matches_pillow():
    frames = _clip(T=2, H=45, W=70, seed=8)
    got = video.resize_frames(torch.from_numpy(frames), (28, 44)).numpy()
    ref = np.stack([np.asarray(Image.fromarray(f).resize((44, 28), Image.BICUBIC))
                    for f in frames])
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.abs(got.astype(int) - ref).max() <= 1
    np.testing.assert_array_equal(video.resize_frames(torch.from_numpy(frames), (45, 70)).numpy(),
                                  frames)
