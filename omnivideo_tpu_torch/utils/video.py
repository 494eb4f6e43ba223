"""Video files in and out, and the frame transforms of the generate CLI
(port of omnivideo_tpu/utils/video.py, with the arithmetic of
omnivideo_tpu/utils/frame_native.py).

Readers: `.npz` ("frames", "fps"), `.npy`, MJPEG `.avi` (utils/avi.py),
`.gif`, a directory of PNG/JPG frames, and anything else through imageio.
Writers, in the JAX package's order: mp4 where imageio can encode it, else
MJPEG AVI, else GIF (both need Pillow), else `.npz` ("frames", "fps"), the
last resort on a machine that has neither imageio nor Pillow. Pillow and
imageio are imported only inside the functions of the formats that need
them.

The transforms run with torch on the clip's device: frames are resized with
`interpolate(mode="bicubic", antialias=True)` in Pillow's two passes (width,
then height, each rounded and clamped to uint8), where the JAX package
calls Pillow's BICUBIC; on noisy frames the two differ by at most one uint8
level (ROADMAP §3). Then the frames are scaled to [-1, 1] as x·(1/127.5) − 1
(the arithmetic of the JAX package's native frame ops) and laid out
[3, T, H, W].
"""

from __future__ import annotations

import functools
import logging
import os
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

log = logging.getLogger(__name__)

Frames = Union[np.ndarray, torch.Tensor]


def to_uint8(video: Frames, value_range: Tuple[float, float] = (-1, 1)) -> np.ndarray:
    """[C, T, H, W] float in value_range (or uint8 frames) → [T, H, W, C]
    uint8 on the host. uint8 passes through: [T, H, W, C] as it is,
    [C, T, H, W] transposed. The float math is the JAX package's
    (x + 1)·127.5 + 0.5 truncated, in f32 on the tensor's device."""
    x = torch.as_tensor(video)
    cthw = x.ndim == 4 and x.shape[0] in (1, 3)
    if x.dtype == torch.uint8:
        if cthw and x.shape[-1] not in (1, 3):
            x = x.permute(1, 2, 3, 0)
        return x.cpu().numpy()
    x = x.float()
    lo, hi = value_range
    if (lo, hi) == (-1, 1):
        x = (x.clamp(-1, 1) + 1.0) * 127.5 + 0.5
    else:
        x = (x.clamp(lo, hi) - lo) / (hi - lo) * 255.0 + 0.5
    x = x.to(torch.uint8)
    if cthw:
        x = x.permute(1, 2, 3, 0)
    return x.cpu().numpy()


def _pillow_available() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def _mp4_available() -> bool:
    try:
        import imageio
    except ImportError:
        return False
    return _mp4_encoder_works(imageio)


@functools.lru_cache(maxsize=None)
def _mp4_encoder_works(imageio) -> bool:
    """Whether imageio has a backend that writes mp4 (probed once, into a
    temporary file)."""
    with tempfile.TemporaryDirectory() as d:
        try:
            imageio.get_writer(os.path.join(d, "probe.mp4"), fps=8).close()
        except Exception:  # imageio raises per backend: any failure means "no mp4 here"
            return False
    return True


def save_video(path: str, video: Frames, fps: int = 16,
               value_range: Tuple[float, float] = (-1, 1), retry: int = 5) -> str:
    """Write frames as a video; returns the path written, whose extension
    changes when the asked format cannot be written here (mp4 → .avi,
    other → .gif, and → .npz without Pillow). Retries like the reference's
    cache_video."""
    frames = to_uint8(video, value_range)
    path = str(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    stem = os.path.splitext(path)[0]
    for attempt in range(retry):
        try:
            if path.endswith(".mp4") and _mp4_available():
                import imageio

                with imageio.get_writer(path, fps=fps, codec="libx264") as w:
                    for fr in frames:
                        w.append_data(fr)
                return path
            if path.endswith(".npz") or not _pillow_available():
                out = stem + ".npz"
                if out != path:
                    log.warning("neither an mp4 encoder nor Pillow here; writing %s", out)
                np.savez_compressed(out, frames=frames, fps=fps)
                return out
            if path.endswith((".mp4", ".avi")):
                from .avi import write_mjpeg_avi

                out = stem + ".avi"
                if out != path:
                    log.warning("no mp4 encoder here; writing MJPEG AVI %s", out)
                return write_mjpeg_avi(out, frames, fps=fps)
            from PIL import Image

            out = stem + ".gif"
            if out != path:
                log.warning("writing %s", out)
            imgs = [Image.fromarray(fr) for fr in frames]
            imgs[0].save(out, save_all=True, append_images=imgs[1:],
                         duration=max(1, int(1000 / fps)), loop=0)
            return out
        except OSError as e:
            log.error("save_video attempt %d failed: %s", attempt, e)
            time.sleep(0.1)
    raise RuntimeError(f"failed to save video to {path} after {retry} attempts")


def save_image(path: str, image: Frames, value_range=(-1, 1)) -> str:
    """[C, H, W] float in value_range, or [H, W, C] uint8, → an image file
    (Pillow), or `.npz` ("frames" [1, H, W, C], "fps" 0) without Pillow.
    Returns the path written."""
    img = torch.as_tensor(image)
    if img.dtype == torch.uint8 and img.shape[-1] in (1, 3):
        arr = img.cpu().numpy()
    else:
        arr = to_uint8(img[:, None], value_range)[0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not _pillow_available():
        out = os.path.splitext(path)[0] + ".npz"
        log.warning("no Pillow here; writing %s", out)
        np.savez_compressed(out, frames=arr[None], fps=0)
        return out
    from PIL import Image

    Image.fromarray(arr).save(path)
    return path


def read_video_frames(path: str, max_frames: Optional[int] = None) -> Tuple[np.ndarray, float]:
    """A clip → ([T, H, W, 3] uint8, fps)."""
    p = Path(path)
    if p.suffix == ".npz":
        with np.load(p) as data:
            frames = data["frames"]
            fps = float(data["fps"]) if "fps" in data else 16.0
    elif p.suffix == ".npy":
        frames, fps = np.load(p), 16.0
    elif p.is_dir():
        from PIL import Image

        files = sorted(p.glob("*.png")) + sorted(p.glob("*.jpg"))
        frames = np.stack([np.asarray(Image.open(f).convert("RGB")) for f in files])
        fps = 16.0
    elif p.suffix == ".avi":
        from .avi import read_mjpeg_avi

        frames, fps = read_mjpeg_avi(str(p))
    elif p.suffix == ".gif":
        from PIL import Image, ImageSequence

        with Image.open(p) as im:
            frames = np.stack([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)])
            fps = 1000.0 / max(im.info.get("duration", 62), 1)
    else:
        import imageio

        reader = imageio.get_reader(str(p))
        try:
            fps = float(reader.get_meta_data().get("fps", 16))
            frames = np.stack([fr for fr in reader])
        finally:
            reader.close()
    if max_frames is not None:
        frames = frames[:max_frames]
    return frames, fps


def resize_frames(frames: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """[T, H, W, 3] uint8 → [T, h, w, 3] uint8 at size = (h, w), on the
    frames' device. Pillow's BICUBIC in torch: antialiased bicubic
    (`interpolate(..., antialias=True)`, Pillow's a = -0.5 kernel) along the
    width, then along the height, rounding and clamping to uint8 after each
    pass as Pillow's two passes do."""
    h, w = size
    x = frames.permute(0, 3, 1, 2).float()
    for shape in ((x.shape[2], w), (h, w)):
        if tuple(x.shape[2:]) != shape:
            x = F.interpolate(x, size=shape, mode="bicubic", antialias=True,
                              align_corners=False).round_().clamp_(0, 255)
    return x.to(torch.uint8).permute(0, 2, 3, 1)


def sample_and_transform_frames(frames: Frames, num_frames: int, size: Tuple[int, int],
                                src_fps: float = 16.0, target_fps: float = 16.0,
                                device="cuda") -> torch.Tensor:
    """Every round(src_fps / target_fps)-th frame (the last one repeated to
    fill num_frames), resized so the target is covered, center-cropped and
    scaled to [-1, 1] (the reference's transform_frames_to_tensor).

    frames: [T, H, W, 3] uint8; size: (width, height). Returns [3,
    num_frames, height, width] f32 on `device`."""
    dev = resolve_device(device)
    rate = max(1, int(round(src_fps / target_fps)))
    idx = np.arange(0, len(frames), rate)[:num_frames]
    if len(idx) < num_frames:
        idx = np.concatenate([idx, np.full(num_frames - len(idx), idx[-1])])
    sel = torch.as_tensor(frames[idx] if isinstance(frames, np.ndarray)
                          else frames[torch.as_tensor(idx)]).to(dev)
    W_t, H_t = size
    h, w = sel.shape[1:3]
    scale = max(W_t / w, H_t / h)
    w2, h2 = int(round(w * scale)), int(round(h * scale))
    sel = resize_frames(sel, (h2, w2))
    left, top = (w2 - W_t) // 2, (h2 - H_t) // 2
    sel = sel[:, top:top + H_t, left:left + W_t]
    return (sel.float() * (1 / 127.5) - 1.0).permute(3, 0, 1, 2).contiguous()
