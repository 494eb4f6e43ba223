"""Offline-feature dataset and loader (a copy of omnivideo_tpu/training/
dataset.py, which is numpy only; the port keeps its own).

Per-sample files holding precomputed features (`text_emb` [Lt, 4096],
`latent_feature` / `latent_feature_tgt` [C, F, h, w],
`vlm_last_hidden_states` [1, Lv, vlm_dim], optional `aligned_emb`,
`prompt`): a directory of .npz/.pkl/.pt files or indexed .tar shards of .npz
members, retry-on-corrupt loading with seeded substitution, a collate that
pads to FIXED config lengths (`PadSpec`), a host-sharded seeded-permutation
loader (`index % num_hosts == host_id`), a dummy-dataset factory and a
background-thread prefetcher.
"""

from __future__ import annotations

import dataclasses
import logging
import random
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

FEATURE_KEYS = (
    "text_emb",
    "latent_feature",
    "latent_feature_tgt",
    "vlm_last_hidden_states",
    "aligned_emb",
)


def _load_sample(path: Path) -> Dict[str, np.ndarray]:
    if path.suffix == ".npz":
        data = dict(np.load(path, allow_pickle=True))
        return {k: np.asarray(v) for k, v in data.items()}
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    out = {}
    for k, v in obj.items():
        out[k] = v.float().numpy() if isinstance(v, torch.Tensor) else v
    return out


@dataclasses.dataclass
class PadSpec:
    """Fixed padded lengths for jit-stable batches."""

    text_len: int = 512
    vlm_len: int = 512
    latent_frames: int = 21
    aligned_len: int = 256


class OmniVideoDataset:
    """Per-sample feature files: a directory of .pkl/.npz/.pt, or indexed
    .tar shards of .npz members (role of the reference's WebDataset-style
    shards, .../llava/wids/wids.py)."""

    def __init__(self, root: str, max_retries: int = 20):
        rootp = Path(root)
        self._tar_members = None
        if rootp.is_file() and rootp.suffix == ".tar" or (
            rootp.is_dir() and any(rootp.glob("*.tar"))
        ):
            import tarfile

            shards = [rootp] if rootp.is_file() else sorted(rootp.glob("*.tar"))
            self._tar_members = []
            for shard in shards:
                with tarfile.open(shard) as tf:
                    for m in tf.getmembers():
                        if m.isfile() and m.name.endswith(".npz"):
                            self._tar_members.append((shard, m.name))
            assert self._tar_members, f"no .npz members in shards under {root}"
            self.files = [f"{s}::{n}" for s, n in self._tar_members]
        else:
            self.files = sorted(
                p for p in rootp.iterdir() if p.suffix in (".pkl", ".npz", ".pt")
            )
            assert self.files, f"no samples under {root}"
        self.max_retries = max_retries

    def _load(self, idx: int) -> Dict[str, np.ndarray]:
        if self._tar_members is not None:
            import io
            import tarfile

            shard, name = self._tar_members[idx]
            with tarfile.open(shard) as tf:
                data = np.load(io.BytesIO(tf.extractfile(name).read()),
                               allow_pickle=True)
                return {k: np.asarray(v) for k, v in dict(data).items()}
        return _load_sample(self.files[idx])

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        """Retry-on-corrupt with random substitute samples
        (omnivideo_dataset_patched.py:46-50)."""
        rng = random.Random(idx)
        for attempt in range(self.max_retries):
            try:
                return self._load(idx)
            except Exception as e:  # pragma: no cover - corrupt-file path
                log.warning("sample %s failed (%s); substituting", self.files[idx], e)
                idx = rng.randrange(len(self.files))
        raise RuntimeError("too many corrupt samples")


def _pad_to(a: np.ndarray, length: int, axis: int = 0) -> np.ndarray:
    cur = a.shape[axis]
    if cur == length:
        return a
    if cur > length:
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(0, length)
        return a[tuple(sl)]
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, length - cur)
    return np.pad(a, pad)


def collate(samples: Sequence[Dict[str, np.ndarray]], pad: PadSpec) -> Dict[str, np.ndarray]:
    """Fixed-shape batch (reference collate pads to batch max,
    omnivideo_dataset_patched.py:96-234; we pad to config lengths)."""
    out: Dict[str, np.ndarray] = {}
    b0 = samples[0]

    if "text_emb" in b0:
        out["context"] = np.stack(
            [_pad_to(np.asarray(s["text_emb"], np.float32), pad.text_len) for s in samples]
        )
    if "vlm_last_hidden_states" in b0:
        vl = []
        for s in samples:
            v = np.asarray(s["vlm_last_hidden_states"], np.float32)
            if v.ndim == 3:
                v = v[0]
            vl.append(_pad_to(v, pad.vlm_len))
        out["vlm"] = np.stack(vl)
    if "aligned_emb" in b0:
        al = []
        for s_ in samples:
            a = np.asarray(s_["aligned_emb"], np.float32)
            if a.ndim == 3:
                a = a[0]
            al.append(_pad_to(a, pad.aligned_len))
        out["aligned_emb"] = np.stack(al)
    key = "latent_feature_tgt" if "latent_feature_tgt" in b0 else "latent_feature"
    out["latents"] = np.stack(
        [_pad_to(np.asarray(s[key], np.float32), pad.latent_frames, axis=1) for s in samples]
    )
    if "latent_feature_tgt" in b0 and "latent_feature" in b0:
        out["visual_emb"] = np.stack(
            [
                _pad_to(np.asarray(s["latent_feature"], np.float32), pad.latent_frames, axis=1)
                for s in samples
            ]
        )
    return out


def data_loader(
    dataset: OmniVideoDataset,
    batch_size: int,
    pad: PadSpec,
    seed: int = 0,
    host_id: int = 0,
    num_hosts: int = 1,
    epochs: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Host-sharded, seeded-permutation loader (reference DistributedSampler,
    omnivideo_dataset_patched.py:235)."""
    epoch = 0
    while epochs is None or epoch < epochs:
        rng = np.random.default_rng(seed + epoch)
        order = rng.permutation(len(dataset))
        order = order[host_id::num_hosts]
        for i in range(0, len(order) - batch_size + 1, batch_size):
            idxs = order[i : i + batch_size]
            yield collate([dataset[int(j)] for j in idxs], pad)
        epoch += 1


def make_dummy_dataset(
    root: str,
    n: int = 8,
    text_len: int = 24,
    vlm_len: int = 16,
    latent_shape=(16, 3, 8, 8),
    text_dim: int = 4096,
    vlm_dim: int = 2048,
    seed: int = 0,
    with_source: bool = True,
    with_aligned: bool = False,
    aligned_len: int = 8,
):
    """Fabricate feature fixtures with reference-compatible keys/shapes
    (role of create_dummy_dataset, omnivideo_dataset_patched.py:277-321)."""
    rng = np.random.default_rng(seed)
    rootp = Path(root)
    rootp.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        sample = {
            "text_emb": rng.standard_normal((text_len, text_dim)).astype(np.float32),
            "vlm_last_hidden_states": rng.standard_normal((1, vlm_len, vlm_dim)).astype(
                np.float32
            ),
            "latent_feature": rng.standard_normal(latent_shape).astype(np.float32),
            "prompt": f"dummy prompt {i}",
        }
        if with_source:
            sample["latent_feature_tgt"] = rng.standard_normal(latent_shape).astype(
                np.float32
            )
        if with_aligned:
            sample["aligned_emb"] = rng.standard_normal(
                (aligned_len, text_dim)
            ).astype(np.float32)
        np.savez_compressed(rootp / f"sample_{i:05d}.npz", **sample)
    return rootp


class PrefetchLoader:
    """Background-thread prefetching wrapper (role of dataloader workers /
    decord's async decode): decodes + collates the next batches while the
    device runs the current step. IO and npz decompression release the GIL,
    so a thread suffices; `depth` bounds host memory.
    """

    def __init__(self, iterator: Iterator, depth: int = 2):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()

        def worker():
            try:
                for item in iterator:
                    self._q.put(item)
            finally:
                self._q.put(self._done)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
