"""The generate CLI sequence-parallel over 4 gloo ranks on the CPU: `--tiny`
T2V-1.3B, `--sp_size 4 --sp_mode ring --ring_impl pallas`, f32 residual. Rank
0 alone writes the frames, which match the single-process CLI's within 2
uint8 levels (measured: equal; bf16 weights, so a bf16 rounding may flip
with the summation order of the sharded attention). Also the
flags that raise: the hybrid mode (its Ulysses axis is 'fsdp'), --tp_size,
--fsdp_size, and --sp_size without the processes.
"""

import json

import numpy as np
import pytest
import torch

from omnivideo_tpu_torch.tools import generate
from torch_sp_workers import WORLD, cli_worker, spawn

ARGS = ["--task", "t2v-1.3B", "--tiny", "--random_weights", "--device", "cpu",
        "--residual_dtype", "float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sp_cli_matches_single_process(tmp_path):
    rows = tmp_path / "in.jsonl"
    rows.write_text(json.dumps({"sample_id": "a", "prompt": "a red kite"}) + "\n")
    sp_dir, ref_dir = tmp_path / "sp", tmp_path / "ref"
    spawn(cli_worker, tmp_path, ARGS + ["--input", str(rows), "--output_dir", str(sp_dir),
                                        "--sp_size", str(WORLD), "--sp_mode", "ring",
                                        "--ring_impl", "pallas"])
    assert generate.main(ARGS + ["--input", str(rows), "--output_dir", str(ref_dir)]) == 0
    assert sorted(p.name for p in sp_dir.iterdir()) == ["a.npz"]
    got, ref = (np.load(d / "a.npz")["frames"].astype(np.int32) for d in (sp_dir, ref_dir))
    assert got.shape == ref.shape == (9, 32, 64, 3)
    diff = np.abs(got - ref)
    assert diff.max() <= 2 and diff.mean() < 0.05, (diff.max(), diff.mean())


@pytest.mark.parametrize("flags,match", [
    (["--sp_size", "2", "--sp_mode", "hybrid"], "fsdp"),
    (["--tp_size", "2"], "FSDP/TP slice"),
    (["--fsdp_size", "2"], "FSDP/TP slice"),
])
def test_unported_parallel_flags_raise(flags, match):
    with pytest.raises(NotImplementedError, match=match):
        generate.parse_args(ARGS + ["--input", "x.jsonl"] + flags)


def test_sp_size_without_processes_raises(monkeypatch, tmp_path):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="needs 2 processes"):
        generate.main(ARGS + ["--input", "x.jsonl", "--output_dir", str(tmp_path),
                              "--sp_size", "2"])
