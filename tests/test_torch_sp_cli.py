"""The generate CLI over 4 gloo ranks on the CPU, `--tiny` T2V-1.3B, f32
residual, two JSONL rows, against the single-process CLI. One spawn runs
every mesh in turn:
- `--sp_size 4 --sp_mode ring --ring_impl pallas`: rank 0 alone writes the
  frames, within 2 uint8 levels of the single process's (measured: equal;
  bf16 weights, so a bf16 rounding may flip with the summation order of
  the sharded attention); every rank runs both rows (the mesh's data size
  is 1, so SP ranks never split rows);
- `--fsdp_size 2 --tp_size 2` (FSDP2 and the Megatron split), `--fsdp_size
  2 --sp_size 2 --sp_mode hybrid` and `--fsdp_size 4`: frames within 1
  uint8 level and latents within 1e-4 of their scale (row-parallel sums of
  bf16 partial products in another order).
Both sides hide Pillow and imageio, so `save_video` writes the exact
frames as `<id>.npz` (its last resort) rather than as JPEG frames in an
AVI. Also: `--dp_rank/--dp_world_size` give a run its share of the rows
with their seeds; and the flags that raise: the hybrid without
`--fsdp_size`, `--sp_size` with `--tp_size`, and --sp_size without the
processes.
"""

import json
import sys

import numpy as np
import pytest
import torch

from omnivideo_tpu_torch.tools import generate
from torch_sp_workers import WORLD, cli_runs_worker, load, spawn

ARGS = ["--task", "t2v-1.3B", "--tiny", "--random_weights", "--device", "cpu",
        "--residual_dtype", "float32"]
ROWS = [{"sample_id": "a", "prompt": "a red kite"}, {"sample_id": "b", "prompt": "a blue boat"}]
MESHES = {"fsdp2_tp2": ["--fsdp_size", "2", "--tp_size", "2"],
          "fsdp2_sp2_hybrid": ["--fsdp_size", "2", "--sp_size", "2", "--sp_mode", "hybrid"],
          "fsdp4": ["--fsdp_size", "4"]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's CLI run in one spawn, and the single-process run."""
    tmp = tmp_path_factory.mktemp("sp_cli")
    rows = tmp / "in.jsonl"
    rows.write_text("".join(json.dumps(r) + "\n" for r in ROWS))
    base = ARGS + ["--input", str(rows)]
    mesh_runs = [("sp", base + ["--output_dir", str(tmp / "sp"), "--sp_size", str(WORLD),
                                "--sp_mode", "ring", "--ring_impl", "pallas"])]
    mesh_runs += [(name, base + ["--output_dir", str(tmp / name)] + flags)
                  for name, flags in MESHES.items()]
    spawn(cli_runs_worker, tmp, mesh_runs)
    hidden = {m: sys.modules.get(m) for m in ("PIL", "imageio")}
    sys.modules.update(PIL=None, imageio=None)
    try:
        ref = generate.run(generate.parse_args(base + ["--output_dir", str(tmp / "ref")]))
    finally:
        for m, mod in hidden.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
    return tmp, {r["id"]: r["latents"].numpy() for r in ref}, load(tmp, "cli_latents")


def _frames(d, sample_id):
    return np.load(d / f"{sample_id}.npz")["frames"].astype(np.int32)


def test_sp_cli_matches_single_process(runs):
    tmp, _, _ = runs
    sp_dir, ref_dir = tmp / "sp", tmp / "ref"
    assert sorted(p.name for p in sp_dir.iterdir()) == ["a.npz", "b.npz"]
    for sample_id in ("a", "b"):
        got, ref = _frames(sp_dir, sample_id), _frames(ref_dir, sample_id)
        assert got.shape == ref.shape == (9, 32, 64, 3)
        diff = np.abs(got - ref)
        assert diff.max() <= 2 and diff.mean() < 0.05, (diff.max(), diff.mean())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_cli_matches_single_process(runs, mesh):
    tmp, ref_lat, lat = runs
    for sample_id in ("a", "b"):
        ref = ref_lat[sample_id]
        got = lat[f"{mesh}/{sample_id}"]
        assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4, mesh
        diff = np.abs(_frames(tmp / mesh, sample_id) - _frames(tmp / "ref", sample_id))
        assert diff.max() <= 1, (mesh, diff.max())


def test_dp_split_takes_its_rows_and_seeds(runs, monkeypatch):
    """--dp_rank 1 --dp_world_size 2 generates row 1 alone, as the full run
    does (seed base_seed + 1)."""
    tmp, ref_lat, _ = runs
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    out = generate.run(generate.parse_args(ARGS + [
        "--input", str(tmp / "in.jsonl"), "--output_dir", str(tmp / "dp1"), "--dp_rank", "1",
        "--dp_world_size", "2"]))
    assert [r["id"] for r in out] == ["b"]
    np.testing.assert_array_equal(out[0]["latents"].numpy(), ref_lat["b"])
    assert sorted(p.name for p in (tmp / "dp1").iterdir()) == ["b.npz"]


@pytest.mark.parametrize("flags,match", [
    (["--sp_size", "2", "--sp_mode", "hybrid"], "fsdp"),
    (["--sp_size", "2", "--tp_size", "2"], "exclude"),
    (["--vlm_fsdp", "64"], "multiple of 8"),
])
def test_unported_parallel_flags_raise(flags, match, capsys, tmp_path):
    """Combinations the CLI refuses; `--vlm_fsdp 64` at Qwen3-VL-30B-A3B's
    config (its experts' 768 columns would leave 12 a rank, which the
    grouped products do not take) is refused before any process group or
    weight is needed (the dir holds the config.json alone)."""
    from omnivideo_tpu_torch.configs.qwen3vl import QWEN3_VL_30B_A3B
    from torch_io_tiny import hf_config_dict

    (tmp_path / "config.json").write_text(json.dumps(hf_config_dict(QWEN3_VL_30B_A3B)))
    argv = ARGS + ["--input", "x.jsonl", "--vlm_path", str(tmp_path), "--output_dir",
                   str(tmp_path)] + flags
    with pytest.raises((ValueError, SystemExit)) as err:
        generate.run(generate.parse_args(argv))
    assert match in str(err.value) + capsys.readouterr().err


def test_sp_size_without_processes_raises(monkeypatch, tmp_path):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="needs 2 processes"):
        generate.main(ARGS + ["--input", "x.jsonl", "--output_dir", str(tmp_path),
                              "--sp_size", "2"])
