"""torch.export of the port's DiT denoise step (omnivideo_tpu_torch/tools/
export_aot.py) on the CPU, against the eager port and JAX's `wan_dit_apply`
on the same bf16 weights (JAX's init, bridged) and seeded numpy inputs.

- export → `save_program` → `torch.export.load` → call is bit-equal to the
  eager forward (the same plain twins run behind the registered ops), with
  the bf16 residual (qk_prep and flash ops) and the f32 residual (also the
  fused_adaln op: 3 a block and the head);
- the program holds `omnivideo::` ops as calls and no weights: its state
  dict is empty, the weights are its `params` input, and a fresh process
  that imports only `omnivideo_tpu_torch.ops` loads and runs it;
- the eager and loaded outputs are within 2e-2 of the scale of JAX's
  wan_dit_apply through its Pallas kernels in interpret mode (the bf16
  tolerance of tests/test_torch_wan_dit.py: single bf16 roundings flip and
  propagate through the blocks);
- the CLI writes the tiny program and `--load --check` calls it.
"""

import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.configs.base import WanDiTConfig as JaxDiTConfig
from omnivideo_tpu.models.wan_dit import init_wan_dit, wan_dit_apply
from omnivideo_tpu_torch.configs.base import WanDiTConfig
from omnivideo_tpu_torch.io.jax_bridge import load_wan_state_dict, wan_params_to_state_dict
from omnivideo_tpu_torch.models.wan_dit import WanDiT
from omnivideo_tpu_torch.tools import export_aot

jax_fa = importlib.import_module("omnivideo_tpu.ops.fused_adaln")

# head_dim 128 and dim % 128 == 0: the fused qk_prep prologue and the fused
# AdaLN sandwich both run, so all three registered ops are in the program
DIT = dict(patch_size=(1, 2, 2), text_len=16, in_dim=4, dim=256, ffn_dim=512, freq_dim=32,
           text_dim=48, out_dim=4, num_heads=2, num_layers=2)
BF16_TOL = 2e-2
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    p = init_wan_dit(jax.random.PRNGKey(0), JaxDiTConfig(**DIT), dtype=jnp.bfloat16)
    p["head"]["head"]["kernel"] = jnp.asarray(
        0.1 * np.random.default_rng(1).standard_normal(p["head"]["head"]["kernel"].shape),
        jnp.float32)
    dit = WanDiT(WanDiTConfig(**DIT), dtype=torch.bfloat16, device="cpu")
    load_wan_state_dict(dit, wan_params_to_state_dict(
        jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), p)))
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((2, 4, 3, 8, 8)), dtype=torch.bfloat16)
    t = torch.tensor([937.0, 41.0])
    ctx = torch.tensor(rng.standard_normal((2, 16, 48)), dtype=torch.bfloat16)
    return p, dit, (x, t, ctx)


def _ops(prog) -> dict:
    out = {}
    for n in prog.graph.nodes:
        if n.op == "call_function" and str(n.target).startswith("omnivideo."):
            out[str(n.target)] = out.get(str(n.target), 0) + 1
    return out


@pytest.fixture(scope="module")
def programs(setup, tmp_path_factory):
    _, dit, (x, t, ctx) = setup
    d = tmp_path_factory.mktemp("pt2")
    out = {}
    for name in ("bfloat16", "float32"):
        prog = export_aot.export_denoise(dit, x, t, ctx, getattr(torch, name))
        path = d / f"dit_{name}.pt2"
        nbytes = export_aot.save_program(prog, path)
        out[name] = (prog, path, nbytes)
    return out


@pytest.mark.parametrize("residual,fused_adaln", [("bfloat16", 0), ("float32", 7)])
def test_loaded_program_equals_eager_and_holds_the_ops(monkeypatch, setup, programs, residual,
                                                       fused_adaln):
    p, dit, (x, t, ctx) = setup
    prog, path, nbytes = programs[residual]
    assert _ops(prog) == {"omnivideo.qk_prep.default": 8,
                          "omnivideo.flash_attention.default": 4,
                          **({"omnivideo.fused_adaln.default": fused_adaln}
                             if fused_adaln else {})}
    assert len(prog.state_dict) == 0 and nbytes < 2_000_000  # 2.2M bf16 weights ≈ 4.4 MB
    loaded = torch.export.load(str(path))
    rdt = getattr(torch, residual)
    with torch.no_grad():
        eager = dit(x, t, ctx, residual_dtype=rdt, qk_impl="kernel",
                    ew_impl=export_aot.ew_impl_for(rdt))
        got = loaded.module()(export_aot.dit_params(dit), x, t, ctx)
    assert got.dtype == torch.float32 and got.shape == (2, 4, 3, 8, 8)
    assert torch.equal(got, eager)

    monkeypatch.setattr(jax_fa, "_INTERPRET", True)
    ref = np.asarray(wan_dit_apply(
        p, JaxDiTConfig(**DIT), jnp.asarray(x.float().numpy()), jnp.asarray(t.numpy()),
        jnp.asarray(ctx.float().numpy()), attn_impl="pallas_interpret",
        qk_impl="pallas_interpret", ew_impl="pallas" if fused_adaln else "xla",
        residual_dtype=jnp.bfloat16 if residual == "bfloat16" else None))
    rel = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert rel < BF16_TOL, rel


def test_program_loads_with_only_the_ops_import(setup, programs, tmp_path):
    """A fresh process imports torch and omnivideo_tpu_torch.ops alone (no
    model code), loads the program and reproduces the eager output."""
    _, dit, (x, t, ctx) = setup
    _, path, _ = programs["bfloat16"]
    with torch.no_grad():
        want = dit(x, t, ctx, residual_dtype=torch.bfloat16)
    torch.save({"params": export_aot.dit_params(dit), "x": x, "t": t, "ctx": ctx, "want": want},
               tmp_path / "io.pt")
    code = (
        "import sys, torch\n"
        "import omnivideo_tpu_torch.ops\n"
        f"io = torch.load({str(tmp_path / 'io.pt')!r}, weights_only=True)\n"
        f"prog = torch.export.load({str(path)!r})\n"
        "got = prog.module()(io['params'], io['x'], io['t'], io['ctx'])\n"
        "assert torch.equal(got, io['want'])\n"
        "mods = [m for m in sys.modules if m.startswith(('omnivideo_tpu_torch.models',"
        " 'omnivideo_tpu_torch.pipelines', 'jax', 'omnivideo_tpu.'))]\n"
        "print('MODS', mods)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "MODS []" in res.stdout, res.stdout


def test_cli_export_then_load_check(tmp_path, capsys):
    out = tmp_path / "tiny.pt2"
    assert export_aot.main(["--tiny", "--device", "cpu", "--out", str(out)]) is None
    assert out.exists() and "exported" in capsys.readouterr().out
    y = export_aot.main(["--tiny", "--device", "cpu", "--load", str(out), "--check"])
    assert y.shape == (2, 16, 3, 4, 8) and bool(torch.isfinite(y).all())
    assert "program call OK" in capsys.readouterr().out
