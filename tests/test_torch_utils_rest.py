"""The rest of the port's utilities against the JAX package on the CPU:

- utils/metrics.py (torch f64 on the clip's device) against JAX's numpy
  f64 metrics: within 1e-10 relative (summation order only), and
  tools/eval_videos.py's report against JAX's tool on the same directory;
- schedulers/ddim.py and schedulers/continuous_ode.py against JAX's on the
  same schedules: tables bit-equal (f64 built, rounded to f32 once), every
  step, noise, target and weight within 1e-6 of scale (f32 products);
- utils/prompt_extend.py: the system prompt choice, the dispatch, the
  DashScope expander refusing without its package, and the Qwen expander
  over the port's engine giving JAX's expansion of a text prompt on a tiny
  checkpoint dir (greedy, token for token);
- tools/export_tokenizer.py writing JAX's tokenizer.json and its --check
  ids; utils/chaos.py driving the port's dataset retry path with JAX's
  faults and substitutions (the same seeded draws), and call faults;
  utils/misc.py's str2bool, masks_like and best_output_size.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_io_tiny import write_qwen3vl_hf_dir, write_spiece

from omnivideo_tpu.schedulers.continuous_ode import ContinuousODEScheduler as JaxODE
from omnivideo_tpu.schedulers.ddim import EnhancedDDIMScheduler as JaxDDIM
from omnivideo_tpu.training import dataset as j_dataset
from omnivideo_tpu.utils import chaos as j_chaos
from omnivideo_tpu.utils import metrics as j_metrics
from omnivideo_tpu.utils import misc as j_misc
from omnivideo_tpu.utils import prompt_extend as j_prompt
from omnivideo_tpu_torch.schedulers import ContinuousODEScheduler, EnhancedDDIMScheduler
from omnivideo_tpu_torch.tools import eval_videos, export_tokenizer
from omnivideo_tpu_torch.training import dataset
from omnivideo_tpu_torch.utils import chaos, metrics, misc, prompt_extend

REPO = Path(__file__).resolve().parents[1]
METRIC_TOL = 1e-10
SCHED_TOL = 1e-6


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(a, b, tol):
    if np.isinf(b):
        return a == b
    return abs(a - b) <= tol * max(abs(b), 1e-12)


def _clips():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (5, 21, 30, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-20, 21, a.shape), 0, 255).astype(np.uint8)
    return a, b


def test_metrics_equal_jax():
    a, b = _clips()
    got = metrics.evaluate_pair(torch.from_numpy(a), torch.from_numpy(b))
    ref = j_metrics.evaluate_pair(a, b)
    assert set(got) == set(ref)
    for k in ref:
        assert _close(got[k], ref[k], METRIC_TOL), (k, got[k], ref[k])
    assert metrics.evaluate_single(a) == pytest.approx(j_metrics.evaluate_single(a),
                                                       rel=METRIC_TOL)
    assert metrics.psnr(a, a) == float("inf") == j_metrics.psnr(a, a)
    assert metrics.ssim(a, a) == pytest.approx(1.0, abs=1e-12)
    assert metrics.ssim(a, b[:3]) == pytest.approx(j_metrics.ssim(a, b[:3]), rel=METRIC_TOL)
    assert metrics.temporal_consistency(a[:1]) == 1.0 and metrics.motion_magnitude(a[:1]) == 0.0
    f = a.astype(np.float32) / 255.0
    assert metrics.psnr(f, f * 0.9, data_range=1.0) == pytest.approx(
        j_metrics.psnr(f, f * 0.9, data_range=1.0), rel=METRIC_TOL)


def test_eval_videos_report_equals_jax(tmp_path, monkeypatch):
    a, b = _clips()
    gen, ref = tmp_path / "gen", tmp_path / "ref"
    gen.mkdir(), ref.mkdir()
    np.savez(gen / "s0.npz", frames=a, fps=16)
    np.savez(gen / "s1.npz", frames=b, fps=16)
    np.savez(ref / "s0.npz", frames=b, fps=16)  # s1 has no reference
    got = eval_videos.main(["--generated", str(gen), "--reference", str(ref), "--report",
                            str(tmp_path / "got.json"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["eval_videos", "--generated", str(gen), "--reference",
                                      str(ref), "--report", str(tmp_path / "ref.json")])
    _load_tool("eval_videos").main()
    want = json.loads((tmp_path / "ref.json").read_text())
    assert json.loads((tmp_path / "got.json").read_text()).keys() == want.keys()
    assert got["n"] == want["n"] == 2 and got["per_sample"].keys() == want["per_sample"].keys()
    for name, m in want["per_sample"].items():
        assert m.keys() == got["per_sample"][name].keys()
        for k, v in m.items():
            assert _close(got["per_sample"][name][k], v, METRIC_TOL)
    for k, v in want["summary"].items():
        assert _close(got["summary"][k], v, METRIC_TOL)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no videos"):
        eval_videos.main(["--generated", str(tmp_path / "empty"), "--device", "cpu"])


def _scale_close(got, ref, tol=SCHED_TOL):
    """Within tol of the finite values' scale; the same inf and nan where the
    schedule divides by zero (a zero-terminal-SNR ᾱ of 0 at t = 999)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(got[~fin], ref[~fin])
    if fin.any():
        assert np.abs(got[fin] - ref[fin]).max() <= tol * max(np.abs(ref[fin]).max(), 1e-12)


@pytest.mark.parametrize("kw", [
    {}, {"prediction_type": "v_prediction", "num_inference_steps": 7},
    {"beta_schedule": "linear", "rescale_zero_terminal_snr": True, "num_inference_steps": 5},
    {"num_inference_steps": 4, "denoising_strength": 0.6}, {"num_inference_steps": 1},
])
def test_ddim_equals_jax(kw):
    s, j = EnhancedDDIMScheduler.create(**kw), JaxDDIM.create(**kw)
    np.testing.assert_array_equal(s.alphas_cumprod.numpy(), np.asarray(j.alphas_cumprod))
    np.testing.assert_array_equal(s.timesteps.numpy(), np.asarray(j.timesteps))
    rng = np.random.default_rng(1)
    x, eps, x0 = (rng.standard_normal((2, 4, 3, 5)).astype(np.float32) for _ in range(3))
    tx, te, t0 = (torch.from_numpy(v) for v in (x, eps, x0))
    for t in list(np.asarray(j.timesteps)) + [511.0]:
        for final in (False, True):
            _scale_close(s.step(te, t, tx, to_final=final), j.step(eps, t, x, to_final=final))
        _scale_close(s.add_noise(t0, te, t), j.add_noise(x0, eps, t))
        _scale_close(s.training_target(t0, te, t), j.training_target(x0, eps, t))
        if t < 999:
            _scale_close(s.return_to_timestep(t, tx, t0), j.return_to_timestep(t, x, x0))
    assert float(s.training_weight(3)) == float(j.training_weight(3)) == 1.0
    s2, j2 = s.set_timesteps(3, 0.5), j.set_timesteps(3, 0.5)
    np.testing.assert_array_equal(s2.timesteps.numpy(), np.asarray(j2.timesteps))


@pytest.mark.parametrize("kw", [{}, {"num_inference_steps": 12, "rho": 5.0},
                                {"num_inference_steps": 6, "denoising_strength": 0.5,
                                 "sigma_max": 80.0}])
def test_continuous_ode_equals_jax(kw):
    s, j = ContinuousODEScheduler.create(**kw), JaxODE.create(**kw)
    np.testing.assert_array_equal(s.sigmas.numpy(), np.asarray(j.sigmas))
    np.testing.assert_array_equal(s.timesteps.numpy(), np.asarray(j.timesteps))
    rng = np.random.default_rng(2)
    x, out, x0 = (rng.standard_normal((3, 8)).astype(np.float32) for _ in range(3))
    tx, to, t0 = (torch.from_numpy(v) for v in (x, out, x0))
    for t in np.asarray(j.timesteps)[:: max(1, len(j.timesteps) // 5)].tolist() + [
            float(np.asarray(j.timesteps)[-1])]:
        for final in (False, True):
            _scale_close(s.step(to, t, tx, to_final=final), j.step(out, t, x, to_final=final))
        _scale_close(s.add_noise(t0, to, t), j.add_noise(x0, out, t))
        _scale_close(s.training_target(t0, to, t), j.training_target(x0, out, t))
        _scale_close(s.training_weight(t), j.training_weight(t))


def test_prompt_expander_base_equals_jax(tmp_path):
    prompts = {"t2v-1.3B": {"en": "short en", "zh": "短"}, "t2v-A14B": {"en": "big"}}
    f = tmp_path / "p.json"
    f.write_text(json.dumps(prompts))
    for task in ("t2v-1.3B", "t2v-A14B", "other"):
        for lang in ("en", "zh", "fr"):
            kw = dict(task=task, system_prompt_file=str(f))
            assert (prompt_extend.PromptExpander(**kw).decide_system_prompt(lang)
                    == j_prompt.PromptExpander(**kw).decide_system_prompt(lang))
            assert (prompt_extend.PromptExpander(task=task).decide_system_prompt(lang)
                    == j_prompt.PromptExpander(task=task).decide_system_prompt(lang))
    assert prompt_extend.DEFAULT_EXPAND_SYS_PROMPT == j_prompt.DEFAULT_EXPAND_SYS_PROMPT
    with pytest.raises(NotImplementedError):
        prompt_extend.PromptExpander()("a fox", seed=1)
    with pytest.raises(NotImplementedError):
        prompt_extend.PromptExpander(is_vl=True)("a fox", seed=1)
    out = prompt_extend.PromptOutput(True, "p", 1, "s", "m")
    out.add_custom_field("extra", 2)
    assert out.extra == 2
    with pytest.raises(RuntimeError, match="dashscope is not installed"):
        prompt_extend.DashScopePromptExpander(api_key="k")


def test_qwen_prompt_expander_equals_jax(tmp_path):
    d = write_qwen3vl_hf_dir(tmp_path / "hf", transformers=False)
    ours = prompt_extend.QwenPromptExpander(model_name=str(d), max_new_tokens=6, device="cpu")
    theirs = j_prompt.QwenPromptExpander(model_name=str(d), max_new_tokens=6)
    for text in ("tok1 tok2 yes", "no tok7"):
        got = ours(text, system_prompt="tok3 tok4", seed=5)
        ref = theirs(text, system_prompt="tok3 tok4", seed=5)
        assert (got.status, got.prompt, got.seed, got.message) == (
            ref.status, ref.prompt, ref.seed, ref.message) and got.status
    img = np.random.default_rng(3).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    vl = prompt_extend.QwenPromptExpander(model_name=str(d), max_new_tokens=6, device="cpu",
                                          is_vl=True)
    out = vl("tok1", system_prompt="tok3", image=img, seed=2)
    assert out.status and isinstance(out.prompt, str)
    bad = vl.extend_with_img("tok1", "tok3", image=np.zeros((4, 4), np.uint8))
    assert not bad.status and bad.prompt == "tok1"


def test_export_tokenizer_equals_jax(tmp_path, monkeypatch, capsys):
    d = write_spiece(tmp_path / "sp")
    ids = export_tokenizer.main(["--dir", str(d), "--out", str(tmp_path / "ours.json"),
                                 "--check"])
    assert "ids:" in capsys.readouterr().out and len(ids) > 3
    monkeypatch.setattr(sys, "argv", ["export_tokenizer", "--spiece", str(d / "spiece.model"),
                                      "--out", str(tmp_path / "theirs.json")])
    _load_tool("export_tokenizer").main()
    assert (json.loads((tmp_path / "ours.json").read_text())
            == json.loads((tmp_path / "theirs.json").read_text()))
    from tokenizers import Tokenizer

    assert ids == Tokenizer.from_file(str(tmp_path / "theirs.json")).encode(
        export_tokenizer.SAMPLE).ids
    with pytest.raises(FileNotFoundError):
        export_tokenizer.main(["--dir", str(tmp_path)])


def test_chaos_drives_the_dataset_retry_path_as_jax(tmp_path):
    root = dataset.make_dummy_dataset(tmp_path / "d", n=6, text_len=4, vlm_len=4,
                                      latent_shape=(4, 2, 4, 4), text_dim=8, vlm_dim=8)
    got, ref = [], []
    for ds_mod, ch, out in ((dataset, chaos, got), (j_dataset, j_chaos, ref)):
        ds = ds_mod.OmniVideoDataset(str(root))
        with ch.inject_io_faults(rate=0.4, seed=3, match="*.npz") as inj:
            out.extend(ds[i] for i in range(len(ds)))
        out.append(inj.injected)
    assert got[-1] == ref[-1] > 0  # the same faults fired
    for a, b in zip(got[:-1], ref[:-1]):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)

    class Saver:
        saved = 0

        def save(self):
            self.saved += 1

    counts = []
    for ch in (chaos, j_chaos):
        s, failures = Saver(), 0
        with ch.inject_call_faults(s, "save", rate=0.5, seed=1) as inj:
            for _ in range(20):
                try:
                    s.save()
                except RuntimeError:
                    failures += 1
        s.save()
        counts.append((failures, inj.injected, s.saved))
    assert counts[0] == counts[1] and counts[0][0] > 0


def test_misc_equals_jax():
    for v in (True, False, "yes", "T", "0", "n", "1"):
        assert misc.str2bool(v) == j_misc.str2bool(v)
    with pytest.raises(Exception, match="boolean value expected"):
        misc.str2bool("maybe")
    for z in (False, True):
        np.testing.assert_array_equal(
            misc.masks_like((2, 3, 4, 5), z, device="cpu").numpy(),
            np.asarray(j_misc.masks_like((2, 3, 4, 5), z)))
    for args in ((1280, 720, 16, 16, 832 * 480), (480, 832, 32, 32, 1280 * 720),
                 (1000, 1000, 8, 8, 640 * 640), (3, 1, 16, 16, 99999)):
        assert misc.best_output_size(*args) == j_misc.best_output_size(*args)
