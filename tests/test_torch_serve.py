"""The port's HTTP server (omnivideo_tpu_torch/tools/serve.py) on the CPU at
the JAX tool's tiny widths (dim 64, 2 layers, 64x32x9, 2 steps).

- `Server.handle_generate` on a pipeline bridged from JAX's random init
  (f32 weights and residual, a non-zero head; the port's seeded VAE handed
  to JAX) writes the frames of JAX `OmniVideoX2XUnified.generate` with the
  same context, a zero negative, the same seed and the same noise (JAX's
  draw for the seed, handed to the port as tests/test_torch_x2x.py does):
  within 1 uint8 level (the decoded videos agree to 1e-4 there);
- with the serving default (bf16 weights and residual) its frames are bit
  for bit those of the pipeline's own `generate` with a generator seeded
  from the request;
- the client-id guard, a prompt request (the negative left to `generate`),
  `--once`, and the HTTP round trip on port 0 (a malformed body gets a 500
  and the server keeps answering); `--max_steps_per_call` is refused.
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import HTTPServer
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.configs import WAN_CONFIGS as JAX_CONFIGS
from omnivideo_tpu.models.vae2_1 import Wan21VAE as JaxVAE
from omnivideo_tpu.pipelines.x2x import OmniVideoX2XUnified as JaxPipe
from omnivideo_tpu.utils.video import _to_uint8
from omnivideo_tpu_torch.configs.prompts import SAMPLE_NEG_PROMPT_EN
from omnivideo_tpu_torch.io.jax_bridge import pipeline_from_jax
from omnivideo_tpu_torch.models.vae2_1 import Wan21VAE, init_vae
from omnivideo_tpu_torch.tools import serve

SIZE, FRAMES, STEPS, SEED, GUIDE = (64, 32), 9, 2, 5, 4.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(tmp, **kw):
    base = dict(task="t2v-1.3B", tiny=True, device="cpu", output_dir=str(tmp), vae_dtype=None,
                residual_dtype="bfloat16", random_weights=True, ckpt_dir=None, once=None,
                max_steps_per_call=None)
    return SimpleNamespace(**{**base, **kw})


def _request(**kw):
    ctx = np.random.default_rng(3).standard_normal((10, 48)).astype(np.float32)
    return {"context": ctx.tolist(), "size": list(SIZE), "frame_num": FRAMES,
            "sampling_steps": STEPS, "seed": SEED, "guide_scale": GUIDE, **kw}


class _Written:
    """The frames `serve.save_video` gets (before the lossy writer)."""

    def __init__(self, monkeypatch):
        self.frames = {}
        real = serve.save_video

        def capture(path, video, **kw):
            self.frames[Path(path).stem] = torch.as_tensor(video).numpy()
            return real(path, video, **kw)

        monkeypatch.setattr(serve, "save_video", capture)


@pytest.fixture(scope="module")
def jax_and_port():
    """JAX's tiny serving pipeline in f32 (weights and residual) and the
    port's from the same weights."""
    jcfg = JAX_CONFIGS["t2v-1.3B"]
    jcfg = jcfg.replace(
        dit=jcfg.dit.replace(dim=64, ffn_dim=128, num_heads=4, num_layers=2, freq_dim=32,
                             text_dim=48),
        vae=jcfg.vae.__class__(dim=8, z_dim=16, num_res_blocks=1), max_context_len=64,
        param_dtype="float32")
    jpipe = JaxPipe.random_init(jcfg, seed=0, with_vae=False, attn_impl="xla")
    head = jpipe.low_noise.wan["head"]["head"]
    head["kernel"] = jnp.asarray(
        0.1 * np.random.default_rng(1).standard_normal(head["kernel"].shape), jnp.float32)
    cfg = serve.task_config("t2v-1.3B", tiny=True).replace(param_dtype="float32")
    vae_params = init_vae(cfg.vae, device="cpu", generator=torch.Generator().manual_seed(0))
    jpipe.vae = JaxVAE.create(jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()),
                                                     vae_params), jcfg.vae)
    tpipe = pipeline_from_jax(cfg, jpipe.low_noise, device="cpu", residual_dtype="float32",
                              ew_impl="kernel")
    tpipe.vae = Wan21VAE.create(vae_params, cfg.vae)
    return jpipe, tpipe


def test_served_frames_match_jax_generate(jax_and_port, tmp_path, monkeypatch):
    jpipe, tpipe = jax_and_port
    req = _request(id="parity")
    shape = tpipe._latent_shape(SIZE, FRAMES)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(SEED), shape, jnp.float32))[None]
    real = tpipe.generate

    def with_jax_noise(generator=None, **kw):  # the request's seed, drawn as JAX draws it
        assert generator.initial_seed() == SEED
        return real(noise=torch.tensor(noise), **kw)

    monkeypatch.setattr(tpipe, "generate", with_jax_noise)
    written = _Written(monkeypatch)
    out = serve.Server(_args(tmp_path, residual_dtype="float32"), pipe=tpipe).handle_generate(req)
    assert out["id"] == out["file_id"] == "parity" and Path(out["path"]).exists()
    ctx = jnp.asarray(np.asarray(req["context"], np.float32))
    ref = _to_uint8(np.asarray(jpipe.generate(
        precomputed_context=ctx, precomputed_context_null=jnp.zeros_like(ctx), size=SIZE,
        frame_num=FRAMES, sampling_steps=STEPS, guide_scale=GUIDE, seed=SEED)))
    got = written.frames["parity"]
    assert got.shape == ref.shape == (FRAMES, SIZE[1], SIZE[0], 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert got.std() > 1.0  # not a flat clip


@pytest.fixture(scope="module")
def tiny_server(tmp_path_factory):
    return serve.Server(_args(tmp_path_factory.mktemp("serve")))


def test_bf16_serving_equals_direct_generate(tiny_server, monkeypatch):
    written = _Written(monkeypatch)
    out = tiny_server.handle_generate(_request(id="direct"))
    ctx = torch.tensor(np.asarray(_request()["context"], np.float32))
    want = tiny_server.pipe.generate(
        precomputed_context=ctx, precomputed_context_null=torch.zeros_like(ctx), size=SIZE,
        frame_num=FRAMES, sampling_steps=STEPS, guide_scale=GUIDE,
        generator=torch.Generator().manual_seed(SEED), output_uint8=True)
    assert out["latency_s"] >= 0 and tiny_server.pipe.residual_dtype == torch.bfloat16
    np.testing.assert_array_equal(written.frames["direct"], want.numpy())


@pytest.mark.parametrize("client_id,kept", [("clip_01-a", True), ("../../evil", False),
                                            ("", False), ("a" * 65, False), ("x y", False)])
def test_client_id_names_the_file_only_when_plain(tiny_server, client_id, kept):
    out = tiny_server.handle_generate(_request(id=client_id, frame_num=1, sampling_steps=1))
    path = Path(out["path"])
    assert out["id"] == (client_id or out["file_id"])
    assert (out["file_id"] == client_id) is kept
    assert path.parent.resolve() == tiny_server.outdir.resolve() and path.exists()


def test_prompt_needs_an_encoder_and_leaves_the_negative_to_generate(tiny_server,
                                                                     monkeypatch):
    with pytest.raises(ValueError, match="no text encoder"):
        tiny_server.handle_generate({"prompt": "a fox", "frame_num": 1, "sampling_steps": 1,
                                     "size": list(SIZE)})
    seen = []

    def encoder(texts):
        seen.extend(texts)
        return [torch.ones(7, 48) * len(seen)]

    monkeypatch.setattr(tiny_server.pipe, "text_encoder", encoder)
    tiny_server.handle_generate({"prompt": "a fox", "frame_num": 1, "sampling_steps": 1,
                                 "size": list(SIZE)})
    assert seen == ["a fox", SAMPLE_NEG_PROMPT_EN]


def test_once_writes_one_clip(tmp_path, capsys):
    req = tmp_path / "req.json"
    req.write_text(json.dumps(_request(id="once", frame_num=5)))
    serve.main(["--random_weights", "--tiny", "--device", "cpu", "--once", str(req),
                "--output_dir", str(tmp_path / "out")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["file_id"] == "once" and Path(out["path"]).exists()
    with pytest.raises(NotImplementedError, match="max_steps_per_call"):
        serve.parse_args(["--random_weights", "--max_steps_per_call", "4"])


def _call(url, body=None):
    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_round_trip(tiny_server):
    httpd = HTTPServer(("127.0.0.1", 0), serve.make_handler(tiny_server))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert _call(base + "/healthz") == (200, {"status": "ok", "backend": "cpu",
                                                  "task": "t2v-1.3B"})
        code, out = _call(base + "/generate",
                          json.dumps(_request(id="http", frame_num=1)).encode())
        assert code == 200 and out["file_id"] == "http" and Path(out["path"]).exists()
        code, out = _call(base + "/generate", b"{not json")
        assert code == 500 and "error" in out
        assert _call(base + "/healthz")[0] == 200
        assert _call(base + "/nowhere")[0] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
