"""The port's block streaming (omnivideo_tpu_torch/pipelines/streaming.py)
on the CPU: against the port's resident WanDiT.forward (exact: the same
block code on the same tensors) and against JAX's `wan_dit_stream_apply`
and streamed pipeline (JAX's own tolerances, tests/test_streaming.py:
2e-5 for the forward, rtol 2e-4 / atol 2e-5 for a 3-step generate), with
the same weights bridged by io/jax_bridge.py.

The int8 streamed forward runs bf16 blocks; JAX's bf16 matmuls on the CPU
round in another order than torch's, so the two packages' bf16 forwards
differ by ~1e-3 of the output's scale with the same weights (measured
1.1e-3 unquantised, 1.3e-3 int8, against 2.3e-3 between int8 and
unquantised): the port's int8 output is held to JAX's within INT8_TOL."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.configs.base import PipelineConfig as JaxPipelineConfig
from omnivideo_tpu.configs.base import VAEConfig as JaxVAEConfig
from omnivideo_tpu.configs.base import WanDiTConfig as JaxDiTConfig
from omnivideo_tpu.models.wan_dit import init_wan_dit
from omnivideo_tpu.pipelines import streaming as jstream
from omnivideo_tpu.pipelines.x2x import OmniVideoX2XUnified as JaxPipe
from omnivideo_tpu_torch.configs.base import PipelineConfig, VAEConfig, WanDiTConfig
from omnivideo_tpu_torch.io.jax_bridge import (load_wan_state_dict, pipeline_from_jax,
                                               wan_params_to_state_dict)
from omnivideo_tpu_torch.models.wan_dit import WanDiT
from omnivideo_tpu_torch.ops.quant import Q8
from omnivideo_tpu_torch.pipelines import streaming
from omnivideo_tpu_torch.pipelines.x2x import OmniVideoX2XUnified

DIT = dict(patch_size=(1, 2, 2), text_len=16, in_dim=4, dim=64, ffn_dim=128, freq_dim=32,
           text_dim=48, out_dim=4, num_heads=4, num_layers=3)
TOL = 2e-5
INT8_TOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_params(dtype=jnp.float32):
    params = init_wan_dit(jax.random.PRNGKey(0), JaxDiTConfig(**DIT), dtype=dtype)
    params["head"]["head"]["kernel"] = jax.random.normal(
        jax.random.PRNGKey(9), params["head"]["head"]["kernel"].shape) * 0.05
    return params


def _port(params, dtype=torch.float32) -> WanDiT:
    wan = WanDiT(WanDiTConfig(**DIT), dtype=dtype, device="cpu")
    return load_wan_state_dict(wan, wan_params_to_state_dict(np_tree(params)))


def _inputs():
    x = jax.random.normal(jax.random.PRNGKey(1), (1, 4, 4, 8, 8))
    t = jnp.array([500.0])
    ctx = jax.random.normal(jax.random.PRNGKey(2), (1, 16, 48))
    return (x, t, ctx), tuple(torch.from_numpy(np.array(a)) for a in (x, t, ctx))


@pytest.fixture(scope="module")
def f32():
    """(JAX params, JAX streamed outputs {seq_len: out}, port resident
    outputs {seq_len: out}, the port module split to host, its blocks)."""
    params = _jax_params()
    (jx, jt, jc), (x, t, c) = _inputs()
    resident, blocks = jstream.split_host_params(params)
    jcfg = JaxDiTConfig(**DIT)
    ex = jstream.BlockStreamingExecutor(jcfg, blocks, window=2, attn_impl="xla")
    jout = {L: np.asarray(jstream.wan_dit_stream_apply(resident, ex, jcfg, jx, jt, jc,
                                                       seq_len=L)) for L in (None, 80)}
    wan = _port(params)
    with torch.no_grad():
        ref = {L: wan(x, t, c, seq_len=L) for L in (None, 80)}
    wan, host = streaming.split_host_params(wan)
    return params, jout, ref, wan, host


def test_packer_round_trip_mixed_dtypes():
    g = torch.Generator().manual_seed(0)
    q = Q8(torch.randint(-127, 128, (6, 40), generator=g, dtype=torch.int8),
           torch.rand(6, generator=g), torch.bfloat16)
    block = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
             "g": torch.randn(5, generator=g).bfloat16(), "q": q,
             "nested.b": torch.full((2, 2), 7.0), "s": torch.tensor(0.25)}
    packer = streaming.BlockPacker(block)
    assert all(off % streaming.ALIGN == 0 for *_, off in packer.specs)
    back = packer.pack(block, pin=False).block()
    assert list(back) == list(block)
    for k, v in block.items():
        if isinstance(v, Q8):
            assert isinstance(back[k], Q8) and back[k].dtype == torch.bfloat16
            assert torch.equal(back[k].q8, v.q8) and torch.equal(back[k].scale, v.scale)
        else:
            assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


@pytest.mark.parametrize("window", [1, 2, 3])
@pytest.mark.parametrize("group", [1, 3])
def test_streamed_forward_matches_resident_and_jax(f32, window, group):
    _, jout, ref, wan, host = f32
    _, (x, t, c) = _inputs()
    ex = streaming.BlockStreamingExecutor(wan.cfg, host, window=window, group=group,
                                          device="cpu")
    with torch.no_grad():
        out = streaming.wan_dit_stream_apply(wan, ex, x, t, c)
    assert torch.equal(out, ref[None])
    np.testing.assert_allclose(out.numpy(), jout[None], rtol=TOL, atol=TOL)


def test_streamed_forward_padded_seq(f32):
    """L_nat = 4·4·4 = 64 padded to 80: the kv_lens path."""
    _, jout, ref, wan, host = f32
    _, (x, t, c) = _inputs()
    ex = streaming.BlockStreamingExecutor(wan.cfg, host, device="cpu")
    with torch.no_grad():
        out = streaming.wan_dit_stream_apply(wan, ex, x, t, c, seq_len=80)
    assert torch.equal(out, ref[80])
    np.testing.assert_allclose(out.numpy(), jout[80], rtol=TOL, atol=TOL)


def test_resident_forward_refuses_a_streamed_dit(f32):
    _, _, _, wan, _ = f32
    _, (x, t, c) = _inputs()
    with pytest.raises(ValueError, match="wan_dit_stream_apply"):
        wan(x, t, c)


def test_aliased_blocks_residentize(f32):
    """A schedule of one block repeated keeps it on the device after its
    first copy (JAX's rule): the same output as streaming it every time,
    and as JAX's aliased schedule."""
    params, _, _, wan, host = f32
    (jx, jt, jc), (x, t, c) = _inputs()
    sched = [host[0]] * 4
    ex = streaming.BlockStreamingExecutor(wan.cfg, sched, window=1, device="cpu")
    plain = streaming.BlockStreamingExecutor(wan.cfg, sched, residentize=False, device="cpu")
    assert ex._residentize and not plain._residentize
    with torch.no_grad():
        out = streaming.wan_dit_stream_apply(wan, ex, x, t, c)
        assert len(ex._resident) == 1
        assert torch.equal(out, streaming.wan_dit_stream_apply(wan, plain, x, t, c))
    ex.release()
    assert not ex._resident
    resident, jblocks = jstream.split_host_params(params)
    jcfg = JaxDiTConfig(**DIT)
    jex = jstream.BlockStreamingExecutor(jcfg, [jblocks[0]] * 4, window=1, attn_impl="xla")
    jout = np.asarray(jstream.wan_dit_stream_apply(resident, jex, jcfg, jx, jt, jc))
    np.testing.assert_allclose(out.numpy(), jout, rtol=TOL, atol=TOL)


def test_int8_stream_matches_jax():
    """quant="int8" on bf16 blocks: the port's int8 forward against JAX's
    (same int8 payloads, ops/quant.py), groups 1 and 2 bit-equal, the
    streamed bytes about half."""
    params = _jax_params(jnp.bfloat16)
    (jx, jt, jc), (x, t, c) = _inputs()
    resident, jblocks = jstream.split_host_params(params)
    jcfg = JaxDiTConfig(**DIT)
    jex = jstream.BlockStreamingExecutor(jcfg, jblocks, window=2, attn_impl="xla", quant="int8")
    jq8 = np.asarray(jstream.wan_dit_stream_apply(resident, jex, jcfg, jx, jt, jc), np.float32)
    wan, host = streaming.split_host_params(_port(params, torch.bfloat16))
    outs = []
    for group in (1, 2):
        ex = streaming.BlockStreamingExecutor(wan.cfg, host, quant="int8", group=group,
                                              device="cpu")
        with torch.no_grad():
            outs.append(streaming.wan_dit_stream_apply(wan, ex, x, t, c))
    assert torch.equal(outs[0], outs[1])
    assert ex.block_bytes < 0.6 * host[0].nbytes
    scale = np.abs(jq8).max()
    assert np.abs(outs[0].numpy() - jq8).max() <= INT8_TOL * scale


def test_random_streamed_dit_equals_the_seeded_init():
    cfg = WanDiTConfig(**DIT)
    ref = WanDiT(cfg, torch.bfloat16, "cpu", torch.Generator().manual_seed(3))
    wan = streaming.random_streamed_dit(cfg, torch.bfloat16, "cpu",
                                        torch.Generator().manual_seed(3))
    assert wan.streamed and all(p.device.type == "meta" for p in wan.blocks.parameters())
    got = {**dict(wan.resident_parameters()), **streaming.host_block_targets(wan)}
    sd = ref.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_load_expert_streamed(tmp_path):
    """load_expert(layer_stream=True) reads the block tensors into host
    buffers (bf16 safetensors in place, a model.pt by copy) and only the
    rest into the module: the same tensors as the resident load."""
    from safetensors.torch import save_file

    from omnivideo_tpu_torch.pipelines.loading import load_expert

    cfg = PipelineConfig(dit=WanDiTConfig(**DIT), vae=VAEConfig(), max_context_len=16,
                         vlm_in_dim=16)
    src = WanDiT(cfg.dit, torch.bfloat16, "cpu", torch.Generator().manual_seed(4))
    sd = {k: v.contiguous() for k, v in src.state_dict().items()}
    st = tmp_path / "st" / cfg.low_noise_checkpoint / "wan_model"
    st.mkdir(parents=True)
    save_file(sd, str(st / "diffusion_pytorch_model.safetensors"))
    pt = tmp_path / "pt" / cfg.low_noise_checkpoint
    pt.mkdir(parents=True)
    torch.save({f"wan_model.{k}": v for k, v in sd.items()}, pt / "model.pt")
    for root in ("st", "pt"):
        wan = load_expert(cfg, str(tmp_path / root), cfg.low_noise_checkpoint, torch.bfloat16,
                          "cpu", layer_stream=True).wan
        got = {**dict(wan.resident_parameters()), **streaming.host_block_targets(wan)}
        assert set(got) == set(sd)
        for k, v in sd.items():
            assert torch.equal(got[k], v), (root, k)


def test_merge_adapters_into_host_blocks():
    """LoRA adapters (generate --lora_adapters) fold into a streamed DiT's
    host blocks as into a resident one's weights."""
    from omnivideo_tpu_torch.pipelines.loading import merge_adapters
    from omnivideo_tpu_torch.training.lora import extract_lora, inject_lora

    cfg = WanDiTConfig(**DIT)
    donor = inject_lora(WanDiT(cfg, torch.float32, "cpu", torch.Generator().manual_seed(1)), 4,
                        generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        for m in donor.modules():
            if hasattr(m, "lora_b"):
                m.lora_b.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(3))
    adapters = extract_lora(donor)
    ref = WanDiT(cfg, torch.bfloat16, "cpu", torch.Generator().manual_seed(5))
    wan = streaming.random_streamed_dit(cfg, torch.bfloat16, "cpu",
                                        torch.Generator().manual_seed(5))
    merge_adapters(ref, adapters)
    merge_adapters(wan, adapters)
    got = {**dict(wan.resident_parameters()), **streaming.host_block_targets(wan)}
    for k, v in ref.state_dict().items():
        assert torch.equal(got[k], v), k
    assert not torch.equal(got["blocks.1.ffn.0.weight"], WanDiT(
        cfg, torch.bfloat16, "cpu", torch.Generator().manual_seed(5)).blocks[1].ffn[0].weight)


@pytest.fixture(scope="module")
def pipes():
    jcfg = JaxPipelineConfig(
        name="tiny-stream",
        dit=JaxDiTConfig(patch_size=(1, 2, 2), in_dim=8, out_dim=8, dim=64, ffn_dim=128,
                         freq_dim=32, text_dim=48, num_heads=4, num_layers=2),
        vae=JaxVAEConfig(dim=8, z_dim=8, dim_mult=(1, 2, 4, 4), num_res_blocks=1,
                         temperal_downsample=(False, True, True)),
        max_context_len=32, dual_expert=True, vlm_in_dim=16, param_dtype="float32")
    jpipe = JaxPipe.random_init(jcfg, attn_impl="xla", with_vae=False)
    for expert, seed in ((jpipe.low_noise, 1), (jpipe.high_noise, 2)):
        head = expert.wan["head"]["head"]
        head["kernel"] = jnp.asarray(
            0.1 * np.random.default_rng(seed).standard_normal(head["kernel"].shape), jnp.float32)
    cfg = PipelineConfig(
        name="tiny-stream",
        dit=WanDiTConfig(patch_size=(1, 2, 2), in_dim=8, out_dim=8, dim=64, ffn_dim=128,
                         freq_dim=32, text_dim=48, num_heads=4, num_layers=2),
        vae=VAEConfig(dim=8, z_dim=8, dim_mult=(1, 2, 4, 4), num_res_blocks=1,
                      temperal_downsample=(False, True, True)),
        max_context_len=32, dual_expert=True, vlm_in_dim=16, param_dtype="float32")
    low = type("E", (), dict(wan=np_tree(jpipe.low_noise.wan),
                             companions=np_tree(jpipe.low_noise.companions)))
    high = type("E", (), dict(wan=np_tree(jpipe.high_noise.wan), companions=low.companions))
    return jpipe, cfg, low, high


def test_pipeline_layer_stream_matches_resident_and_jax(pipes):
    """generate() with layer_stream=True: the port's resident generate
    bit for bit, JAX's layer_stream generate within its own tolerance; each
    step's synchronized time is recorded."""
    jpipe, cfg, low, high = pipes
    ctx = np.full((5, 48), 0.1, np.float32)
    kw = dict(size=(64, 32), frame_num=9, sampling_steps=3, guide_scale=3.0, decode=False)
    jstreamed = JaxPipe(jpipe.config, jpipe.low_noise, jpipe.high_noise, attn_impl="xla",
                        layer_stream=True)
    jout = np.asarray(jstreamed.generate(precomputed_context=jnp.asarray(ctx),
                                         precomputed_context_null=jnp.zeros_like(ctx), seed=7,
                                         **kw))
    tpipe = pipeline_from_jax(cfg, low, high, device="cpu")
    shape = tpipe._latent_shape(kw["size"], kw["frame_num"])
    noise = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(7), shape,
                                                          jnp.float32))[None].copy())
    tkw = dict(precomputed_context=torch.from_numpy(ctx),
               precomputed_context_null=torch.zeros(5, 48), noise=noise, **kw)
    ref = tpipe.generate(**tkw)
    spipe = OmniVideoX2XUnified(cfg, tpipe.low_noise, tpipe.high_noise, layer_stream=True)
    assert spipe.high_noise.wan.streamed and spipe.low_noise.wan.streamed
    out = spipe.generate(**tkw)
    assert torch.equal(out, ref)
    assert len(spipe.timings["step_s"]) == 3
    np.testing.assert_allclose(out.numpy(), jout, rtol=2e-4, atol=2e-5)
    grouped = OmniVideoX2XUnified(cfg, spipe.low_noise, spipe.high_noise, layer_stream=True,
                                  stream_group=2)
    for e in (grouped.high_noise, grouped.low_noise):
        grouped.executor(e.wan).window = 1
    assert torch.equal(grouped.generate(**tkw), out)
    with pytest.raises(ValueError, match="layer_stream"):
        OmniVideoX2XUnified(cfg, tpipe.low_noise, stream_quant="int8")
