"""Shared tiny setup of the streamed-trainer tests: JAX's streamed-trainer
test config (dim 64, 4 heads, 3 layers, f32, context 48), JAX params with a
seeded head (the init's zero head would zero every block gradient),
optionally with LoRA adapters, the port's DiT from them, JAX's batch and
the draws JAX's streamed `prep` takes from a key, and comparisons under the
port's names."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from omnivideo_tpu.configs.base import PipelineConfig as JaxPipelineConfig
from omnivideo_tpu.configs.base import VAEConfig as JaxVAEConfig
from omnivideo_tpu.configs.base import WanDiTConfig as JaxDiTConfig
from omnivideo_tpu.models.wan_dit import init_wan_dit
from omnivideo_tpu.training import lora as jlora
from omnivideo_tpu.training import trainer as jtrainer
from omnivideo_tpu_torch.configs.base import PipelineConfig, VAEConfig, WanDiTConfig
from omnivideo_tpu_torch.io.jax_bridge import (_stack, load_wan_state_dict,
                                               wan_params_to_state_dict)
from omnivideo_tpu_torch.models.wan_dit import WanDiT
from omnivideo_tpu_torch.pipelines.streaming import host_block_targets
from omnivideo_tpu_torch.training import trainer

DIT = dict(patch_size=(1, 2, 2), in_dim=16, out_dim=16, dim=64, ffn_dim=128, freq_dim=32,
           text_dim=48, num_heads=4, num_layers=3)
PIPE = dict(name="tiny-stream-train", vlm_in_dim=16, max_context_len=48, param_dtype="float32")
JCFG = JaxPipelineConfig(dit=JaxDiTConfig(**DIT), vae=JaxVAEConfig(), **PIPE)
CFG = PipelineConfig(dit=WanDiTConfig(**DIT), vae=VAEConfig(), **PIPE)
B, LATENTS = 2, (2, 16, 3, 8, 8)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def jax_params(dtype=jnp.float32, lora_rank=0):
    params = init_wan_dit(jax.random.PRNGKey(0), JCFG.dit.replace(text_len=48), dtype=dtype)
    hk = params["head"]["head"]["kernel"]  # the init's zero head would zero every block grad
    params["head"]["head"]["kernel"] = (
        jax.random.normal(jax.random.PRNGKey(9), hk.shape, jnp.float32) * 0.02).astype(hk.dtype)
    if lora_rank:
        params = jlora.inject_lora(params, jax.random.PRNGKey(7), rank=lora_rank)
    return params


def port_dit(params, dtype=torch.float32) -> WanDiT:
    wan = WanDiT(CFG.dit.replace(text_len=48), dtype=dtype, device="cpu")
    return load_wan_state_dict(wan, wan_params_to_state_dict(np_tree(params)))


def jax_batch(uncond=False):
    b = {"latents": jax.random.normal(jax.random.PRNGKey(1), LATENTS, jnp.float32),
         "context": jax.random.normal(jax.random.PRNGKey(2), (B, 48, 48), jnp.float32)}
    if uncond:
        b["uncond_context"] = jnp.zeros_like(b["context"])
    return b, {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def draws(seed, jtc):
    """(key, (tid, noise, drop)): what JAX's streamed `prep` draws from key."""
    key = jax.random.PRNGKey(seed)
    k_t, k_n, k_cfg = jax.random.split(key, 3)
    tid = np.asarray(jtrainer._sample_timestep_ids(k_t, B, jtc))
    noise = np.asarray(jax.random.normal(k_n, LATENTS, jnp.float32))
    drop = np.asarray(jax.random.uniform(k_cfg, (B,)) < jtc.cfg_dropout)
    return key, (torch.tensor(tid), torch.tensor(noise), torch.tensor(drop))


def jax_named(state) -> dict:
    """A JAX streamed state's parameters under the port's names."""
    full = {**np_tree(state.resident), "blocks": _stack(np_tree(state.host_blocks))}
    return wan_params_to_state_dict(full)


def port_named(state) -> dict:
    return {**{n: p.detach() for n, p in state.resident.resident_parameters()},
            **host_block_targets(state.resident)}


def assert_close(got: dict, ref: dict, rtol, atol, names=None):
    for k in names or ref:
        np.testing.assert_allclose(got[k].float().numpy(), np.asarray(ref[k], np.float32)
                                   .reshape(got[k].shape), rtol=rtol, atol=atol, err_msg=k)


def assert_leaf_close(got: dict, ref: dict, tol: float, floor: float = 1e-2):
    """Each leaf's largest |got − ref| within tol of max(its largest |ref|,
    floor), as tests/test_torch_train.py holds updated params: AdamW's
    first step moves an element whose gradient is rounding noise by ±lr
    with that noise's sign, in either package."""
    for k in ref:
        r = np.asarray(ref[k], np.float32).reshape(got[k].shape)
        err = np.abs(got[k].float().numpy() - r).max() / max(np.abs(r).max(), floor)
        assert err <= tol, (k, err)


def configs(**kw):
    """AdamW moves every parameter on the first step (warmup 0). Adafactor's
    first update is g/√(g² + 1e-30) elementwise, which rounding noise in a
    near-zero gradient steers, so its cases keep JAX's warmup of 1 (the
    first update has lr 0; the next ones move)."""
    base = dict(cfg_dropout=0.0, remat=True, total_steps=10, learning_rate=1e-3, grad_clip=0.1,
                warmup_steps=1 if kw.get("optimizer") == "adafactor" else 0)
    base.update(kw)
    return jtrainer.TrainConfig(**base), trainer.TrainConfig(**base)


def resident_run(tc, params, batch, draw_list):
    """The port's resident make_train_step: (metrics per step, params)."""
    wan = port_dit(params)
    tx = trainer.make_optimizer(tc, wan)
    state = trainer.init_train_state(wan, tx)
    step = trainer.make_train_step(CFG, tc, tx)
    ms = []
    for d in draw_list:
        state, m = step(state, batch, d)
        ms.append(m)
    return ms, {n: p.detach() for n, p in wan.named_parameters()}


