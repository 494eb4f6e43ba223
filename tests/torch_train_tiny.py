"""Shared tiny setup of the port's training tests: the `--tiny` finetune
config (dim 64, 4 heads, 2 layers), JAX unified params with a seeded head
(the init zero-fills it, which zeroes every block gradient), a seeded batch
with text, VLM and visual context, JAX's per-step draws, and the bridges
between the two packages' trees."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from omnivideo_tpu.configs.base import PipelineConfig as JaxPipelineConfig
from omnivideo_tpu.configs.base import VAEConfig as JaxVAEConfig
from omnivideo_tpu.configs.base import WanDiTConfig as JaxDiTConfig
from omnivideo_tpu.models.unified import init_unified_companions
from omnivideo_tpu.models.wan_dit import init_wan_dit
from omnivideo_tpu.training import trainer as jax_trainer
from omnivideo_tpu_torch.configs.base import PipelineConfig, VAEConfig, WanDiTConfig
from omnivideo_tpu_torch.io.jax_bridge import load_unified, unified_params_to_state_dict
from omnivideo_tpu_torch.training import trainer

DIT = dict(in_dim=4, dim=64, ffn_dim=128, freq_dim=32, text_dim=48, out_dim=4, num_heads=4,
           num_layers=2)
PIPE = dict(vlm_in_dim=16, max_context_len=64)
JCFG = JaxPipelineConfig(dit=JaxDiTConfig(**DIT), vae=JaxVAEConfig(z_dim=4), **PIPE)
CFG = PipelineConfig(dit=WanDiTConfig(**DIT), vae=VAEConfig(z_dim=4), **PIPE)
B = 2
LATENTS = (B, 4, 3, 8, 8)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def jax_params(seed: int = 0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = {"wan": init_wan_dit(k1, JCFG.dit.replace(text_len=JCFG.max_context_len),
                                  dtype=jnp.float32),
              "companions": init_unified_companions(k2, JCFG)}
    head = params["wan"]["head"]["head"]
    head["kernel"] = jnp.asarray(
        0.1 * np.random.default_rng(seed + 1).standard_normal(head["kernel"].shape), jnp.float32)
    return params


def port_params(params) -> trainer.UnifiedParams:
    model = trainer.init_unified_params(CFG, device="cpu")
    return load_unified(model, unified_params_to_state_dict(np_tree(params)))


def batch(seed: int = 0):
    """latents and visual_emb [2, 4, 3, 8, 8], zero-padded text [2, 8, 48]
    (5 live tokens), VLM features [2, 6, 16]: a 26-token mixed context."""
    rng = np.random.default_rng(seed)
    ctx = np.zeros((B, 8, 48), np.float32)
    ctx[:, :5] = rng.standard_normal((B, 5, 48))
    return {"latents": rng.standard_normal(LATENTS).astype(np.float32), "context": ctx,
            "vlm": rng.standard_normal((B, 6, 16)).astype(np.float32),
            "visual_emb": rng.standard_normal(LATENTS).astype(np.float32)}


def jax_draws(step: int, jtc, one_drop: bool = True):
    """(rng key, (tid, noise, drop) as the JAX loss draws them from it). With
    one_drop the key is chosen so that CFG dropout drops exactly one sample."""
    seed = 100 + step
    while True:
        key = jax.random.PRNGKey(seed)
        k_t, k_n, k_cfg = jax.random.split(key, 3)
        drop = np.asarray(jax.random.uniform(k_cfg, (B,)) < jtc.cfg_dropout)
        if not one_drop or drop.sum() == 1:
            break
        seed += 1000
    tid = np.asarray(jax_trainer._sample_timestep_ids(k_t, B, jtc))
    noise = np.asarray(jax.random.normal(k_n, LATENTS, jnp.float32))
    return key, (torch.tensor(tid), torch.tensor(noise), torch.tensor(drop))


def grad_capture():
    """An optax stage that passes updates through and keeps the raw grads
    in its state (chained first, it records what value_and_grad gave)."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
        lambda u, s, p=None: (u, {"g": u}))


def to_port_names(tree):
    return {k: torch.tensor(v) for k, v in unified_params_to_state_dict(np_tree(tree)).items()}


def worst_rel(got, ref, floor: float = 0.0):
    """max over leaves of |got − ref| / max(max|ref|, floor) → (value, leaf)."""
    return max((float((got[n].detach().float() - r).abs().max()
                      / max(float(r.abs().max()), floor, 1e-30)), n) for n, r in ref.items())
