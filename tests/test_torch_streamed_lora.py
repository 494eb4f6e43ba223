"""The port's StreamedLoRATrainer (omnivideo_tpu_torch/training/
streaming.py) on the CPU: two steps against JAX's StreamedLoRATrainer and
the port's resident LoRA step (make_train_step, freeze_base, LORA_FILTERS)
from the same weights, adapters, batch and draws (tests/torch_stream_tiny.py),
and the int8 frozen base against the bf16 one. Tolerances: loss 1e-5 and
grad_norm 1e-4 relative, adapters within 2e-4 of each leaf's scale
(`assert_leaf_close`); int8 loss within 0.1 relative (JAX's bound)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.training import streaming as jstream
from omnivideo_tpu_torch.io.jax_bridge import _linear_name
from omnivideo_tpu_torch.pipelines.streaming import host_block_targets
from omnivideo_tpu_torch.training import trainer
from omnivideo_tpu_torch.training.lora import LORA_FILTERS, freeze_base
from omnivideo_tpu_torch.training.streaming import StreamedLoRATrainer
from torch_stream_tiny import (CFG, JCFG, assert_leaf_close, configs, draws, jax_batch,
                               jax_params, np_tree, port_dit)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_streamed_lora_matches_resident_and_jax():
    """Two steps of StreamedLoRATrainer: loss, grad_norm (over the adapters)
    and adapters as JAX's streamed LoRA step and the port's resident LoRA
    step (make_train_step, freeze_base, LORA_FILTERS); base untouched; the
    export holds the adapters in JAX's form."""
    jtc, tc = configs(trainable_filters=LORA_FILTERS)
    params = jax_params(lora_rank=4)
    jb, b = jax_batch()
    jst = jstream.StreamedLoRATrainer(JCFG, jtc, attn_impl="xla", act_offload=True)
    st = StreamedLoRATrainer(CFG, tc, act_offload=True, device="cpu")
    js, s = jst.init_state(params), st.init_state(port_dit(params))
    base0 = {k: v.clone() for k, v in host_block_targets(s.resident).items()}
    ref = port_dit(params)
    freeze_base(ref)
    tx = trainer.make_optimizer(tc, ref)
    rs = trainer.init_train_state(ref, tx)
    rstep = trainer.make_train_step(CFG, tc, tx)
    for k in range(2):
        key, d = draws(100 + k, jtc)
        js, jm = jst.train_step(js, jb, key)
        s, m = st.train_step(s, b, d)
        rs, rm = rstep(rs, b, d)
        for ref_m in (jm, rm):
            np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=1e-4)
    jad = {f"blocks.{i}.{_linear_name(path)}.{key}": site[key]
           for i, blk in enumerate(js.lora) for path, site in blk.items()
           for key in ("lora_a", "lora_b")}
    assert set(jad) == set(s.lora)
    assert_leaf_close({k: v.detach() for k, v in s.lora.items()}, np_tree(jad), 2e-4)
    rp = dict(ref.named_parameters())
    assert_leaf_close({k: v.detach() for k, v in s.lora.items()},
                      {k: rp[k].detach().numpy() for k in s.lora}, 2e-4)
    for k, v in host_block_targets(s.resident).items():
        assert torch.equal(v, base0[k]), k
    exported = st.export_adapters(s)
    assert exported["blocks/self_attn/q"]["lora_a"].shape == (3, 64, 4)
    sd = st.export_params(s)
    assert "blocks.2.ffn.0.lora_b" in sd and "head.head.weight" in sd


def test_streamed_lora_int8_base():
    """base_quant="int8" (QLoRA): the base streams as int8 + scales, the
    loss tracks the bf16 streamed step within 0.1 relative (JAX's bound),
    the adapters move and the stored base is untouched."""
    _, tc = configs(trainable_filters=LORA_FILTERS)
    params = jax_params(jnp.bfloat16, lora_rank=4)
    _, b = jax_batch()
    ref = StreamedLoRATrainer(CFG, tc, device="cpu")
    qt = StreamedLoRATrainer(CFG, tc, device="cpu", base_quant="int8")
    sr = ref.init_state(port_dit(params, torch.bfloat16))
    sq = qt.init_state(port_dit(params, torch.bfloat16))
    lora0 = {k: v.detach().clone() for k, v in sq.lora.items()}
    for k in range(2):
        d = draws(100 + k, configs()[0])[1]
        sr, mr = ref.train_step(sr, b, d)
        sq, mq = qt.train_step(sq, b, d)
        assert np.isfinite(float(mq["loss"]))
        np.testing.assert_allclose(float(mq["loss"]), float(mr["loss"]), rtol=0.1)
    assert max(float((sq.lora[k].detach() - v).abs().max()) for k, v in lora0.items()) > 0
    for (k, v), w in zip(host_block_targets(sq.resident).items(),
                         host_block_targets(sr.resident).values()):
        assert torch.equal(v, w), k
    assert qt._base[0].nbytes < 0.65 * sq.host_blocks[0].nbytes
