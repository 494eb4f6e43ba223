"""Process-group workers for the sharded Qwen3-VL tests (CPU, gloo), started
with `torch_sp_workers.spawn`: each rank builds its shard of the expert
banks (parallel/expert_shard.py) and writes what it computed to
`<tag>_<rank>.npz` in `tmp`. This module imports torch and the port only,
so the ranks start without JAX."""

import sys

import numpy as np
import torch
import torch.distributed as dist
from torch_sp_workers import _save, load


def _model(cfg, sd, shard, dtype):
    from omnivideo_tpu_torch.io.jax_bridge import load_qwen3vl
    from omnivideo_tpu_torch.models.qwen3vl.full_model import Qwen3VLModel

    model = Qwen3VLModel(cfg, dtype, device="cpu", shard=shard)
    return load_qwen3vl(model, {k: torch.from_numpy(v) for k, v in sd.items()})


def model_worker(rank, tmp, cases):
    """Per (tag, config, dtype, decode) of `cases`: the model of
    `sd_<tag>_<rank>.npz` (this rank's shard from the bridge) on the whole
    group with the routing checked; the MoE of layer 0 and its dense oracle
    on inputs.npz's x, the feature forward and (decode) a 6-token greedy
    decode on its video prompt; then the MoE on x + 3·rank, whose routing
    differs between the ranks: the check's message is kept."""
    from omnivideo_tpu_torch.models.qwen3vl import full_model, text_model
    from omnivideo_tpu_torch.parallel.expert_shard import ExpertShard, placements, shard_bytes

    n = dist.get_world_size()
    inp = load(tmp, "inputs")
    ids, patches, grid = inp["ids"], inp["patches"], tuple(int(g) for g in inp["grid"])
    for tag, cfg, dtype, decode in cases:
        shard = ExpertShard(rank, n, dist.group.WORLD, check_routing=True)
        model = _model(cfg, load(tmp, f"sd_{tag}_{rank}"), shard, dtype)
        mlp = model.language_model.layers[0].mlp
        checks = text_model.check_routing.calls
        x = torch.from_numpy(inp["x"]).to(dtype)
        with torch.inference_mode():
            out = {"moe": text_model.moe(mlp, x).float(),
                   "moe_dense": text_model.moe_dense(mlp, x).float(),
                   "features": full_model.qwen3vl_forward(model, ids, patches, grid).float()}
        if decode:
            out["tokens"] = full_model.qwen3vl_greedy_decode(model, ids, patches, grid,
                                                             max_new_tokens=6)
        out["routing_checks"] = np.array(text_model.check_routing.calls - checks)
        try:
            with torch.inference_mode():
                text_model.moe(mlp, x + 3.0 * rank)
            out["routing_error"] = np.array("")
        except RuntimeError as err:
            out["routing_error"] = np.array(str(err))
        out["bank"] = np.array(placements(model)["language_model.layers.0.mlp.experts_gate"])
        b = shard_bytes(model)
        out["bytes"] = np.array([b["replicated"], b["sharded"]])
        _save(tmp, f"{tag}_{rank}", **{k: np.asarray(v) for k, v in out.items()})


def engine_cli_worker(rank, tmp, vlm_dir, argv):
    """The engine at fsdp 2 on the HF dir `vlm_dir` (its bytes, a target
    caption, text-only features), then the generate CLI with `--vlm_fsdp 2`
    (its latents and the VLM stage's features, Pillow and imageio hidden)
    and with `--vlm_fsdp 3`, which must raise: its message is kept."""
    from omnivideo_tpu_torch.models.qwen3vl.engine import Qwen3VLEngine, VLMConfig
    from omnivideo_tpu_torch.parallel.expert_shard import shard_bytes
    from omnivideo_tpu_torch.tools import generate

    eng = Qwen3VLEngine(VLMConfig(model_path=vlm_dir, fsdp=2, device="cpu", max_new_tokens=4))
    b = shard_bytes(eng.model)
    out = {"bytes": np.array([b["replicated"], b["sharded"]]),
           "caption": np.array(eng.predict_target_video_caption("", "tok9 no")),
           "features": eng.extract_features(None, "tok5 tok6 tok7")["vlm_last_hidden_states"]}
    del eng
    sys.modules.update(PIL=None, imageio=None)
    stage, feats = generate.vlm_stage, {}

    def spy(*args, **kw):
        got = stage(*args, **kw)
        feats.update(got)
        return got

    generate.vlm_stage = spy
    try:
        for r in generate.run(generate.parse_args(argv + ["--vlm_fsdp", "2"])):
            out[f"latents/{r['id']}"] = r["latents"]
            out[f"vlm/{r['id']}"] = feats[r["id"]]["ar_vision_input"]
            out[f"caption/{r['id']}"] = np.array(feats[r["id"]]["target_caption"])
    finally:
        generate.vlm_stage = stage
    try:
        generate.run(generate.parse_args(argv + ["--vlm_fsdp", "3"]))
        out["fsdp3_error"] = np.array("")
    except ValueError as err:
        out["fsdp3_error"] = np.array(str(err))
    _save(tmp, f"engine_cli_{rank}", **{k: np.asarray(v) for k, v in out.items()})


def world2_worker(rank, tmp, cases, vlm_dir, argv):
    model_worker(rank, tmp, cases)
    engine_cli_worker(rank, tmp, vlm_dir, argv)
