"""HTTP serving frontend for the x2x generation pipeline (port of
tools/serve.py).

The pipeline is built once at startup (seeded random weights, or a
reference checkpoint dir through pipelines/loading.py) and every request
runs its `generate` on the card:

    python -m omnivideo_tpu_torch.tools.serve --random_weights --port 8800
    curl -s localhost:8800/healthz
    curl -s -X POST localhost:8800/generate -d '{"context": [[...]], "size": [832, 480],
        "frame_num": 81, "sampling_steps": 50, "seed": 0}'

API (JSON over the standard library's http.server):

  GET  /healthz            -> {"status": "ok", "backend": <card name, or "cpu">,
                               "task": ...}
  POST /generate           body: {"prompt": str | "context": [[...]],
                                  "size": [W, H], "frame_num": int,
                                  "sampling_steps": int, "seed": int,
                                  "guide_scale": float, "id": str}
                           -> {"id": ..., "file_id": ..., "path": <written clip>,
                               "latency_s": ...}

A `context` request ([L, text_dim] features, padded by the DiT to its
context length) runs CFG against zeros; a `prompt` needs the text encoder
of a checkpoint dir, and its negative is the default negative prompt,
encoded by `generate` (ctx_null=None), as the generate CLI does. The noise
comes from a torch.Generator seeded with `seed` on the pipeline's device.
Requests run one at a time under a lock (one card, one generate). The
client's id is echoed, but it names the written file only when it is a
plain token ([A-Za-z0-9_-]{1,64}); otherwise the file gets a server id, so
no request writes outside --output_dir. The file is `save_video`'s
(utils/video.py): `.mp4` where imageio encodes it, else MJPEG `.avi`, else
`.npz`.

`--residual_dtype bfloat16` (the default) stores the DiT's residual stream
in bf16; `float32` is the parity stream, with the fused AdaLN sandwich
(kernel row 7) as tools/export_aot.py exports it. `--once req.json` serves
that one request without a socket and prints the reply. `--tiny` takes the
JAX tool's tiny widths (head dim 16: the CPU's plain twins only). The
device defaults to cuda; `--device cpu` runs the plain twins.
`--max_steps_per_call` (a TPU dispatch workaround) is not ported and
raises. `Server` takes a prebuilt pipeline, so a caller that already holds
one serves it without a second init.
"""

from __future__ import annotations

import argparse
import json
import logging
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from omnivideo_tpu_torch.configs import WAN_CONFIGS
from omnivideo_tpu_torch.configs.base import PipelineConfig
from omnivideo_tpu_torch.device import resolve_device
from omnivideo_tpu_torch.pipelines.loading import load_pipeline
from omnivideo_tpu_torch.pipelines.x2x import OmniVideoX2XUnified
from omnivideo_tpu_torch.tools.export_aot import ew_impl_for
from omnivideo_tpu_torch.tools.generate import NOT_PORTED
from omnivideo_tpu_torch.utils.video import save_video

log = logging.getLogger("serve")

CLIENT_ID = r"[A-Za-z0-9_-]{1,64}"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--task", default="t2v-1.3B",
                   choices=sorted(k for k, c in WAN_CONFIGS.items() if c.dit.model_type != "i2v"))
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--random_weights", action="store_true")
    p.add_argument("--output_dir", default="outputs/serve")
    p.add_argument("--port", type=int, default=8800)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max_steps_per_call", type=int, default=None,
                   help="not ported: " + NOT_PORTED["max_steps_per_call"][1])
    p.add_argument("--vae_dtype", default=None, choices=[None, "float32", "bfloat16"])
    p.add_argument("--residual_dtype", default="bfloat16", choices=["float32", "bfloat16"],
                   help="DiT residual-stream storage dtype (bf16 default for serving; "
                        "float32 = the parity stream with the fused AdaLN sandwich)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--once", default=None,
                   help="serve exactly one request from this JSON file and exit (no socket)")
    args = p.parse_args(argv)
    if args.max_steps_per_call is not None:
        raise NotImplementedError(f"--max_steps_per_call is not ported: "
                                  f"{NOT_PORTED['max_steps_per_call'][1]}")
    return args


def task_config(task: str, tiny: bool = False) -> PipelineConfig:
    """The task's config; `tiny` takes the JAX tool's tiny widths."""
    cfg = WAN_CONFIGS[task]
    if tiny:
        cfg = cfg.replace(
            dit=cfg.dit.replace(dim=64, ffn_dim=128, num_heads=4, num_layers=2, freq_dim=32,
                                text_dim=48),
            vae=cfg.vae.__class__(dim=8, z_dim=16, num_res_blocks=1),
            max_context_len=64)
    return cfg


def build_pipeline(args) -> OmniVideoX2XUnified:
    cfg = task_config(args.task, args.tiny)
    dev = resolve_device(args.device)
    rdt = getattr(torch, args.residual_dtype)
    kw = dict(residual_dtype=args.residual_dtype, ew_impl=ew_impl_for(rdt))
    if args.random_weights:
        return OmniVideoX2XUnified.random_init(cfg, device=dev, **kw)
    if not args.ckpt_dir:
        raise ValueError("--ckpt_dir is required without --random_weights")
    return load_pipeline(cfg, args.ckpt_dir, device=dev, **kw)


class Server:
    def __init__(self, args, pipe: Optional[OmniVideoX2XUnified] = None):
        self.args = args
        self.pipe = pipe if pipe is not None else build_pipeline(args)
        self.outdir = Path(args.output_dir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.lock = threading.Lock()

    def handle_generate(self, req: dict) -> dict:
        t0 = time.perf_counter()
        size = tuple(int(v) for v in req.get("size", (832, 480)))
        frame_num = int(req.get("frame_num", 81))
        steps = int(req.get("sampling_steps", 50))
        seed = int(req.get("seed", 0))
        guide = float(req.get("guide_scale", 3.0))
        dev = self.pipe.device

        if "context" in req:
            ctx = torch.as_tensor(np.asarray(req["context"], np.float32), device=dev)
            ctx_null = torch.zeros_like(ctx)  # client sent features; no encoder assumed
        elif self.pipe.text_encoder is not None:
            ctx = self.pipe.text_encoder([req.get("prompt", "")])[0]
            ctx_null = None  # generate() encodes the default negative prompt, as the CLI
        else:
            raise ValueError("no text encoder attached; POST a precomputed 'context' "
                             "[[L, text_dim]] instead of 'prompt'")
        vae_dtype = None if self.args.vae_dtype is None else getattr(torch, self.args.vae_dtype)
        with self.lock:  # one generate on the card at a time
            frames = self.pipe.generate(
                precomputed_context=ctx, precomputed_context_null=ctx_null, size=size,
                frame_num=frame_num, sampling_steps=steps, guide_scale=guide,
                generator=torch.Generator(device=dev).manual_seed(seed), decode=True,
                output_uint8=True, vae_dtype=vae_dtype)
        # the client id is echoed back, but names the file only when it is a
        # plain token: "../../x" must not escape --output_dir
        client_id = str(req.get("id") or "")
        rid = client_id if re.fullmatch(CLIENT_ID, client_id) else uuid.uuid4().hex[:10]
        path = save_video(str(self.outdir / f"{rid}.mp4"), frames)
        return {"id": client_id or rid, "file_id": rid, "path": str(path),
                "latency_s": round(time.perf_counter() - t0, 2)}


def make_handler(server: Server):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                dev = server.pipe.device  # the card's name, where JAX's names its backend
                backend = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
                self._reply(200, {"status": "ok", "backend": backend, "task": server.args.task})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                self._reply(200, server.handle_generate(req))
            except Exception as e:  # the reply carries any failure; the server keeps serving
                log.exception("generate failed")
                self._reply(500, {"error": str(e)})

        def log_message(self, fmt, *a):
            log.info("%s " + fmt, self.address_string(), *a)

    return Handler


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    server = Server(args)
    if args.once:
        req = json.loads(Path(args.once).read_text())
        print(json.dumps(server.handle_generate(req)))
        return
    httpd = HTTPServer((args.host, args.port), make_handler(server))
    log.info("serving %s on http://%s:%d", args.task, args.host, args.port)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
