"""HTTP edit server (port of ``scripts/serve.py``): the micro-batching
:class:`pbe_tpu_torch.serving.EditServer` behind a stdlib ``http.server``,
with the JAX front's JSON + base64 API and status codes:

    POST /edit      {"image": <b64 PNG>, "mask": <b64 PNG>,
                     "reference": <b64 PNG/JPG>, "seed": 42}
                 -> {"result": <b64 PNG>, "latency_ms": ..., "seed": ...}
                    (400 bad request, 413 body too large, 429 queue full,
                     503 deadline exceeded, 500 anything else)
    GET  /healthz -> {"ok": true}
    GET  /stats   -> batching counters (requests, batches, occupancy, ...)

    python -m pbe_tpu_torch.scripts.serve --config configs/v1.yaml \\
        --ckpt model.ckpt --warmup [--quantize int8|int8-static]

The flags are the JAX front's, plus --device (default cuda; cpu runs the
kernels' plain versions). Without a card and without --device cpu it exits
non-zero. --precision full serves in fp32, on the card through the fp32
attention kernels, with TF32 off. Sampler settings (steps/sampler/scale/paste_back) are fixed per
deployment; per-request knobs are the images and the seed. --warmup runs
every batch bucket before accepting traffic; --prewarm_only does that and
exits. --data_parallel (multi-card serving) is refused with a non-zero exit.
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import os
import sys
import time

import numpy as np

from pbe_tpu_torch.scripts.inference import REPO, device_and_dtype, refuse


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--config", type=str, default="")
    p.add_argument("--ckpt", type=str, default="")
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=512)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--plms", action="store_true", default=True)
    p.add_argument("--ddim", dest="plms", action="store_false")
    p.add_argument("--scale", type=float, default=5.0)
    p.add_argument("--paste_back", type=int, default=None, metavar="FEATHER")
    p.add_argument("--quantize", choices=["int8", "int8-static"], default=None,
                   help="w8a8 UNet matmuls/convs (ops/quant.py, opt-in); int8-static "
                        "calibrates constant scales at startup on a synthetic edit at the "
                        "serving geometry (point --calib_image/--calib_mask/--calib_ref "
                        "at a real example for production PTQ)")
    p.add_argument("--calib_image", type=str, default="")
    p.add_argument("--calib_mask", type=str, default="")
    p.add_argument("--calib_ref", type=str, default="")
    p.add_argument("--precision", type=str, choices=["full", "autocast"],
                   default="autocast", help="fp32 or bf16")
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 2, 4, 8],
                   help="batch sizes to serve; requests coalesce into the smallest "
                        "bucket that fits")
    p.add_argument("--max_wait_ms", type=float, default=20.0,
                   help="how long the batcher waits for co-riders")
    p.add_argument("--max_body_mb", type=int, default=64,
                   help="reject request bodies larger than this (413)")
    p.add_argument("--data_parallel", action="store_true",
                   help="not ported: multi-card serving (refused)")
    p.add_argument("--warmup", action="store_true",
                   help="run every bucket once before serving")
    p.add_argument("--prewarm_only", action="store_true",
                   help="run every bucket once (the kernels build, cuBLAS/cuDNN pick "
                        "their plans), then exit")
    p.add_argument("--deadline_s", type=float, default=0.0,
                   help="per-request queueing budget (0 = none): requests still "
                        "queued past it get 503 instead of a stale result")
    p.add_argument("--queue_depth", type=int, default=256,
                   help="admission bound: submits beyond this backlog get 429 "
                        "immediately (reject-fast over ballooning)")
    p.add_argument("--sample_first_stage", action="store_true",
                   help="reference-parity posterior *sampling* for the masked-source "
                        "latent (batch-mates then perturb the draw); default is the "
                        "posterior mode, which makes results batch-invariant")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def make_handler(server, size, max_body_mb: int = 64):
    """The request handler bound to an EditServer (split out so tests can
    drive the HTTP surface on an ephemeral port)."""
    from http.server import BaseHTTPRequestHandler

    from PIL import Image

    from pbe_tpu_torch.data import transforms as T
    from pbe_tpu_torch.serving import DeadlineExceeded, ServerOverloaded

    ref_size = server.pipeline.ref_size  # exemplar side of the deployed model
    max_body = max_body_mb * 1024 * 1024

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet access log
            pass

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/stats":
                self._send(200, server.stats())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/edit":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                if n > max_body:
                    # take in a body up to 4x the limit before refusing it: a
                    # connection closed with unread bytes resets, and the
                    # client still sending its body reads a broken pipe
                    # instead of the 413
                    if n <= 4 * max_body:
                        self.rfile.read(n)
                    self._send(413, {"error": f"body {n} bytes exceeds {max_body} limit"})
                    return
                req = json.loads(self.rfile.read(n))
                image = T.load_image(io.BytesIO(base64.b64decode(req["image"])), size)
                mask = T.load_mask(io.BytesIO(base64.b64decode(req["mask"])), size)
                ref = T.load_reference(io.BytesIO(base64.b64decode(req["reference"])),
                                       ref_size)
                seed = int(req.get("seed", 42))
            except Exception as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            try:
                t0 = time.perf_counter()
                out = server.edit(image, mask, ref, seed=seed)
                ms = (time.perf_counter() - t0) * 1000.0
                buf = io.BytesIO()
                arr = out if out.dtype == np.uint8 else T.to_uint8(out)
                Image.fromarray(arr).save(buf, format="PNG")
                self._send(200, {"result": base64.b64encode(buf.getvalue()).decode(),
                                 "latency_ms": round(ms, 1), "seed": seed})
            except ServerOverloaded as e:
                self._send(429, {"error": str(e)})
            except DeadlineExceeded as e:
                self._send(503, {"error": f"deadline exceeded: {e}"})
            except Exception as e:
                self._send(500, {"error": str(e)})

    return Handler


def calibration_inputs(opt, ref_size: int):
    """(image, mask, ref) batches of one for int8-static calibration: the
    --calib_* files, or a seeded synthetic edit at the serving geometry."""
    if opt.calib_image:
        from pbe_tpu_torch.data import transforms as T

        return (T.load_image(opt.calib_image, (opt.H, opt.W))[None],
                T.load_mask(opt.calib_mask, (opt.H, opt.W))[None],
                T.load_reference(opt.calib_ref, ref_size)[None])
    g = np.random.default_rng(0)
    img = g.uniform(-1, 1, (1, opt.H, opt.W, 3)).astype(np.float32)
    msk = np.ones((1, opt.H, opt.W, 1), np.float32)
    msk[:, opt.H // 4: 3 * opt.H // 4, opt.W // 4: 3 * opt.W // 4] = 0.0
    cref = g.standard_normal((1, ref_size, ref_size, 3)).astype(np.float32)
    return img, msk, cref


def main(argv=None) -> None:
    opt = get_parser().parse_args(argv)
    if opt.data_parallel:
        refuse("--data_parallel", "multi-card serving (EditPipeline.shard)", "11")
    device, dtype = device_and_dtype(opt.device, opt.precision)

    from pbe_tpu_torch.pipelines.loading import load_pipeline
    from pbe_tpu_torch.serving import EditServer

    config = opt.config or os.path.join(REPO, "configs", "v1.yaml")
    pipeline, _ = load_pipeline(config, opt.ckpt or None, device=device, dtype=dtype,
                                quantize="int8" if opt.quantize else None)
    if opt.quantize == "int8-static":
        pipeline.quant_scales = pipeline.calibrate_int8(
            *calibration_inputs(opt, pipeline.ref_size))
        print(f"calibrated {len(pipeline.quant_scales)} static int8 op scales",
              file=sys.stderr)

    multi = len(set(opt.buckets)) > 1
    server = EditServer(
        pipeline, steps=opt.ddim_steps, sampler="plms" if opt.plms else "ddim",
        scale=opt.scale, paste_back=opt.paste_back,
        det_first_stage=not opt.sample_first_stage, buckets=opt.buckets,
        max_wait_ms=opt.max_wait_ms,
        # int8 results depend on the bucket's shape (whole quantization
        # steps flip on the shape-dependent fp noise), so multi-bucket int8
        # serving opts out of seed-reproducibility; --buckets N alone keeps it
        allow_batch_variant_sampling=bool(opt.quantize) and multi,
        deadline_s=opt.deadline_s or None, queue_depth=opt.queue_depth,
        # results leave as PNGs: convert on the card, read back 4x less
        output_uint8=True,
    )
    if opt.quantize and multi:
        print("note: --quantize with multiple buckets: outputs vary with batch "
              "occupancy (use a single bucket for seed-reproducible serving)",
              file=sys.stderr)
    if opt.warmup or opt.prewarm_only:
        print(f"warming up buckets {server.buckets} ...", flush=True)
        t0 = time.perf_counter()
        server.warmup(opt.H, opt.W)
        print(f"warmup done in {time.perf_counter() - t0:.1f}s", flush=True)
    if opt.prewarm_only:
        server.close()
        print("prewarm complete; exiting", flush=True)
        return

    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer((opt.host, opt.port),
                                make_handler(server, (opt.H, opt.W), opt.max_body_mb))
    print(f"serving on http://{opt.host}:{opt.port} (steps={opt.ddim_steps}, "
          f"scale={opt.scale}, buckets={server.buckets}, {device})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()


if __name__ == "__main__":
    main()
