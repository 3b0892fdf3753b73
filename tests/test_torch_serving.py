"""The port's serving layer on the CPU: EditServer (pbe_tpu_torch/serving)
against the JAX package's on the same weights, request and seed; the
behaviours of tests/test_serving.py (coalescing, buckets, batch invariance,
double-buffered dispatch, errors, cancel, deadlines, the admission bound,
the int8 guards) and of tests/test_serve_http.py on the port's HTTP front
(pbe_tpu_torch/scripts/serve.py), and that front's main() in-process."""
import base64
import http.client
import io
import json
import threading
import time
import types

import numpy as np
import pytest
import torch
from PIL import Image

from pbe_tpu.serving import EditServer as JEditServer
from pbe_tpu.pipelines.inference import EditPipeline as JEditPipeline

from pbe_tpu_torch.data.transforms import to_uint8
from pbe_tpu_torch.pipelines.inference import EditPipeline
from pbe_tpu_torch.pipelines.loading import init_parameters, randomize_zero_params
from pbe_tpu_torch.scripts import serve
from pbe_tpu_torch.serving import DeadlineExceeded, EditServer, ServerOverloaded

from _torch_port import pipeline_pair

S = 32  # image side of the PIPELINE_GEO model (8x8 latents)
# tests/test_torch_edit.py's bound on the port's fp32 image against JAX's
IMAGE_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite's workers share the CPU, and idle
    threads spinning for work take it from the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def pipelines():
    jm, variables, tm = pipeline_pair()
    return JEditPipeline(jm, variables), EditPipeline(tm)


@pytest.fixture(scope="module")
def pipeline(pipelines):
    return pipelines[1]


def _example(i: int):
    g = np.random.default_rng(i)
    image = g.uniform(-1, 1, (S, S, 3)).astype(np.float32)
    mask = np.ones((S, S, 1), np.float32)
    mask[8:24, 8:24] = 0.0
    ref = g.standard_normal((32, 32, 3)).astype(np.float32)
    return image, mask, ref


def test_server_matches_jax(pipelines):
    """The same request and seed through both servers (det_first_stage,
    2 PLMS steps): x_T comes from the seed folded to uint64 the JAX way."""
    jp, tp = pipelines
    image, mask, ref = _example(0)
    with JEditServer(jp, steps=2, buckets=(1,), max_wait_ms=1) as srv:
        want = {seed: srv.edit(image, mask, ref, seed=seed, timeout=300) for seed in (7, -3)}
    with EditServer(tp, steps=2, buckets=(1,), max_wait_ms=1) as srv:
        got = {seed: srv.edit(image, mask, ref, seed=seed, timeout=120) for seed in (7, -3)}
    for seed in want:
        assert got[seed].shape == (S, S, 3) and got[seed].dtype == np.float32
        np.testing.assert_allclose(got[seed], want[seed], rtol=0, atol=IMAGE_ATOL)
    assert np.abs(got[7] - got[-3]).max() > 1e-2


def test_single_request_roundtrip(pipeline):
    with EditServer(pipeline, steps=2, buckets=(1, 2), max_wait_ms=1) as srv:
        out = srv.edit(*_example(0), seed=7, timeout=120)
        st = srv.stats()
    assert out.shape == (S, S, 3)
    assert np.isfinite(out).all() and 0.0 <= out.min() and out.max() <= 1.0
    assert st["requests"] == 1 and st["batches"] == 1


def test_results_are_batch_invariant(pipeline):
    """A request's output does not depend on its batch-mates: within one
    bucket bit for bit (solo, padded with its own rows, against co-batched
    with others); across buckets within fp32 noise."""
    image, mask, ref = _example(1)
    with EditServer(pipeline, steps=2, buckets=(1, 2, 4), max_wait_ms=1) as srv:
        solo1 = srv.edit(image, mask, ref, seed=11, timeout=120)
    with EditServer(pipeline, steps=2, buckets=(4,), max_wait_ms=500) as srv:
        solo4 = srv.edit(image, mask, ref, seed=11, timeout=120)
        futs = [srv.submit(*_example(k), seed=100 + k) for k in (2, 3)]
        futs.append(srv.submit(image, mask, ref, seed=11))
        outs = [f.result(120) for f in futs]
        st = srv.stats()
    assert st["batches"] == 2 and st["padded_rows"] == 3 + 1, st  # 3 coalesced, +1 pad
    np.testing.assert_array_equal(outs[2], solo4)
    np.testing.assert_allclose(outs[2], solo1, atol=1e-5)


def test_coalescing_and_bucketing(pipeline):
    with EditServer(pipeline, steps=2, buckets=(1, 2, 4), max_wait_ms=400) as srv:
        futs = [srv.submit(*_example(k), seed=k) for k in range(3)]
        outs = [f.result(120) for f in futs]
        st = srv.stats()
    assert all(o.shape == (S, S, 3) for o in outs)
    assert st["requests"] == 3 and st["batches"] == 1 and st["padded_rows"] == 1
    assert st["mean_batch_occupancy"] == 0.75 and st["mean_latency_s"] > 0
    assert not np.array_equal(outs[0], outs[1])  # distinct seeds, distinct edits


SAME_BITS = {
    # (first seed, second seed), each through a server of its own: one seed
    # twice; a negative seed and its uint64 fold
    "across_servers": (99, 99),
    "negative_seed_folded": (-1, 2 ** 64 - 1),
}


@pytest.mark.parametrize("case", list(SAME_BITS))
def test_same_seed_gives_the_same_bits(pipeline, case):
    a_seed, b_seed = SAME_BITS[case]
    image, mask, ref = _example(4)
    outs = []
    for seed in (a_seed, b_seed):
        with EditServer(pipeline, steps=2, buckets=(1,), max_wait_ms=1) as srv:
            outs.append(srv.edit(image, mask, ref, seed=seed, timeout=120))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_pipelined_dispatch_burst(pipeline):
    """buckets=(1,): a burst of sequential batches runs the double-buffered
    path (batch k+1 issued while k is in flight); each result is still the
    request's own seed's edit."""
    image, mask, ref = _example(13)
    with EditServer(pipeline, steps=2, buckets=(1,), max_wait_ms=1) as srv:
        solo = {k: srv.edit(image, mask, ref, seed=k, timeout=120) for k in range(3)}
    with EditServer(pipeline, steps=2, buckets=(1,), max_wait_ms=1) as srv:
        futs = [srv.submit(image, mask, ref, seed=k) for k in range(3)]
        outs = [f.result(120) for f in futs]
        st = srv.stats()
    assert st["requests"] == 3 and st["batches"] == 3
    for k in range(3):
        np.testing.assert_array_equal(outs[k], solo[k])


@pytest.mark.parametrize("buckets", [(1, 2), (1,)], ids=["coalescing", "in_flight"])
def test_bad_shape_fails_alone_and_the_server_keeps_serving(pipeline, buckets):
    """A request whose shape differs from its batch's fails alone; with a
    batch in flight (buckets=(1,)) the in-flight batch still resolves."""
    image, mask, ref = _example(5)
    with EditServer(pipeline, steps=2, buckets=buckets, max_wait_ms=500) as srv:
        good = srv.submit(image, mask, ref, seed=1)
        # the exemplar too: at a bucket of its own a half-height edit is valid
        bad = srv.submit(image[: S // 2], mask[: S // 2], ref[: S // 2], seed=2)
        good2 = srv.submit(image, mask, ref, seed=3)
        assert good.result(180).shape == (S, S, 3)
        with pytest.raises(Exception):
            bad.result(180)
        assert good2.result(180).shape == (S, S, 3)
        st = srv.stats()
    assert st["errors"] == 1 and st["requests"] == 2


def test_submit_after_close_raises(pipeline):
    srv = EditServer(pipeline, steps=2, buckets=(1,), max_wait_ms=1)
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(*_example(6))


def test_concurrent_submitters(pipeline):
    """Many client threads, one dispatch thread: every future resolves, each
    request counted once, results deterministic per seed."""
    with EditServer(pipeline, steps=2, buckets=(1, 2, 4), max_wait_ms=30) as srv:
        results: dict[int, np.ndarray] = {}
        lock = threading.Lock()

        def client(k: int):
            out = srv.edit(*_example(7), seed=k % 3, timeout=180)
            with lock:
                results[k] = out

        threads = [threading.Thread(target=client, args=(k,)) for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(240)
        assert not any(t.is_alive() for t in threads)
        st = srv.stats()
    assert len(results) == 6 and st["requests"] == 6 and st["batches"] <= 6
    np.testing.assert_allclose(results[0], results[3], atol=1e-5)
    assert not np.array_equal(results[0], results[1])


def test_cancelled_request_is_skipped(pipeline):
    with EditServer(pipeline, steps=2, buckets=(1, 2), max_wait_ms=400) as srv:
        image, mask, ref = _example(8)
        first = srv.submit(image, mask, ref, seed=0)
        doomed = srv.submit(image, mask, ref, seed=1)
        assert doomed.cancel()
        first.result(180)
        ok = srv.edit(image, mask, ref, seed=2, timeout=180)
        st = srv.stats()
    assert doomed.cancelled() and ok.shape == (S, S, 3)
    assert st["requests"] == 2  # the cancelled one never counted


def test_warmup_runs_every_bucket_directly(pipeline, monkeypatch):
    """warmup() calls the pipeline once per bucket (with the pipeline's own
    exemplar size), not through the coalescing queue."""
    seen = []
    real = pipeline.edit_batch
    monkeypatch.setattr(pipeline, "edit_batch",
                        lambda image, mask, ref, **kw: seen.append((len(image), ref.shape))
                        or real(image, mask, ref, **kw))
    with EditServer(pipeline, steps=2, buckets=(1, 2), max_wait_ms=1) as srv:
        srv.warmup(S, S)
        assert seen == [(1, (1, 32, 32, 3)), (2, (2, 32, 32, 3))]
        assert srv.edit(*_example(10), seed=0, timeout=120).shape == (S, S, 3)
        assert srv.stats()["requests"] == 1  # warm-up is not a request


def test_uint8_output(pipeline):
    image, mask, ref = _example(12)
    with EditServer(pipeline, steps=2, buckets=(1,), max_wait_ms=1) as srv:
        f32 = srv.edit(image, mask, ref, seed=5, timeout=120)
    with EditServer(pipeline, steps=2, buckets=(1,), max_wait_ms=1, output_uint8=True) as srv:
        u8 = srv.edit(image, mask, ref, seed=5, timeout=120)
    assert u8.dtype == np.uint8 and u8.shape == (S, S, 3)
    # the same program: the uint8 output is to_uint8 of the float one
    np.testing.assert_array_equal(u8, to_uint8(f32))


def test_sampler_and_int8_guards(pipeline):
    with pytest.raises(ValueError, match="batch-invariance"):
        EditServer(pipeline, steps=2, sampler="ddim", eta=1.0)
    with pytest.raises(ValueError, match="batch-invariance"):
        EditServer(pipeline, steps=2, sampler="ddpm")
    EditServer(pipeline, steps=2, sampler="ddim", eta=1.0,
               allow_batch_variant_sampling=True).close()
    q = EditPipeline(pipeline.model, quantize="int8")
    with pytest.raises(ValueError, match="quantized"):
        EditServer(q, steps=2, buckets=(1, 2, 4))
    EditServer(q, steps=2, buckets=(4,)).close()


def test_int8_server_is_content_invariant_within_its_bucket():
    """At one bucket, a hot co-batched neighbour (which would shift a
    per-tensor scale) leaves a request's int8 output unchanged, bit for bit,
    on a model whose UNet clears the int8 gates (128 channels, 16x16
    latents)."""
    from test_torch_quant import GEO
    from pbe_tpu_torch.models.clip_vit import CLIPVisionConfig
    from pbe_tpu_torch.models.exemplar import ExemplarEncoderConfig
    from pbe_tpu_torch.models.pbe import PaintByExample
    from pbe_tpu_torch.models.unet import UNetConfig
    from pbe_tpu_torch.models.vae import AutoencoderKLConfig

    model = PaintByExample(UNetConfig(**GEO["unet"]), AutoencoderKLConfig(**GEO["vae"]),
                           ExemplarEncoderConfig(clip=CLIPVisionConfig(**GEO["clip"]),
                                                 mapper_layers=1))
    randomize_zero_params(init_parameters(model), scale=0.02)
    q = EditPipeline(model, quantize="int8")
    g = np.random.default_rng(5)
    img = g.uniform(-1, 1, (64, 64, 3)).astype(np.float32)
    msk = np.ones((64, 64, 1), np.float32)
    msk[16:48, 16:48] = 0.0
    ref = g.standard_normal((32, 32, 3)).astype(np.float32)
    hot = np.full_like(img, 0.999)
    with EditServer(q, steps=2, buckets=(4,), max_wait_ms=300) as srv:
        solo = srv.edit(img, msk, ref, seed=7, timeout=120)  # padded with its own rows
        futs = [srv.submit(img, msk, ref, seed=7), srv.submit(hot, msk, ref, seed=8),
                srv.submit(hot, msk, ref, seed=9)]
        batched = futs[0].result(120)
        st = srv.stats()
    assert st["batches"] == 2, st
    np.testing.assert_array_equal(solo, batched)
    with torch.inference_mode():
        fp = EditPipeline(model).edit(img, msk, ref, steps=2, det_first_stage=True,
                                      x_T=srv._x_T(7, 64, 64)[None])
    assert not np.array_equal(solo, fp)  # the int8 path was taken


@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (1, 1)])
def test_unet_conv_computes_every_example_alike(kernel, stride):
    """ops/conv.conv2d: without autograd a batched conv wider than 1x1 is an
    im2col and one product (cuDNN's 3x3 kernels on the card round rows at
    other batch positions otherwise): the fp32 conv's result, every example
    computed alike; with autograd it is F.conv2d itself."""
    from pbe_tpu_torch.ops.conv import conv2d

    g = np.random.default_rng(0)
    x0 = torch.from_numpy(g.standard_normal((1, 16, 12, 12)).astype(np.float32))
    x = torch.cat([x0, torch.from_numpy(g.standard_normal((2, 16, 12, 12)).astype(np.float32)),
                   x0])
    w = torch.from_numpy(g.standard_normal((24, 16, kernel, kernel)).astype(np.float32)) * 0.1
    b = torch.from_numpy(g.standard_normal(24).astype(np.float32))
    pad = (kernel - 1) // 2
    want = torch.nn.functional.conv2d(x, w, b, stride, pad)
    with torch.inference_mode():
        got = conv2d(x, w, b, (stride, stride), (pad, pad))
    assert got.is_contiguous() and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[3], got[0], rtol=0, atol=0)
    torch.testing.assert_close(conv2d(x, w, b, (stride, stride), (pad, pad)), want,
                               rtol=0, atol=0)


# ---- load shedding (a stub pipeline with a set "device" time) -------------------

class _SlowStubPipeline:
    """Pipeline stand-in with a set device time that returns host arrays,
    as the JAX tests' stub does."""

    quantize = None
    ref_size = 32

    def __init__(self, delay_s: float):
        self.delay_s = delay_s
        self.model = types.SimpleNamespace(latent_downsample=8)

    def edit_batch(self, image, mask, ref, **kw):
        time.sleep(self.delay_s)
        return np.asarray(image, np.float32) * 0.0 + 0.5


def test_deadline_expired_requests_are_dropped():
    srv = EditServer(_SlowStubPipeline(0.5), steps=2, buckets=(1,), max_wait_ms=1,
                     deadline_s=0.05)
    image, mask, ref = _example(0)
    futs = [srv.submit(image, mask, ref, seed=i) for i in range(4)]
    assert futs[0].result(30).shape == image.shape  # dequeued inside its budget
    expired = 0
    for f in futs[1:]:
        try:
            f.result(30)
        except DeadlineExceeded:
            expired += 1
    assert expired >= 2  # they sat behind a 0.5 s batch with a 50 ms budget
    st = srv.stats()
    srv.close()
    assert st["expired"] == expired


def test_per_request_deadline_overrides_server_default():
    srv = EditServer(_SlowStubPipeline(0.3), steps=2, buckets=(1,), max_wait_ms=1)
    image, mask, ref = _example(1)
    f0 = srv.submit(image, mask, ref, seed=0)
    f1 = srv.submit(image, mask, ref, seed=1, deadline_s=0.01)
    f2 = srv.submit(image, mask, ref, seed=2)  # unlimited budget
    assert f0.result(30).shape == image.shape
    with pytest.raises(DeadlineExceeded):
        f1.result(30)
    assert f2.result(30).shape == image.shape
    srv.close()


def test_admission_queue_full_rejects_fast():
    srv = EditServer(_SlowStubPipeline(0.5), steps=2, buckets=(1,), max_wait_ms=1,
                     queue_depth=1)
    image, mask, ref = _example(2)
    f0 = srv.submit(image, mask, ref, seed=0)
    time.sleep(0.1)  # let the worker move f0 onto the "device"
    f1 = srv.submit(image, mask, ref, seed=1)  # fills the 1-deep queue
    t0 = time.perf_counter()
    with pytest.raises(ServerOverloaded):
        srv.submit(image, mask, ref, seed=2)
    assert time.perf_counter() - t0 < 0.1  # rejected, not blocked
    assert f0.result(30).shape == image.shape and f1.result(30).shape == image.shape
    st = srv.stats()
    srv.close()
    assert st["rejected"] == 1


# ---- the HTTP front ---------------------------------------------------------------

def _b64_png(arr_u8: np.ndarray, mode: str) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr_u8, mode).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _start_http(server, max_body_mb=64):
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                serve.make_handler(server, (S, S), max_body_mb))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _request(addr, method, path, payload=None, raw=None):
    conn = http.client.HTTPConnection(*addr, timeout=300)
    body = raw if raw is not None else (json.dumps(payload).encode()
                                        if payload is not None else None)
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"} if body else {})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


@pytest.fixture(scope="module")
def http_server(pipeline):
    server = EditServer(pipeline, steps=2, buckets=(1, 2), max_wait_ms=5, output_uint8=True)
    httpd = _start_http(server)
    yield httpd.server_address, server
    httpd.shutdown()
    httpd.server_close()
    server.close()


def _payload(seed):
    g = np.random.default_rng(0)
    msk = np.zeros((S, S), np.uint8)
    msk[8:24, 8:24] = 255  # white = edit region
    return {"image": _b64_png(g.integers(0, 255, (S, S, 3), np.uint8), "RGB"),
            "mask": _b64_png(msk, "L"),
            "reference": _b64_png(g.integers(0, 255, (S, S, 3), np.uint8), "RGB"),
            "seed": seed}


def test_healthz_and_stats(http_server):
    addr, _ = http_server
    assert _request(addr, "GET", "/healthz") == (200, {"ok": True})
    status, out = _request(addr, "GET", "/stats")
    assert status == 200 and {"requests", "batches", "mean_batch_occupancy"} <= set(out)


def test_edit_roundtrip(http_server):
    """The PNG equals EditServer.edit's result for the same inputs and seed;
    the same seed gives the same bytes, another seed another image."""
    from pbe_tpu_torch.data import transforms as T

    addr, server = http_server
    payload = _payload(3)
    status, out = _request(addr, "POST", "/edit", payload)
    assert status == 200, out
    result = np.asarray(Image.open(io.BytesIO(base64.b64decode(out["result"]))))
    assert result.shape == (S, S, 3) and out["seed"] == 3 and out["latency_ms"] > 0
    dec = lambda k, fn, *a: fn(io.BytesIO(base64.b64decode(payload[k])), *a)
    want = server.edit(dec("image", T.load_image, (S, S)), dec("mask", T.load_mask, (S, S)),
                       dec("reference", T.load_reference, server.pipeline.ref_size), seed=3)
    np.testing.assert_array_equal(result, want)
    assert _request(addr, "POST", "/edit", payload)[1]["result"] == out["result"]
    assert _request(addr, "POST", "/edit", _payload(4))[1]["result"] != out["result"]


def test_bad_requests(http_server):
    addr, _ = http_server
    assert _request(addr, "GET", "/nope")[0] == 404
    assert _request(addr, "POST", "/nope", {})[0] == 404
    status, out = _request(addr, "POST", "/edit", {"image": "not-base64-png"})
    assert status == 400 and "bad request" in out["error"]
    status, out = _request(addr, "POST", "/edit", raw=b"{not json")
    assert status == 400


def test_shedding_status_codes():
    """413 for a body over --max_body_mb; with a 0.5 s stub batch on the
    "device", a 1-deep queue and a 50 ms budget: 429 for the request that
    finds the queue full, 503 for the one that expires in it, 200 for the
    one that reached the device."""
    server = EditServer(_SlowStubPipeline(0.5), steps=2, buckets=(1,), max_wait_ms=1,
                        queue_depth=1, deadline_s=0.05)
    httpd = _start_http(server, max_body_mb=1)
    addr = httpd.server_address
    try:
        status, out = _request(addr, "POST", "/edit", raw=b" " * (1024 * 1024 + 1))
        assert status == 413 and "exceeds" in out["error"]
        codes = {}

        def post(name):
            codes[name] = _request(addr, "POST", "/edit", _payload(0))[0]

        threads = []
        for name in ("served", "expired", "rejected"):
            threads.append(threading.Thread(target=post, args=(name,)))
            threads[-1].start()
            time.sleep(0.15)
        for t in threads:
            t.join(30)
        assert codes == {"served": 200, "expired": 503, "rejected": 429}
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()


# ---- serve.main ---------------------------------------------------------------------

TINY = ["--config", "configs/tiny.yaml", "--H", "64", "--W", "64", "--ddim_steps", "2",
        "--device", "cpu", "--precision", "full"]


@pytest.mark.parametrize("quantize", [[], ["--quantize", "int8-static"]],
                         ids=["fp", "int8-static"])
def test_serve_main_prewarms_and_exits(capsys, quantize):
    serve.main(TINY + ["--buckets", "1", "2", "--prewarm_only"] + quantize)
    captured = capsys.readouterr()
    assert "warming up buckets (1, 2)" in captured.out
    assert "prewarm complete" in captured.out
    if quantize:
        n = int(captured.err.split("calibrated ")[1].split()[0])
        assert n > 0  # the tiny UNet's 64-channel 16x16 convs clear the gates


@pytest.mark.parametrize("argv,cuda,message", [
    (TINY + ["--data_parallel"], True, "item 11"),
    (["--config", "configs/tiny.yaml"], False, "no CUDA device"),
], ids=["data_parallel", "no_card"])
def test_serve_main_refuses(monkeypatch, argv, cuda, message):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    with pytest.raises(SystemExit) as e:
        serve.main(argv)
    assert message in str(e.value.code)


def test_serve_main_takes_fp32_on_the_card(monkeypatch):
    """--precision full on the card builds the fp32 pipeline there (the
    fp32 attention kernels), with TF32 off for matmuls and convolutions."""
    from pbe_tpu_torch.pipelines import loading

    built = []

    class Built(Exception):
        pass

    def load_pipeline(*args, device, dtype, **kw):
        built.append((device, dtype))
        raise Built  # stop before anything touches the card

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(loading, "load_pipeline", load_pipeline)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(Built):
        serve.main(["--config", "configs/tiny.yaml", "--precision", "full"])
    assert built == [("cuda", torch.float32)]
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
