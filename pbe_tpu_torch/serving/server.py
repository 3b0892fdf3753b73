"""Dynamic micro-batching edit server (port of ``pbe_tpu/serving/server.py``).

The serving layer over :class:`~pbe_tpu_torch.pipelines.inference.EditPipeline`:

- **Batch buckets.** Concurrent requests are coalesced into the smallest
  bucket that fits (default 1/2/4/8), so the card sees a handful of
  shapes; padding rows repeat the last request and are trimmed from the
  output. ``warmup()`` runs every bucket once (the kernels' libraries
  load, cuBLAS and cuDNN pick their plans).
- **One dispatch thread** owns the card: batches are formed on the host,
  issued one after another, and results fan back out through per-request
  futures.
- **Double-buffered dispatch.** ``edit_batch(block=False)`` returns a
  handle whose ``is_ready()`` polls a CUDA event, so while batch k runs
  the thread collects and stacks batch k+1, issues it, then waits on k's
  readback. The eager pipeline returns that handle only once the host has
  issued every launch of the edit, so this hides only the device's tail
  of each batch until the edit is captured as one program.
- **Optional uint8 output** (``output_uint8=True``): results come back
  PNG-ready at a quarter of the float32 readback bytes, by the host-side
  ``to_uint8`` formula.
- **Batch-invariant results.** Each request's start noise ``x_T`` comes
  from its own seed on the host (numpy's ``default_rng``, the seed folded
  to uint64), and the masked-source latent uses the VAE posterior *mode*
  by default (``det_first_stage``), so a request's output does not depend
  on which other requests shared its batch. ``det_first_stage=False``
  samples the posterior as the reference does (then co-batching perturbs
  the draw).
- **Load shedding.** ``queue_depth`` bounds the backlog (submit raises
  :class:`ServerOverloaded`), and a request still queued past its deadline
  resolves with :class:`DeadlineExceeded` before it costs card time.

The server serves one configuration: sampler/steps/scale/paste_back are
fixed at construction; per-request knobs are the inputs and the seed.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Sequence

import numpy as np


def _is_ready(out) -> bool:
    """Whether an in-flight result can be read without waiting: the
    pipeline's ``PendingOutput`` polls its event; a host array is ready."""
    ready = getattr(out, "is_ready", None)
    return True if ready is None else ready()


class ServerOverloaded(RuntimeError):
    """submit() rejected immediately: the admission queue is full.

    Reject-fast beats ballooning: a request admitted behind a
    `queue_depth`-long backlog would wait queue_depth/throughput seconds
    anyway — better to tell the client now so it can shed or retry
    elsewhere."""


class DeadlineExceeded(RuntimeError):
    """The request expired in the queue before reaching the device; it
    was dropped without costing device time."""


@dataclasses.dataclass
class _Request:
    image: np.ndarray   # (H,W,3) in [-1,1]
    mask: np.ndarray    # (H,W,1), 1 = keep
    ref: np.ndarray     # (ref_size,ref_size,3) CLIP-normalized
    seed: int
    future: Future
    enqueued_at: float
    deadline: float | None = None  # perf_counter time after which we drop


class EditServer:
    """Micro-batching server over a (possibly sharded) EditPipeline."""

    def __init__(
        self,
        pipeline,
        *,
        steps: int = 50,
        sampler: str = "plms",
        scale: float = 5.0,
        eta: float = 0.0,
        paste_back: int | None = None,
        det_first_stage: bool = True,
        buckets: Sequence[int] = (1, 2, 4, 8),
        max_wait_ms: float = 20.0,
        queue_depth: int = 256,
        deadline_s: float | None = None,
        allow_batch_variant_sampling: bool = False,
        output_uint8: bool = False,
    ) -> None:
        self.pipeline = pipeline
        self.steps = int(steps)
        self.sampler = sampler
        self.scale = float(scale)
        self.eta = float(eta)
        self.paste_back = paste_back
        self.det_first_stage = bool(det_first_stage)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"bad buckets {buckets!r}")
        if (self.eta > 0 or sampler == "ddpm") and not allow_batch_variant_sampling:
            # the per-batch sampling noise draw (edit_batch's r_sample) is
            # shaped by the padded batch, so a request's output would depend
            # on its batch-mates and could not be reproduced from its seed
            raise ValueError(
                "stochastic sampler config (eta>0 or ddpm) breaks the "
                "server's batch-invariance guarantee; pass "
                "allow_batch_variant_sampling=True to serve it anyway")
        if (getattr(pipeline, "quantize", None) and len(self.buckets) > 1
                and not allow_batch_variant_sampling):
            # int8 activation scales are per-row, so co-batched CONTENT can
            # never change a request's output — but cuBLAS and cuDNN choose
            # their kernels by shape, so the fp math differs across batch
            # SHAPES in the last bits, and int8 rounding amplifies that into
            # whole quantization steps. One bucket = one shape = fully
            # reproducible; multiple buckets need the explicit opt-out.
            raise ValueError(
                "a quantized pipeline with multiple buckets breaks the "
                "server's reproducibility guarantee (int8 rounding "
                "amplifies the batch-shape-dependent fp noise); use a "
                "single bucket or pass allow_batch_variant_sampling=True")
        self.max_wait_ms = float(max_wait_ms)
        # latency shaping (both optional): queue_depth bounds the backlog —
        # submit() raises ServerOverloaded instead of blocking when it's
        # full; deadline_s is the default per-request queueing budget —
        # requests still queued past it are dropped with DeadlineExceeded
        # before they cost device time (submit(deadline_s=...) overrides)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.output_uint8 = bool(output_uint8)
        self._queue: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._stats_lock = threading.Lock()
        self._stats = {
            "requests": 0, "batches": 0, "padded_rows": 0,
            "batch_occupancy_sum": 0.0, "latency_sum_s": 0.0,
            "errors": 0, "rejected": 0, "expired": 0,
        }
        self._closed = False
        self._lifecycle = threading.Lock()  # orders submit() vs close()
        self._worker = threading.Thread(
            target=self._run, name="edit-server", daemon=True)
        self._worker.start()

    # -- public API ---------------------------------------------------------

    def submit(self, image: np.ndarray, mask: np.ndarray, ref: np.ndarray,
               *, seed: int = 42, deadline_s: float | None = None) -> Future:
        """Enqueue one edit; returns a Future resolving to (H,W,3) [0,1].

        Raises :class:`ServerOverloaded` immediately when the admission
        queue is full (reject-fast — never blocks the caller). deadline_s
        overrides the server default queueing budget for this request; a
        request still waiting past it resolves with
        :class:`DeadlineExceeded` instead of occupying a device batch."""
        image, mask, ref = map(np.asarray, (image, mask, ref))
        if image.ndim != 3 or mask.ndim != 3 or ref.ndim != 3:
            raise ValueError("submit() takes single HWC examples")
        now = time.perf_counter()
        budget = self.deadline_s if deadline_s is None else float(deadline_s)
        fut: Future = Future()
        req = _Request(image, mask, ref,
                       int(seed) & 0xFFFFFFFFFFFFFFFF,  # fold into uint64
                       fut, now,
                       deadline=None if budget is None else now + budget)
        with self._lifecycle:
            # checked under the lock so no request can land behind the
            # shutdown sentinel (whose put also holds the lock)
            if self._closed:
                raise RuntimeError("server is closed")
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                with self._stats_lock:
                    self._stats["rejected"] += 1
                raise ServerOverloaded(
                    f"admission queue full ({self._queue.maxsize} deep); "
                    "shed load or raise queue_depth") from None
        return fut

    def edit(self, image, mask, ref, *, seed: int = 42,
             timeout: float | None = None) -> np.ndarray:
        return self.submit(image, mask, ref, seed=seed).result(timeout)

    def warmup(self, height: int = 512, width: int = 512) -> None:
        """Run every bucket once up front (blocking): the kernels' libraries
        load and cuBLAS/cuDNN pick their plans before the first request.

        Calls the pipeline directly per bucket — going through the queue
        would race the coalescing window and could warm the wrong buckets.
        """
        r = self.pipeline.ref_size
        for b in self.buckets:
            self.pipeline.edit_batch(
                np.zeros((b, height, width, 3), np.float32),
                np.ones((b, height, width, 1), np.float32),
                np.zeros((b, r, r, 3), np.float32),
                steps=self.steps, scale=self.scale, sampler=self.sampler,
                eta=self.eta,
                x_T=np.zeros((b, height // self.pipeline.model.latent_downsample,
                              width // self.pipeline.model.latent_downsample, 4),
                             np.float32),
                paste_back=self.paste_back,
                det_first_stage=self.det_first_stage,
                output="uint8" if self.output_uint8 else "float32",
            )

    def stats(self) -> dict[str, Any]:
        with self._stats_lock:
            s = dict(self._stats)
        n, b = s.pop("batch_occupancy_sum"), s["batches"]
        s["mean_batch_occupancy"] = (n / b) if b else 0.0
        s["mean_latency_s"] = (s.pop("latency_sum_s") / s["requests"]
                               if s["requests"] else 0.0)
        return s

    def close(self, timeout: float = 30.0) -> None:
        """Drain already-queued requests, stop the worker, reject late
        submits (the lock guarantees nothing lands behind the sentinel)."""
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # wake + stop sentinel
        self._worker.join(timeout)

    def __enter__(self) -> "EditServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- batching core ------------------------------------------------------

    def _collect(self, block: bool = True,
                 in_flight=None) -> list[_Request] | None:
        """Wait for the first request, then coalesce until the deadline or
        the largest bucket fills. Returns None on the shutdown sentinel.

        block=False (a batch is already in flight on the device): if the
        queue is empty return [] immediately so the caller can go read the
        in-flight result instead of stalling its waiters. While coalescing
        with a batch in flight, the wait is chunked so a finished device
        result cuts the window short — its waiters shouldn't sit behind a
        full max_wait_ms of coalescing for requests that arrived later."""
        if block:
            first = self._queue.get()
        else:
            try:
                first = self._queue.get_nowait()
            except queue.Empty:
                return []
        if first is None:
            return None
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_ms / 1000.0
        max_b = self.buckets[-1]
        while len(batch) < max_b:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            if in_flight is not None:
                try:
                    if _is_ready(in_flight):
                        break  # resolve the done batch now, coalesce later
                except Exception:
                    break  # failed in flight: surface it promptly
                remaining = min(remaining, 0.002)
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                if in_flight is None:
                    break
                continue  # chunked wait: re-check deadline + readiness
            if nxt is None:
                self._queue.put(None)  # re-post for the outer loop
                break
            batch.append(nxt)
        return batch

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _x_T(self, seed: int, h: int, w: int) -> np.ndarray:
        f = self.pipeline.model.latent_downsample
        return np.random.default_rng(np.uint64(seed)).standard_normal(
            (h // f, w // f, 4)).astype(np.float32)

    def _resolve(self, pending) -> None:
        """Block on an in-flight batch's device result and fan it out."""
        reqs, n, pad, bucket, dev = pending
        try:
            out = np.asarray(dev)  # D2H; device runtime errors surface here
        except Exception as e:
            with self._stats_lock:
                self._stats["errors"] += 1
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        done = time.perf_counter()
        with self._stats_lock:
            self._stats["requests"] += n
            self._stats["batches"] += 1
            self._stats["padded_rows"] += pad
            self._stats["batch_occupancy_sum"] += n / bucket
            self._stats["latency_sum_s"] += sum(
                done - r.enqueued_at for r in reqs)
        for i, r in enumerate(reqs):
            r.future.set_result(out[i])

    def _run(self) -> None:
        # Double-buffered dispatch: while batch k executes on the device,
        # batch k+1 is collected, stacked, transferred and issued; only the
        # readback blocks. Under load this hides the per-batch host work
        # behind the device's tail of batch k; when the queue goes idle the
        # in-flight batch resolves immediately.
        pending = None  # (requests, n, pad, bucket, device_out)
        while True:
            batch = self._collect(
                block=pending is None,
                in_flight=pending[4] if pending is not None else None)
            if batch is None:  # shutdown sentinel
                if pending is not None:
                    self._resolve(pending)
                return
            if not batch and pending is not None:
                self._resolve(pending)
                pending = None
                continue
            # drop requests whose queueing budget expired — DeadlineExceeded
            # beats silently serving a result the client gave up on
            now = time.perf_counter()
            live = []
            for r in batch:
                if r.deadline is not None and now > r.deadline:
                    if not r.future.done():
                        r.future.set_exception(DeadlineExceeded(
                            f"queued {now - r.enqueued_at:.2f}s, budget "
                            f"{r.deadline - r.enqueued_at:.2f}s"))
                    with self._stats_lock:
                        self._stats["expired"] += 1
                else:
                    live.append(r)
            batch = live
            # honor Future.cancel(): anything cancelled while queued is
            # dropped before it costs device time
            batch = [r for r in batch
                     if r.future.set_running_or_notify_cancel()]
            # shape-mismatched requests fail individually instead of
            # poisoning their batch-mates at np.stack
            if batch:
                shapes = (batch[0].image.shape, batch[0].mask.shape,
                          batch[0].ref.shape)
                kept = []
                for r in batch:
                    if (r.image.shape, r.mask.shape, r.ref.shape) == shapes:
                        kept.append(r)
                    else:
                        r.future.set_exception(ValueError(
                            f"request shapes {(r.image.shape, r.mask.shape, r.ref.shape)} "
                            f"differ from the batch's {shapes}"))
                        with self._stats_lock:
                            self._stats["errors"] += 1
                batch = kept
            if not batch:
                continue
            n = len(batch)
            bucket = self._bucket_for(n)
            try:
                image = np.stack([r.image for r in batch])
                mask = np.stack([r.mask for r in batch])
                ref = np.stack([r.ref for r in batch])
                x_T = np.stack([
                    self._x_T(r.seed, r.image.shape[0], r.image.shape[1])
                    for r in batch])
                pad = bucket - n
                if pad:
                    rep = lambda a: np.concatenate(
                        [a, np.repeat(a[-1:], pad, axis=0)], axis=0)
                    image, mask, ref, x_T = map(rep, (image, mask, ref, x_T))
                dev = self.pipeline.edit_batch(
                    image, mask, ref,
                    steps=self.steps, scale=self.scale, sampler=self.sampler,
                    eta=self.eta, x_T=x_T, paste_back=self.paste_back,
                    det_first_stage=self.det_first_stage,
                    output="uint8" if self.output_uint8 else "float32",
                    block=False,
                )
                if pad:
                    dev = dev[:n]  # the same handle's rows; pad rows never read back
            except Exception as e:  # propagate to every waiter, keep serving
                with self._stats_lock:
                    self._stats["errors"] += 1
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
                continue  # the previous in-flight batch is untouched
            if pending is not None:
                self._resolve(pending)
            pending = (batch, n, pad, bucket, dev)
