"""Training driver on one device (port of ``pbe_tpu/training/trainer.py``).

The loop, validation, checkpoints and a JSONL metric log around
:func:`train_step`:

  * host batches (numpy or CPU tensors) are copied to the model's device
    from pinned memory without blocking, one batch ahead of the step that
    consumes them;
  * a ragged batch gets per-row weights (zero for padded rows), so the
    loss is the mean over the real rows;
  * ``fit`` logs, validates and checkpoints at its cadences, and on
    SIGTERM/SIGINT finishes the current step, saves and stops;
  * checkpoints (``torch.save`` of the step, the trainable parameters, the
    optimizer — bf16 first moments with ``mu_dtype`` included —, the LR
    schedule, the EMA and the generator) are kept as the JAX trainer's
    Orbax manager keeps them: the ``max_to_keep`` best by
    ``val/loss_simple`` (``..._ema`` with EMA), newer first among equals;
    ``restore`` takes the latest;
  * with ``sample_images`` every validation also samples 6-panel image
    grids (:meth:`log_images`), and with a feature function it streams the
    FID trio ``val/fid_{global,local,ref}`` (:meth:`sample_and_score`).

The data-parallel mesh is not ported yet (ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

import json
import math
import os
import re
import signal
import time
from pathlib import Path
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from pbe_tpu_torch.models.pbe import PaintByExample
from pbe_tpu_torch.training.ema import EMA
from pbe_tpu_torch.training.partition import split_parameters
from pbe_tpu_torch.training.train_step import (draw_step_noise, eval_step, make_optimizer,
                                               train_step)

_CKPT_RE = re.compile(r"^step_(\d+)\.pt$")


class MetricLogger:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, metrics: dict[str, Any], prefix: str = "train") -> None:
        row = {"step": int(step), **{f"{prefix}/{k}": float(v) for k, v in metrics.items()},
               "time": time.time()}
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class Trainer:
    """Trains ``model`` on its own device; the frozen partition is frozen
    in place (``requires_grad=False``). ``det_first_stage`` takes the VAE
    posterior mode instead of a sample (random-weight runs and tests);
    ``mu_dtype=torch.bfloat16`` stores Adam's first moments in bf16."""

    def __init__(self, model: PaintByExample, base_lr: float = 1e-5,
                 logdir: str = "logs/run", use_ema: bool = False, max_to_keep: int = 5,
                 seed: int = 0, scheduler=None, det_first_stage: bool = False,
                 mu_dtype: torch.dtype | None = None):
        self.model = model
        self.device = model.device
        self.logdir = logdir
        self.params, _ = split_parameters(model)
        self.optimizer, self.lr_schedule = make_optimizer(self.params, base_lr, scheduler,
                                                          mu_dtype=mu_dtype)
        self.ema = EMA(self.params) if use_ema else None
        self.det_first_stage = det_first_stage
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0
        self.logger = MetricLogger(logdir)
        self.ckpt_dir = Path(logdir).absolute() / "checkpoints"
        self.max_to_keep = max_to_keep
        self.monitor = "val/loss_simple_ema" if use_ema else "val/loss_simple"
        self._sample_pipeline = None

    # -- checkpoints ------------------------------------------------------------
    def _ckpt(self, step: int) -> Path:
        return self.ckpt_dir / f"step_{step:08d}.pt"

    def _steps(self) -> list[int]:
        if not self.ckpt_dir.is_dir():
            return []
        return sorted(int(m.group(1)) for f in os.listdir(self.ckpt_dir)
                      if (m := _CKPT_RE.match(f)))

    def save(self, metrics: dict | None = None) -> None:
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        blob = {"step": self.step,
                "params": {k: p.detach() for k, p in self.params.items()},
                "optimizer": self.optimizer.state_dict(),
                "lr_schedule": self.lr_schedule.state_dict(),
                "ema": None if self.ema is None else self.ema.state_dict(),
                "generator": self.generator.get_state(),
                "metrics": metrics}
        path = self._ckpt(self.step)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(blob, tmp)
        os.replace(tmp, path)
        path.with_suffix(".json").write_text(json.dumps(metrics))
        self._remove_old_checkpoints()

    def _remove_old_checkpoints(self) -> None:
        """Keep the max_to_keep best by the monitored metric (a checkpoint
        without it ranks last), newer first among equals."""
        def rank(step):
            m = json.loads(self._ckpt(step).with_suffix(".json").read_text())
            return (m.get(self.monitor, math.inf), -step)
        for step in sorted(self._steps(), key=rank)[self.max_to_keep:]:
            self._ckpt(step).unlink()
            self._ckpt(step).with_suffix(".json").unlink()

    def restore(self, step: int | None = None) -> bool:
        """Load a checkpoint (the latest when ``step`` is None); False if
        there is none."""
        steps = self._steps()
        if step is None:
            if not steps:
                return False
            step = steps[-1]
        blob = torch.load(self._ckpt(step), map_location=self.device, weights_only=False)
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(blob["params"][k])
        self.optimizer.load_state_dict(blob["optimizer"])
        self.lr_schedule.load_state_dict(blob["lr_schedule"])
        if self.ema is not None:
            self.ema.load_state_dict(blob["ema"])
        self.generator.set_state(blob["generator"].cpu())
        self.step = int(blob["step"])
        return True

    # -- batches ----------------------------------------------------------------
    @staticmethod
    def _pad_ragged(arrays: dict, n: int) -> dict:
        """Pad the batch to a multiple of n rows by repeating the last row,
        with a ``weight`` vector that is zero on the padded rows, so the
        weighted loss is exactly the mean over the real rows. On one
        device n is 1 and only the weights are added."""
        if not arrays:
            return arrays
        b = next(iter(arrays.values())).shape[0]
        pad = (-b) % n
        if not pad and "weight" in arrays:
            return arrays
        w = arrays.get("weight")
        w = np.ones((b,), np.float32) if w is None else np.asarray(w, np.float32)
        if pad:
            arrays = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
                      for k, v in arrays.items() if k != "weight"}
            w = np.concatenate([w, np.zeros((pad,), np.float32)])
        return {**arrays, "weight": w}

    def _put_batch(self, batch: dict) -> dict:
        """Host arrays -> tensors on the device (pinned, non-blocking);
        tensors already there pass through."""
        host = {k: np.asarray(v) for k, v in batch.items()
                if isinstance(v, np.ndarray)
                or (isinstance(v, torch.Tensor) and v.device.type == "cpu")}
        out = {k: v for k, v in batch.items()
               if isinstance(v, torch.Tensor) and v.device.type != "cpu"}
        for k, v in self._pad_ragged(host, 1).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _device_batches(self, loader: Iterable) -> Iterator[dict]:
        """One batch ahead: batch i+1's copy is queued before step i runs."""
        pending = None
        for batch in loader:
            d = self._put_batch(batch)
            if pending is not None:
                yield pending
            pending = d
        if pending is not None:
            yield pending

    def _draws(self, batch: dict, generator: torch.Generator):
        b, h, w, _ = batch["image"].shape
        f = self.model.latent_downsample
        return draw_step_noise(generator, b, (b, h // f, w // f, 4),
                               self.model.schedule.num_timesteps)

    # -- loops ------------------------------------------------------------------
    def train_step(self, batch: dict) -> dict:
        """One optimizer step on a device batch -> metrics (device tensors)."""
        t, noise, u = self._draws(batch, self.generator)
        metrics = train_step(self.model, self.params, self.optimizer, self.lr_schedule,
                             batch, t, noise, u, self.ema,
                             None if self.det_first_stage else self.generator)
        self.step += 1
        return metrics

    def fit(self, train_loader: Iterable, val_loader: Iterable | None = None,
            max_steps: int = 1000, max_epochs: int | None = None, log_every: int = 50,
            val_every: int = 1000, ckpt_every: int = 1000, sample_images: bool = False,
            fid_feature_fn=None, fid_batches: int = 2, fid_every: int | None = None,
            sample_steps: int = 50, sample_sampler: str = "ddim") -> None:
        """Train until ``max_steps`` (or ``max_epochs`` passes over the
        loader). On SIGTERM/SIGINT: finish the step, save, stop.

        With ``sample_images`` every validation also samples 6-panel grids
        (:meth:`log_images`, ``sample_steps`` of ``sample_sampler`` at CFG
        scale 5); ``fid_feature_fn`` (e.g. evaltools.fid's
        make_inception_feature_fn) adds ``val/fid_{global,local,ref}`` over
        ``fid_batches`` validation batches, every ``fid_every`` steps (None:
        at every validation)."""
        preempted = {"flag": False}

        def _handler(signum, frame):
            preempted["flag"] = True
            print(f"signal {signum}: checkpointing and stopping...", flush=True)

        old_handlers = {s: signal.signal(s, _handler) for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            epoch = 0
            t0 = time.time()
            while (self.step < max_steps and (max_epochs is None or epoch < max_epochs)
                   and not preempted["flag"]):
                ran = False
                for dbatch in self._device_batches(train_loader):
                    if preempted["flag"]:
                        break
                    ran = True
                    metrics = self.train_step(dbatch)
                    step = self.step
                    if step % log_every == 0:
                        m = {k: float(v) for k, v in metrics.items()}
                        m["steps_per_sec"] = log_every / max(time.time() - t0, 1e-9)
                        t0 = time.time()
                        self.logger.log(step, m)
                        print(f"step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items()),
                              flush=True)
                    if val_loader is not None and step % val_every == 0:
                        val_m = self.validate(val_loader)
                        want_fid = fid_feature_fn is not None and (
                            fid_every is None or step % fid_every == 0)
                        if sample_images or want_fid:
                            val_m.update(self.sample_and_score(
                                val_loader, fid_feature_fn=fid_feature_fn if want_fid else None,
                                fid_batches=fid_batches, steps=sample_steps,
                                sampler=sample_sampler))
                        self.logger.log(step, val_m, prefix="val")
                        self.save({f"val/{k}": v for k, v in val_m.items()})
                        t0 = time.time()  # keep steps_per_sec train-only
                    elif step % ckpt_every == 0:
                        self.save()
                        t0 = time.time()
                    if step >= max_steps:
                        break
                if not ran:  # an exhausted iterator: nothing more to train on
                    break
                epoch += 1
            if preempted["flag"]:
                self.save()
        finally:
            for s, h in old_handlers.items():
                signal.signal(s, h)

    def log_images(self, batch: dict, outdir: str | None = None, steps: int = 50,
                   scale: float = 5.0, sampler: str = "ddim", seed: int = 0) -> np.ndarray:
        """Sample edits of ``batch`` with the current weights and save
        6-panel grids under ``outdir`` (default logdir/samples/step_N) -> the
        (B,H,W,3) [0,1] predictions. The reference's validation-time
        log_images (latent_diffusion.py:1020-1123, CFG scale 5): an
        EditPipeline over the training module itself (no copy of the
        weights), in eval mode and without autograd; the module's mode is
        restored after."""
        from pbe_tpu_torch.data.transforms import unpack_uint8_batch
        from pbe_tpu_torch.pipelines.batch import infer_batch, visualize_batch
        from pbe_tpu_torch.pipelines.inference import EditPipeline

        was_training = self.model.training
        try:
            if self._sample_pipeline is None:
                self._sample_pipeline = EditPipeline(self.model)
            self.model.eval()
            batch = unpack_uint8_batch(batch)
            arrays = {k: np.asarray(v) for k, v in batch.items()
                      if isinstance(v, (np.ndarray, torch.Tensor))}
            preds = infer_batch(self._sample_pipeline, arrays, steps=steps, scale=scale,
                                sampler=sampler, seed=seed)
        finally:
            self.model.train(was_training)
        out = outdir or os.path.join(self.logdir, "samples", f"step_{self.step:08d}")
        visualize_batch(arrays, preds, out, ids=batch.get("id"))
        return preds

    def sample_and_score(self, val_loader: Iterable, fid_feature_fn=None, fid_batches: int = 2,
                         steps: int = 50, scale: float = 5.0, sampler: str = "ddim") -> dict:
        """Sample edits on up to ``fid_batches`` validation batches (grids
        under logdir/samples/step_N) and, given a feature function, the
        in-training FID trio -> {} or {'fid_global', 'fid_local',
        'fid_ref'}."""
        from pbe_tpu_torch.data.transforms import unpack_uint8_batch
        from pbe_tpu_torch.evaltools.fid_callback import FIDTrioTracker

        tracker = (None if fid_feature_fn is None
                   else FIDTrioTracker(fid_feature_fn, device=self.device))
        for i, batch in enumerate(val_loader):
            if i >= fid_batches:
                break
            preds = self.log_images(batch, steps=steps, scale=scale, sampler=sampler, seed=i)
            if tracker is not None:
                tracker.update(unpack_uint8_batch(batch), preds)
        return tracker.compute() if tracker is not None else {}

    def validate(self, val_loader: Iterable, max_batches: int = 50, seed: int = 0) -> dict:
        """Mean eval metrics over up to ``max_batches`` batches, with draws
        from a generator seeded ``seed`` (the same at every validation);
        with EMA, also the ``*_ema`` metrics of the shadow weights on the
        same draws."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        agg: dict[str, list[float]] = {}
        for i, batch in enumerate(val_loader):
            if i >= max_batches:
                break
            dbatch = self._put_batch(batch)
            t, noise, u = self._draws(dbatch, gen)
            vae_gen = None if self.det_first_stage else gen
            vae_state = None if vae_gen is None else vae_gen.get_state()
            for k, v in eval_step(self.model, dbatch, t, noise, u, vae_gen).items():
                agg.setdefault(k, []).append(float(v))
            if self.ema is not None:
                if vae_gen is not None:
                    vae_gen.set_state(vae_state)  # the same posterior draws
                with self.ema.swapped_in(self.params):
                    m = eval_step(self.model, dbatch, t, noise, u, vae_gen)
                for k, v in m.items():
                    agg.setdefault(f"{k}_ema", []).append(float(v))
        return {k: float(np.mean(v)) for k, v in agg.items()}
