"""The training step (port of ``pbe_tpu/training/train_step.py``).

The reference's training semantics (latent_diffusion.py:612-634, 763-809):

  * the frozen VAE encodes the ground truth and the masked source, with
    posterior sampling (or its mode with ``det_first_stage``), and the mask
    is resized to the latent grid;
  * the exemplar passes the frozen CLIP trunk, then the trainable mapper,
    final_ln and proj_out; with probability u_cond_percent the whole
    batch's condition is the learnable vector (one uniform per step, not
    per example);
  * t ~ U{0..999} and eps ~ N(0, 1) q-sample the latent; the UNet sees the
    9 channels [x_t, z_inpaint, mask]; the loss is the eps MSE in fp32, with
    optional per-row weights, and the VLB term is kept as a metric;
  * AdamW over the trainable partition with the LR multiplier stepped per
    optimizer step; optional EMA.

The step's random draws (t, eps, u) are made by :func:`draw_step_noise`,
apart from the loss, so that a test can hand the loss the JAX package's
draws. Batches are dicts of NHWC tensors on the model's device.
"""
from __future__ import annotations

from typing import Callable

import torch

from pbe_tpu_torch.models.pbe import PaintByExample
from pbe_tpu_torch.ops.image import CLIP_MEAN, CLIP_STD
from pbe_tpu_torch.training.ema import EMA
from pbe_tpu_torch.training.lr_schedule import default_scheduler


def make_optimizer(params: dict[str, torch.Tensor], base_lr: float = 1e-5,
                   scheduler: Callable[[int], float] | None = None,
                   weight_decay: float = 0.01):
    """AdamW (torch's default betas and eps, as the reference's
    configure_optimizers) over ``params`` -> (optimizer, LambdaLR with the
    multiplier schedule, v1's warm-up by default)."""
    opt = torch.optim.AdamW(list(params.values()), lr=base_lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, scheduler or default_scheduler())


def normalize_uint8_batch(batch: dict) -> dict:
    """Unpack the uint8 transfer format on the device: image -> [-1,1],
    mask (255 = keep) -> {0,1}, inpaint_image = image * mask, ref ->
    CLIP-normalized; u8/255 in fp32, as the host path computes it. Float
    batches pass unchanged."""
    img = batch.get("image")
    if img is None or img.dtype != torch.uint8:
        return batch
    image = img.float() / 255.0 * 2.0 - 1.0
    mask = (batch["mask"] > 127).float()
    stat = lambda a: torch.as_tensor(a, device=img.device)
    ref = (batch["ref"].float() / 255.0 - stat(CLIP_MEAN)) / stat(CLIP_STD)
    out = {k: v for k, v in batch.items() if k not in ("image", "mask", "ref")}
    out.update(image=image, inpaint_image=image * mask, mask=mask, ref=ref)
    return out


def draw_step_noise(generator: torch.Generator, b: int, shape: tuple[int, ...],
                    num_timesteps: int = 1000):
    """One step's draws on the generator's device -> (t (b,) int64, eps of
    ``shape`` fp32, u () fp32)."""
    dev = generator.device
    t = torch.randint(0, num_timesteps, (b,), generator=generator, device=dev)
    noise = torch.randn(shape, generator=generator, device=dev)
    u = torch.rand((), generator=generator, device=dev)
    return t, noise, u


def loss_fn(model: PaintByExample, batch: dict, t: torch.Tensor, noise: torch.Tensor,
            u: torch.Tensor, vae_generator: torch.Generator | None = None):
    """-> (loss, metrics) for one batch and its draws. ``vae_generator``
    samples the VAE posterior; None takes its mode (det_first_stage)."""
    batch = normalize_uint8_batch(batch)
    enc = model.cond_stage_model
    with torch.no_grad():  # the frozen VAE and CLIP trunk
        z, z_inpaint, m_lat = model.prepare_latents(
            batch["image"], batch["inpaint_image"], batch["mask"], vae_generator)
        pooled = enc.transformer(batch["ref"])[1]
    c = model.proj_out(enc.map_pooled(pooled))
    b = z.shape[0]
    # both branches are computed, as jnp.where does: the branch not taken
    # gets a zero gradient (not none), so AdamW treats every step alike
    cond = torch.where(u < model.u_cond_percent, model.uncond_vector(b).to(c.dtype), c)

    coef = lambda table: table[t][:, None, None, None]
    x_noisy = (coef(model.sqrt_alphas_cumprod) * z.float()
               + coef(model.sqrt_one_minus_alphas_cumprod) * noise).to(z.dtype)
    x9 = torch.cat([x_noisy, z_inpaint, m_lat], dim=-1)
    eps = model.apply_model(x9, t, cond)
    per_ex = (eps.float() - noise).square().mean(dim=(1, 2, 3))
    # per-row weights: Trainer pads a ragged batch with zero-weight rows, and
    # the weighted mean is then the mean over the real rows
    w = batch.get("weight")
    if w is None:
        w = torch.ones((b,), device=per_ex.device)
    wsum = w.sum().clamp_min(1e-9)
    loss_simple = (w * per_ex).sum() / wsum
    loss_vlb = (w * model.lvlb_weights[t] * per_ex).sum() / wsum
    # v1: logvar == 0 and original_elbo_weight == 0, so loss == loss_simple
    return loss_simple, {"loss_simple": loss_simple, "loss_vlb": loss_vlb,
                         "loss": loss_simple}


def train_step(model: PaintByExample, params: dict[str, torch.Tensor],
               optimizer: torch.optim.Optimizer, scheduler, batch: dict,
               t: torch.Tensor, noise: torch.Tensor, u: torch.Tensor,
               ema: EMA | None = None, vae_generator: torch.Generator | None = None):
    """One optimizer step on ``params`` (the trainable partition) -> metrics
    as device tensors, ``grad_norm`` the global L2 norm of the gradients."""
    optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(model, batch, t, noise, u, vae_generator)
    loss.backward()
    # a trainable parameter the loss does not reach (the cross-attention's
    # norm2: one context token makes attn2 independent of its query) gets
    # a zero gradient, as under jax.grad, so AdamW decays it as optax does
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    metrics["grad_norm"] = torch.nn.utils.get_total_norm(
        [p.grad for p in params.values()])
    optimizer.step()
    scheduler.step()
    if ema is not None:
        ema.update(params)
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def eval_step(model: PaintByExample, batch: dict, t: torch.Tensor, noise: torch.Tensor,
              u: torch.Tensor, vae_generator: torch.Generator | None = None) -> dict:
    """Validation metrics of one batch (the reference's validation_step)."""
    return loss_fn(model, batch, t, noise, u, vae_generator)[1]

