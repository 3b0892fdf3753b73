"""First-stage (VAE) training (port of ``pbe_tpu/training/vae_train.py``).

The reference carries the KL-VAE's Lightning training steps + an
LPIPS+PatchGAN loss stack (autoencoder.py:88-134, losses/contperceptual.py)
but never exercises them for PBE (lossconfig is torch.nn.Identity,
configs/v1.yaml:68-69). The JAX package rebuilds the capability and this
module ports it:

  * reconstruction (L1 or L2) + KL with the reference's weighting shape;
  * a PatchGAN discriminator with hinge loss and the ADAPTIVE generator
    weight (losses/contperceptual.py:32-43):
        d_weight = ||grad_last rec_loss|| / (||grad_last gan_loss|| + 1e-4),
    clipped to [0, 1e4], detached, scaled by disc_weight, where `last` is
    the decoder's conv_out weight: the trunk runs once without a gradient,
    and two autograd.grad calls take both gradients through one conv_out
    application;
  * a pluggable perceptual term (training/perceptual.py).

Loss scaling: means everywhere and KL divided by the per-example numel, as
the JAX package does (the reference's sum/batch differs by that constant,
which the learning rate absorbs).

One step, as the JAX train_step orders it: one draw eps of the latent's
shape, used by the adaptive weight, the G loss and the D loss alike (JAX
folds the step into one key and samples all three from it); the G step
(Adam on the VAE); then the D step, which decodes with the VAE weights
after the G update and trains the discriminator from step 0 (the JAX
d_loss_fn has no GAN gate; the reference's disc_factor would zero it
before disc_start).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from pbe_tpu_torch.models.layers import Conv2d, to_nchw, to_nhwc
from pbe_tpu_torch.models.vae import AutoencoderKL, diagonal_gaussian_kl


class PatchDiscriminator(nn.Module):
    """70x70-receptive-field PatchGAN (taming-transformers
    NLayerDiscriminator shape: stride-2 conv stack, LeakyReLU 0.2,
    GroupNorm with min(32, C) groups and eps 1e-6 in fp32). NHWC in, NHWC
    logits out; convs compute in ``dtype``."""

    def __init__(self, ch: int = 64, n_layers: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.n_layers = dtype, n_layers
        self.conv_in = Conv2d(3, ch, 4, stride=2, padding=1)
        cin = ch
        for i in range(1, n_layers + 1):
            cout = ch * min(2 ** i, 8)
            self.add_module(f"conv_{i}", Conv2d(cin, cout, 4, stride=2 if i < n_layers else 1,
                                                padding=1, bias=False))
            self.add_module(f"norm_{i}", nn.GroupNorm(min(32, cout), cout, eps=1e-6))
            cin = cout
        self.conv_out = Conv2d(cin, 1, 4, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv_in(to_nchw(x).to(self.dtype)), 0.2)
        for i in range(1, self.n_layers + 1):
            h = getattr(self, f"conv_{i}")(h)
            norm = getattr(self, f"norm_{i}")
            h = F.group_norm(h.float(), norm.num_groups, norm.weight, norm.bias,
                             norm.eps).to(h.dtype)
            h = F.leaky_relu(h, 0.2)
        return to_nhwc(self.conv_out(h))


def hinge_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - real_logits.float()).mean()
                  + F.relu(1.0 + fake_logits.float()).mean())


@dataclasses.dataclass
class VAETrainState:
    """The modules (those make_vae_train_step was given) and their
    optimizers; ``step`` counts train_step calls."""

    vae: AutoencoderKL
    disc: PatchDiscriminator
    vae_opt: torch.optim.Adam
    disc_opt: torch.optim.Adam
    step: int = 0


def create_vae_train_state(vae: AutoencoderKL, disc: PatchDiscriminator,
                           lr: float = 4.5e-6) -> VAETrainState:
    """Two Adams with the reference's betas (autoencoder.py:128-133), as
    ``optax.adam(lr, b1=0.5, b2=0.9)``: eps 1e-8, no weight decay. The
    modules keep the weights they have (``models.layers.init_like_flax``
    gives a fresh discriminator flax's initialization)."""
    adam = lambda m: torch.optim.Adam(m.parameters(), lr=lr, betas=(0.5, 0.9), eps=1e-8)
    return VAETrainState(vae=vae, disc=disc, vae_opt=adam(vae), disc_opt=adam(disc))


def calculate_adaptive_weight(
    vae: AutoencoderKL,
    disc: PatchDiscriminator,
    images: torch.Tensor,
    eps: torch.Tensor,
    rec_fn: Callable,
    disc_weight: float = 0.5,
) -> torch.Tensor:
    """d_weight = ||grad_last rec|| / (||grad_last gan|| + 1e-4), clip
    [0, 1e4], x disc_weight (contperceptual.py:32-43), `last` the decoder's
    conv_out weight. The decode trunk runs without a gradient up to
    conv_out's input; both gradients are taken through one conv_out
    application. ``eps`` is the step's latent draw."""
    dec = vae.decoder
    with torch.no_grad():
        mean, logvar = vae.encode(images)
        z = mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)
        h = dec.features(vae.post_quant_conv(to_nchw(z).to(vae.dtype)))
    last = dec.conv_out.weight
    recon = to_nhwc(dec.conv_out(h))
    rec = rec_fn(images, recon).mean()
    gan = -disc(recon).float().mean()
    (rec_g,) = torch.autograd.grad(rec, last, retain_graph=True)
    (gan_g,) = torch.autograd.grad(gan, last)
    d_weight = torch.linalg.vector_norm(rec_g) / (torch.linalg.vector_norm(gan_g) + 1e-4)
    return d_weight.clamp(0.0, 1e4).detach() * disc_weight


def make_vae_train_step(
    vae: AutoencoderKL,
    disc: PatchDiscriminator,
    kl_weight: float = 1e-6,
    disc_weight: float = 0.5,
    disc_start: int = 50001,
    rec_loss: str = "l1",
    perceptual_fn: Callable | None = None,
    perceptual_weight: float = 1.0,
    adaptive_d_weight: bool = True,
):
    """Returns train_step(state, images, noise=None, generator=None) ->
    metrics, alternating G/D like the reference's optimizer_idx scheme
    (losses/contperceptual.py semantics) and updating ``state`` in place.
    ``images`` NHWC in [-1, 1]; ``noise`` is the step's latent draw (else
    drawn from ``generator``). The metrics are 0-dim tensors (no host
    sync): g_loss, rec, kl, d_loss, d_weight.

    adaptive_d_weight=True (the reference default) rebalances the
    generator's GAN term against the reconstruction term per step via the
    last-decoder-layer gradient-norm ratio; False uses the fixed
    disc_weight."""

    def rec(x, y):
        e = (x - y).abs() if rec_loss == "l1" else (x - y).square()
        if perceptual_fn is not None:
            e = e + perceptual_weight * perceptual_fn(x, y)
        return e

    def train_step(state: VAETrainState, images: torch.Tensor,
                   noise: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> dict:
        vae_params, disc_params = list(vae.parameters()), list(disc.parameters())
        eps = noise if noise is not None else torch.randn(
            vae.latent_shape(images.shape), generator=generator, device=images.device)
        use_gan = state.step >= disc_start
        if adaptive_d_weight:
            d_weight = calculate_adaptive_weight(vae, disc, images, eps, rec, disc_weight)
        else:
            d_weight = torch.tensor(disc_weight, device=images.device)

        # G step
        recon, (mean, logvar) = vae(images, noise=eps)
        rec_l = rec(images, recon).mean()
        kl_l = diagonal_gaussian_kl(mean, logvar).mean() / images[0].numel()
        g_gan = -disc(recon).float().mean() if use_gan else torch.zeros((), device=images.device)
        g_loss = rec_l + kl_weight * kl_l + d_weight * g_gan
        for p, g in zip(vae_params, torch.autograd.grad(g_loss, vae_params)):
            p.grad = g
        state.vae_opt.step()

        # D step, on the reconstruction of the updated VAE
        with torch.no_grad():
            recon, _ = vae(images, noise=eps)
        d_loss = hinge_d_loss(disc(images), disc(recon))
        for p, g in zip(disc_params, torch.autograd.grad(d_loss, disc_params)):
            p.grad = g
        state.disc_opt.step()
        state.step += 1
        return {"g_loss": g_loss.detach(), "rec": rec_l.detach(), "kl": kl_l.detach(),
                "d_loss": d_loss.detach(), "d_weight": d_weight}

    return train_step
