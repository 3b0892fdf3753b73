"""Model construction and checkpoint loading (port of
``pbe_tpu/pipelines/loading.py``).

``load_pipeline`` builds the model from YAML directly on its device,
initializes it from a seed as flax does, and overlays a reference-format
``.ckpt`` when one is given.
"""
from __future__ import annotations

import re

import torch
from torch import nn

from pbe_tpu_torch.models.layers import init_like_flax
from pbe_tpu_torch.models.pbe import PaintByExample, build_from_yaml
from pbe_tpu_torch.models.unet import MyResBlock, ResBlock, SpatialTransformer, UNetModel
from pbe_tpu_torch.pipelines.inference import EditPipeline

# reference checkpoint keys the port has no parameter for: recomputed
# schedule buffers, EMA shadows, loss modules, position_ids, the
# single-token cross-attention's to_q/to_k and the dead MyResBlock skip
_DROP_RE = re.compile("|".join([
    r"^betas$", r"^alphas_cumprod", r"^sqrt_", r"^log_one_minus", r"^posterior_",
    r"^lvlb_weights$", r"^logvar$", r"^model_ema\.", r"^first_stage_model\.loss\.",
    r"position_ids$", r"^cond_ids$", r"^ddim_",
    r"\.attn2\.to_q\.", r"\.attn2\.to_k\.",
    r"^model\.diffusion_model\.add_resbolck\.1\.0\.skip_connection\.",
]))


def _zero_init_modules(model: nn.Module) -> list[nn.Module]:
    """The convs flax initializes to zero: every ResBlock's out conv, every
    SpatialTransformer's proj_out and the UNet's eps head."""
    out = []
    for m in model.modules():
        if isinstance(m, (ResBlock, MyResBlock)):
            out.append(m.out_layers[3])
        elif isinstance(m, SpatialTransformer):
            out.append(m.proj_out)
        elif isinstance(m, UNetModel):
            out.append(m.out[2])
    return out


@torch.no_grad()
def init_parameters(model: PaintByExample, seed: int = 0) -> PaintByExample:
    """Initialize every parameter in place as flax does
    (``models.layers.init_like_flax``: lecun-normal (truncated) kernels,
    zero biases, unit norm scales, normal(0.02) CLIP embeddings,
    normal(1.0) learnable vector), then the zero-init heads. Draws come
    from a generator on the model's device, so nothing is built on the
    host."""
    init_like_flax(model, seed)
    for m in _zero_init_modules(model):
        m.weight.zero_()
    return model


@torch.no_grad()
def randomize_zero_params(model: nn.Module, seed: int = 0, scale: float = 0.1) -> nn.Module:
    """Replace every all-zero float parameter with seeded gaussian * scale.

    The eps head, every ResBlock out conv and every transformer proj_out are
    zero-init, so a random-init model predicts eps == 0 and every sampler
    trajectory is the same: benches and parity tests on random weights run
    this first (the JAX package's function of the same name)."""
    for p in model.parameters():
        if p.is_floating_point() and p.numel() and not torch.any(p):
            gen = torch.Generator(device=p.device).manual_seed(int(seed))
            seed += 1
            p.normal_(0.0, scale, generator=gen)
    return model


@torch.no_grad()
def eps_rms_probe(model: PaintByExample, height: int = 512, width: int = 512,
                  seed: int = 0) -> float:
    """RMS of one eps prediction on random inputs at the edit geometry; a
    bench on random weights checks it clears ~1e-3 before it times anything."""
    f = model.latent_downsample
    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    x9 = torch.randn((1, height // f, width // f, 9), generator=gen,
                     device=model.device).to(model.dtype)
    ctx = torch.randn((1, 1, 768), generator=gen, device=model.device).to(model.dtype)
    t = torch.full((1,), 500.0, device=model.device)
    eps = model.apply_model(x9, t, ctx)
    return float(eps.float().square().mean().sqrt())


@torch.no_grad()
def load_checkpoint(model: PaintByExample, ckpt_path: str, verbose: bool = True,
                    drop_prefixes: tuple[str, ...] = ()) -> tuple[list[str], list[str]]:
    """Overlay a reference-format ``.ckpt`` (``{"state_dict": ...}``) on the
    model: known-dead keys are dropped, a 4-channel first conv gets the
    9-channel surgery (extra inputs zero), and missing keys keep their
    init. Keys starting with any of ``drop_prefixes`` are dropped before
    the load: ``("model.",)`` is the reference's --train_from_scratch
    (main.py:244-248: the UNet keeps its random init, only the frozen VAE
    and CLIP load). Returns (missing, unexpected)."""
    blob = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict", blob)
    pre = tuple(drop_prefixes)
    sd = {k: v for k, v in sd.items()
          if not _DROP_RE.search(k) and not (pre and k.startswith(pre))}
    key = "model.diffusion_model.input_blocks.0.0.weight"
    want = model.state_dict().get(key)
    if key in sd and want is not None and sd[key].shape[1] < want.shape[1]:
        got = sd[key]
        pad = torch.zeros(got.shape[0], want.shape[1] - got.shape[1], *got.shape[2:],
                          dtype=got.dtype)
        sd[key] = torch.cat([got, pad], dim=1)
        if verbose:
            print(f"expanded first conv input channels {got.shape[1]} -> {want.shape[1]} "
                  "with zeros (SD -> PBE 9-channel surgery)")
    result = model.load_state_dict(sd, strict=False)
    if verbose:
        print(f"Restored from {ckpt_path}: {len(result.missing_keys)} missing, "
              f"{len(result.unexpected_keys)} unexpected keys")
        if result.missing_keys:
            print(f"  missing (kept init): {result.missing_keys[:8]}")
        if result.unexpected_keys:
            print(f"  unexpected: {result.unexpected_keys[:8]}")
    return list(result.missing_keys), list(result.unexpected_keys)


def load_pipeline(config_path: str, ckpt_path: str | None = None,
                  device: str | torch.device | None = "cuda",
                  dtype: torch.dtype = torch.bfloat16, attn_impl: str = "flash",
                  seed: int = 0, verbose: bool = True, quantize: str | None = None,
                  tiling=None, quant_scales: tuple | None = None
                  ) -> tuple[EditPipeline, dict]:
    """Build the model from YAML on ``device`` (+ optional reference .ckpt)
    -> (pipeline, raw config). ``attn_impl="flash"`` runs the UNet and VAE
    self-attention through the Hopper kernels on CUDA (bf16 or fp32, by
    ``dtype``) and their plain version on the CPU; ``"plain"`` runs einsum
    attention. ``quantize="int8"`` serves with w8a8 UNet matmuls and convs
    (ops/quant.py); ``quant_scales`` are calibrated static scales
    (``EditPipeline.calibrate_int8``). ``tiling``: an ops.tiling.TilingSpec
    that runs every UNet eps call of an edit over latent crops (the
    reference's split_input_params, latent_diffusion.py:656-736)."""
    model, raw = build_from_yaml(config_path, dtype=dtype, attn_impl=attn_impl,
                                 device=device, remat=False)
    init_parameters(model, seed)
    if ckpt_path:
        load_checkpoint(model, ckpt_path, verbose=verbose)
    elif verbose:
        print("WARNING: no checkpoint given — running with randomly initialized "
              "weights (outputs will not be meaningful edits)")
    if verbose:
        n = sum(p.numel() for p in model.parameters())
        print(f"model parameters: {n / 1e6:.1f}M")
    return EditPipeline(model, quantize=quantize, tiling=tiling,
                        quant_scales=quant_scales), raw
