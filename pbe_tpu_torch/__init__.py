"""pbe_tpu_torch — Paint-by-Example on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``pbe_tpu`` that loads the same weights and
computes the same edit. It imports nothing of ``pbe_tpu``: the few
framework-free pieces it needs (schedules, config registry, checkpoint key
map) are its own copies.

Layout (module names mirror ``pbe_tpu`` so each counterpart is easy to find):
    pbe_tpu_torch.config     YAML + target-alias registry (configs/v1.yaml)
    pbe_tpu_torch.schedules  diffusion beta/DDIM schedule math (numpy)
    pbe_tpu_torch.convert    flax parameter tree -> torch state_dict key map
    pbe_tpu_torch.ops        norms, image ops, attention, flash kernel wrapper
    pbe_tpu_torch.csrc       hand-written CUDA sources (built at first use)
    pbe_tpu_torch.models     UNet, VAE, CLIP ViT, exemplar encoder, PaintByExample
    pbe_tpu_torch.samplers   PLMS with folded classifier-free guidance
    pbe_tpu_torch.pipelines  EditPipeline.edit_batch and load_pipeline

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without a card they raise rather than fall back.
"""

__version__ = "0.1.0"
