"""Trainable/frozen parameter partition (port of ``pbe_tpu/training/partition.py``).

The reference trains exactly the UNet, the exemplar mapper and final_ln,
proj_out and the learnable unconditional vector; the VAE and the CLIP
trunk stay frozen (latent_diffusion.py:1184-1196, modules.py:153-160). The
JAX package splits the parameter tree in two; here the frozen parameters
get ``requires_grad=False``, so autograd records nothing for them and the
optimizer never sees them.
"""
from __future__ import annotations

from torch import nn

TRAINABLE_PREFIXES = ("model.", "proj_out.", "cond_stage_model.mapper.",
                      "cond_stage_model.final_ln.")


def is_trainable(name: str) -> bool:
    """Whether the parameter of this state_dict name is trained."""
    return name == "learnable_vector" or name.startswith(TRAINABLE_PREFIXES)


def split_parameters(model: nn.Module) -> tuple[dict, dict]:
    """Freeze the frozen part in place -> (trainable, frozen) name -> parameter."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        p.requires_grad_(is_trainable(name))
        (trainable if p.requires_grad else frozen)[name] = p
    return trainable, frozen
