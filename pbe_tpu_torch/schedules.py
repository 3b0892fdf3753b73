"""Diffusion noise-schedule math.

All schedule quantities are computed eagerly in float64 numpy at model-build
time (they are tiny 1-D tables) and handed to jitted code as constants, so XLA
folds them into the compiled program.

Behavioral reference: ldm/modules/diffusionmodules/util.py:21-74 and
ldm/models/diffusion/ddpm.py:175-228 in the PyTorch Paint-by-Example repo.
"""
from __future__ import annotations

import dataclasses
import numpy as np


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Return betas[t] for t in [0, n_timestep).

    'linear' is the SD/PBE schedule: linspace in sqrt-beta space, squared
    (ref: diffusionmodules/util.py:22-25).
    """
    if schedule == "linear":
        betas = (
            np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64)
            ** 2
        )
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"unknown beta schedule {schedule!r}")
    return betas


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Full forward-process tables for a DDPM chain.

    Mirrors the registered buffers of ddpm.py:register_schedule (:175-228).
    """

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    lvlb_weights: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @classmethod
    def create(
        cls,
        timesteps: int = 1000,
        beta_schedule: str = "linear",
        linear_start: float = 1e-4,
        linear_end: float = 2e-2,
        cosine_s: float = 8e-3,
        given_betas: np.ndarray | None = None,
        v_posterior: float = 0.0,
        parameterization: str = "eps",
    ) -> "DiffusionSchedule":
        betas = (
            np.asarray(given_betas, dtype=np.float64)
            if given_betas is not None
            else make_beta_schedule(
                beta_schedule, timesteps, linear_start, linear_end, cosine_s
            )
        )
        alphas = 1.0 - betas
        acp = np.cumprod(alphas, axis=0)
        acp_prev = np.append(1.0, acp[:-1])
        posterior_variance = (1 - v_posterior) * betas * (1.0 - acp_prev) / (
            1.0 - acp
        ) + v_posterior * betas
        if parameterization == "eps":
            # posterior_variance[0] == 0 -> inf at t=0, patched to t=1 below
            # exactly as the reference does (ddpm.py:226)
            with np.errstate(divide="ignore"):
                lvlb = betas**2 / (2 * posterior_variance * alphas * (1 - acp))
        elif parameterization == "x0":
            lvlb = 0.5 * np.sqrt(acp) / (2.0 * 1 - acp)
        else:
            raise NotImplementedError(parameterization)
        lvlb = lvlb.copy()
        lvlb[0] = lvlb[1]
        return cls(
            betas=betas,
            alphas_cumprod=acp,
            alphas_cumprod_prev=acp_prev,
            sqrt_alphas_cumprod=np.sqrt(acp),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - acp),
            log_one_minus_alphas_cumprod=np.log(1.0 - acp),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / acp),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / acp - 1),
            posterior_variance=posterior_variance,
            posterior_log_variance_clipped=np.log(np.maximum(posterior_variance, 1e-20)),
            posterior_mean_coef1=betas * np.sqrt(acp_prev) / (1.0 - acp),
            posterior_mean_coef2=(1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp),
            lvlb_weights=lvlb,
        )


def make_ddim_timesteps(
    num_ddim_timesteps: int,
    num_ddpm_timesteps: int,
    discr_method: str = "uniform",
) -> np.ndarray:
    """Subsequence of DDPM timesteps used by DDIM/PLMS, incl. the +1 shift
    (ref: diffusionmodules/util.py:46-60)."""
    if discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        # arange(S)*c == range(0, T, c) when S divides T (the reference's
        # formula, util.py:48-49) but stays in-bounds for ragged step counts
        # where the reference would index past the schedule
        ddim_timesteps = np.arange(num_ddim_timesteps) * c
    elif discr_method == "quad":
        ddim_timesteps = (
            np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps) ** 2
        ).astype(int)
    else:
        raise NotImplementedError(discr_method)
    return ddim_timesteps + 1


@dataclasses.dataclass(frozen=True)
class SamplerSchedule:
    """Per-DDIM-step parameter tables, indexed by step position (not DDPM t).

    alphas/alphas_prev/sigmas/sqrt_one_minus follow
    diffusionmodules/util.py:63-74; eta=0 gives deterministic DDIM.
    """

    timesteps: np.ndarray  # ascending DDPM timesteps used, shape (S,)
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray
    eta: float

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])

    @classmethod
    def create(
        cls,
        schedule: DiffusionSchedule,
        num_steps: int,
        eta: float = 0.0,
        discr_method: str = "uniform",
    ) -> "SamplerSchedule":
        ts = make_ddim_timesteps(num_steps, schedule.num_timesteps, discr_method)
        acp = schedule.alphas_cumprod
        alphas = acp[ts]
        alphas_prev = np.asarray([acp[0]] + acp[ts[:-1]].tolist())
        sigmas = eta * np.sqrt(
            (1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev)
        )
        return cls(
            timesteps=ts,
            alphas=alphas,
            alphas_prev=alphas_prev,
            sqrt_one_minus_alphas=np.sqrt(1.0 - alphas),
            sigmas=sigmas,
            eta=float(eta),
        )
