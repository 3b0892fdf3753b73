"""Runtime for frozen edit programs (port of ``pbe_tpu/export_runtime.py``;
the programs are written by ``pbe_tpu_torch/pipelines/export.py``).

A light top-level module on purpose: a serving host that runs an exported
edit needs torch, numpy and this file. It imports the flash kernels' op
registrations (``ops/flash_attention.py``, which builds no kernel at import),
so that ``torch.export.load`` finds the ``pbe`` ops, and nothing of the
models, pipelines or samplers.

An artifact is a directory: ``prologue.pt2``, ``step.pt2`` and
``epilogue.pt2`` (``torch.export`` programs holding no parameter),
``params.npz`` (the parameters by their reference state_dict keys) and
``manifest.json``, which says in which order the edit's inputs come, which
program reads and writes which named value, and how many times the step
body runs. The runtime knows nothing of models: it runs the prologue, then
the step ``runs`` times carrying its outputs into its inputs, then the
epilogue.
"""
from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch

import pbe_tpu_torch.ops.flash_attention  # noqa: F401  (registers the pbe ops)

MANIFEST = "manifest.json"


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def load_edit_program_dir(path: str, device: str | torch.device | None = None) -> Callable:
    """The artifact directory -> ``fn(params, image, mask, ref, x_T, scale[,
    eps_first_stage][, noise]) -> img01``: arrays or tensors in, a float32
    tensor in [0,1] on the device out. Each input is converted to its
    frozen shape's dtype on the program's device (``device``, by default
    the one it was exported on); ``params`` is the dict of
    :func:`load_params_npz`. ``fn.in_specs`` gives each input's (shape,
    dtype) in call order, ``params`` first as a dict of the same by key
    (as JAX's ``in_avals``); ``fn.manifest`` is the manifest."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    programs = {name: torch.export.load(os.path.join(path, spec["file"]))
                for name, spec in manifest["programs"].items()}
    return edit_program_fn(programs, manifest, device)


def _flat_program(ep: torch.export.ExportedProgram, dev: torch.device) -> Callable:
    """A program as a call on its flat graph (``ep.graph_module``):
    ``call(*params, *inputs)``, every argument a tensor in the order the
    program was exported with, the constants that the export lifted (the
    samplers' tables) put in their places here once. ``ep.module()`` would
    flatten the arguments and check each against the program on every call,
    1.3k parameters 49 times an edit; the runtime checks the edit's inputs
    and parameters once a call instead."""
    from torch.export.graph_signature import InputKind

    slots, n_user = [], 0
    for spec in ep.graph_signature.input_specs:
        if spec.kind == InputKind.USER_INPUT:
            slots.append(n_user)
            n_user += 1
        elif spec.kind == InputKind.CONSTANT_TENSOR:
            slots.append(ep.constants[spec.target].to(dev))
        else:
            raise ValueError(f"a frozen program takes no {spec.kind.name} input "
                             f"({spec.target}): it holds no parameter")
    gm = ep.graph_module

    def call(*user):
        if len(user) != n_user:
            raise TypeError(f"the program takes {n_user} tensors, got {len(user)}")
        return gm(*[user[s] if isinstance(s, int) else s for s in slots])

    return call


def edit_program_fn(programs: dict, manifest: dict,
                    device: str | torch.device | None = None) -> Callable:
    """The frozen edit of :func:`load_edit_program_dir` from its programs
    (``{name: ExportedProgram}``) and manifest in memory. It runs under
    ``torch.inference_mode``, as the live edit does."""
    dev = torch.device(device or manifest["device"])
    param_specs = {k: (tuple(shape), _dtype(dt)) for k, shape, dt in manifest["params"]}
    specs = {name: (tuple(shape), _dtype(dt)) for name, shape, dt in manifest["inputs"]}
    calls = {name: _flat_program(ep, dev) for name, ep in programs.items()}

    def run(name: str, env: dict) -> None:
        spec = manifest["programs"][name]
        outs = calls[name](*env["params"], *(env[n] for n in spec["inputs"]))
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        env.update(zip(spec["outputs"], outs))

    def check(name: str, t: torch.Tensor, shape: tuple, dtype=None) -> None:
        if tuple(t.shape) != shape or (dtype is not None and t.dtype != dtype):
            raise ValueError(f"{name}: the program was frozen at shape {shape}"
                             f"{'' if dtype is None else f' and {dtype}'}, got "
                             f"{tuple(t.shape)} and {t.dtype}")

    @torch.inference_mode()
    def fn(params: dict, *args):
        if len(args) != len(specs):
            raise TypeError(f"the frozen edit takes params and {list(specs)}, got "
                            f"{len(args)} inputs after params")
        for k, (shape, dtype) in param_specs.items():
            check(k, params[k], shape, dtype)
            if params[k].device.type != dev.type:
                raise ValueError(f"{k} is on {params[k].device}, the program runs on {dev}")
        env = {"params": [params[k] for k in param_specs]}
        for (name, (shape, dtype)), a in zip(specs.items(), args):
            t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
            check(name, t, shape)
            env[name] = t.to(dev, dtype)
        run("prologue", env)
        step = manifest["programs"]["step"]
        # the step indices as views of one arange: a tensor made from a
        # host int each step would wait for the card each step
        first = step["first_index"]
        indices = torch.arange(first, first + step["runs"], device=dev)
        for r, index in enumerate(indices):
            env[step["index"]] = index
            for name, source in step.get("per_step", {}).items():
                env[name] = env[source][first + r]
            run("step", env)
        run("epilogue", env)
        return env[manifest["output"]]

    fn.in_specs = {"params": param_specs, **specs}
    fn.manifest = manifest
    return fn


def save_params_npz(path: str, params: dict) -> None:
    """A state dict -> one .npz, pickle-free: each tensor by its key, as
    numpy in its own dtype, except bfloat16 (which numpy lacks), kept bit
    for bit as its uint16 view with its dtype recorded under
    ``__dtype__/<key>``."""
    flat = {}
    for k, v in params.items():
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            flat[f"__dtype__/{k}"] = np.asarray("bfloat16")
            flat[k] = v.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[k] = v.numpy()
    np.savez(path, **flat)


def load_params_npz(path: str, device: str | torch.device | None = "cuda") -> dict:
    """Inverse of :func:`save_params_npz` -> {key: tensor}, put on
    ``device`` once here (None keeps them on the host): handing the frozen
    program host tensors would copy every parameter to the card on every
    call."""
    out = {}
    with np.load(path) as data:
        dtypes = {k.removeprefix("__dtype__/"): str(data[k]) for k in data.files
                  if k.startswith("__dtype__/")}
        for k in data.files:
            if k.startswith("__dtype__/"):
                continue
            a = data[k]
            if dtypes.get(k) == "bfloat16":
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            out[k] = t if device is None else t.to(device)
    return out
