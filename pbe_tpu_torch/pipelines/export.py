"""Frozen edit programs (port of ``pbe_tpu/pipelines/export.py``).

``export_edit_program`` traces one edit configuration at a fixed geometry
with ``torch.export`` into three programs that a host runs with torch and
``pbe_tpu_torch/export_runtime.py`` alone, no model code:

  * ``prologue``: encode the masked source and the exemplar, and run the
    sampler's peeled steps (PLMS steps 0-2 with step 0's Heun double call;
    none for DDIM);
  * ``step``: one step of the sampler (PLMS's uniform AB4 body on a
    most-recent-first eps history of fixed shape; DDIM's step, with that
    step's standard normals as an input at eta > 0), its index an input;
  * ``epilogue``: decode, [0,1], paste-back.

The JAX program has the same shape: it peels PLMS's first three steps and
scans the rest as one body. Unrolling a 50-step edit would trace ~51 UNet
calls. Every piece is :class:`~pbe_tpu_torch.pipelines.inference.EditBody`'s
and the samplers' step functions, which the live edit runs too.

The parameters stay out of the programs, as in JAX (3.4 GB of weights do not
belong in the artifact): each program takes them as its first inputs, one
tensor each in the order of the manifest's ``params`` (the reference
state_dict keys), and the model is traced with those inputs put in place of
its own tensors (``torch.func.functional_call``'s
reparametrization), so no program holds a parameter or buffer. An ``int8``
pipeline freezes its w8a8 program (inside ``quant.quantized``, static scales
as constants). Flash attention is the ``pbe`` custom ops, one node a call.
A sharded program is not offered: ``EditPipeline.shard`` is not ported
(ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

import json
import os

import torch
from torch.nn.utils import stateless

from pbe_tpu_torch.export_runtime import MANIFEST
from pbe_tpu_torch.ops import quant
from pbe_tpu_torch.pipelines.inference import EditBody
from pbe_tpu_torch.samplers.ddim import ddim_step, ddim_tables
from pbe_tpu_torch.samplers.plms import PEELED, plms_step, plms_tables


class _Program(torch.nn.Module):
    """fn(params, *inputs) as a module that owns no parameter, called with
    the parameters as flat tensors in ``keys``' order ahead of the inputs:
    ``fn`` reaches the model only through :func:`_params_in_place`."""

    def __init__(self, fn, keys: list[str]):
        super().__init__()
        self.fn, self.keys = fn, keys

    def forward(self, *args):
        n = len(self.keys)
        return self.fn(dict(zip(self.keys, args[:n])), *args[n:])


def _params_in_place(model: torch.nn.Module, params: dict):
    """The model with ``params`` (every parameter and persistent buffer: its
    state_dict's keys) in place of its own tensors, as
    ``torch.func.functional_call`` puts them. The edit reads none of the
    model's non-persistent buffers (the training step's q-sample tables)."""
    return stateless._reparametrize_module(model, params)


def _spec(name: str, x: torch.Tensor) -> list:
    return [name, list(x.shape), str(x.dtype).removeprefix("torch.")]


def export_edit_program(pipeline, *, batch: int, height: int = 512, width: int = 512,
                        steps: int = 50, sampler: str = "plms", eta: float = 0.0,
                        cfg: bool = True, paste_back: int | None = None,
                        det_first_stage: bool = False) -> dict:
    """Trace one edit configuration -> {"programs": {"prologue", "step",
    "epilogue": ExportedProgram}, "manifest": dict} on the pipeline's device.

    The frozen edit is ``(params, image, mask, ref, x_T, scale[,
    eps_first_stage][, noise]) -> img01``, float32 inputs as
    ``edit_batch`` takes them: ``scale`` a 0-d tensor (only guided-or-not,
    ``cfg``, is fixed here); ``eps_first_stage`` the posterior's standard
    normals of the latent's shape (absent with ``det_first_stage``);
    ``noise`` DDIM's (steps, B, h, w, 4) standard normals at eta > 0. It
    equals ``edit_batch(..., x_T=x_T, scale=scale)`` with the same draws."""
    if sampler not in ("plms", "ddim"):
        raise ValueError(f"the frozen edit takes sampler 'plms' or 'ddim', got {sampler!r}")
    model = pipeline.model
    dev, dt, f = model.device, model.dtype, model.latent_downsample
    body = EditBody(pipeline, steps=steps, sampler=sampler, eta=eta, cfg=cfg,
                    paste_back=paste_back)
    stochastic = sampler == "ddim" and eta > 0.0
    b, h, w, r = batch, height // f, width // f, pipeline.ref_size
    zeros = lambda *shape: torch.zeros(shape, device=dev)
    inputs = {"image": zeros(b, height, width, 3), "mask": zeros(b, height, width, 1),
              "ref": zeros(b, r, r, 3), "x_T": zeros(b, h, w, 4), "scale": zeros()}
    if not det_first_stage:
        inputs["eps_first_stage"] = zeros(b, h, w, 4)
    if stochastic:
        inputs["noise"] = zeros(int(steps), b, h, w, 4)
    params = dict(model.state_dict())

    if sampler == "plms":
        tables, peeled = plms_tables(body.sched, dev), min(PEELED, int(steps))
        state = ["x", "e1", "e2", "e3", "z_inpaint", "m_lat", "c"]

        def prologue(params, image, mask, ref, x_T, scale, eps=None):
            with _params_in_place(model, params):
                z_inpaint, m_lat, c = body.encode(image, mask, ref, eps=eps)
                eps_fn, x, history = body.eps_fn(c, scale), x_T.to(dt), ()
                for i in range(peeled):
                    x, history = plms_step(eps_fn, tables, torch.tensor(i, device=dev), x,
                                           history, z_inpaint, m_lat)
                # a history of fixed shape: a chain of fewer than 3 steps
                # runs no step body, so the padding is never read
                history += tuple(torch.zeros_like(x, dtype=torch.float32)
                                 for _ in range(PEELED - len(history)))
                return (x, *history, z_inpaint, m_lat, c)

        def step(params, i, x, e1, e2, e3, z_inpaint, m_lat, c, scale):
            with _params_in_place(model, params):
                x, history = plms_step(body.eps_fn(c, scale), tables, i, x, (e1, e2, e3),
                                       z_inpaint, m_lat)
                return (x, *history)

        step_in = ["i", *state, "scale"]
        step_out, first, runs = state[:4], peeled, int(steps) - peeled
    else:
        tables = ddim_tables(body.sched, dev)
        state = ["x", "z_inpaint", "m_lat", "c"]

        def prologue(params, image, mask, ref, x_T, scale, eps=None):
            with _params_in_place(model, params):
                return (x_T.to(dt), *body.encode(image, mask, ref, eps=eps))

        def step(params, i, x, z_inpaint, m_lat, c, scale, z=None):
            with _params_in_place(model, params):
                return ddim_step(body.eps_fn(c, scale), tables, i, x, z_inpaint, m_lat, z)

        step_in = ["i", *state, "scale"] + (["z"] if stochastic else [])
        step_out, first, runs = ["x"], 0, int(steps)

    def epilogue(params, x, image=None, mask=None):
        with _params_in_place(model, params):
            return body.finish(x, image, mask)

    pro_in = [n for n in inputs if n != "noise"]
    epi_in = ["x"] + (["image", "mask"] if paste_back is not None else [])
    qkw = {"static": pipeline.quant_scales} if pipeline.quant_scales else {}
    programs, env = {}, dict(inputs)
    with torch.no_grad(), quant.quantized(pipeline.quantize, **qkw):
        # no_grad, as edit_batch's inference_mode: ops/conv.conv2d takes
        # the same route as the live edit
        for name, fn, names, outs in (("prologue", prologue, pro_in, state),
                                      ("step", step, step_in, step_out),
                                      ("epilogue", epilogue, epi_in, ["img01"])):
            env["i"] = torch.tensor(first, device=dev)
            if stochastic:
                env["z"] = inputs["noise"][0]
            ep = torch.export.export(_Program(fn, list(params)),
                                     (*params.values(), *(env[n] for n in names)))
            # the example inputs would be saved with the program: the
            # parameters among them
            ep.example_inputs = None
            programs[name] = ep
            out_node = next(n for n in ep.graph.nodes if n.op == "output")
            env.update({n: torch.zeros(a.meta["val"].shape, dtype=a.meta["val"].dtype,
                                       device=dev)
                        for n, a in zip(outs, out_node.args[0])})
    manifest = {
        "format": "pbe-frozen-edit/1", "device": dev.type, "batch": b, "H": height,
        "W": width, "steps": int(steps), "sampler": sampler, "eta": float(eta),
        "cfg": bool(cfg), "paste_back": paste_back, "det_first_stage": bool(det_first_stage),
        "dtype": str(dt).removeprefix("torch."), "quantize": pipeline.quantize,
        "static_scales": bool(pipeline.quant_scales), "ref_size": r,
        "latent_downsample": f,
        "signature": "(params, " + ", ".join(inputs) + ") -> img01",
        "inputs": [_spec(n, x) for n, x in inputs.items()],
        "params": [_spec(k, v) for k, v in params.items()],
        "programs": {
            "prologue": {"file": "prologue.pt2", "inputs": pro_in, "outputs": state},
            "step": {"file": "step.pt2", "inputs": step_in, "outputs": step_out,
                     "index": "i", "first_index": first, "runs": runs,
                     **({"per_step": {"z": "noise"}} if stochastic else {})},
            "epilogue": {"file": "epilogue.pt2", "inputs": epi_in, "outputs": ["img01"]},
        },
        "output": "img01",
    }
    return {"programs": programs, "manifest": manifest}


def save_edit_program(path: str, program: dict) -> dict:
    """Write an :func:`export_edit_program` result into directory ``path``:
    one ``.pt2`` a program and ``manifest.json`` (with each program's
    bytes). Returns the manifest as written."""
    os.makedirs(path, exist_ok=True)
    manifest = dict(program["manifest"])
    sizes = {}
    for name, ep in program["programs"].items():
        file = os.path.join(path, manifest["programs"][name]["file"])
        torch.export.save(ep, file)
        sizes[name] = os.path.getsize(file)
    manifest["program_bytes"] = sizes
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest
