"""The port's frozen edit programs (pipelines/export.py, export_runtime.py and
their scripts), fp32 on the CPU at the geometry of tests/test_pipeline.py:
the frozen PLMS edit against JAX's live edit, the frozen programs bit for
bit against the port's live edits (PLMS with the step body run 0, 1 and 2
times, DDIM at eta 0 and > 0, int8 and int8-static), what the programs and
their archives hold, the runtime in a process without model code, the
params file, the flash ops' fake implementations and FLOP formulas, the
backward's cotangent repair and the checkpoint surgery script."""
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch
from torch.export.graph_signature import InputKind
from torch.utils.flop_counter import FlopCounterMode
from torch.utils._python_dispatch import TorchDispatchMode

from pbe_tpu.pipelines.inference import EditPipeline as JEditPipeline

from pbe_tpu_torch import export_runtime as rt
from pbe_tpu_torch.models.clip_vit import CLIPVisionConfig as TClip
from pbe_tpu_torch.models.exemplar import ExemplarEncoderConfig as TExemplar
from pbe_tpu_torch.models.layers import init_like_flax
from pbe_tpu_torch.models.pbe import PaintByExample as TPBE
from pbe_tpu_torch.models.unet import UNetConfig as TUNet
from pbe_tpu_torch.models.vae import AutoencoderKLConfig as TVAE
from pbe_tpu_torch.ops import flash_attention as tfa
from pbe_tpu_torch.pipelines.export import export_edit_program, save_edit_program
from pbe_tpu_torch.pipelines.inference import EditPipeline as TEditPipeline
from pbe_tpu_torch.pipelines.loading import load_checkpoint, randomize_zero_params
from pbe_tpu_torch.scripts import export_program, modify_checkpoints

from _torch_port import PIPELINE_GEO, pipeline_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# test_torch_edit.py's bound against JAX's edit (PARITY.md:51-53 over the
# 5 eps calls and the decode)
IMAGE_ATOL = 2e-4
# the int8 gates' geometry (tests/test_torch_quant.py): 128 channels and
# 16x16 latents, so the UNet's convs and dense layers quantize
INT8_GEO = dict(
    unet=dict(model_channels=128, channel_mult=(1,), num_res_blocks=1,
              attention_resolutions=(1,), num_heads=4, context_dim=768,
              use_checkpoint=False),
    vae=dict(ddconfig={"ch": 16, "ch_mult": [1, 2, 2], "num_res_blocks": 1,
                       "z_channels": 4, "double_z": True, "out_ch": 3,
                       "in_channels": 3, "resolution": 64}, embed_dim=4),
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Six test workers share the CPU: two intra-op threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipelines():
    jm, variables, tm = pipeline_pair()
    return JEditPipeline(jm, variables), TEditPipeline(tm)


def _inputs(size=32, f=4, seed=0):
    g = np.random.default_rng(seed)
    image = g.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    mask = np.ones((2, size, size, 1), np.float32)
    mask[:, size // 4: 3 * size // 4, 6: size * 5 // 8] = 0.0
    ref = g.standard_normal((2, 32, 32, 3)).astype(np.float32)
    x_T = g.standard_normal((2, size // f, size // f, 4)).astype(np.float32)
    return image, mask, ref, x_T


def _freeze(pipe, path=None, size=32, **kw):
    """Export one configuration -> (the runtime's fn over the programs in
    memory, the programs); written to ``path`` too where given (loading
    them back is the subprocess test's)."""
    program = export_edit_program(pipe, batch=2, height=size, width=size, **kw)
    if path is not None:
        save_edit_program(str(path), program)
    return rt.edit_program_fn(program["programs"], program["manifest"]), program["programs"]


def _params(pipe):
    return dict(pipe.model.state_dict())


DDIM = dict(steps=4, sampler="ddim", eta=0.5, cfg=True, det_first_stage=True, paste_back=2)


def _noise():
    return np.random.default_rng(5).standard_normal((4, 2, 8, 8, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def frozen_ddim(pipelines, tmp_path_factory):
    """A DDIM edit at eta > 0 (its standard normals an input, one row a
    step) with paste-back, frozen and written out with its params.npz: the
    artifact of the archive and runtime tests (a prologue without UNet
    calls loads fastest)."""
    _, tp = pipelines
    path = tmp_path_factory.mktemp("frozen_ddim")
    fn, programs = _freeze(tp, path, **DDIM)
    rt.save_params_npz(str(path / "params.npz"), _params(tp))
    return path, fn, programs


def _live_ddim(tp, image, mask, ref, x_T):
    kw = {k: v for k, v in DDIM.items() if k != "cfg"}
    return tp.edit_batch(image, mask, ref, scale=3.0, x_T=x_T, noise=_noise(), **kw)


class _OpCount(TorchDispatchMode):
    """Counts the pbe ops a region calls."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func.namespace == "pbe"
        return func(*args, **(kwargs or {}))


def test_frozen_edit_matches_jax_live_edit(pipelines):
    """test_torch_edit.py's edit frozen: PLMS 4, CFG 5, the posterior mode."""
    jp, tp = pipelines
    fn, _ = _freeze(tp, steps=4, cfg=True, det_first_stage=True)
    image, mask, ref, x_T = _inputs()
    want = jp.edit_batch(image, mask, ref, steps=4, scale=5.0, x_T=x_T, det_first_stage=True)
    got = fn(_params(tp), image, mask, ref, x_T, np.float32(5.0)).numpy()
    assert got.shape == (2, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_ATOL)
    live = tp.edit_batch(image, mask, ref, steps=4, scale=5.0, x_T=x_T, det_first_stage=True)
    np.testing.assert_array_equal(got, live)


def test_programs_hold_the_flash_ops_and_no_parameter(pipelines, frozen_ddim):
    _, tp = pipelines
    path, fn, programs = frozen_ddim
    image, mask, ref, x_T = _inputs()
    with torch.inference_mode(), _OpCount() as live:
        _live_ddim(tp, image, mask, ref, x_T)
    nodes = {name: sum(str(n.target).startswith("pbe.") for n in ep.graph.nodes)
             for name, ep in programs.items()}
    runs = fn.manifest["programs"]["step"]["runs"]
    assert runs == 4 and nodes["step"] > 0 and nodes["prologue"] == nodes["epilogue"] == 1
    assert nodes["prologue"] + runs * nodes["step"] + nodes["epilogue"] == live.n
    for name, ep in programs.items():
        kinds = {s.kind for s in ep.graph_signature.input_specs}
        assert InputKind.PARAMETER not in kinds and InputKind.BUFFER not in kinds, name
        user = [s.arg.name for s in ep.graph_signature.input_specs
                if s.kind == InputKind.USER_INPUT]
        assert len(user) >= len(fn.in_specs["params"]), name
        files = zipfile.ZipFile(path / f"{name}.pt2").infolist()
        weights = [f.filename for f in files if "/data/weights/" in f.filename
                   and not f.filename.endswith("model_weights_config.json")]
        samples = [f.filename for f in files if "/sample_inputs/" in f.filename
                   and f.file_size]
        assert weights == [] and samples == [], name
    # every input's frozen shape and dtype, as JAX's in_avals
    assert list(fn.in_specs) == ["params", "image", "mask", "ref", "x_T", "scale", "noise"]
    assert fn.in_specs["x_T"] == ((2, 8, 8, 4), torch.float32)
    assert fn.in_specs["noise"] == ((4, 2, 8, 8, 4), torch.float32)
    assert fn.in_specs["params"] == {k: (tuple(v.shape), v.dtype)
                                     for k, v in _params(tp).items()}


def test_runtime_runs_in_a_process_without_model_code(pipelines, frozen_ddim, tmp_path):
    _, tp = pipelines
    path, fn, _ = frozen_ddim
    image, mask, ref, x_T = _inputs()
    np.savez(tmp_path / "inputs.npz", image=image, mask=mask, ref=ref, x_T=x_T,
             noise=_noise())
    want = _live_ddim(tp, image, mask, ref, x_T)
    code = f"""
import sys
import numpy as np
import torch
torch.set_num_threads({torch.get_num_threads()})  # the CPU's sums split as here
from pbe_tpu_torch import export_runtime as rt
banned = [m for m in sys.modules if m.startswith(("pbe_tpu_torch.models",
          "pbe_tpu_torch.pipelines", "pbe_tpu_torch.samplers", "pbe_tpu.", "jax."))
          or m in ("pbe_tpu", "jax")]
assert not banned, banned
fn = rt.load_edit_program_dir({str(path)!r})
params = rt.load_params_npz({str(path / "params.npz")!r}, device=None)
d = np.load({str(tmp_path / "inputs.npz")!r})
args = [d["image"], d["mask"], d["ref"], d["x_T"], np.float32(3.0), d["noise"]]
out = fn(params, *args)
assert torch.equal(out, fn(params, *args))
np.save({str(tmp_path / "out.npy")!r}, out.numpy())
"""
    env = {**os.environ, "PYTHONPATH": ROOT}
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want)


@pytest.mark.parametrize("steps", [3, 4, 5])
def test_frozen_plms_equals_live_with_posterior_sample(pipelines, steps):
    """Scale 1 (the single-call program) and the posterior sampled with
    normals drawn as the live generator draws them after an injected x_T;
    the step body runs 0, 1 and 2 times."""
    _, tp = pipelines
    fn, _ = _freeze(tp, steps=steps, cfg=False, det_first_stage=False)
    assert fn.manifest["programs"]["step"]["runs"] == steps - 3
    image, mask, ref, x_T = _inputs()
    eps = torch.randn((2, 8, 8, 4), generator=torch.Generator().manual_seed(7))
    got = fn(_params(tp), image, mask, ref, x_T, 1.0, eps).numpy()
    want = tp.edit_batch(image, mask, ref, steps=steps, scale=1.0, seed=7, x_T=x_T)
    np.testing.assert_array_equal(got, want)
    # not the posterior mode: the sample moved the result
    det = tp.edit_batch(image, mask, ref, steps=steps, scale=1.0, x_T=x_T,
                        det_first_stage=True)
    assert np.abs(want - det).max() > 1e-4


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_frozen_ddim_equals_live(pipelines, frozen_ddim, eta):
    _, tp = pipelines
    if eta > 0:
        fn = frozen_ddim[1]
    else:
        fn, _ = _freeze(tp, **{**DDIM, "eta": eta})
    image, mask, ref, x_T = _inputs()
    args = [_noise()] if eta > 0 else []
    assert list(fn.in_specs)[-1] == ("noise" if eta > 0 else "scale")
    got = fn(_params(tp), image, mask, ref, x_T, 3.0, *args).numpy()
    want = tp.edit_batch(image, mask, ref, steps=4, scale=3.0, sampler="ddim", eta=eta,
                         x_T=x_T, det_first_stage=True, paste_back=2,
                         noise=_noise() if eta > 0 else None)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def int8_model():
    g = INT8_GEO
    model = TPBE(unet_config=TUNet(**g["unet"]), vae_config=TVAE(**g["vae"]),
                 cond_config=TExemplar(clip=TClip(**PIPELINE_GEO["clip"]), mapper_layers=1),
                 attn_impl="flash")
    return randomize_zero_params(init_like_flax(model, seed=3), seed=3).eval()


@pytest.mark.parametrize("static", [False, True], ids=["int8", "int8-static"])
def test_frozen_int8_equals_live(int8_model, static):
    image, mask, ref, x_T = _inputs(size=64, f=4, seed=2)
    pipe = TEditPipeline(int8_model, quantize="int8")
    if static:
        pipe = TEditPipeline(int8_model, quantize="int8",
                             quant_scales=pipe.calibrate_int8(image[:1], mask[:1], ref[:1],
                                                              n_t=2))
    fn, programs = _freeze(pipe, size=64, steps=4, cfg=True, det_first_stage=True)
    for name in ("prologue", "step"):
        assert any(n.target is torch.ops.aten._int_mm.default
                   for n in programs[name].graph.nodes), name
    got = fn(_params(pipe), image, mask, ref, x_T, 5.0).numpy()
    want = pipe.edit_batch(image, mask, ref, steps=4, scale=5.0, x_T=x_T,
                           det_first_stage=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_params_npz_round_trip(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    params = {"a.weight": torch.randn(3, 5, generator=g).to(dtype),
              "b.bias": torch.randn(7, generator=g).to(dtype),
              "c": torch.tensor([-0.0, float("inf"), 1e-40], dtype=dtype)}
    rt.save_params_npz(str(tmp_path / "p.npz"), params)
    back = rt.load_params_npz(str(tmp_path / "p.npz"), device="cpu")
    assert list(back) == list(params)
    for k, v in params.items():
        assert back[k].dtype == dtype and back[k].shape == v.shape
        assert torch.equal(back[k].view(torch.int16 if dtype == torch.bfloat16 else
                                         torch.int32),
                           v.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    with np.load(tmp_path / "p.npz", allow_pickle=False) as d:  # no pickle inside
        assert d["a.weight"].shape == (3, 5)


def test_export_program_refuses_data_parallel(tmp_path):
    with pytest.raises(SystemExit) as e:
        export_program.main(["--outdir", str(tmp_path), "--data_parallel", "--device", "cpu"])
    assert e.value.code not in (0, None) and "item 11" in str(e.value.code)


_OPS = {
    "flash_fwd": lambda q, k, v, o, lse, do, dd: (q, k, v, "fwd", 0),
    "flash_fwd_lse": lambda q, k, v, o, lse, do, dd: (q, k, v, "resident", 32),
    "flash_bwd_dq": lambda q, k, v, o, lse, do, dd: (q, k, v, do, lse, dd),
    "flash_bwd_dkv": lambda q, k, v, o, lse, do, dd: (q, k, v, do, lse, dd),
}


@pytest.mark.parametrize("name", list(_OPS))
def test_opcheck(name):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 40, 2, 16, generator=g) for _ in range(3))
    o, lse = tfa.flash_attention_plain(q, k, v, return_lse=True)
    do = torch.randn(o.shape, generator=g)
    args = _OPS[name](q, k, v, o, lse, do, tfa.rowsum_do_o(do, o))
    torch.library.opcheck(getattr(torch.ops.pbe, name).default, args)


def _cotangent(kind, shape, g):
    b, n, h, d = shape
    if kind == "expanded":
        return torch.ones(()).expand(shape)
    if kind == "permuted":
        return torch.randn(b, n, d, h, generator=g).permute(0, 1, 3, 2)
    return torch.randn(b * n * h * d + 2, generator=g)[2:].view(shape)


@pytest.mark.parametrize("kind", ["expanded", "permuted", "offset"])
def test_backward_takes_any_cotangent(kind):
    """The cotangent the backward hands the kernels is one they read in
    place, and the gradients are the plain backward's on the cotangent."""
    g = torch.Generator().manual_seed(2)
    shape = (2, 24, 2, 40)
    do = _cotangent(kind, shape, g)
    assert tfa.layout_error(do) is not None
    handed = tfa.kernel_cotangent(do)
    assert tfa.layout_error(handed) is None and torch.equal(handed, do)
    q, k, v = (torch.randn(shape, generator=g).requires_grad_() for _ in range(3))
    out = tfa.flash_attention(q, k, v)
    got = (torch.autograd.grad(out.sum(), (q, k, v)) if kind == "expanded"
           else torch.autograd.grad(out, (q, k, v), do))
    o, lse = tfa.flash_attention_plain(q.detach(), k.detach(), v.detach(), return_lse=True)
    # bit for bit the plain backward on the dense copy (the same numbers);
    # on the strided view itself the CPU's products may sum in another order
    want = tfa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o, lse, handed)
    on_view = tfa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o, lse, do)
    for a, b, c in zip(got, want, on_view):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)


def test_flop_formulas_count_the_flash_ops():
    g = torch.Generator().manual_seed(3)
    b, n, h, d = 2, 64, 2, 16
    q, k, v = (torch.randn(b, n, h, d, generator=g).requires_grad_() for _ in range(3))
    with FlopCounterMode(display=False) as fwd:
        out = tfa.flash_attention(q, k, v)
    assert fwd.get_total_flops() == 4 * b * h * n * n * d
    with FlopCounterMode(display=False) as bwd:
        out.sum().backward()
    counts = bwd.get_flop_counts()["Global"]
    assert counts[torch.ops.pbe.flash_bwd_dq] == 6 * b * h * n * n * d
    assert counts[torch.ops.pbe.flash_bwd_dkv] == 8 * b * h * n * n * d


def test_unet_call_counts_the_same_flops_with_flash_and_plain():
    g = PIPELINE_GEO["unet"]
    x9 = torch.randn(2, 8, 8, 9, generator=torch.Generator().manual_seed(4))
    t, ctx = torch.full((2,), 500.0), torch.randn(2, 1, 768)
    flops = {}
    for impl in ("flash", "plain"):
        unet = TUNet(**g).build(torch.float32, impl, False)
        with torch.no_grad(), FlopCounterMode(display=False) as mode:
            unet(x9, t, ctx)
        flops[impl] = mode.get_total_flops()
        if impl == "flash":
            assert torch.ops.pbe.flash_fwd in mode.get_flop_counts()["Global"]
    assert flops["flash"] == flops["plain"] > 0


def _unet_ckpt(tmp_path, cin):
    w = torch.randn(8, cin, 3, 3, generator=torch.Generator().manual_seed(cin))
    path = tmp_path / f"sd{cin}.ckpt"
    torch.save({"state_dict": {modify_checkpoints.KEY: w,
                               "model.diffusion_model.input_blocks.0.0.bias": torch.ones(8)}},
               path)
    return path, w


def test_modify_checkpoints_matches_load_checkpoint_surgery(pipelines, tmp_path):
    _, tp = pipelines
    src, w = _unet_ckpt(tmp_path, 4)
    dst = tmp_path / "sd9.ckpt"
    modify_checkpoints.main([str(src), str(dst)])
    widened = torch.load(dst, weights_only=True)["state_dict"][modify_checkpoints.KEY]
    assert widened.shape == (8, 9, 3, 3) and torch.equal(widened[:, :4], w)
    assert not torch.any(widened[:, 4:])
    model = tp.model
    saved = {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith("model.diffusion_model.input_blocks.0.0.")}
    try:
        load_checkpoint(model, str(src), verbose=False)
        assert torch.equal(model.state_dict()[modify_checkpoints.KEY], widened)
    finally:
        model.load_state_dict(saved, strict=False)


def test_modify_checkpoints_copies_a_9_channel_file(tmp_path):
    src, w = _unet_ckpt(tmp_path, 9)
    dst = tmp_path / "copy.ckpt"
    modify_checkpoints.main([str(src), str(dst)])
    assert torch.equal(torch.load(dst, weights_only=True)["state_dict"][
        modify_checkpoints.KEY], w)
