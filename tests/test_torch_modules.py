"""Each module of the PyTorch port against its JAX counterpart at small
widths (fp32, CPU, same weights carried through the port's key map), plus
the weight-loading and package-boundary contracts of the port."""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbe_tpu.convert.to_torch import _torch_key_and_value, save_torch_checkpoint
from pbe_tpu.models.clip_vit import CLIPVisionConfig as JClip
from pbe_tpu.models import unet as junet
from pbe_tpu.models import vae as jvae
from pbe_tpu.models.pbe import PaintByExample as JPBE
from pbe_tpu.models.pbe import build_from_yaml as j_build_from_yaml
from pbe_tpu.ops import norms as jnorms

from pbe_tpu_torch.convert import state_dict_from_flax
from pbe_tpu_torch.models import unet as tunet
from pbe_tpu_torch.models import vae as tvae
from pbe_tpu_torch.models.pbe import build_from_yaml as t_build_from_yaml
from pbe_tpu_torch.ops import norms as tnorms
from pbe_tpu_torch.ops.image import resize_mask
from pbe_tpu_torch.pipelines import loading as tloading

from _torch_port import PIPELINE_GEO, pipeline_pair, sub_params, tiny_yaml_pair, to_t

REPO = pathlib.Path(__file__).resolve().parent.parent
nchw = lambda a: to_t(a).permute(0, 3, 1, 2)
nhwc = lambda t: t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Six test workers share the CPU: two intra-op threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _carry(jmodule, tmodule, *args, seed=0):
    """Give every parameter of a standalone flax module (shapes traced at
    args, nothing compiled) seeded random values, so zero-init convs and
    biases are not vacuous; load the same weights into the torch module.
    Returns the flax variables."""
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(seed), *args)
    g = np.random.default_rng(seed + 100)
    variables = jax.tree.map(
        lambda s: jnp.asarray(g.standard_normal(s.shape) * 0.2, jnp.float32), shapes)
    params = jax.tree.map(np.asarray, variables["params"])
    sd = {k[2:]: v for k, v in state_dict_from_flax({"x": params}).items()}
    tmodule.load_state_dict(sd, strict=True)
    return variables


def _jit_apply(model, method):
    """A jitted model.apply: for whole models one XLA compile is several
    times faster on the CPU than running the ops one by one."""
    return jax.jit(lambda v, *args: model.apply(v, *args, method=method))


def _unet_bound(want):
    """The UNet parity bound of PARITY.md:51-53: 2e-4 x output scale. fp32
    on both sides; only the order of the reductions differs."""
    return 2e-4 * float(np.abs(want).max())


# ---- ops -------------------------------------------------------------------

@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm(eps):
    x = _rand((2, 4, 4, 48)) * 3 + 1  # gcd(32, 48) = 16 groups
    tm = tnorms.GroupNorm32(48, eps=eps)
    v = _carry(jnorms.GroupNorm32(epsilon=eps), tm, jnp.asarray(x))
    want = jnorms.GroupNorm32(epsilon=eps).apply(v, jnp.asarray(x))
    # fp32 statistics both sides (JAX takes E[x^2] - E[x]^2, torch two-pass)
    np.testing.assert_allclose(nhwc(tm(nchw(x))), np.asarray(want), atol=2e-5)


def test_layer_norm():
    x = _rand((2, 7, 64)) * 2 + 0.5
    tm = tnorms.LayerNormF32(64)
    v = _carry(jnorms.LayerNormF32(), tm, jnp.asarray(x))
    want = jnorms.LayerNormF32().apply(v, jnp.asarray(x))
    np.testing.assert_allclose(tm(to_t(x)).detach().numpy(), np.asarray(want), atol=1e-5)


def test_timestep_embedding():
    t = np.asarray([0.0, 1.0, 37.5, 981.0], np.float32)
    want = junet.timestep_embedding(jnp.asarray(t), 33)  # odd dim pads a zero
    got = tunet.timestep_embedding(to_t(t), 33)
    # fp32 cos/sin of arguments up to ~1e3: a few ulp of the argument
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_mask_resize_matches_jax_image_resize():
    g = np.random.default_rng(4)
    mask = np.ones((2, 64, 64, 1), np.float32)
    mask[:, 10:50, 7:33] = 0.0
    mask[1] = (g.uniform(size=(64, 64, 1)) > 0.5)
    want = jax.image.resize(jnp.asarray(mask), (2, 8, 8, 1), "bilinear")
    got = resize_mask(to_t(mask), (8, 8))
    # antialiased bilinear on both sides (see ops/image.py); fp32 weights
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---- UNet blocks -------------------------------------------------------------

@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 32)])
def test_resblock(cin, cout):
    x, emb = _rand((2, 8, 8, cin)), _rand((2, 24), seed=1)
    tm = tunet.ResBlock(cin, cout, 24)
    v = _carry(junet.ResBlock(cout), tm, jnp.asarray(x), jnp.asarray(emb))
    want = np.asarray(junet.ResBlock(cout).apply(v, jnp.asarray(x), jnp.asarray(emb)))
    got = nhwc(tm(nchw(x), to_t(emb)))
    np.testing.assert_allclose(got, want, atol=_unet_bound(want))


def test_spatial_transformer_one_token_context():
    x, ctx = _rand((2, 8, 8, 32)), _rand((2, 1, 768), seed=1)
    jm = junet.SpatialTransformer(heads=4, dim_head=8)
    tm = tunet.SpatialTransformer(32, 4, 8, 1, 768, attn_impl="flash")
    v = _carry(jm, tm, jnp.asarray(x), jnp.asarray(ctx))
    want = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(ctx)))
    got = nhwc(tm(nchw(x), to_t(ctx)))
    np.testing.assert_allclose(got, want, atol=_unet_bound(want))


def test_unet_downsample_pads_symmetrically():
    x = _rand((1, 9, 9, 8))
    tm = tunet.Downsample(8)
    v = _carry(junet.Downsample(), tm, jnp.asarray(x))
    want = np.asarray(junet.Downsample().apply(v, jnp.asarray(x)))
    got = nhwc(tm(nchw(x)))
    assert got.shape == want.shape == (1, 5, 5, 8)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_vae_downsample_pads_asymmetrically():
    x = _rand((1, 8, 8, 8))
    tm = tvae.Downsample(8)
    v = _carry(jvae.Downsample(), tm, jnp.asarray(x))
    want = np.asarray(jvae.Downsample().apply(v, jnp.asarray(x)))
    got = nhwc(tm(nchw(x)))
    assert got.shape == want.shape == (1, 4, 4, 8)
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---- whole models at the pipeline test geometry and at configs/tiny.yaml -----

@pytest.fixture(scope="module")
def pair():
    return pipeline_pair()


@pytest.fixture(scope="module")
def tiny_pair():
    return tiny_yaml_pair()


@pytest.mark.parametrize("which", ["pipeline_geometry", "tiny_yaml"])
def test_unet_eps(pair, tiny_pair, which):
    jm, v, tm = pair if which == "pipeline_geometry" else tiny_pair
    n = 8
    x9 = _rand((2, n, n, 9))
    t = np.asarray([7.0, 911.0], np.float32)
    ctx = _rand((2, 1, 768), seed=1)
    want = np.asarray(_jit_apply(jm, JPBE.apply_model)(v, x9, t, ctx))
    with torch.no_grad():
        got = tm.apply_model(to_t(x9), to_t(t), to_t(ctx)).numpy()
    assert np.abs(want).max() > 1e-2  # zero-init heads were randomized
    np.testing.assert_allclose(got, want, atol=_unet_bound(want))


def test_vae_encode_decode(pair):
    jm, v, tm = pair
    x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    mean, logvar = _jit_apply(jm, lambda m, x: m.first_stage_model.encode(x))(v, x)
    dec = _jit_apply(jm, lambda m, z: m.first_stage_model.decode(z))(v, mean)
    with torch.no_grad():
        tmean, tlogvar = tm.first_stage_model.encode(to_t(x))
        tdec = tm.first_stage_model.decode(to_t(np.asarray(mean)))
    for got, want in ((tmean, mean), (tlogvar, logvar), (tdec, dec)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * np.abs(want).max())


def test_clip_tower(pair):
    jm, v, tm = pair
    ref = _rand((2, 32, 32, 3), seed=3)
    jclip = JClip(**PIPELINE_GEO["clip"]).build()
    hidden, pooled = jax.jit(jclip.apply)(
        sub_params(v, "cond_stage_model", "transformer"), ref)
    with torch.no_grad():
        thidden, tpooled = tm.cond_stage_model.transformer(to_t(ref))
    # fp32 LayerNorm-bounded activations: absolute 1e-4
    np.testing.assert_allclose(thidden.numpy(), np.asarray(hidden), atol=1e-4)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(pooled), atol=1e-4)


def test_exemplar_encoder_and_conditioning(pair):
    jm, v, tm = pair
    ref = _rand((2, 32, 32, 3), seed=4)
    tok = _jit_apply(jm, lambda m, r: m.cond_stage_model(r))(v, ref)
    ctx = _jit_apply(jm, JPBE.get_conditioning)(v, ref)
    with torch.no_grad():
        ttok = tm.cond_stage_model(to_t(ref))
        tctx = tm.get_conditioning(to_t(ref))
    assert ttok.shape == (2, 1, 1024) and tctx.shape == (2, 1, 768)
    np.testing.assert_allclose(ttok.numpy(), np.asarray(tok), atol=1e-4)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(ctx), atol=2e-4 * np.abs(ctx).max())


# ---- weights and loading -------------------------------------------------------

def test_v1_state_dict_keys_and_shapes_equal_the_jax_export():
    """Full v1 geometry without allocating it: flax shapes by eval_shape
    through the JAX exporter's key map, the port built on the meta device."""
    jm, _ = j_build_from_yaml("configs/v1.yaml")
    shapes = jax.eval_shape(lambda r: jm.init(
        {"params": r}, jnp.zeros((1, 64, 64, 3)), jnp.ones((1, 64, 64, 1)),
        jnp.zeros((1, 224, 224, 3)), r, method=JPBE.initialize_all),
        jax.random.PRNGKey(0))
    want = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        key, arr = _torch_key_and_value(tuple(p.key for p in path),
                                        np.lib.stride_tricks.as_strided(
                                            np.zeros(1, np.float32), s.shape,
                                            (0,) * len(s.shape)))
        want[key] = tuple(arr.shape)
    tm, _ = t_build_from_yaml("configs/v1.yaml", device="meta")
    got = {k: tuple(p.shape) for k, p in tm.state_dict().items()}
    assert got == want
    assert 1.0e9 < sum(np.prod(s) for s in got.values()) < 1.5e9  # ~1.3B


def test_reference_ckpt_loads_through_load_pipeline(tmp_path, tiny_pair):
    _, v, tm = tiny_pair
    path = str(tmp_path / "tiny.ckpt")
    save_torch_checkpoint(v["params"], path)
    pipe, _ = tloading.load_pipeline("configs/tiny.yaml", path, device="cpu",
                                     dtype=torch.float32, verbose=False)
    got = pipe.model.state_dict()
    for k, want in tm.state_dict().items():
        torch.testing.assert_close(got[k], want, rtol=0, atol=0)


def test_four_channel_first_conv_is_expanded(tmp_path, tiny_pair):
    _, v, tm = tiny_pair
    key = "model.diffusion_model.input_blocks.0.0.weight"
    sd = dict(tm.state_dict())
    sd[key] = sd[key][:, :4].clone()  # a plain SD checkpoint: 4 latent channels
    sd["model.diffusion_model.input_blocks.1.1.transformer_blocks.0.attn2.to_q.weight"] = \
        torch.zeros(1)  # known-dead key: dropped
    path = str(tmp_path / "sd.ckpt")
    torch.save({"state_dict": sd}, path)
    model = tm.__class__(tm.unet_config, tm.vae_config, tm.cond_config)
    missing, unexpected = tloading.load_checkpoint(model, path, verbose=False)
    assert missing == [] and unexpected == []
    w = model.state_dict()[key]
    assert w.shape[1] == 9
    torch.testing.assert_close(w[:, :4], tm.state_dict()[key][:, :4], rtol=0, atol=0)
    assert not torch.any(w[:, 4:])


@pytest.mark.parametrize("entry", ["load_pipeline", "build_from_yaml"])
def test_entry_point_defaults_to_cuda_and_raises_without_it(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"load_pipeline": lambda p: tloading.load_pipeline(p, verbose=False),
          "build_from_yaml": t_build_from_yaml}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn("configs/tiny.yaml")


def test_randomize_zero_params_leaves_no_zero_tensor():
    model, _ = t_build_from_yaml("configs/tiny.yaml", device="cpu")
    tloading.init_parameters(model, seed=0)
    assert not torch.any(model.model.diffusion_model.out[2].weight)  # zero-init head
    tloading.randomize_zero_params(model, seed=0)
    assert all(torch.any(p) for p in model.parameters())


# ---- package boundary ----------------------------------------------------------

def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_pbe_tpu():
    """A static scan: the interpreter here imports jax at start-up, so
    sys.modules cannot show it. 'pbe_tpu_torch' starts with 'pbe_tpu', so
    the JAX package is matched as 'pbe_tpu' or 'pbe_tpu.*' exactly; the JAX
    package's CLIs ('scripts.*') are banned too."""
    files = sorted((REPO / "pbe_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"pbe_tpu_torch/ops/quant.py", "pbe_tpu_torch/serving/server.py",
            "pbe_tpu_torch/serving/__init__.py", "pbe_tpu_torch/scripts/serve.py",
            "pbe_tpu_torch/data/native.py", "pbe_tpu_torch/data/openimages.py",
            "pbe_tpu_torch/data/quadruple.py", "pbe_tpu_torch/evaltools/inception.py",
            "pbe_tpu_torch/evaltools/fid.py", "pbe_tpu_torch/evaltools/fid_callback.py",
            "pbe_tpu_torch/scripts/train.py",
            "pbe_tpu_torch/scripts/make_synthetic_openimages.py",
            "pbe_tpu_torch/evaltools/gmm_score.py", "pbe_tpu_torch/evaltools/clip_score.py",
            "pbe_tpu_torch/scripts/eval_fid.py", "pbe_tpu_torch/scripts/eval_clip_score.py",
            "pbe_tpu_torch/scripts/eval_gmm.py",
            "pbe_tpu_torch/scripts/create_square_gt_for_fid.py",
            "pbe_tpu_torch/training/perceptual.py", "pbe_tpu_torch/training/vae_train.py",
            "pbe_tpu_torch/models/vae_asym.py", "pbe_tpu_torch/models/safety.py",
            "pbe_tpu_torch/ops/tiling.py", "pbe_tpu_torch/export_runtime.py",
            "pbe_tpu_torch/pipelines/export.py", "pbe_tpu_torch/scripts/export_program.py",
            "pbe_tpu_torch/scripts/verify_frozen_program.py",
            "pbe_tpu_torch/utils/profiling.py",
            "pbe_tpu_torch/scripts/modify_checkpoints.py",
            "pbe_tpu_torch/scripts/test.py", "pbe_tpu_torch/scripts/train_overfit_demo.py",
            "pbe_tpu_torch/scripts/read_bbox.py",
            "pbe_tpu_torch/scripts/make_synthetic_test_bench.py",
            "pbe_tpu_torch/scripts/weights_runbook.py",
            "pbe_tpu_torch/models/encoder_unet.py", "pbe_tpu_torch/models/text_transformer.py",
            "pbe_tpu_torch/models/vae_legacy.py", "pbe_tpu_torch/models/diffusion_wrapper.py",
            "pbe_tpu_torch/data/legacy.py", "pbe_tpu_torch/ops/flash_attention.py",
            "pbe_tpu_torch/ops/cuda_build.py",
            "pbe_tpu_torch/scripts/sweep_flash_tiles.py"} <= names
    banned = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "orbax", "scripts") or top == "pbe_tpu":
                banned.append((f.relative_to(REPO).as_posix(), mod))
    assert banned == []


def test_port_imports_sklearn_only_where_fit_gmm_asks_for_it():
    """Scoring a GMM needs no scikit-learn: no module of the port imports
    it at module level, and the one import inside a function is fit_gmm's
    (the JAX module's lazy import)."""
    files = sorted((REPO / "pbe_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    at_top, inside = [], []
    for f in files:
        tree = ast.parse(f.read_text())
        top_level = {id(n) for n in tree.body}
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""])
                if any(n.split(".")[0] == "sklearn" for n in names):
                    (at_top if id(node) in top_level else inside).append(
                        f.relative_to(REPO).as_posix())
    assert at_top == []
    assert inside == ["pbe_tpu_torch/evaltools/gmm_score.py"]
    fit = next(n for n in ast.walk(ast.parse(
        (REPO / "pbe_tpu_torch/evaltools/gmm_score.py").read_text()))
        if isinstance(n, ast.FunctionDef) and n.name == "fit_gmm")
    assert any(isinstance(n, ast.ImportFrom) and n.module.startswith("sklearn")
               for n in ast.walk(fit))
