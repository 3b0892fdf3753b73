"""Shared builders for the PyTorch port's parity tests: the same geometry
in both frameworks, the JAX weights (with zero-init leaves randomized, or
parity would be vacuous) carried into the port through its key map."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from pbe_tpu.models.clip_vit import CLIPVisionConfig as JClip
from pbe_tpu.models.exemplar import ExemplarEncoderConfig as JExemplar
from pbe_tpu.models.pbe import PaintByExample as JPBE
from pbe_tpu.models.pbe import build_from_yaml as j_build_from_yaml
from pbe_tpu.models.unet import UNetConfig as JUNet
from pbe_tpu.models.vae import AutoencoderKLConfig as JVAE
from pbe_tpu.pipelines.loading import randomize_zero_params

from pbe_tpu_torch.convert import state_dict_from_flax
from pbe_tpu_torch.models.clip_vit import CLIPVisionConfig as TClip
from pbe_tpu_torch.models.exemplar import ExemplarEncoderConfig as TExemplar
from pbe_tpu_torch.models.pbe import PaintByExample as TPBE
from pbe_tpu_torch.models.pbe import build_from_yaml as t_build_from_yaml
from pbe_tpu_torch.models.unet import UNetConfig as TUNet
from pbe_tpu_torch.models.vae import AutoencoderKLConfig as TVAE

# the geometry of tests/test_pipeline.py:18-31 (32x32 images, 8x8 latents)
PIPELINE_GEO = dict(
    unet=dict(model_channels=8, channel_mult=(1, 2), num_res_blocks=1,
              attention_resolutions=(1,), num_heads=2, context_dim=768,
              use_checkpoint=False),
    vae=dict(ddconfig={"ch": 8, "ch_mult": [1, 2, 2], "num_res_blocks": 1,
                       "z_channels": 4, "double_z": True, "out_ch": 3,
                       "in_channels": 3, "resolution": 32}, embed_dim=4),
    clip=dict(hidden_size=1024, num_layers=1, num_heads=4, mlp_dim=32,
              patch_size=8, image_size=32),
    mapper_layers=1,
)


def jax_pipeline_model():
    g = PIPELINE_GEO
    return JPBE(unet_config=JUNet(**g["unet"]), vae_config=JVAE(**g["vae"]),
                cond_config=JExemplar(clip=JClip(**g["clip"]),
                                      mapper_layers=g["mapper_layers"]))


def torch_pipeline_model():
    g = PIPELINE_GEO
    return TPBE(unet_config=TUNet(**g["unet"]), vae_config=TVAE(**g["vae"]),
                cond_config=TExemplar(clip=TClip(**g["clip"]),
                                      mapper_layers=g["mapper_layers"]),
                attn_impl="flash")


def init_jax(model, image_size, ref_size, seed=0):
    """Seeded weights for every parameter of the flax model, then
    randomize_zero_params (which gives the zero biases values too).

    The shapes come from jax.eval_shape, which traces without compiling
    (an XLA compile of the whole init is slow on the CPU). Kernels are
    lecun-normal like flax's init (so activations keep their scale through
    the layers), norm scales and embeddings as flax initializes them."""
    shapes = jax.eval_shape(lambda r: model.init(
        {"params": r}, jnp.zeros((1, image_size, image_size, 3)),
        jnp.ones((1, image_size, image_size, 1)),
        jnp.zeros((1, ref_size, ref_size, 3)), r,
        method=JPBE.initialize_all), jax.random.PRNGKey(seed))
    g = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return g.standard_normal(s.shape) / np.sqrt(fan_in)
        if name.endswith("['scale']"):
            return np.ones(s.shape)
        if name.endswith("['bias']"):
            return np.zeros(s.shape)
        return g.standard_normal(s.shape) * 0.02  # embeddings, learnable vector

    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(leaf(p, s), jnp.float32), shapes)
    return randomize_zero_params(variables, seed=seed)


def load_into(tmodel, variables):
    """Carry JAX weights into the port with a strict load."""
    params = jax.tree.map(np.asarray, variables["params"])
    tmodel.load_state_dict(state_dict_from_flax(params), strict=True)
    return tmodel.eval()


def pipeline_pair():
    """(jax model, variables, port model) at PIPELINE_GEO, same weights."""
    jm = jax_pipeline_model()
    variables = init_jax(jm, 32, 32)
    return jm, variables, load_into(torch_pipeline_model(), variables)


def tiny_yaml_pair():
    """(jax model, variables, port model) at configs/tiny.yaml."""
    jm, _ = j_build_from_yaml("configs/tiny.yaml")
    variables = init_jax(jm, 64, 224)
    tm, _ = t_build_from_yaml("configs/tiny.yaml", attn_impl="flash", device="cpu")
    return jm, variables, load_into(tm, variables)


def to_t(a):
    return torch.from_numpy(np.array(a, np.float32))


def sub_params(variables, *path):
    """The flax params under one submodule path, as its own tree."""
    tree = variables["params"]
    for p in path:
        tree = tree[p]
    return {"params": tree}


def write_test_bench(root, n, size, seed=0):
    """A COCOEE-layout dir (pbe_tpu/data/test_bench.py) of n random pairs;
    returns the ids."""
    g = np.random.default_rng(seed)
    ids = [int(i) for i in g.choice(10**6, n, replace=False)]
    for sub in ("GT_3500", "Ref_3500", "Mask_bbox_3500"):
        (root / sub).mkdir(parents=True)
    np.save(root / "id_list.npy", np.asarray(ids))
    for i in ids:
        Image.fromarray(g.integers(0, 256, (size, size, 3), np.uint8)).save(
            root / "GT_3500" / f"{i:012d}_GT.png")
        Image.fromarray(g.integers(0, 256, (size // 2 + 3, size // 2, 3), np.uint8)).save(
            root / "Ref_3500" / f"{i:012d}_ref.png")
        m = np.zeros((size, size), np.uint8)
        y, x = g.integers(0, size // 2, 2)
        m[y:y + size // 3, x:x + size // 3] = 255
        Image.fromarray(m).save(root / "Mask_bbox_3500" / f"{i:012d}_mask.png")
    return ids


# the safety checker's test geometry: CLIP width 64 (one 64-wide head, as the
# loaders infer it), 2 layers, patch 8, image 32; projection 24; 5 + 3 concepts
SAFETY_GEO = dict(hidden_size=64, num_layers=2, num_heads=1, mlp_dim=128, patch_size=8,
                  image_size=32, projection_dim=24, num_concepts=5, num_special=3)


def safety_state_dict(seed=0, concept_thr=-2.0, special_thr=2.0):
    """A seeded diffusers-layout safety-checker state_dict at SAFETY_GEO:
    every key of the port's module (diffusers' keys), the thresholds given,
    and the tower's position_ids buffer that real checkpoints carry and no
    module holds."""
    from pbe_tpu_torch.models.safety import SafetyChecker

    g = np.random.default_rng(seed)
    sd = {}
    for k, v in SafetyChecker(**SAFETY_GEO).state_dict().items():
        if k.endswith("_weights"):
            continue
        scale = 1.0 if "embeds" in k else 0.05
        base = 1.0 if ("norm" in k and k.endswith("weight")) else 0.0
        sd[k] = torch.from_numpy((base + scale * g.standard_normal(v.shape)).astype(np.float32))
    sd["concept_embeds_weights"] = torch.full((SAFETY_GEO["num_concepts"],), concept_thr)
    sd["special_care_embeds_weights"] = torch.full((SAFETY_GEO["num_special"],), special_thr)
    n_pos = (SAFETY_GEO["image_size"] // SAFETY_GEO["patch_size"]) ** 2 + 1
    sd["vision_model.vision_model.embeddings.position_ids"] = torch.arange(n_pos)[None]
    return sd


# --- the fp32 kernels' tensor-core arithmetic on the CPU: csrc/flash_fp32.cu
# and csrc/flash_anyd.cu run their fp32 products as 3xTF32 mma.sync, emulated
# here step by step


def tf32(x):
    """csrc/mma_sm90.cuh's to_tf32: round to 10 mantissa bits, ties away
    from zero, by one integer add and a mask."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def top19(x):
    """The 19 bits of an fp32 register that the tensor cores read as tf32."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def mma_k8(acc, a, b):
    """acc + a b for one k8 step of mma.sync.m16n8k8: the products summed
    (float64 stands in for the exact sum) and added into the fp32
    accumulator with truncation toward zero."""
    exact = acc.double() + a.double() @ b.double()
    f = exact.float()
    return torch.where(f.double().abs() > exact.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def tf32_steps(acc, a, b, k0, k1, terms: int, pair: bool):
    """acc + a[..., k0:k1] b[..., k0:k1, :] as csrc/mma_sm90.cuh's mma_3xtf32
    over the k8 steps of [k0, k1) (terms 1: hi hi alone): hi = to_tf32(x),
    lo = x - hi read as its top 19 bits, each step added with the tensor
    cores' truncation. With ``pair`` hi hi goes into one zeroed partial and
    lo hi, hi lo into another, then acc + (big + small) in fp32; else all
    three into one zeroed partial (lo hi, hi lo, hi hi), then acc + it."""
    big = small = torch.zeros_like(acc)
    for k in range(k0, min(k1, a.shape[-1]), 8):
        x, y = a[..., k:k + 8], b[..., k:k + 8, :]
        xh, yh = tf32(x), tf32(y)
        if terms == 3:
            small = mma_k8(small, top19(x - xh), yh)
            small = mma_k8(small, xh, top19(y - yh))
        if pair:
            big = mma_k8(big, xh, yh)
        else:
            small = mma_k8(small, xh, yh)
    return acc + (big + small) if pair else acc + small


def stress_inputs(kind: str, shape, seed: int = 20, count: int = 3):
    """chip_smoke.py's fp32 inputs on the CPU (q, k, v and, with count 4,
    dO): randn, peaked scores (q and k x8) and a row max that rises by 0.02
    a key in the exp2 domain (rising_scores)."""
    from pbe_tpu_torch.ops import flash_attention as fa

    g = np.random.default_rng(seed)
    q, k, *rest = (torch.from_numpy(g.standard_normal(shape).astype(np.float32))
                   for _ in range(count))
    if kind == "peaked":
        return q * 8, k * 8, *rest
    if kind == "rising":
        n, d = shape[1], shape[3]
        q, k = 0.1 * q, 0.1 * k
        q[..., 0] = 1.0
        step = 0.02 / (d ** -0.5 * fa.LOG2E)
        k[..., 0] = (torch.arange(n, dtype=torch.float32) * step)[None, :, None]
    return q, k, *rest


def rel_errors(got, want):
    """(max|got - want| / max|want|, rel L2): chip_smoke.py's fp32 measures."""
    diff = got - want
    return ((diff.abs().max() / want.abs().max()).item(),
            (diff.norm() / want.norm()).item())
