"""The port's flash-attention function against the Pallas forward kernels
it replaces (run in interpret mode on the CPU, as tests/test_flash_attention
.py runs them), at each head dim the 512^2 edit uses. On the CPU the port's
wrapper runs the kernel's plain version; the CUDA kernel itself is held
against that plain version on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pbe_tpu.ops import flash_attention as jfa

from pbe_tpu_torch.ops import flash_attention as tfa
from pbe_tpu_torch.ops.attention import multi_head_attention


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Six test workers share the CPU: two intra-op threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _qkv(shape, seed=0):
    g = np.random.default_rng(seed)
    return [g.standard_normal(shape).astype(np.float32) for _ in range(3)]


# (BH, N, D): one small shape per main-path head dim (40, 80, 160, 512)
SHAPES = [(2, 256, 40), (2, 128, 80), (2, 64, 160), (1, 256, 512)]


@pytest.mark.parametrize("variant", ["rowblock", "streamed", "resident", "pipelined"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernel(shape, variant):
    """Each Pallas forward variant against the port's flash_forward with
    the same variant named (on the CPU: its plain version)."""
    q, k, v = _qkv(shape)
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = jfa._flash_fwd_bhnd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=64,
            block_k=64, return_stats=True, variant=variant)
    # (BH, N, D) is (B, N, H, D) with B = BH and H = 1
    as_bnhd = lambda a: torch.from_numpy(a)[:, :, None, :]
    got, got_lse = tfa.flash_forward(as_bnhd(q), as_bnhd(k), as_bnhd(v),
                                     variant=variant, return_lse=True)
    # the bounds of tests/test_flash_attention.py: fp32 throughout, the two
    # differ only in summation order (and the streamed and resident kernels'
    # online rescaling); LSE is lane 0 of the JAX kernel's lane-broadcast output
    np.testing.assert_allclose(got[:, :, 0].numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0], atol=1e-4)


@pytest.mark.parametrize("variant", ["rowblock", "streamed"])
@pytest.mark.parametrize("d", [40, 512])
def test_plain_matches_pallas_kernel_on_peaked_scores(d, variant):
    """Peaked scores (q and k x8: a softmax close to one-hot, where a wrong
    rescale cannot hide) at N = 100, which no q tile or key tile of the
    card's kernels divides: the plain version that chip_smoke.py holds
    them to, against the Pallas rowblock and streamed kernels on q blocks
    of 50 rows (the streamed kernel rescales over 4 key blocks of 25)."""
    q, k, v = _qkv((1, 100, d), seed=4)
    q, k = 8 * q, 8 * k
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = jfa._flash_fwd_bhnd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=50,
            block_k=25, return_stats=True, variant=variant)
    as_bnhd = lambda a: torch.from_numpy(a)[:, :, None, :]
    got, got_lse = tfa.flash_forward(as_bnhd(q), as_bnhd(k), as_bnhd(v),
                                     variant=variant, return_lse=True)
    # fp32 throughout; the logits reach |S2| ~ 400, and at d = 512 their
    # sums in another order differ by a few ulps of that (3e-5 each), which
    # moves the LSE by as much and the near-max keys' P by as much
    # relatively, so O (|O| <= |v| ~ 4) by up to ~1e-4
    np.testing.assert_allclose(got[:, :, 0].numpy(), np.asarray(want), atol=2e-4)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0], rtol=1e-6)


def test_plain_ragged_length_matches_xla_reference():
    """A sequence length no block divides (the kernel masks the last k-tile;
    the JAX package falls back to its O(N^2) path there)."""
    q, k, v = _qkv((2, 100, 40), seed=1)
    want = jfa._attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    as_bnhd = lambda a: torch.from_numpy(a)[:, :, None, :]
    got = tfa.flash_attention(as_bnhd(q), as_bnhd(k), as_bnhd(v))
    np.testing.assert_allclose(got[:, :, 0].numpy(), np.asarray(want), atol=2e-5)


def test_bf16_plain_rounds_like_the_kernel_contract():
    """In bf16 the prescaled q and P are rounded to bf16 before their
    products, as in the Pallas kernels; the result stays within bf16
    rounding of the fp32 computation."""
    q, k, v = _qkv((1, 128, 2, 40), seed=2)
    t = lambda a, dt: torch.from_numpy(a).to(dt)
    got = tfa.flash_attention_plain(t(q, torch.bfloat16), t(k, torch.bfloat16),
                                    t(v, torch.bfloat16))
    ref = tfa.flash_attention_plain(t(q, torch.float32), t(k, torch.float32),
                                    t(v, torch.float32))
    assert got.dtype == torch.bfloat16
    # inputs rounded to bf16 (rel 2^-9) move the logits by ~|q||k| 2^-9
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=3e-2)


def test_multi_head_flash_equals_plain_without_a_launch():
    b, n, h, d = 2, 64, 4, 40
    q, k, v = (torch.from_numpy(a) for a in _qkv((b, n, h * d), seed=3))
    before = tfa.flash_fwd.launches
    got = multi_head_attention(q, k, v, h, impl="flash")
    want = multi_head_attention(q, k, v, h, impl="plain")
    # fp32: exp2 of prescaled logits vs exp of scaled logits, same function
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    assert tfa.flash_fwd.launches == before  # a CPU tensor runs no kernel


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 64, 1, 40, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="unknown attention impl"):
        multi_head_attention(q.reshape(1, 64, 40), q.reshape(1, 64, 40),
                             q.reshape(1, 64, 40), 1, impl="sdpa")


@pytest.mark.parametrize("batch", [1, 2])
def test_model_hands_the_kernel_tensors_it_can_read(monkeypatch, batch):
    """Every q/k/v the UNet and the VAE pass to flash attention, and every
    q/k/v/O/dO the UNet's backward passes to the backward kernels, meets
    the kernels' layout contract (unit head-dim stride, aligned rows), at
    batch 1 too, where a permuted reshape can leave a strided view; CPU,
    bf16. The backward is checked for configs/tiny.yaml's UNet and for the
    v1 UNet's transformers at their three widths (d = 40, 80, 160)."""
    from pbe_tpu_torch.models.pbe import build_from_yaml
    from pbe_tpu_torch.models.unet import SpatialTransformer
    from pbe_tpu_torch.ops import attention
    from pbe_tpu_torch.pipelines.loading import init_parameters

    seen, seen_bwd = [], []

    def checked(q, k, v, return_lse=False):
        for x in (q, k, v):
            assert tfa.layout_error(x) is None, tfa.layout_error(x)
        seen.append(tuple(q.shape))
        return tfa.flash_attention(q, k, v, return_lse)

    real_bwd = tfa.flash_bwd_dq_plain

    # the backward's dQ op on a CPU tensor runs this plain version: what it
    # is handed is what the dQ and dK/dV kernels read on the card
    def checked_bwd(q, k, v, do, lse, dd):
        for x in (q, k, v, do):
            assert tfa.layout_error(x) is None, tfa.layout_error(x)
        seen_bwd.append(tuple(do.shape))
        return real_bwd(q, k, v, do, lse, dd)

    monkeypatch.setattr(attention, "flash_attention", checked)
    monkeypatch.setattr(tfa, "flash_bwd_dq_plain", checked_bwd)
    model, _ = build_from_yaml("configs/tiny.yaml", dtype=torch.bfloat16,
                               attn_impl="flash", device="cpu")
    init_parameters(model, seed=0)
    g = torch.Generator().manual_seed(0)
    # NHWC views of NCHW-contiguous tensors: the models then run in the
    # NCHW layout cuDNN keeps on the card (CPU convs would otherwise carry
    # the channels-last layout of a plain NHWC input through every layer)
    nhwc = lambda *shape: torch.randn(shape, generator=g).permute(0, 2, 3, 1)
    with torch.no_grad():
        z = model.encode_first_stage(nhwc(batch, 3, 64, 64))
        model.decode_first_stage(z.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))
    # VAE mid attention in encode and decode (1 head, d=32)
    assert (batch, 1024, 1, 32) in seen
    x9 = nhwc(batch, 9, *z.shape[1:3])
    eps = model.apply_model(x9, torch.full((batch,), 500.0), torch.randn(batch, 1, 768))
    eps.float().square().mean().backward()
    # UNet ds1/ds2 (d=8, 16), forward and backward
    assert (batch, 1024, 4, 8) in seen and (batch, 256, 4, 16) in seen
    assert (batch, 1024, 4, 8) in seen_bwd and (batch, 256, 4, 16) in seen_bwd
    for ch in (320, 640, 1280):
        tf = SpatialTransformer(ch, 8, ch // 8, 1, 768, attn_impl="flash")
        out = tf(torch.randn(batch, ch, 4, 4, generator=g).to(torch.bfloat16),
                 torch.randn(batch, 1, 768, generator=g))
        out.float().square().mean().backward()
        assert seen_bwd[-1] == (batch, 16, 8, ch // 8)
