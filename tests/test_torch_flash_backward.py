"""The port's flash-attention backward against the Pallas backward kernels
it replaces (``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``, run in
interpret mode on the CPU as tests/test_flash_attention.py runs them) and
against the JAX package's ``flash_attention`` custom VJP, fp32. On the CPU
the autograd function runs the kernels' plain versions; the CUDA kernels
are held against those plain versions on the card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pbe_tpu.ops import flash_attention as jfa

from pbe_tpu_torch.ops import flash_attention as tfa
from pbe_tpu_torch.ops.attention import multi_head_attention

# (B, N, H, D): a padded head dim (40 -> 48) and the tiny config's 16
SHAPES = [(1, 128, 2, 40), (2, 256, 2, 16)]


def _inputs(shape, seed=0):
    g = np.random.default_rng(seed)
    return [g.standard_normal(shape).astype(np.float32) for _ in range(4)]  # q k v dO


def _bhnd(a):
    """(B,N,H,D) numpy -> JAX (B*H, N, D)."""
    b, n, h, d = a.shape
    return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, n, d))


def _bnhd(a, shape):
    b, n, h, d = shape
    return np.asarray(a).reshape(b, h, n, d).transpose(0, 2, 1, 3)


def _assert_rel(got, want, rel):
    """max|got - want| <= rel * max|want|: fp32 on both sides, the two
    differ only in the order of their sums."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_pallas_kernels(shape):
    q, k, v, do = _inputs(shape)
    with pltpu.force_tpu_interpret_mode():
        o, lse = jfa._flash_fwd_bhnd(_bhnd(q), _bhnd(k), _bhnd(v), return_stats=True)
        want = jfa._flash_bwd_bhnd(_bhnd(q), _bhnd(k), _bhnd(v), o, lse, _bhnd(do))
    # the port keeps the LSE as (B*H, N); JAX broadcasts it over 128 lanes
    t = lambda a: torch.from_numpy(np.array(a))
    got = tfa.flash_attention_bwd_plain(t(q), t(k), t(v), t(_bnhd(o, shape)),
                                        t(np.asarray(lse)[..., 0]), t(do))
    for g, w in zip(got, want):
        _assert_rel(g.numpy(), _bnhd(w, shape), 1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_autograd_function_matches_jax_custom_vjp_and_plain_autograd(shape):
    q, k, v, do = _inputs(shape, seed=1)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jfa.flash_attention, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches
    tfa.flash_attention(*leaves).backward(torch.from_numpy(do))
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == before  # CPU: no kernel
    for leaf, w in zip(leaves, want):
        _assert_rel(leaf.grad.numpy(), w, 1e-5)

    # autograd through einsum attention: exp of scaled logits instead of
    # exp2 of prescaled ones, the same function
    b, n, h, d = shape
    plain = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = multi_head_attention(*(x.reshape(b, n, h * d) for x in plain), h, impl="plain")
    out.reshape(b, n, h, d).backward(torch.from_numpy(do))
    for leaf, p in zip(leaves, plain):
        _assert_rel(leaf.grad.numpy(), p.grad.numpy(), 1e-5)


def test_forward_keeps_the_lse_only_for_a_gradient(monkeypatch):
    """Inference (no input needs a gradient) asks the forward for no
    statistics and saves nothing; training asks for the LSE."""
    asked = []
    real = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda q, k, v, return_lse=False: (asked.append(return_lse),
                                                           real(q, k, v, return_lse))[1])
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs((1, 64, 2, 16), seed=2))
    with torch.no_grad():
        tfa.flash_attention(q, k, v)
    tfa.flash_attention(q.requires_grad_(), k, v)
    assert asked == [False, True]


def test_backward_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 64, 1, 40, dtype=torch.bfloat16)
    stats = torch.zeros(1, 64)
    for kernel in (tfa.flash_bwd_dq, tfa.flash_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(x, x, x, x, stats, stats)
