"""The port's whole slice against the JAX package: EditPipeline.edit_batch
with injected x_T, the posterior mode for the masked source, 4-step PLMS,
at CFG scale 5 and at scale 1 (the single-call specialization), same
weights in both frameworks, fp32 on the CPU."""
import numpy as np
import pytest
import torch

from pbe_tpu.data.transforms import to_uint8
from pbe_tpu.pipelines.inference import EditPipeline as JEditPipeline

from pbe_tpu_torch.ops.tiling import TilingSpec
from pbe_tpu_torch.pipelines.inference import EditPipeline as TEditPipeline

from _torch_port import pipeline_pair


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


def _inputs():
    g = np.random.default_rng(0)
    image = g.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    mask = np.ones((2, 32, 32, 1), np.float32)
    mask[:, 8:24, 6:20] = 0.0
    ref = g.standard_normal((2, 32, 32, 3)).astype(np.float32)
    x_T = g.standard_normal((2, 8, 8, 4)).astype(np.float32)
    return image, mask, ref, x_T


@pytest.fixture(scope="module")
def jax_scale5(pipelines):
    """The JAX edit at scale 5, compiled once for the tests below (each
    distinct JAX edit program is a long XLA compile on the CPU)."""
    jp, _ = pipelines
    image, mask, ref, x_T = _inputs()
    return jp.edit_batch(image, mask, ref, steps=4, scale=5.0, x_T=x_T,
                         det_first_stage=True)


# the UNet bound of PARITY.md:51-53 (2e-4 x output scale) held over the 5
# eps calls (4 steps + the Heun call) and the decode: fp32 reductions run in
# another order in the two frameworks; nothing else differs. Images are in
# [0,1], so the output scale is 1.
IMAGE_ATOL = 2e-4


def test_edit_latent_matches_jax(pipelines):
    jp, tp = pipelines
    image, mask, ref, x_T = _inputs()
    kw = dict(steps=4, scale=5.0, x_T=x_T, det_first_stage=True, output="latent")
    want = jp.edit_batch(image, mask, ref, **kw)
    got = tp.edit_batch(image, mask, ref, **kw)
    assert got.shape == want.shape == (2, 8, 8, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())
    # the edit moved the latent away from x_T (parity is not vacuous)
    assert np.abs(want - x_T).max() > 1e-2


@pytest.mark.parametrize("scale", [5.0, 1.0])
def test_edit_batch_matches_jax(pipelines, jax_scale5, scale):
    jp, tp = pipelines
    image, mask, ref, x_T = _inputs()
    kw = dict(steps=4, scale=scale, x_T=x_T, det_first_stage=True)
    want = jax_scale5 if scale == 5.0 else jp.edit_batch(image, mask, ref, **kw)
    got = tp.edit_batch(image, mask, ref, **kw)
    assert got.shape == want.shape == (2, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_ATOL)


def test_uint8_output_matches_jax(pipelines, jax_scale5):
    _, tp = pipelines
    image, mask, ref, x_T = _inputs()
    got = tp.edit_batch(image, mask, ref, steps=4, scale=5.0, x_T=x_T,
                        det_first_stage=True, output="uint8")
    # the JAX uint8 output applies data/transforms.to_uint8's formula to the
    # same float image inside its program
    want = to_uint8(jax_scale5)
    assert got.dtype == np.uint8 and got.shape == want.shape
    # both round half to even; the float images agree to ~1e-6, so a value
    # within that of a rounding boundary (k + 0.5) / 255 may land one LSB
    # apart, and nothing more
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


def test_pending_edit_is_ready_and_reads_back_the_blocking_edit(pipelines):
    """edit_batch(block=False): the handle's is_ready() (what the
    reference's server polls) and its host copy, equal to block=True."""
    _, tp = pipelines
    image, mask, ref, x_T = _inputs()
    kw = dict(steps=2, scale=5.0, x_T=x_T, det_first_stage=True)
    pending = tp.edit_batch(image, mask, ref, block=False, **kw)
    assert pending.is_ready()  # a CPU tensor is ready once it exists
    got = np.asarray(pending)
    want = tp.edit_batch(image, mask, ref, **kw)
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(got, want)


def test_unported_options_raise(pipelines):
    """DDIM, DDPM and paste_back are ported (tests/test_torch_samplers.py),
    int8 (tests/test_torch_quant.py) and tiling (tests/test_torch_tiling.py,
    which holds a tiled edit against JAX's; here one runs); multi-card
    serving still raises, and so do options no sampler or int8 mode takes."""
    _, tp = pipelines
    image, mask, ref, x_T = _inputs()
    with pytest.raises(ValueError, match="unknown quantization mode"):
        TEditPipeline(tp.model, quantize="fp4").edit_batch(image, mask, ref, steps=2, x_T=x_T)
    with pytest.raises(ValueError, match="quant_scales requires"):
        TEditPipeline(tp.model, quant_scales=((1.0, (1.0,)),))
    with pytest.raises(NotImplementedError, match="Queue 1, item 11"):
        tp.shard()
    tiled = TEditPipeline(tp.model, tiling=TilingSpec(ks=(4, 4), stride=(2, 2)))
    out = tiled.edit_batch(image, mask, ref, steps=2, x_T=x_T, det_first_stage=True)
    assert out.shape == (2, 32, 32, 3) and np.isfinite(out).all()
    with pytest.raises(ValueError, match="unknown sampler"):
        tp.edit_batch(image, mask, ref, steps=2, sampler="euler", x_T=x_T)
    with pytest.raises(ValueError, match="PLMS requires eta"):
        tp.edit_batch(image, mask, ref, steps=2, eta=0.5, x_T=x_T)
