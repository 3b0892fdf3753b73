"""The port's training step and trainer against ``pbe_tpu/training`` at
the pipeline test geometry (tests/_torch_port.py), fp32 on the CPU: the
loss and every trainable gradient under the same weights and the same
draws, AdamW against optax, the LR schedules, EMA and the partition; then
the port's own contracts (remat, uint8 batches, row weights, resume)."""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pbe_tpu.data.transforms import unpack_uint8_batch
from pbe_tpu.training import ema as jema
from pbe_tpu.training import lr_schedule as jsched
from pbe_tpu.training.partition import split_params
from pbe_tpu.training.train_step import make_loss_fn
from pbe_tpu.training.train_step import make_optimizer as j_make_optimizer

from pbe_tpu_torch import config as tconfig
from pbe_tpu_torch.convert import flatten_params, torch_key_and_value
from pbe_tpu_torch.models.unet import SelfAttention
from pbe_tpu_torch.ops import flash_attention as tfa
from pbe_tpu_torch.training import lr_schedule as tsched
from pbe_tpu_torch.training.ema import EMA
from pbe_tpu_torch.training.partition import split_parameters
from pbe_tpu_torch.training.train_step import (loss_fn, make_optimizer,
                                               normalize_uint8_batch, train_step)
from pbe_tpu_torch.training.trainer import Trainer

from _torch_port import pipeline_pair

B, SIZE, LATENT = 2, 32, 8  # PIPELINE_GEO: 32^2 images, 4x latent downsample


@pytest.fixture(scope="module")
def pair():
    return pipeline_pair()


def _batch(b=B, seed=0):
    g = np.random.default_rng(seed)
    image = g.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)
    mask = np.ones((b, SIZE, SIZE, 1), np.float32)
    mask[:, 8:24, 8:24] = 0.0
    return {"image": image, "inpaint_image": image * mask, "mask": mask,
            "ref": g.standard_normal((b, SIZE, SIZE, 3)).astype(np.float32)}


def _draws(b=B, seed=0):
    g = np.random.default_rng(100 + seed)
    return (torch.from_numpy(g.integers(0, 1000, (b,))),
            torch.from_numpy(g.standard_normal((b, LATENT, LATENT, 4)).astype(np.float32)),
            torch.tensor(0.5))


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _grads(model):
    return {k: p.grad for k, p in model.named_parameters() if p.grad is not None}


@pytest.fixture(scope="module")
def jax_value_and_grad(pair):
    jm, variables, _ = pair
    train, frozen = split_params(variables["params"])
    vg = jax.jit(jax.value_and_grad(make_loss_fn(jm, det_first_stage=True), has_aux=True))
    return lambda batch, rng: vg(train, frozen, batch, rng)


@pytest.mark.parametrize("uncond", [False, True], ids=["exemplar", "learnable_vector"])
def test_loss_and_trainable_gradients_match_jax(pair, jax_value_and_grad, uncond):
    """The same t, eps and u as the JAX step draws (train_step.py:140-154
    replayed), the posterior mode for the latents: with u < 0.2 the
    condition is the learnable vector, else the exemplar token."""
    rng = next(r for r in (jax.random.PRNGKey(s) for s in range(100))
               if (float(jax.random.uniform(jax.random.split(r, 4)[3], ())) < 0.2) == uncond)
    _, r_t, r_noise, r_uc = jax.random.split(rng, 4)
    t = np.asarray(jax.random.randint(r_t, (B,), 0, 1000))
    noise = np.asarray(jax.random.normal(r_noise, (B, LATENT, LATENT, 4), jnp.float32))
    u = np.asarray(jax.random.uniform(r_uc, ()))
    batch = _batch()
    (jloss, jmetrics), jgrads = jax_value_and_grad(batch, rng)

    model = copy.deepcopy(pair[2])
    _, frozen = split_parameters(model)
    loss, metrics = loss_fn(model, _t(batch), *(torch.from_numpy(np.array(a))
                                                 for a in (t, noise, u)))
    loss.backward()
    # fp32 both sides; the reductions run in another order
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(metrics["loss_vlb"].item(), float(jmetrics["loss_vlb"]),
                               rtol=1e-5)
    got = _grads(model)
    want = dict(torch_key_and_value(path, np.asarray(g))
                for path, g in flatten_params(jgrads).items())
    assert set(got) <= set(want)
    cond_leaf = "learnable_vector" if uncond else "proj_out.weight"
    assert np.abs(want[cond_leaf]).max() > 0  # the condition taken is trained
    scale = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        # 1e-4 of the leaf's own scale; a leaf the loss does not reach (the
        # condition not taken; attn2's norm2, whose one-token attention
        # ignores its query) has a zero gradient under jax.grad and none or
        # a zero one here; a leaf whose gradient vanishes in exact
        # arithmetic (a bias ahead of a one-channel-per-group GroupNorm)
        # holds fp32 rounding noise, judged against the whole gradient's
        # scale (1e-6 of it)
        g = got[k].numpy() if k in got else np.zeros_like(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-6 * scale,
                                   err_msg=k)
    assert all(p.grad is None for p in frozen.values())


def test_partition_matches_jax(pair):
    _, variables, tm = pair
    jtrain, jfrozen = split_params(variables["params"])
    names = lambda tree: {torch_key_and_value(p, np.zeros((1,) * np.ndim(v)))[0]
                          for p, v in flatten_params(tree).items()}
    train, frozen = split_parameters(copy.deepcopy(tm))
    assert set(train) == names(jtrain) and set(frozen) == names(jfrozen)
    count = lambda tree: sum(int(np.prod(np.shape(v))) for v in flatten_params(tree).values())
    assert sum(p.numel() for p in train.values()) == count(jtrain)
    assert sum(p.numel() for p in frozen.values()) == count(jfrozen)


def test_two_adamw_steps_equal_two_optax_steps():
    g = np.random.default_rng(5)
    shapes = {"w": (4, 3), "b": (7,)}
    p0 = {k: g.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: g.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    mult = lambda n: 0.5 + 0.25 * n  # a multiplier that differs between the steps

    tx = j_make_optimizer(base_lr=1e-2, scheduler=mult)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for gr in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in gr.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt, sched = make_optimizer(params, base_lr=1e-2, scheduler=mult)
    for gr in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(gr[k])
        opt.step()
        sched.step()
    for k, p in params.items():
        # the same AdamW in another order of fp32 operations
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7)


SCHEDULES = {
    "linear_v1": lambda m: m.LambdaLinearScheduler(
        warm_up_steps=[10000], f_min=[1.0], f_max=[1.0], f_start=[1e-6],
        cycle_lengths=[10_000_000_000_000]),
    "cosine": lambda m: m.LambdaWarmUpCosineScheduler(
        warm_up_steps=1000, lr_min=0.1, lr_max=1.0, lr_start=0.0, max_decay_steps=20000),
    "cosine2": lambda m: m.LambdaWarmUpCosineScheduler2(
        warm_up_steps=[1000, 500], f_min=[0.1, 0.2], f_max=[1.0, 0.8],
        f_start=[0.0, 0.1], cycle_lengths=[8000, 2_000_000]),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    j, t = SCHEDULES[name](jsched), SCHEDULES[name](tsched)
    for n in (0, 5000, 10000, 10**6):
        # JAX evaluates in fp32, the port in Python floats
        np.testing.assert_allclose(t(n), float(j(n)), rtol=1e-5, atol=1e-7)
    if name == "linear_v1":  # v1.yaml's scheduler_config builds the same schedule
        raw = tconfig.load_config("configs/v1.yaml")
        built = tconfig.instantiate_from_config(raw["model"]["params"]["scheduler_config"])
        assert built == t == tsched.default_scheduler()


def test_ema_matches_jax():
    g = np.random.default_rng(6)
    p0 = g.standard_normal((5,)).astype(np.float32)
    steps = [g.standard_normal((5,)).astype(np.float32) for _ in range(3)]
    st = jema.ema_init({"w": jnp.asarray(p0)})
    ema = EMA({"w": torch.from_numpy(p0.copy())})
    for p in steps:
        st = jema.ema_update(st, {"w": jnp.asarray(p)})
        ema.update({"w": torch.from_numpy(p)})
    assert ema.count == int(st.count) == 3
    np.testing.assert_allclose(ema.shadow["w"].numpy(), np.asarray(st.shadow["w"]), rtol=1e-6)


def test_remat_gives_the_same_gradients_and_recomputes_the_attention(pair, monkeypatch):
    calls = []
    real = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **kw: (calls.append(1), real(*a, **kw))[1])
    grads, counts = [], []
    for remat in (False, True):
        model = copy.deepcopy(pair[2])
        model.model.diffusion_model.remat = remat
        split_parameters(model)
        calls.clear()
        loss_fn(model, _t(_batch()), *_draws())[0].backward()
        grads.append(_grads(model))
        counts.append(len(calls))
    # checkpointing recomputes each UNet self-attention once in the backward
    n_attn = sum(isinstance(m, SelfAttention) for m in pair[2].modules())
    assert counts[1] - counts[0] == n_attn > 0
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=0, atol=0)


def test_uint8_batch_gives_the_float_loss(pair):
    g = np.random.default_rng(3)
    u8 = {"image": g.integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8),
          "mask": np.where(g.uniform(size=(B, SIZE, SIZE, 1)) < 0.3, 0, 255).astype(np.uint8),
          "ref": g.integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)}
    host = unpack_uint8_batch(dict(u8))  # the JAX package's host float path
    dev = normalize_uint8_batch(_t(u8))
    assert set(dev) == set(host)
    for k, v in host.items():
        np.testing.assert_array_equal(dev[k].numpy(), v)
    model = pair[2]
    with torch.no_grad():
        l_u = loss_fn(model, _t(u8), *_draws())[0]
        l_f = loss_fn(model, _t(host), *_draws())[0]
    assert l_u.item() == l_f.item()


def test_zero_weight_rows_leave_the_loss_unchanged(pair):
    model = copy.deepcopy(pair[2])
    split_parameters(model)
    batch = _batch(b=4)
    garbage = {k: np.concatenate([v[:2], -v[2:] * 3.0 + 0.7]) for k, v in batch.items()}
    w = np.asarray([1.0, 1.0, 0.0, 0.0], np.float32)
    out = []
    for b in (batch, garbage):
        model.zero_grad()
        loss = loss_fn(model, _t({**b, "weight": w}), *_draws(b=4))[0]
        loss.backward()
        out.append((loss.item(), _grads(model)))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    for k, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][k], g, rtol=1e-5, atol=1e-7)

    # a ragged batch padded to 4 rows: zero weight on the repeated row
    three = {k: v[:3] for k, v in batch.items()}
    padded = Trainer._pad_ragged(dict(three), 4)
    np.testing.assert_array_equal(padded["weight"], [1, 1, 1, 0])
    np.testing.assert_array_equal(padded["image"][3], three["image"][2])
    t, noise, u = _draws(b=4)
    with torch.no_grad():
        l_pad = loss_fn(model, _t(padded), t, noise, u)[0].item()
        l_3 = loss_fn(model, _t(three), t[:3], noise[:3], u)[0].item()
    np.testing.assert_allclose(l_pad, l_3, rtol=1e-5)


def test_fit_save_restore_fit_equals_one_run(pair, tmp_path):
    """Resume is exact: the step, the trainable weights, the optimizer and
    LR-schedule state and the generator (t, eps, u and the posterior
    samples) all come back. A loader that runs out ends fit."""
    batches = [_batch(seed=i) for i in range(4)]
    kw = dict(base_lr=1e-3, scheduler=lambda n: 1.0 + n, log_every=100)
    trainer = lambda d: Trainer(copy.deepcopy(pair[2]), logdir=str(tmp_path / d),
                                base_lr=kw["base_lr"], scheduler=kw["scheduler"])
    one = trainer("one")
    one.fit(batches, max_steps=4, log_every=100, ckpt_every=100)

    # the first half validates at its end (its own draws, which leave the
    # training generator alone) and saves with the validation metrics
    first = trainer("two")
    first.fit(iter(batches[:2]), val_loader=batches[:1], max_steps=4, log_every=100,
              val_every=2, ckpt_every=100)  # the iterator runs out after 2 steps
    assert first.step == 2
    second = trainer("two")
    assert second.restore() and second.step == 2
    saved = json.loads((tmp_path / "two" / "checkpoints" / "step_00000002.json").read_text())
    assert saved["val/loss_simple"] > 0
    second.fit(batches[2:], max_steps=4, log_every=100, ckpt_every=100)
    assert second.step == one.step == 4
    for k, p in one.params.items():
        torch.testing.assert_close(second.params[k], p, rtol=0, atol=0)


def test_checkpoints_kept_best_by_val_loss(pair, tmp_path):
    """max_to_keep best by val/loss_simple; a checkpoint without it ranks
    last (the JAX trainer's Orbax manager); restore takes the latest kept."""
    tr = Trainer(copy.deepcopy(pair[2]), logdir=str(tmp_path), max_to_keep=2)
    for step, metrics in ((1, {"val/loss_simple": 0.5}), (2, {}),
                          (3, {"val/loss_simple": 0.3}), (4, {"val/loss_simple": 0.9})):
        tr.step = step
        tr.save(metrics)
    assert tr._steps() == [1, 3]
    assert tr.restore() and tr.step == 3


def test_loss_falls_over_12_steps(pair):
    model = copy.deepcopy(pair[2])
    params, _ = split_parameters(model)
    opt, sched = make_optimizer(params, base_lr=2e-3, scheduler=lambda n: 1.0)
    batch, draws = _t(_batch(b=4)), _draws(b=4)
    losses = [train_step(model, params, opt, sched, batch, *draws)["loss"].item()
              for _ in range(12)]
    assert losses[-1] < losses[0], losses
