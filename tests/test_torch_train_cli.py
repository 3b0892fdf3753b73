"""The port's training CLI (``pbe_tpu_torch.scripts.train``) and what it adds
to the trainer, on the CPU: bf16-moment AdamW against optax's
``adamw(mu_dtype=bfloat16)``, the CLI end to end at configs/tiny.yaml on a
64² synthetic OpenImages tree (grids, finite FID rows, a checkpoint that
--resume restores), the loss ``Trainer.fit`` reaches on the data module's
first batch against the JAX loss on the same draws, ``log_images`` against
``infer_batch``, --train_from_scratch's key filter and the refusals."""
import contextlib
import copy
import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pbe_tpu import config as jconfig
from pbe_tpu.training.partition import split_params
from pbe_tpu.training.train_step import make_loss_fn
from pbe_tpu.training.train_step import make_optimizer as j_make_optimizer

from pbe_tpu_torch.models.pbe import build_from_yaml
from pbe_tpu_torch.pipelines.batch import infer_batch
from pbe_tpu_torch.pipelines.inference import EditPipeline
from pbe_tpu_torch.pipelines.loading import init_parameters, load_checkpoint
from pbe_tpu_torch.scripts import train as train_cli
from pbe_tpu_torch.scripts.make_synthetic_openimages import make_tree
from pbe_tpu_torch.training.train_step import AdamW, make_optimizer
from pbe_tpu_torch.training.trainer import Trainer

from _torch_port import tiny_yaml_pair

SIZE = 64


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Six test workers share the CPU: two intra-op threads each, and two
    BLAS threads for numpy (the FID trio's float64 eigendecompositions,
    which with a thread per core stall behind the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:  # scikit-learn's dependency, there wherever tests/test_torch_eval.py runs
        from threadpoolctl import threadpool_limits
    except ImportError:
        threadpool_limits = lambda n: contextlib.nullcontext()
    with threadpool_limits(2):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("oi")
    make_tree(str(out), n_train=4, n_val=2, size=SIZE, seed=0)
    return str(out)


def _data_yaml(tmp_path, tree: str) -> str:
    """tests/test_cli_train.py's data section, with two loader threads."""
    split = lambda state: f"""
      target: ldm.data.open-images.OpenImageDataset
      params:
        state: {state}
        dataset_dir: {tree}
        arbitrary_mask_percent: 0.5
        image_size: {SIZE}"""
    path = tmp_path / "data.yaml"
    path.write_text(f"""
data:
  target: main.DataModuleFromConfig
  params:
    batch_size: 2
    num_workers: 2
    train:{split("train")}
    validation:{split("validation")}
""")
    return str(path)


def test_two_bf16_moment_adamw_steps_equal_two_optax_steps():
    g = np.random.default_rng(5)
    shapes = {"w": (4, 3), "b": (7,), "big": (300,)}
    p0 = {k: g.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: g.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    mult = lambda n: 0.5 + 0.25 * n  # a multiplier that differs between the steps

    tx = j_make_optimizer(base_lr=1e-2, scheduler=mult, mu_dtype=jnp.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for gr in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in gr.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
    adam = state[0]

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt, sched = make_optimizer(params, base_lr=1e-2, scheduler=mult, mu_dtype=torch.bfloat16)
    assert isinstance(opt, AdamW)
    opt.CHUNK = 20  # several chunks: "w" alone, then "b" with "big"
    for gr in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(gr[k])
        opt.step()
        sched.step()
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7)
        mu, nu = opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"]
        assert mu.dtype == torch.bfloat16 and nu.dtype == torch.float32
        want_mu = np.asarray(adam.mu[k].astype(jnp.float32))
        # within one bf16 ulp (2^-7 of the value's binade)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want_mu) + 1e-30)) - 7)
        assert np.all(np.abs(mu.float().numpy() - want_mu) <= ulp), k
        np.testing.assert_allclose(nu.numpy(), np.asarray(adam.nu[k]), rtol=1e-6)


def test_bf16_moments_survive_save_and_restore(tmp_path):
    p = {"w": torch.nn.Parameter(torch.ones(8))}
    opt, _ = make_optimizer(p, base_lr=1e-2, mu_dtype=torch.bfloat16)
    p["w"].grad = torch.linspace(-1, 1, 8)
    opt.step()
    torch.save(opt.state_dict(), tmp_path / "opt.pt")
    again, _ = make_optimizer(p, base_lr=1e-2, mu_dtype=torch.bfloat16)
    again.load_state_dict(torch.load(tmp_path / "opt.pt", weights_only=False))
    st, want = again.state[p["w"]], opt.state[p["w"]]
    assert st["exp_avg"].dtype == torch.bfloat16
    assert torch.equal(st["exp_avg"], want["exp_avg"])
    assert torch.equal(st["exp_avg_sq"], want["exp_avg_sq"])
    assert again.param_groups[0]["count"] == 1


def _rows(logdir) -> list[dict]:
    with open(f"{logdir}/metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_train_cli_samples_scores_and_resumes(tmp_path, tree):
    logdir = tmp_path / "run"
    args = ["--base", "configs/tiny.yaml", _data_yaml(tmp_path, tree), "--val_every", "2",
            "--log_every", "1", "--logdir", str(logdir), "--device", "cpu",
            "--precision", "full", "--bf16_moments", "--scale_lr"]
    trainer = train_cli.main(args + ["--max_steps", "2", "--sample_images", "--fid_every", "2",
                                     "--fid_batches", "1", "--sample_steps", "2"])
    assert trainer.step == 2
    assert trainer.model.model.diffusion_model.remat  # the JAX CLI builds with remat
    assert trainer.lr_schedule.base_lrs == [1e-4 * 2]  # --scale_lr: 1 device x batch 2
    assert len(glob.glob(str(logdir / "samples" / "step_00000002" / "grid_*.png"))) == 2
    rows = _rows(logdir)
    fid = [r for r in rows if "val/fid_global" in r]
    assert [r["step"] for r in fid] == [2]
    for k in ("val/fid_global", "val/fid_local", "val/fid_ref", "val/loss"):
        assert np.isfinite(fid[0][k])
    assert all(np.isfinite(r["train/loss"]) for r in rows if "train/loss" in r)
    assert (logdir / "checkpoints" / "step_00000002.pt").exists()
    state = trainer.optimizer.state
    assert all(state[p]["exp_avg"].dtype == torch.bfloat16 for p in trainer.params.values())

    resumed = train_cli.main(args + ["--max_steps", "3", "--resume"])
    assert resumed.step == 3
    assert [r["step"] for r in _rows(logdir) if "train/loss" in r] == [1, 2, 3]
    assert resumed.optimizer.param_groups[0]["count"] == 3
    assert all(resumed.optimizer.state[p]["exp_avg"].dtype == torch.bfloat16
               for p in resumed.params.values())


def test_fit_loss_on_the_data_module_batch_matches_jax(tmp_path, tree):
    jm, variables, tm = tiny_yaml_pair()
    raw = jconfig.load_config(_data_yaml(tmp_path, tree))
    batch = next(iter(jconfig.instantiate_from_config(raw["data"]).train_dataloader()))
    rng = jax.random.fold_in(jax.random.PRNGKey(0), 0)  # the JAX train step's first draws
    _, r_t, r_noise, r_uc = jax.random.split(rng, 4)
    n = SIZE // tm.latent_downsample
    draws = (np.asarray(jax.random.randint(r_t, (2,), 0, 1000)),
             np.asarray(jax.random.normal(r_noise, (2, n, n, 4), jnp.float32)),
             np.asarray(jax.random.uniform(r_uc, ())))
    train, frozen = split_params(variables["params"])
    loss_fn = jax.jit(make_loss_fn(jm, det_first_stage=True))
    want = float(loss_fn(train, frozen, {k: v for k, v in batch.items()
                                         if isinstance(v, np.ndarray)}, rng)[0])

    trainer = Trainer(copy.deepcopy(tm), logdir=str(tmp_path / "fit"), det_first_stage=True)
    trainer._draws = lambda b, gen: tuple(torch.from_numpy(np.array(a)) for a in draws)
    from pbe_tpu_torch import config as tconfig

    loader = tconfig.instantiate_from_config(raw["data"]).train_dataloader()
    trainer.fit(loader, max_steps=1, log_every=1)
    got = _rows(tmp_path / "fit")[0]["train/loss"]
    np.testing.assert_allclose(got, want, rtol=1e-5)  # fp32 both sides, another order


def test_log_images_equals_infer_batch_and_restores_train_mode(tmp_path):
    model, _ = build_from_yaml("configs/tiny.yaml", device="cpu")
    init_parameters(model, seed=1)
    for m in model.modules():  # randomize the zero-init heads: eps != 0
        if isinstance(m, torch.nn.Conv2d) and not torch.any(m.weight):
            torch.nn.init.normal_(m.weight, 0.0, 0.05, generator=torch.Generator().manual_seed(2))
    g = np.random.default_rng(3)
    image = g.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    mask = np.ones((2, SIZE, SIZE, 1), np.float32)
    mask[:, 16:40, 20:44] = 0.0
    batch = {"image": image, "inpaint_image": image * mask, "mask": mask,
             "ref": g.standard_normal((2, 224, 224, 3)).astype(np.float32)}
    trainer = Trainer(model, logdir=str(tmp_path))
    model.train()
    preds = trainer.log_images(batch, steps=2, seed=4)
    assert model.training
    want = infer_batch(EditPipeline(model), batch, steps=2, scale=5.0, sampler="ddim", seed=4)
    np.testing.assert_array_equal(preds, want)
    assert preds.std() > 0
    assert len(glob.glob(str(tmp_path / "samples" / "step_00000000" / "grid_*.png"))) == 2


def test_load_checkpoint_drop_prefixes_keeps_the_unet_init(tmp_path):
    src, _ = build_from_yaml("configs/tiny.yaml", device="cpu")
    init_parameters(src, seed=5)
    torch.save({"state_dict": src.state_dict()}, tmp_path / "src.ckpt")
    dst, _ = build_from_yaml("configs/tiny.yaml", device="cpu")
    init_parameters(dst, seed=6)
    unet_before = copy.deepcopy(dst.model.state_dict())
    load_checkpoint(dst, str(tmp_path / "src.ckpt"), verbose=False, drop_prefixes=("model.",))
    for k, v in dst.model.state_dict().items():
        assert torch.equal(v, unet_before[k]), k
    for k, v in dst.first_stage_model.state_dict().items():
        assert torch.equal(v, src.first_stage_model.state_dict()[k]), k


def test_cli_refuses_without_a_card_and_multi_process(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--base", "configs/tiny.yaml", "--logdir", str(tmp_path)])
    assert e.value.code not in (0, None)
    monkeypatch.setenv("PBE_MULTIHOST", "1")
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--device", "cpu", "--logdir", str(tmp_path)])
    assert "item 11" in str(e.value.code)
