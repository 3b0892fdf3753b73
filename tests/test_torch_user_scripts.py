"""The port's user scripts against the JAX package's, fp32 on the CPU:
scripts/test.py (the test-split CLI on configs/tiny.yaml over a synthetic
tree, its result keys the JAX CLI's; its loss, Trainer.validate's, equal to
JAX's make_eval_step under the same t, noise and u), the overfit demo
(make_pairs bit for bit; a 2-step run of configs/tiny.yaml writing the JAX
demo's files) and the weights runbook's plan (every step a port CLI whose
own parser takes its arguments)."""
import ast
import contextlib
import importlib
import json
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbe_tpu.evaltools.fid_callback import FIDTrioTracker as JFIDTrioTracker
from pbe_tpu.training.partition import split_params
from pbe_tpu.training.train_step import make_eval_step

from pbe_tpu_torch.scripts import make_synthetic_openimages
from pbe_tpu_torch.scripts import test as test_cli
from pbe_tpu_torch.scripts import train_overfit_demo, weights_runbook
from pbe_tpu_torch.training.trainer import Trainer

from _torch_port import pipeline_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _batch(b=2, size=32, seed=0):
    g = np.random.default_rng(seed)
    image = g.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    mask = np.ones((b, size, size, 1), np.float32)
    mask[:, 8:24, 8:24] = 0.0
    return {"image": image, "inpaint_image": image * mask, "mask": mask,
            "ref": g.standard_normal((b, size, size, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_eval():
    """(JAX eval-step metrics of _batch() under PRNGKey(3), the port's
    model with the same weights, the step's draws)."""
    jm, variables, tm = pipeline_pair()
    train, frozen = split_params(variables["params"])
    rng = jax.random.PRNGKey(3)
    metrics = jax.jit(make_eval_step(jm, det_first_stage=True))(train, frozen, _batch(), rng)
    _, r_t, r_noise, r_uc = jax.random.split(rng, 4)  # train_step.py:140-154
    draws = (np.asarray(jax.random.randint(r_t, (2,), 0, 1000)),
             np.asarray(jax.random.normal(r_noise, (2, 8, 8, 4), jnp.float32)),
             np.asarray(jax.random.uniform(r_uc, ())))
    return {k: float(v) for k, v in metrics.items()}, tm, draws


def test_test_split_loss_equals_jax_eval_step(jax_eval, tmp_path):
    """The CLI's loss is Trainer.validate's: with JAX's draws injected (the
    posterior mode, as make_eval_step(det_first_stage=True)) it is JAX's
    within 1e-4."""
    want, tm, draws = jax_eval
    trainer = Trainer(tm, logdir=str(tmp_path), det_first_stage=True)
    trainer._draws = lambda batch, gen: tuple(torch.from_numpy(np.array(a)) for a in draws)
    got = trainer.validate([_batch()], max_batches=1)
    trainer.logger.close()
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 * abs(v), (k, got[k], v)


def _data_yaml(tmp_path, tree):
    path = tmp_path / "data.yaml"
    path.write_text(f"""
data:
  target: main.DataModuleFromConfig
  params:
    batch_size: 2
    num_workers: 0
    test:
      target: ldm.data.open-images.OpenImageDataset
      params:
        state: test
        dataset_dir: {tree}
        arbitrary_mask_percent: 0.5
        image_size: 64
""")
    return str(path)


def test_test_cli_writes_the_jax_clis_keys_and_the_ema_metrics(jax_eval, tmp_path):
    tree = tmp_path / "tree"
    make_synthetic_openimages.make_tree(str(tree), n_train=0, n_val=2, size=64)
    os.rename(tree / "images" / "validation", tree / "images" / "test")
    os.rename(tree / "bbox" / "validation", tree / "bbox" / "test")
    # a reference checkpoint holding EMA weights (LitEma's names) of two
    # UNet tensors
    from pbe_tpu_torch.models.pbe import build_from_yaml

    model, _ = build_from_yaml("configs/tiny.yaml", device="cpu")
    names = ["model.diffusion_model.out.2.weight", "model.diffusion_model.out.2.bias"]
    params = dict(model.named_parameters())
    ema = {"model_ema." + n.removeprefix("model.").replace(".", ""): params[n].detach() + 0.5
           for n in names}
    ckpt = tmp_path / "ema.ckpt"
    torch.save({"state_dict": {**ema, "model_ema.num_updates": torch.tensor(7)}}, ckpt)
    shadow = test_cli.ema_from_checkpoint(str(ckpt), {n: params[n] for n in names[:1]}
                                          | {"learnable_vector": params["learnable_vector"]})
    assert shadow["count"] == 7
    assert torch.equal(shadow["shadow"][names[0]], params[names[0]].detach() + 0.5)
    assert torch.equal(shadow["shadow"]["learnable_vector"], params["learnable_vector"])

    logdir = tmp_path / "test"
    results = test_cli.main(["--base", "configs/tiny.yaml", _data_yaml(tmp_path, tree),
                             "--ckpt", str(ckpt), "--limit", "1", "--ddim_steps", "2",
                             "--device", "cpu", "--precision", "full",
                             "--logdir", str(logdir)])
    assert json.loads((logdir / "test_results.json").read_text()) == results
    loss_keys = {f"test/{k}" for k in jax_eval[0]}
    jax_keys = loss_keys | {f"test/fid_{n}" for n in JFIDTrioTracker(None).stats}
    assert set(results) == jax_keys | {f"{k}_ema" for k in loss_keys}
    assert all(np.isfinite(v) for v in results.values())
    assert results["test/loss_simple_ema"] != results["test/loss_simple"]
    grids = [f for f in os.listdir(logdir / "images") if f.startswith("grid_")]
    assert len(grids) == 2  # the batch's 6-panel grids


def test_overfit_demo_pairs_are_the_jax_demos():
    jax_demo = runpy.run_path(os.path.join(ROOT, "scripts", "train_overfit_demo.py"))
    for want, got in zip(jax_demo["make_pairs"](8, 128), train_overfit_demo.make_pairs(8, 128)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_overfit_demo_two_steps_writes_the_jax_demos_files(tmp_path):
    out = train_overfit_demo.main([
        "--config", "configs/tiny.yaml", "--size", "32", "--steps", "2", "--batch", "2",
        "--sample_steps", "2", "--log_every", "1", "--device", "cpu", "--precision", "full",
        "--outdir", str(tmp_path)])
    assert [s for s, _ in out["losses"]] == [1, 2]
    assert all(np.isfinite(v) for _, v in out["losses"])
    files = set(os.listdir(tmp_path))
    assert {"metrics.jsonl", "loss_curve.json", "overfit_summary.json", "pred_scale1.npy",
            "pred_scale5.npy", "roundtrip.npy", "grids"} <= files
    summary = json.loads((tmp_path / "overfit_summary.json").read_text())
    assert set(summary) == {"scale1", "scale5"}
    for row in summary.values():
        assert np.isfinite(row["latent_rel_mse"]) and len(row["psnr_pred_vs_roundtrip"]) == 8
    grids = os.listdir(tmp_path / "grids")
    assert sum(f.startswith("roundtrip_vs_pred") for f in grids) == 16
    assert np.load(tmp_path / "pred_scale5.npy").shape == (8, 32, 32, 3)


def _parses(step):
    """The step's argv is a port CLI (or, for the checkpoint report, a
    snippet importing only the port) that its own parser takes."""
    if step.argv[0] == "-c":
        tree = ast.parse(step.argv[1])
        mods = [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert mods and all(m.startswith("pbe_tpu_torch.") for m in mods)
        return
    assert step.argv[0] == "-m" and step.argv[1].startswith("pbe_tpu_torch.scripts.")
    module = importlib.import_module(step.argv[1])
    assert os.path.exists(module.__file__)
    opt = module.get_parser().parse_args(step.argv[2:])
    if "--device" in step.argv:
        assert opt.device == step.argv[step.argv.index("--device") + 1]


@pytest.mark.parametrize("args,want", [
    (["--dry_run", "--config", "configs/tiny.yaml", "--skip_int8", "--skip_frozen",
      "--bench_size", "64"],
     ["synthetic bench", "golden", "bench (fp)", "FID (fp)", "CLIP score (fp)"]),
    (["--ckpt", "m.ckpt", "--int8_static", "--gmm", "g.pkl", "--pca", "p.pkl",
      "--inception_weights", "i.pth", "--clip_weights", "c.pt", "--device", "cpu"],
     ["convert", "golden", "frozen", "bench (fp)", "bench (int8)", "bench (int8static)",
      "FID (fp)", "CLIP score (fp)", "QS (fp)", "FID (int8)", "CLIP score (int8)", "QS (int8)",
      "FID (int8static)", "CLIP score (int8static)", "QS (int8static)"]),
    (["--dry_run", "--skip_bench", "--skip_metrics"], ["synthetic bench", "golden", "frozen"]),
])
def test_weights_runbook_plan_names_port_clis_their_parsers_take(tmp_path, args, want):
    examples = tmp_path / "examples"
    os.makedirs(examples)
    opt = weights_runbook.get_parser().parse_args(args + ["--outdir", str(tmp_path / "out")])
    steps = weights_runbook.plan(opt, examples=str(examples))
    assert [s.name for s in steps] == want
    for step in steps:
        _parses(step)
    metric = [s for s in steps if s.metric]
    assert all(s.requires.endswith("results") for s in metric)
