"""The port's three edit CLIs (pbe_tpu_torch.scripts.inference,
run_inference_batch, inference_test_bench) through their main(argv) on the CPU at
configs/tiny.yaml, 64^2, 2 steps, with a checkpoint of seeded weights and
input PNGs the tests write: the JAX CLIs' file layout, and results equal to
the same edit run in-process; tiled inference and the safety checker
through the inference CLI. Then the flags the port refuses, the lifted
flags failing as the JAX CLI fails, and the refusal to run without a card
unless --device cpu is given."""
import contextlib
import importlib
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from pbe_tpu_torch.data import transforms as T
from pbe_tpu_torch.pipelines.loading import load_pipeline, randomize_zero_params
from pbe_tpu_torch.scripts import inference, inference_test_bench, run_inference_batch

from _torch_port import safety_state_dict, write_test_bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "tiny.yaml")


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """(in-process pipeline, checkpoint path): load_pipeline's seeded init
    with the zero-init tensors randomized; the checkpoint holds just those
    tensors, so a CLI loading it (over the same seeded init) gets the same
    weights bit for bit."""
    pipe, _ = load_pipeline(TINY, device="cpu", dtype=torch.float32, verbose=False)
    zero = [n for n, p in pipe.model.named_parameters() if not torch.any(p)]
    randomize_zero_params(pipe.model, seed=0)
    params = dict(pipe.model.named_parameters())
    path = tmp_path_factory.mktemp("ckpt") / "tiny.ckpt"
    torch.save({"state_dict": {n: params[n].detach().clone() for n in zero}}, path)
    return pipe, str(path)


def _inputs(root, size=64, seed=0):
    g = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    Image.fromarray(g.integers(0, 256, (size, size, 3), np.uint8)).save(root / "photo.png")
    m = np.zeros((size, size), np.uint8)
    m[size // 4:3 * size // 4, size // 8:size // 2] = 255  # white = edit region
    Image.fromarray(m).save(root / "mask.png")
    Image.fromarray(g.integers(0, 256, (50, 40, 3), np.uint8)).save(root / "ref.jpg")
    return root / "photo.png", root / "mask.png", root / "ref.jpg"


def _run(module, args):
    """The CLI's ``main(argv)`` in this process, as ``python -m
    pbe_tpu_torch.scripts.<module>`` runs it (a process of its own would
    import torch and build its pipeline again) -> what it printed. Four
    threads: the suite runs beside other test workers on the CPU."""
    cli = importlib.import_module(f"pbe_tpu_torch.scripts.{module}")
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            cli.main(list(args))
    finally:
        torch.set_num_threads(threads)
    return out.getvalue()


def _png(path):
    return np.asarray(Image.open(path).convert("RGB"))


def _assert_same_edit(got_u8, want01):
    """The CLI's PNG against the in-process edit: the same weights, inputs
    and seed run the same fp32 ops; only the threads' reduction order may
    differ, moving a value across a rounding boundary by one code."""
    diff = np.abs(got_u8.astype(np.int16) - T.to_uint8(want01).astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_inference_cli_layout_and_result(seeded, tmp_path):
    pipe, ckpt = seeded
    img, mask, ref = _inputs(tmp_path / "in")
    common = ["--config", TINY, "--ckpt", ckpt, "--image_path", str(img), "--mask_path",
              str(mask), "--reference_path", str(ref), "--H", "64", "--W", "64",
              "--ddim_steps", "2", "--seed", "7", "--device", "cpu", "--precision", "full",
              "--no_watermark"]
    # the default sampler is DDIM; --n_iter 2 advances the seed;
    # --paste_back 8 keeps every pixel of the source that the mask keeps
    out = tmp_path / "ddim"
    stdout = _run("inference", common + ["--outdir", str(out), "--scale", "5",
                                         "--paste_back", "8"])
    assert "steady-state edit" in stdout and "on cpu" in stdout
    files = sorted(str(p.relative_to(out)) for p in out.rglob("*.png"))
    assert files == sorted(["results/photo_7.png", "results/photo_7_1.png",
                            "grid/grid-photo_7.png", "grid/grid-photo_7_1.png",
                            "source/photo_7_mask.png", "source/photo_7_GT.png",
                            "source/photo_7_inpaint.png", "source/photo_7_ref.png"])
    image = T.load_image(str(img), (64, 64))
    keep = T.load_mask(str(mask), (64, 64))
    exemplar = T.load_reference(str(ref))
    kept = keep[..., 0] == 1.0
    for k, seed in (("", 7), ("_1", 8)):
        got = _png(out / "results" / f"photo_7{k}.png")
        want = pipe.edit(image, keep, exemplar, steps=2, scale=5.0, sampler="ddim", seed=seed,
                         paste_back=8)
        _assert_same_edit(got, want)
        np.testing.assert_array_equal(got[kept], _png(img)[kept])
        assert np.abs(got[~kept].astype(int) - _png(img)[~kept]).max() > 8
    # the source panel is the input photo; the grid's four panels
    # [source | inpaint | ref | result] take the 224^2 exemplar's height
    np.testing.assert_array_equal(_png(out / "source" / "photo_7_GT.png"), _png(img))
    assert _png(out / "grid" / "grid-photo_7.png").shape == (224, 4 * 224 + 3 * 2, 3)


def test_run_inference_batch_cli(seeded, tmp_path):
    pipe, ckpt = seeded
    g = np.random.default_rng(1)
    for sub in ("img", "mask", "ref"):
        (tmp_path / sub).mkdir()
    for stem in ("a", "b", "c"):
        Image.fromarray(g.integers(0, 256, (48, 48, 3), np.uint8)).save(
            tmp_path / "img" / f"{stem}.png")
        Image.fromarray(g.integers(0, 256, (30, 30, 3), np.uint8)).save(
            tmp_path / "ref" / f"{stem}.png")
    (tmp_path / "mask" / "a.txt").write_text("4 4 30 40")
    (tmp_path / "mask" / "b.txt").write_text("10 0 64 20")
    Image.fromarray(np.where(g.uniform(size=(48, 48)) > 0.7, 255, 0).astype(np.uint8)).save(
        tmp_path / "mask" / "c.png")
    out = tmp_path / "out"
    stdout = _run("run_inference_batch", [
        "--fpath_config", TINY, "--fpath_checkpoint", ckpt, "--image_dir",
        str(tmp_path / "img"), "--mask_dir", str(tmp_path / "mask"), "--reference_dir",
        str(tmp_path / "ref"), "--outdir", str(out), "--ddim_steps", "2", "--batch_size",
        "2", "--H", "64", "--W", "64", "--device", "cpu", "--precision", "full",
        "--det_first_stage", "--seed", "3"])
    assert f"wrote 3 edits to {out}" in stdout
    assert sorted(p.name for p in out.iterdir()) == sorted(
        f"{k}_{s}.png" for s in "abc" for k in ("grid", "pred"))
    # the last batch holds c alone: its edit in-process, same seed
    from pbe_tpu_torch.pipelines.batch import load_mask_from_image_or_txt

    want = pipe.edit(T.load_image(str(tmp_path / "img" / "c.png"), (64, 64)),
                     load_mask_from_image_or_txt(str(tmp_path / "mask" / "c.png"), (64, 64)),
                     T.load_reference(str(tmp_path / "ref" / "c.png")), steps=2, scale=5.0,
                     sampler="ddim", seed=3, det_first_stage=True)
    _assert_same_edit(_png(out / "pred_c.png"), want)


def test_inference_test_bench_cli(seeded, tmp_path):
    pipe, ckpt = seeded
    ids = write_test_bench(tmp_path / "bench", 3, 64)
    out = tmp_path / "out"
    stdout = _run("inference_test_bench", [
        "--config", TINY, "--ckpt", ckpt, "--test_bench_dir", str(tmp_path / "bench"),
        "--outdir", str(out), "--ddim_steps", "2", "--n_samples", "2", "--plms",
        "--precision", "full", "--seed", "7", "--device", "cpu", "--uint8_out",
        "--paste_back", "4"])
    assert "done: 3 edits" in stdout and "steady-state" in stdout
    names = [f"{i:012d}" for i in ids]
    assert sorted(p.name for p in (out / "results").iterdir()) == sorted(
        f"{n}.png" for n in names)
    assert sorted(p.name for p in (out / "grid").iterdir()) == sorted(
        f"{k}_{n}.png" for n in names for k in ("grid", "pred"))
    # the ragged last batch (one pair) against the same edit in-process
    from pbe_tpu_torch.data.test_bench import COCOEEDataset

    ex = COCOEEDataset(str(tmp_path / "bench"))[2]
    want = pipe.edit(ex["image"], ex["mask"], ex["ref"], steps=2, scale=5.0, sampler="plms",
                     seed=7, paste_back=4)
    got = _png(out / "results" / f"{names[2]}.png")
    _assert_same_edit(got, want)
    kept = ex["mask"][..., 0] == 1.0
    np.testing.assert_array_equal(got[kept], T.to_uint8(T.unnormalize(ex["image"]))[kept])


def test_quantize_flags_run(seeded, tmp_path, capsys, request):
    """--quantize int8-static on the inference CLI calibrates on the edit's
    own inputs and gives the in-process static int8 edit; --quantize int8
    on the test bench gives the in-process dynamic int8 edit. Both differ
    from the fp edit (the tiny UNet's 64-channel 16x16 convs clear the
    int8 gates at 64^2)."""
    from pbe_tpu_torch.pipelines.inference import EditPipeline

    pipe, ckpt = seeded
    img, mask, ref = _inputs(tmp_path / "in")
    out = tmp_path / "static"
    # with as few threads as the CLI runs above take: the suite's workers
    # share the CPU
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    request.addfinalizer(lambda: torch.set_num_threads(threads))
    inference.main(["--config", TINY, "--ckpt", ckpt, "--image_path", str(img),
                    "--mask_path", str(mask), "--reference_path", str(ref), "--H", "64",
                    "--W", "64", "--ddim_steps", "2", "--seed", "7", "--device", "cpu",
                    "--precision", "full", "--no_watermark", "--n_iter", "1", "--plms",
                    "--scale", "5", "--quantize", "int8-static", "--outdir", str(out)])
    n = int(capsys.readouterr().out.split("calibrated ")[1].split()[0])
    image = T.load_image(str(img), (64, 64))[None]
    keep = T.load_mask(str(mask), (64, 64))[None]
    exemplar = T.load_reference(str(ref))[None]
    scales = pipe.calibrate_int8(image, keep, exemplar, seed=7)
    assert n == len(scales) > 0
    kw = dict(steps=2, scale=5.0, sampler="plms", seed=7)
    want = EditPipeline(pipe.model, quantize="int8", quant_scales=scales).edit_batch(
        image, keep, exemplar, **kw)[0]
    got = _png(out / "results" / "photo_7.png")
    _assert_same_edit(got, want)
    fp = T.to_uint8(pipe.edit_batch(image, keep, exemplar, **kw)[0])
    assert np.abs(got.astype(int) - fp).max() > 1

    ids = write_test_bench(tmp_path / "bench", 1, 64)
    out = tmp_path / "dynamic"
    inference_test_bench.main([
        "--config", TINY, "--ckpt", ckpt, "--test_bench_dir", str(tmp_path / "bench"),
        "--outdir", str(out), "--ddim_steps", "2", "--n_samples", "1", "--plms",
        "--precision", "full", "--seed", "7", "--device", "cpu", "--skip_grid",
        "--quantize", "int8"])
    from pbe_tpu_torch.data.test_bench import COCOEEDataset

    ex = COCOEEDataset(str(tmp_path / "bench"))[0]
    want = EditPipeline(pipe.model, quantize="int8").edit(ex["image"], ex["mask"], ex["ref"],
                                                          **kw)
    _assert_same_edit(_png(out / "results" / f"{ids[0]:012d}.png"), want)


def test_inference_cli_tiles_and_screens(seeded, tmp_path, capsys, request):
    """--tile_ks 8 --tile_stride 4 (7 x 7 latent crops of the 32^2 latent)
    and --safety_ckpt on a seeded diffusers-layout checker whose thresholds
    flag everything: report-only keeps the tiled edit, which equals the
    in-process EditPipeline(tiling=) edit; --enforce_safety blacks it out."""
    from pbe_tpu_torch.ops.tiling import TilingSpec
    from pbe_tpu_torch.pipelines.inference import EditPipeline

    pipe, ckpt = seeded
    img, mask, ref = _inputs(tmp_path / "in")
    checker = tmp_path / "safety.bin"
    torch.save(safety_state_dict(seed=3), str(checker))
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    request.addfinalizer(lambda: torch.set_num_threads(threads))
    argv = ["--config", TINY, "--ckpt", ckpt, "--image_path", str(img), "--mask_path",
            str(mask), "--reference_path", str(ref), "--H", "64", "--W", "64",
            "--ddim_steps", "2", "--seed", "7", "--device", "cpu", "--precision", "full",
            "--no_watermark", "--n_iter", "1", "--plms", "--scale", "5", "--tile_ks", "8",
            "--tile_stride", "4", "--safety_ckpt", str(checker)]
    inference.main(argv + ["--outdir", str(tmp_path / "report")])
    assert "safety: sample 0 flagged NSFW — report-only, kept" in capsys.readouterr().out
    image = T.load_image(str(img), (64, 64))
    keep = T.load_mask(str(mask), (64, 64))
    exemplar = T.load_reference(str(ref))
    tiled = EditPipeline(pipe.model, tiling=TilingSpec((8, 8), (4, 4)))
    kw = dict(steps=2, scale=5.0, sampler="plms", seed=7)
    want = tiled.edit(image, keep, exemplar, **kw)
    _assert_same_edit(_png(tmp_path / "report" / "results" / "photo_7.png"), want)
    assert np.abs(want - pipe.edit(image, keep, exemplar, **kw)).max() > 1e-3

    inference.main(argv + ["--enforce_safety", "--outdir", str(tmp_path / "enforce")])
    assert "safety: sample 0 flagged NSFW — blacked out" in capsys.readouterr().out
    assert not _png(tmp_path / "enforce" / "results" / "photo_7.png").any()


# the flags PR 11 lifted, failing where the JAX CLI fails: a missing
# checkpoint, a tiling that does not cover the 32^2 latent (ks 12, stride
# 6), and --tile_stride without --tile_ks (JAX's message)
LIFTED = {
    "inference-safety_ckpt": (["--safety_ckpt", "{tmp}/missing.bin"], FileNotFoundError,
                              "missing.bin"),
    "inference-tile_ks": (["--tile_ks", "12"], ValueError, "cover the input exactly"),
    "inference-tile_stride": (["--tile_stride", "8"], SystemExit,
                              "--tile_stride has no effect without --tile_ks"),
}


@pytest.mark.parametrize("argv,error,message", list(LIFTED.values()), ids=list(LIFTED))
def test_lifted_flags_fail_as_the_jax_cli_does(argv, error, message, tmp_path):
    img, mask, ref = _inputs(tmp_path / "in")
    common = ["--config", TINY, "--image_path", str(img), "--mask_path", str(mask),
              "--reference_path", str(ref), "--H", "64", "--W", "64", "--ddim_steps", "2",
              "--n_iter", "1", "--device", "cpu", "--precision", "full", "--outdir",
              str(tmp_path / "out")]
    with pytest.raises(error) as e:
        inference.main(common + [a.format(tmp=tmp_path) for a in argv])
    assert message in str(e.value)


REFUSED = {
    "run_inference_batch-data_parallel": (
        run_inference_batch, ["--image_dir", "i", "--mask_dir", "m", "--reference_dir", "r",
                              "--data_parallel"], "multi-card"),
    "inference_test_bench-data_parallel": (inference_test_bench, ["--data_parallel"],
                                           "multi-card"),
}


@pytest.mark.parametrize("cli,argv,what", list(REFUSED.values()), ids=list(REFUSED))
def test_unported_flags_exit_nonzero(cli, argv, what):
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--device", "cpu"])
    # a message (exit status 1) that names what is missing and where it waits
    assert isinstance(e.value.code, str)
    assert what in e.value.code and "ROADMAP Queue 1" in e.value.code


BATCH_DIRS = ["--image_dir", "i", "--mask_dir", "m", "--reference_dir", "r"]


@pytest.mark.parametrize("cli,argv", [(inference, []), (run_inference_batch, BATCH_DIRS),
                                      (inference_test_bench, [])],
                         ids=["inference", "run_inference_batch", "inference_test_bench"])
def test_cli_without_a_card_exits_unless_asked_for_the_cpu(cli, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert "no CUDA device" in str(e.value.code)
    # fp32 on the card is taken (the fp32 kernels): the CLI builds its
    # pipeline on the card in fp32, with TF32 off
    from pbe_tpu_torch.pipelines import loading

    built = []

    class Built(Exception):
        pass

    def load_pipeline(*args, device, dtype, **kw):
        built.append((device, dtype))
        raise Built  # stop before anything touches the card

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(loading, "load_pipeline", load_pipeline)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(Built):
        cli.main(argv + ["--precision", "full"])
    assert built == [("cuda", torch.float32)] and not torch.backends.cudnn.allow_tf32
