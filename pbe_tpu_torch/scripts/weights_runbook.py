"""Weights-arrival runbook (port of ``scripts/weights_runbook.py``): one
command from ``model.ckpt`` to a table against the paper's published
numbers, every step a CLI of this package (``python -m
pbe_tpu_torch.scripts...``).

Quality parity (FID 3.18 / QS 77.80 / CLIP 84.97, reference README.md:
116-166) needs a trained PBE checkpoint, the Inception and CLIP metric
towers and the real COCOEE archive. This script makes that claim a single
command once they exist:

    python -m pbe_tpu_torch.scripts.weights_runbook \\
        --ckpt model.ckpt --test_bench_dir /path/to/COCOEE \\
        [--inception_weights pt_inception.pth] [--clip_weights ViT-B-32.pt] \\
        [--gmm gmm.pkl] [--outdir runbook_out] [--device cuda]

Steps (each logged; each skippable):
  1. convert  — load the torch ckpt through the production loader
               (strict=False; it reports missing and unexpected keys).
  2. golden   — the fixed-seed (321) 50-step PLMS edit of the reference's
               example_1 (under $PBE_EXAMPLES, default ./examples); PNG +
               sha256 next to the results.
  2b. frozen  — export the edit program and check its replay against the
               live pipeline (verify_frozen_program).
  3. bench    — test-bench inference (README.md:116-166's command), then
               the same with --quantize int8 (3b; --skip_int8 to opt out)
               and, with --int8_static, --quantize int8-static.
  4. metrics  — FID (vs GT_3500), CLIP score (vs Ref_3500), QS/GMM over
               each arm's results.
  5. report   — PARITY_WEIGHTS.md: paper vs fp vs int8.

--dry_run runs the chain on a synthetic bench (--bench_size a side; 64 for
a quick run) with random weights: every value is meaningless, the
mechanics are what it checks. :func:`plan` returns the steps' argv without
running anything; :func:`main` runs them.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PAPER = {"FID": 3.18, "QS": 77.80, "CLIP": 84.97}  # README.md:116-166
# the number each metric CLI prints, by the pattern that reads it
METRIC_RE = {
    "FID": r"FID[:=]?\s*([0-9.]+)",
    "CLIP": r"(?:CLIP|clip)[ _-]?score[^:=\n]*[:=]\s*([0-9.]+)",
    "QS": r"(?:QS|quality[ _-]?score)[^:=\n]*[:=]?\s*([0-9.]+)",
}


@dataclasses.dataclass
class Step:
    """One command of the runbook: ``argv`` after the interpreter; run
    only where ``requires`` (a directory) exists, if it is set; ``metric``
    and ``arm`` name the number read from its output."""

    name: str
    argv: list[str]
    requires: str | None = None
    metric: str | None = None
    arm: str | None = None


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default="", help="trained PBE torch .ckpt")
    p.add_argument("--config", default="configs/v1.yaml",
                   help="model YAML for every stage (configs/tiny.yaml with --device cpu "
                        "gives a run without a card)")
    p.add_argument("--test_bench_dir", default="test_bench",
                   help="real COCOEE layout (id_list.npy + *_3500 dirs)")
    p.add_argument("--inception_weights", default="")
    p.add_argument("--clip_weights", default="")
    p.add_argument("--gmm", default="")
    p.add_argument("--pca", default="")
    p.add_argument("--outdir", default="runbook_out")
    p.add_argument("--n_samples", type=int, default=8, help="bench batch")
    p.add_argument("--dry_run", action="store_true",
                   help="synthetic assets + random init: mechanics only")
    p.add_argument("--bench_size", type=int, default=512,
                   help="synthetic dry-run bench image side (64 for a quick run)")
    p.add_argument("--skip_bench", action="store_true")
    p.add_argument("--skip_metrics", action="store_true")
    p.add_argument("--skip_int8", action="store_true",
                   help="skip the int8-vs-fp quality A/B (step 3b/4b)")
    p.add_argument("--int8_static", action="store_true",
                   help="add a third arm: calibrated static-scale int8 "
                        "(--quantize int8-static, constant PTQ scales)")
    p.add_argument("--skip_frozen", action="store_true",
                   help="skip the frozen-program export+verify (step 2b)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu, passed to every step")
    return p


def _cli(name: str, *args: str) -> list[str]:
    return ["-m", f"pbe_tpu_torch.scripts.{name}", *args]


def arms(opt) -> list[tuple[str, str | None]]:
    """(arm, --quantize value) of the bench runs."""
    out = [("fp", None)] + ([] if opt.skip_int8 else [("int8", "int8")])
    if opt.int8_static and not opt.skip_int8:
        out.append(("int8static", "int8-static"))
    return out


def bench_dir(opt) -> str:
    """The test bench the steps read: the synthetic one of a dry run where
    --test_bench_dir holds none."""
    if opt.dry_run and not os.path.isdir(os.path.join(opt.test_bench_dir, "GT_3500")):
        return os.path.join(opt.outdir, "synthetic_bench")
    return opt.test_bench_dir


def plan(opt, examples: str | None = None) -> list[Step]:
    """The runbook's steps for the parsed options, nothing run."""
    examples = examples or os.environ.get("PBE_EXAMPLES", "examples")
    dev = ["--device", opt.device]
    ckpt = ["--ckpt", opt.ckpt] if opt.ckpt else []
    small = ["--H", str(opt.bench_size), "--W", str(opt.bench_size)] if opt.dry_run else []
    bench = bench_dir(opt)
    steps = []
    if bench != opt.test_bench_dir:
        steps.append(Step("synthetic bench", _cli("make_synthetic_test_bench", "--n", "16",
                                                  "--size", str(opt.bench_size),
                                                  "--out", bench)))
    if opt.ckpt:
        # the loader prints the strict=False missing/unexpected/mismatched
        # report; a subprocess, so that it lands in the log
        steps.append(Step("convert", ["-c", (
            "from pbe_tpu_torch.pipelines.loading import load_pipeline; "
            f"load_pipeline({opt.config!r}, {opt.ckpt!r}, device={opt.device!r})")]))
    if os.path.isdir(examples):
        steps.append(Step("golden", _cli(
            "inference", "--image_path", f"{examples}/image/example_1.png",
            "--mask_path", f"{examples}/mask/example_1.png",
            "--reference_path", f"{examples}/reference/example_1.jpg",
            "--outdir", os.path.join(opt.outdir, "golden"), "--config", opt.config,
            "--seed", "321", "--scale", "5", "--plms", "--n_iter", "1",
            *small, *ckpt, *dev)))
    if not opt.skip_frozen:
        steps.append(Step("frozen", _cli(
            "verify_frozen_program", "--outdir", os.path.join(opt.outdir, "frozen"),
            "--config", opt.config, *small, *(["--steps", "2"] if opt.dry_run else []),
            *ckpt, *dev)))
    results = {}
    for arm, quantize in arms(opt):
        out = os.path.join(opt.outdir, "bench" if arm == "fp" else f"bench_{arm}")
        results[arm] = os.path.join(out, "results")
        if not opt.skip_bench:
            steps.append(Step(f"bench ({arm})", _cli(
                "inference_test_bench", "--outdir", out, "--test_bench_dir", bench,
                "--config", opt.config, "--n_samples", str(opt.n_samples), "--plms",
                "--skip_grid", *(["--quantize", quantize] if quantize else []), *ckpt, *dev)))
    if not opt.skip_metrics:
        for arm, _ in arms(opt):
            res = results[arm]
            inception = ["--weights", opt.inception_weights] if opt.inception_weights else []
            steps.append(Step(f"FID ({arm})", _cli(
                "eval_fid", os.path.join(bench, "GT_3500"), res, *inception, *dev),
                requires=res, metric="FID", arm=arm))
            steps.append(Step(f"CLIP score ({arm})", _cli(
                "eval_clip_score", "--result_dir", res, "--test_bench_dir", bench,
                *(["--weights", opt.clip_weights] if opt.clip_weights else []), *dev),
                requires=res, metric="CLIP", arm=arm))
            if opt.gmm:
                steps.append(Step(f"QS ({arm})", _cli(
                    "eval_gmm", res, "--gmm", opt.gmm,
                    *(["--pca", opt.pca] if opt.pca else []), *inception, *dev),
                    requires=res, metric="QS", arm=arm))
    return steps


def run(argv: list[str], log_path: str) -> str:
    cmd = [sys.executable, *argv]
    print(f"$ {' '.join(cmd)}", flush=True)
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, text=True, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    with open(log_path, "a") as f:
        f.write(f"$ {' '.join(cmd)}\n{proc.stdout}\n")
    print(proc.stdout[-1500:])
    if proc.returncode != 0:
        raise SystemExit(f"step failed (rc={proc.returncode}); see {log_path}")
    print(f"  [{time.time() - t0:.0f}s]", flush=True)
    return proc.stdout


def report(opt, measured: dict[str, dict[str, float]]) -> list[str]:
    lines = [
        "# Weights parity report", "",
        f"- checkpoint: `{opt.ckpt or 'RANDOM INIT (dry run)'}`",
        f"- test bench: `{bench_dir(opt)}`",
        f"- metric towers: inception=`{opt.inception_weights or 'RANDOM'}` "
        f"clip=`{opt.clip_weights or 'RANDOM'}` gmm=`{opt.gmm or 'NONE'}`", "",
        "| metric | paper (README.md:116-166) | measured (fp) | measured (int8) | note |",
        "|---|---|---|---|---|",
    ]
    trustworthy = bool(opt.ckpt) and bool(opt.inception_weights)
    note = "" if trustworthy else "random-init towers/weights: value meaningless"
    for k, paper_v in PAPER.items():
        v, v8 = measured.get("fp", {}).get(k), measured.get("int8", {}).get(k)
        lines.append(f"| {k} | {paper_v} | {v if v is not None else '—'} "
                     f"| {v8 if v8 is not None else '—'} | {note} |")
    return lines


def main(argv=None) -> dict:
    """Run the runbook; returns {"steps": names run, "measured": {arm:
    {metric: value}}, "report": path}."""
    opt = get_parser().parse_args(argv)
    os.makedirs(opt.outdir, exist_ok=True)
    log = os.path.join(opt.outdir, "runbook.log")
    measured: dict[str, dict[str, float]] = {a: {} for a, _ in arms(opt)}
    ran = []
    for step in plan(opt):
        if step.requires is not None and not os.path.isdir(step.requires):
            # e.g. --skip_bench over an outdir whose int8 arm never ran
            print(f"== {step.name} SKIPPED (no results at {step.requires}) ==", flush=True)
            continue
        print(f"== {step.name} ==", flush=True)
        out = run(step.argv, log)
        ran.append(step.name)
        if step.metric and (m := re.search(METRIC_RE[step.metric], out, re.I)):
            measured[step.arm][step.metric] = float(m.group(1))
        if step.name == "golden":
            for root, _, files in os.walk(os.path.join(opt.outdir, "golden")):
                for fn in sorted(f for f in files if f.endswith(".png")):
                    with open(os.path.join(root, fn), "rb") as f:
                        digest = hashlib.sha256(f.read()).hexdigest()
                    print(f"  sha256({fn}) = {digest}")
                    with open(os.path.join(opt.outdir, "golden_sha256.txt"), "a") as f:
                        f.write(f"{fn} {digest}\n")
    lines = report(opt, measured)
    path = os.path.join(opt.outdir, "PARITY_WEIGHTS.md")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    print(f"\nwrote {path}")
    return {"steps": ran, "measured": measured, "report": path}


if __name__ == "__main__":
    main()
