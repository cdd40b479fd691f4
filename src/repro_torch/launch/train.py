"""Production training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --steps 100 [--full] [--method QLearn] [--ckpt DIR] [--device cpu]

The port of ``repro.launch.train``, with its flags and ``--device`` (default
the card).  ``--smoke`` (the default) trains the reduced same-family
config; ``--full`` the whole architecture.  The step-plan autotuner (the
paper's selection technique, L2) picks the execution plan online;
checkpoints are atomic and async; injected failures exercise the restart
path.  Every arch trains: dense (llama3.2-3b, granite-8b,
mistral-nemo-12b, qwen3-32b, qwen2-vl-72b's backbone), ssm (mamba2-2.7b)
and hybrid (zamba2-7b), the last two through the SSD scan's backward
kernel, moe (olmoe-1b-7b, grok-1-314b), whose dispatch's backward sums in
a fixed order, and encdec (whisper-small), whose batches carry each
step's stub frame embeddings from the pipeline's own seeded stream
(``TokenPipeline.frames_at``: the reference's launcher takes the arch but
its batches have no frames, so it cannot train it); ``--seq-len`` is
then the decoder's tokens, and the encoder reads the config's
``encoder_seq`` frames.

Besides the reference's summary line, it prints one JSON line per plan it
ran: the steps, their wall seconds and tokens a second, the peak of
``torch.cuda.max_memory_allocated`` over its steps (on the card), and the
kernel launches of its steps; and ``main`` returns the trainer's result
with those records (``plans``), the tuner's ``history`` and ``settled``
plan.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List

import torch

from .. import kernels
from ..configs import ARCH_NAMES, get_config, smoke_reduce
from ..data import DataConfig
from ..device import resolve_device
from ..distributed import DEFAULT_PLANS, StepAutoTuner, make_plan_builder
from ..optim.adamw import AdamWConfig
from ..runtime import Trainer, TrainerConfig

#: the families the port trains, and their archs: all of them
TRAIN_FAMILIES = ("dense", "ssm", "hybrid", "moe", "encdec")
TRAIN_ARCHS = [a for a in ARCH_NAMES
               if get_config(a).family in TRAIN_FAMILIES]
#: default checkpoint directory: the checkout's build directory
DEFAULT_CKPT = str(Path(__file__).resolve().parents[3] / "build"
                   / "train_ckpt")


def measured(build, device, records: List[Dict]):
    """``build`` whose steps each append their plan, peak allocated bytes
    (on the card; the peak is reset before the step) and kernel launches
    to ``records``."""
    def build_measured(plan):
        step = build(plan)

        def run(*args):
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            before = kernels.launch_counts()
            out = step(*args)
            after = kernels.launch_counts()
            records.append({
                "plan": plan.name,
                "peak_bytes": (torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else None),
                "launches": {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}})
            return out
        return run
    return build_measured


def plan_summary(history, records, tokens_per_step: int) -> List[Dict]:
    """Per plan, in the order first run: its steps' wall seconds, tokens a
    second, the largest peak (None off the card) and the launches of each
    kernel in its first step."""
    out: Dict[str, Dict] = {}
    for (name, dt, _), rec in zip(history, records):
        row = out.setdefault(name, {"plan": name, "steps": 0,
                                    "step_s": [], "peak_bytes": None,
                                    "launches_per_step": rec["launches"]})
        row["steps"] += 1
        row["step_s"].append(dt)
        if rec["peak_bytes"] is not None:
            row["peak_bytes"] = max(row["peak_bytes"] or 0,
                                    rec["peak_bytes"])
    for row in out.values():
        row["tokens_per_s"] = [tokens_per_step / t for t in row["step_s"]]
    return list(out.values())


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--method", default="ExhaustiveSel")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--failure-rate", type=float, default=0.0)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_reduce(cfg)
    print(f"arch={args.arch} family={cfg.family} "
          f"params={cfg.n_params() / 1e6:.1f}M smoke={args.smoke} "
          f"device={device}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                          total_steps=args.steps,
                          moment_dtype=cfg.moment_dtype)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.batch)
    records: List[Dict] = []
    tuner = StepAutoTuner(list(DEFAULT_PLANS),
                          measured(make_plan_builder(cfg, opt_cfg, device),
                                   device, records),
                          method=args.method)
    trainer = Trainer(cfg, opt_cfg, data_cfg,
                      TrainerConfig(ckpt_dir=args.ckpt,
                                    ckpt_every=max(10, args.steps // 5),
                                    failure_rate=args.failure_rate),
                      autotuner=tuner, device=device)
    trainer.install_preemption_handler()
    out = trainer.train(args.steps)
    losses = out["losses"]
    out["plans"] = plan_summary(tuner.history, records,
                                args.batch * args.seq_len)
    out["history"] = list(tuner.history)
    out["compile_s"] = {tuner.plans[i].name: t
                        for i, t in tuner.compile_times.items()}
    out["settled"] = tuner.selected_plan
    for row in out["plans"]:
        print(json.dumps(row))
    print(f"done: steps={out['final_step']} restarts={out['restarts']} "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"plan={out['settled']}")
    return out


if __name__ == "__main__":
    main()
