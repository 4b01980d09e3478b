"""End-to-end training launcher (counterpart of ``repro/launch/train.py``).

Runs on the CUDA device unless ``--device cpu`` is given, and raises where
there is no card; ``--tiny`` takes the reduced config (the CPU's size).
Wires the data pipeline, the train step (K1 and K3 forward and backward on
the card), checkpoint/restart and straggler monitoring.  The flags are the
reference's, plus ``--device``; ``--ckpt-every 0`` writes no checkpoint (the
reference always writes one at the last step), and checkpoints go under
``build/train_ckpt`` at the repository root unless ``--ckpt-dir`` says
otherwise.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --tiny \
        --arch phi4-mini-3.8b --steps 6 --batch 4 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
        --steps 3 --batch 1 --seq 2048 --remat block --ckpt-every 0
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, RunConfig, ShapeConfig, get_config, get_tiny_config
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import SyntheticTokenPipeline
from repro_torch.training.fault_tolerance import StepMonitor, run_with_restarts
from repro_torch.training.optimizer import make_optimizer, tree_leaves
from repro_torch.training.train_step import init_state, make_train_step

# <root>/src/repro_torch/launch/train.py -> <root>/build/train_ckpt
DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-32b", choices=list(ARCH_IDS))
    ap.add_argument("--tiny", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device (an error if there is none)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "block", "dots"])
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="steps between checkpoints; 0 writes none")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


class Trainer:
    """The launcher's pieces, which ``chip_smoke.py`` drives step by step:
    config, run config, optimizer, train step, checkpoints, monitor."""

    def __init__(self, args: argparse.Namespace, cfg=None):
        """``cfg``: the model config to train in place of ``--arch``'s (a
        config of that arch cut in depth, where the whole does not fit)."""
        self.args = args
        if cfg is None:
            cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
        self.cfg = cfg
        shape = ShapeConfig("cli", args.seq, args.batch, "train")
        self.run = RunConfig(model=self.cfg, shape=shape, optimizer=args.optimizer,
                             microbatches=args.microbatches, remat_policy=args.remat)
        self.optimizer = make_optimizer(args.optimizer, cfg=self.cfg)
        self.step_fn = make_train_step(self.cfg, self.run, self.optimizer, args.device)
        self.device = self.step_fn.model.device
        self.ckpt = CheckpointManager(args.ckpt_dir, keep=2, cfg=self.cfg)
        self.monitor = StepMonitor()
        self.history: list[dict] = []

    def init_state(self) -> dict:
        gen = torch.Generator(device=self.device).manual_seed(self.args.seed)
        params = self.step_fn.model.init(gen)
        return init_state(params, self.optimizer)

    def pipeline(self, start_step: int) -> SyntheticTokenPipeline:
        return SyntheticTokenPipeline(self.cfg, global_batch=self.args.batch,
                                      seq_len=self.args.seq, seed=self.args.seed,
                                      start_step=start_step)

    def train_loop(self, start_step: int) -> int:
        args = self.args
        state = self.init_state()
        pipe_start = 0
        if start_step > 0:
            state, extra = self.ckpt.restore(state)
            for p in tree_leaves(state["params"]):
                p.requires_grad_(True)
            pipe_start = extra.get("data_step", start_step)
            print(f"[restore] resumed at step {start_step}")
        pipe = self.pipeline(pipe_start)
        try:
            last_loss = float("nan")
            for step in range(start_step, args.steps):
                batch = next(pipe)
                self.monitor.start()
                state, metrics = self.step_fn(state, batch)
                last_loss = float(metrics["loss"])
                dt = self.monitor.stop()
                grad_norm = float(metrics["grad_norm"])
                self.history.append({"step": step, "loss": last_loss, "grad_norm": grad_norm,
                                     "ms": dt * 1e3})
                print(f"step {step:5d} loss {last_loss:8.4f} "
                      f"grad_norm {grad_norm:8.3f} {dt*1e3:7.1f} ms", flush=True)
                if args.ckpt_every > 0 and ((step + 1) % args.ckpt_every == 0
                                            or step + 1 == args.steps):
                    self.ckpt.save(step, state, extra={"data_step": pipe.state()["step"],
                                                       "loss": last_loss})
        finally:
            pipe.close()
        self.state = state
        print(f"done. mean step {self.monitor.mean_step_s*1e3:.1f} ms; "
              f"stragglers: {len(self.monitor.stragglers)}")
        return args.steps


def main(argv=None) -> Trainer:
    trainer = Trainer(parse_args(argv))
    run_with_restarts(trainer.train_loop, trainer.ckpt,
                      on_restart=lambda n, e: print(f"[restart {n}] {e}"))
    return trainer


if __name__ == "__main__":
    main()
