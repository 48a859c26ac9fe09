"""Training driver: seeded params, the synthetic LM data, AdamW steps
through ``Model.loss_fn`` on one device (the card unless ``--device
cpu``), with asynchronous checkpoints, a fault drill and START's
straggler runtime in simulation mode (``--simulate-stragglers``:
per-host Pareto step-time telemetry for ``--n-hosts`` hosts -> E_S ->
backup-shard/evict actions logged each step, the tail fit on
``--device``).

Usage (every arch trains: demo-100m, the default, and yi-6b,
minitron-4b, phi4-mini-3.8b, deepseek-67b dense, internvl2-26b vlm (on
text batches), qwen3-moe-30b-a3b and deepseek-v3-671b MoE,
falcon-mamba-7b SSM, jamba-1.5-large-398b hybrid (``--reduced`` on one
card: a full-width period's AdamW state alone passes it);
seamless-m4t-large-v2's synthetic batches carry no frame embeddings, so
its encoder raises ``KeyError: 'frame_embeds'`` at the first step, as
the JAX driver's does):
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 30 \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch falcon-mamba-7b --reduced --steps 30 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch falcon-mamba-7b --reduced --steps 30 --device cpu \\
      --ckpt /tmp/ck --ckpt-every 5 --kill-at 12      # exits 42
  (the same with --resume instead of --kill-at: "resumed from step 10")
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch falcon-mamba-7b --reduced --steps 12 --device cpu \\
      --simulate-stragglers --n-hosts 400

The JAX driver's flags, plus ``--device``.  The checkpoint of step s
holds the params and optimizer state entering step s (the JAX driver's
final checkpoint; its periodic ones hold the state after step s, and
its resume runs step s a second time), so a resumed run repeats no step
and its losses equal an uninterrupted run's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, get_reduced
from repro_torch.distributed.straggler_runtime import (RuntimeConfig,
                                                       StragglerRuntime)
from repro_torch.models.lm import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="demo-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--kill-at", type=int, default=None,
                    help="fault drill: hard-exit mid-run at this step")
    ap.add_argument("--simulate-stragglers", action="store_true")
    ap.add_argument("--n-hosts", type=int, default=8)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = Model(cfg)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps)
    trainer = Trainer(model, mesh=None, opt_cfg=opt_cfg,
                      tcfg=TrainConfig(n_micro=args.n_micro),
                      device=args.device)
    params, opt_state = trainer.init_state(seed=0)
    step_fn = trainer.compile_step()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch),
                       device=args.device)

    start = 0
    writer = None
    if args.ckpt:
        writer = ckpt.AsyncCheckpointer(args.ckpt, keep=3)
        last = ckpt.latest_step(args.ckpt)
        if args.resume and last is not None:
            params, opt_state = ckpt.restore(args.ckpt, last,
                                             (params, opt_state))
            start = last
            print(f"[train] resumed from step {last}")

    runtime = None
    host_rng = np.random.default_rng(0)
    if args.simulate_stragglers:
        runtime = StragglerRuntime(RuntimeConfig(n_hosts=args.n_hosts,
                                                 device=args.device))

    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             data.batch(step))
        loss = float(metrics["loss"])
        losses.append(loss)
        if runtime is not None:
            # synthetic per-host step times: Pareto tail + a chronic host
            times = 1.0 + 0.05 * host_rng.pareto(2.5, args.n_hosts)
            times[args.n_hosts - 1] *= 1.0 + 0.8 * (step % 7 == 0)
            runtime.observe_step(times)
            for a in runtime.decide():
                print(f"[start-runtime] step {step}: {a.kind.value} "
                      f"host={a.host} backup={a.backup}")
        if args.kill_at is not None and step >= args.kill_at:
            if writer is not None:
                # the drill kills the training loop, not the storage
                # layer: checkpoints submitted at earlier steps would be
                # durable long before a real crash this many steps later
                writer.close()
            print(f"[train] FAULT DRILL: dying at step {step}")
            raise SystemExit(42)
        if writer and (step + 1) % args.ckpt_every == 0 \
                and step + 1 < args.steps:
            writer.submit(step + 1, (params, opt_state))
        if step % args.log_every == 0:
            print(f"[train] step {step} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time() - t0):.1f}s)")
    if writer:
        writer.submit(args.steps, (params, opt_state))
        writer.close()
    out = {"first_loss": losses[0] if losses else None,
           "last_loss": losses[-1] if losses else None,
           "steps": len(losses)}
    print(f"[train] done: {out}")
    return dict(out, start=start, losses=losses)


if __name__ == "__main__":
    main()
