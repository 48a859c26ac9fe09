"""Serving entry point: batched decode with continuous batching + START replica
re-dispatch (replica latencies from the engine's own decode steps).

Usage (on the card; ``--device cpu`` runs the plain kernels' versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
      --requests 6 --max-new 12
(``--arch`` takes every arch: demo-100m, yi-6b, minitron-4b,
phi4-mini-3.8b, deepseek-67b, internvl2-26b (text prompts),
qwen3-moe-30b-a3b, deepseek-v3-671b, whose MLA caches the compressed
latent, falcon-mamba-7b, whose recurrent state replaces the KV cache,
and jamba-1.5-large-398b, whose periods cache both (``--reduced``: the
full config's 398.55 B params fit no card).  seamless-m4t-large-v2's
requests carry no frame embeddings, so its encoder raises ``KeyError:
'frame_embeds'`` at the first prefill, as the JAX driver's does; serve
it through ``Model.prefill`` / ``decode_step`` with a batch holding
``frame_embeds``.)

Weights are seeded random until a checkpoint is in the repository.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, get_reduced
from repro_torch.models.lm import Model
from repro_torch.serve.engine import Engine, EngineConfig, \
    ReplicaDispatcher, Request


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="demo-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = Model(cfg)
    params = model.init(0, args.device)
    dispatcher = ReplicaDispatcher(args.replicas, device=args.device)

    def on_step(slot, dt):
        rep = slot % args.replicas
        dispatcher.observe(rep, dt)

    engine = Engine(model, params,
                    EngineConfig(n_slots=args.slots, max_len=96),
                    on_step=on_step)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, rng.integers(4, 12))
        engine.submit(Request(req_id=i, tokens=prompt,
                              max_new=args.max_new))
        dispatcher.assign(i)
    done = engine.run()
    wall = time.time() - t0
    toks = sum(len(r.out) for r in done)
    redis = dispatcher.decide_redispatch()
    out = {"requests_done": len(done), "tokens": toks,
           "tok_per_s": round(toks / wall, 1),
           "redispatch_candidates": len(redis)}
    print(f"[serve] {out}")
    for r in done[:3]:
        print(f"  req {r.req_id}: {len(r.out)} tokens, "
              f"latency {r.finish_t - r.submit_t:.2f}s")
    return out


if __name__ == "__main__":
    main()
