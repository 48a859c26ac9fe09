"""The trainer's compiled program: the unsharded training step captured
as a CUDA graph, the port's counterpart of the JAX trainer's
``jax.jit(make_train_step(...))`` (``Trainer.compile_step``).

JAX compiles the step once per batch shape and traces the params and
optimizer state, which it donates.  A graph reads and writes the
addresses it captured, so here the params and the optimizer state are
*bound* (``core/programs.py``): the entry updates the caller's own
tensors in place, as ``make_train_step`` does, and there is one entry,
one capture, per state tree and batch shape.  The step counter is
advanced in place too (``optimizer.update`` returns a fresh one, which
the program writes back into the caller's), so the step hands back the
very trees it was given and the next call finds the same entry.  The
batch is copied into the entry's static buffers on every call (the
tokens and labels, and a ``vlm``'s ``patch_embeds`` or an ``encdec``'s
``frame_embeds`` where the batch carries them).  The metrics (``loss``,
``lr``, ``grad_norm``) come back as fresh 0-d tensors, as JAX's outputs
are, so a caller who keeps them across steps does not see them
overwritten.

On the card the first call of an entry runs the step eagerly on a side
stream (the warm-up, whose result it returns: the step's first update),
then captures it: the forward, autograd's backward with its
recomputations, the microbatch accumulation and the optimizer update,
every kernel launch on the path among them.  Later calls replay.  On the
CPU the same entry runs the step eagerly on its buffers.  Capture raises
when it fails; nothing falls back to the eager step.

The capture records autograd's backward, which runs on autograd's own
device thread, in the stream-capture mode of every program here
(``"thread_local"``, ``core/programs.py``): the backward's launches go
to the capturing stream and its allocations come from the graph's pool
in that mode as in PyTorch's whole-network recipe's ``"global"``: the
replays equal the eager step bit for bit in either
(``tests/test_torch_cuda.py``).  The layers' activation checkpoints keep
saving the generator's state (``preserve_rng_state``'s default): the
capture takes that read, and the loss draws no random numbers anyway.
"""
from __future__ import annotations

import torch

from repro_torch.convert import leaves, tree_map
from repro_torch.core import programs
from repro_torch.train.trainer import make_train_step


def _step(params, opt_state, batch, *, model, opt_cfg, tcfg):
    _, new_state, metrics = make_train_step(model, opt_cfg, tcfg)(
        params, opt_state, batch)
    programs.write_back(opt_state.step, new_state.step)
    return metrics


TRAIN_STEP = programs.Program("train_step", _step, collect=True)


def train_step(model, opt_cfg, tcfg, params, opt_state, batch):
    """``make_train_step(model, opt_cfg, tcfg)(params, opt_state, batch)``
    through :data:`TRAIN_STEP`: ``params`` and ``opt_state`` are updated
    in place (the step counter too) and returned, with the metrics as
    fresh 0-d tensors."""
    with programs.LOCK:
        dev = leaves(params)[0].device
        key = (model, opt_cfg, tcfg, dev, tuple(sorted(batch)),
               programs.signature(batch),
               programs.identity(params, opt_state))
        e = TRAIN_STEP.entry(
            key, lambda: (tree_map(torch.empty_like, batch),),
            bound=(params, opt_state), model=model, opt_cfg=opt_cfg,
            tcfg=tcfg)
        e.copy_in(0, batch)
        out = e.run(params, opt_state)
        return params, opt_state, {k: v.clone() for k, v in out.items()}
