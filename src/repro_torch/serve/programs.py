"""The serving engine's compiled program: ``Model.decode_step`` captured
as a CUDA graph, the port's counterpart of the JAX engine's
``jax.jit(model.decode_step)``.

JAX compiles the step once an engine: its caches have one shape for
every slot and position, and ``pos`` is a traced scalar.  A graph reads
and writes the addresses it captured, so here the params and a slot's
caches are *bound* (``core/programs.py``): the entry works on the
caller's own tensors in place, and there is one entry, one capture, per
slot's caches.  The slots of one model and params share one memory pool:
a step's intermediates are dead once its logits are read, and the engine
reads them before it steps another slot.  The token and the position are
copied into the entry's static buffers on every call; the position
reaches the model as a 0-d tensor (``Model.decode_step``), so the cache
writes, RoPE and the decode kernel's ``kv_len`` read it on the device and
one graph serves every position.  The entry's output is the step's
logits.

On the card a step is then one copy of the token, one fill of the
position, one graph replay; the first call of an entry runs the step
eagerly (the warm-up) and captures it.  On the CPU the same entry runs
the step eagerly on its buffers.  Capture raises when it fails; nothing
falls back to the eager step.
"""
from __future__ import annotations

import torch

from repro_torch.core import programs


def _step(params, caches, tokens, pos, *, model):
    logits, _ = model.decode_step(params, caches, tokens, pos)
    return logits


DECODE_STEP = programs.Program("decode_step", _step)


def decode_step(model, params, caches, tokens, pos):
    """``model.decode_step(params, caches, tokens, pos)`` through
    :data:`DECODE_STEP`: the caches are written in place and the logits
    (B, 1, V) returned.  ``tokens`` (B, 1) is a tensor, ``pos`` a host
    int or a 0-d tensor.  On the card the logits are the entry's static
    output, in a memory pool the steps of every cache tree of this model
    and these params share: read them before the next call of any of
    those steps."""
    with programs.LOCK:
        dev = tokens.device
        key = (model, programs.identity(params, caches), tuple(tokens.shape),
               dev)
        e = DECODE_STEP.entry(
            key, lambda: (torch.zeros(tokens.shape, dtype=torch.long,
                                      device=dev),
                          torch.zeros((), dtype=torch.long, device=dev)),
            bound=(params, caches),
            pool=("decode_step", model, programs.identity(params)),
            model=model)
        e.copy_in(0, tokens)
        e.copy_in(1, pos)
        return e.run(params, caches)
