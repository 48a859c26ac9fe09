"""Training step construction (the JAX package's ``train/trainer.py`` on
one device): gradients by autograd through ``Model.loss_fn``,
microbatched accumulation in ``accum_dtype``, the optimizer update.

PyTorch runs eagerly, so ``Trainer.compile_step`` returns the step as
it is: there is no jit.  Distribution (a ``mesh``, sharded state,
``Trainer.specs``/``lower``) is not ported yet: ROADMAP.md Queue 1 item
4.5.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.convert import leaves, tree_map, unflatten
from repro_torch.models.config import _DTYPES
from repro_torch.models.lm import Model
from repro_torch.train import optimizer as Opt

_DISTRIBUTION = ("distributed training (a mesh) is not ported yet: "
                 "ROADMAP.md Queue 1 item 4.5 (the rest of the LM stack and "
                 "distribution)")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_micro: int = 1
    accum_dtype: str = "float32"   # bf16 for the 671B config


def auto_n_micro(global_batch: int, seq: int, vocab: int, n_data: int,
                 n_model: int = 1, n_layers: int = 32,
                 d_model: int = 4096,
                 budget_bytes: float = 4e9) -> int:
    """Smallest microbatch count whose per-device live memory fits.

    Memory model per device per microbatch:
      logits  = tokens_loc * (vocab / n_model) * 6  (f32 logits + bf16
                one-hot; vocab is TP-sharded)
      remat   = n_layers * tokens_loc * d_model * 2 (layer inputs)
    Fewer microbatches = fewer FSDP weight regathers, so the SMALLEST
    feasible n.  Hard cap: each microbatch must still cover every data
    shard (global_batch/n >= n_data)."""
    cap = max(global_batch // max(n_data, 1), 1)
    n = 1
    while n < cap:
        tokens_loc = global_batch * seq / max(n_data, 1) / n
        logits = tokens_loc * (vocab / max(n_model, 1)) * 6
        remat = n_layers * tokens_loc * d_model * 2
        if logits + remat <= budget_bytes:
            break
        n *= 2
    return min(n, cap)


def value_and_grad(model: Model, params, batch):
    """(loss, grads): ``model.loss_fn`` and its gradient in every leaf of
    ``params`` (in the leaves' dtypes), as ``jax.value_and_grad``: zeros
    in a leaf the loss does not read (a hybrid period's ``ln1``)."""
    xs = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = model.loss_fn(xs, batch)
    grads = torch.autograd.grad(loss, leaves(xs), materialize_grads=True)
    return loss.detach(), unflatten(params, grads)


def make_train_step(model: Model, opt_cfg: Opt.OptConfig,
                    tcfg: TrainConfig = TrainConfig(), mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  The params and the optimizer's moments are updated in
    place (``optimizer.update``)."""
    if mesh is not None:
        raise NotImplementedError(_DISTRIBUTION)
    adt = _DTYPES[tcfg.accum_dtype]

    def train_step(params, opt_state, batch):
        n_micro = tcfg.n_micro
        if n_micro == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            bsz = batch["tokens"].shape[0]
            if bsz % n_micro:
                raise ValueError(f"batch {bsz} does not split into "
                                 f"{n_micro} microbatches")
            mb = bsz // n_micro
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                                   device=p.device), params)
            losses = []
            for i in range(n_micro):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, g = value_and_grad(model, params, micro)
                for acc, gi in zip(leaves(grads), leaves(g)):
                    acc.add_(gi.to(adt))
                losses.append(loss)
            for acc in leaves(grads):
                acc.div_(n_micro)
            loss = torch.stack(losses).mean()
        params, opt_state, om = Opt.update(opt_cfg, grads, opt_state,
                                           params)
        return params, opt_state, {"loss": loss.float(), **om}

    return train_step


@dataclasses.dataclass
class Trainer:
    """Binds a model to its device: seeded init and the step."""

    model: Model
    mesh: Any
    opt_cfg: Opt.OptConfig = Opt.OptConfig()
    tcfg: TrainConfig = TrainConfig()
    device: str = "cuda"

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(_DISTRIBUTION)
        self.step_fn = None

    def init_state(self, seed: int = 0):
        params = self.model.init(seed, self.device)
        return params, Opt.init(self.opt_cfg, params)

    def compile_step(self):
        self.step_fn = make_train_step(self.model, self.opt_cfg, self.tcfg)
        return self.step_fn
