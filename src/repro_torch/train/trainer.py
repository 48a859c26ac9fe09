"""Training step construction (the JAX package's ``train/trainer.py``):
gradients by autograd through ``Model.loss_fn``, microbatched
accumulation in ``accum_dtype``, the optimizer update; on one device, or
sharded over a mesh.

``Trainer.compile_step`` is the port's ``jax.jit`` of the step
(``train/programs.py``): on the card the unsharded step is captured once
per batch shape and state tree as a CUDA graph and replayed after; on
the CPU the same entry runs the step eagerly on its buffers.  On a mesh
the step stays eager (``compile_step`` returns it as it is): its DTensor
redistributions and collectives are not captured.

With a ``mesh`` (a torch ``DeviceMesh`` over the process group), each
process holds only its shards of the params and of the optimizer's
moments, as DTensors placed by ``sharding.param_specs`` /
``optimizer.opt_specs``.  A step:
  1. gathers every leaf whole (``redistribute`` to replicated; under
     expert parallelism an expert stack keeps its slice on the model
     axis), so the model and its kernels only ever see plain tensors;
  2. runs ``loss_fn`` and autograd on this process's part of the batch
     over the dp axes (the model axis sees the same part): microbatch j
     is this process's part of the single-device step's microbatch j, so
     the MoE layers can route each global microbatch as one device does
     (``moe.EPContext``);
  3. reduce-scatters the gradients to the params' placements, summed over
     the dp axes and divided by their size (a mean over the global batch,
     as the single-device step's);
  4. updates the shards in place, with the global norm of the whole
     gradient summed over the mesh.  AdamW is elementwise, so a shard's
     update is the whole leaf's restricted to it.  AdaFactor's factored
     moments take means along a leaf's rows and columns: each shard sums
     its part, the sums are added over the mesh axes that cut that axis
     of the leaf and divided by the whole leaf's width, so every process
     holds the whole leaf's means of its own rows (columns), placed as
     ``optimizer.opt_specs`` places ``v_row`` (``v_col``).
Gathering the whole tree once a step is the simple schedule; gathering
group by group (ZeRO-3 proper) is speed work for later.  The model axis
computes the same thing on each of its processes (no tensor-parallel
matmuls), apart from the experts under EP.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.convert import leaves, tree_map, unflatten
from repro_torch.distributed import sharding as Sh
from repro_torch.launch.mesh import axes as mesh_axes
from repro_torch.models.config import _DTYPES
from repro_torch.models.lm import EPSetup, Model
from repro_torch.train import optimizer as Opt


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


def _loss_and_grads(model: Model, params, batch, n_micro: int, adt):
    """(loss, grads) over ``batch``, in ``n_micro`` microbatches (their
    mean; gradients accumulated in ``adt``)."""
    if n_micro == 1:
        return value_and_grad(model, params, batch)
    bsz = batch["tokens"].shape[0]
    if bsz % n_micro:
        raise ValueError(f"batch {bsz} does not split into {n_micro} "
                         f"microbatches")
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
    return torch.stack(losses).mean(), grads


def ep_setup(cfg, mesh) -> EPSetup | None:
    """The MoE layers' placement on a (data, model) ``DeviceMesh``: expert
    parallelism over the model axis, as the JAX dry run's
    ``build_model``, where the axis has more than one process and the
    experts split evenly over it; and the data axis, over which the
    layers route as one device would route the global batch.  None where
    the config has no experts or the mesh is one process."""
    sizes = mesh_axes(mesh)
    n_model, n_data = sizes.get("model", 1), sizes.get("data", 1)
    if not cfg.n_experts or n_model * n_data == 1:
        return None
    if set(sizes) - {"data", "model"}:
        raise ValueError(f"MoE layers take a (data, model) mesh, not "
                         f"{tuple(sizes)}")
    split = n_model > 1 and cfg.n_experts % n_model == 0
    return EPSetup(
        group=mesh["model"].get_group() if split else None,
        n_shards=n_model if split else 1,
        rank=mesh.get_local_rank("model") if split else 0,
        dp_group=mesh["data"].get_group() if n_data > 1 else None,
        dp_size=n_data, dp_rank=mesh.get_local_rank("data"))


def make_train_step(model: Model, opt_cfg: Opt.OptConfig,
                    tcfg: TrainConfig = TrainConfig(), mesh=None,
                    dp_axes: tuple | None = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  The params and the optimizer's moments are updated in
    place (``optimizer.update``).  With ``mesh``, the params and moments
    are DTensor trees (``Trainer.init_state``), ``batch`` is the global
    batch (the same on every process) and ``dp_axes`` the axes it is
    split over (default ``sharding.dp_axes``; ``("data", "model")`` for
    the ``fsdp_all`` layout).  The reduced gradients land on the params'
    own placements, which is what JAX's ``grad_specs`` constraint asks
    of GSPMD."""
    adt = _DTYPES[tcfg.accum_dtype]
    if mesh is None:
        def train_step(params, opt_state, batch):
            loss, grads = _loss_and_grads(model, params, batch,
                                          tcfg.n_micro, adt)
            params, opt_state, om = Opt.update(opt_cfg, grads, opt_state,
                                               params)
            return params, opt_state, {"loss": loss.float(), **om}

        return train_step
    return _mesh_step(model, opt_cfg, tcfg, mesh, dp_axes, adt)


def _mesh_step(model, opt_cfg, tcfg, mesh, dp_axes, adt):
    from torch.distributed.tensor import Partial, Replicate, Shard

    names = list(mesh_axes(mesh))
    dp = tuple(dp_axes if dp_axes is not None else Sh.dp_axes(mesh))
    sizes = mesh_axes(mesh)
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]
    ep = model.ep is not None and model.ep.n_shards > 1
    model_dim = names.index("model") if "model" in names else None

    def gathered_placements(path, dt):
        """Every mesh dim replicated, but an expert stack under EP keeps
        its slice on the model axis."""
        out = [Replicate()] * len(names)
        if ep and Sh.is_expert_leaf(path):
            out[model_dim] = dt.placements[model_dim]
        return tuple(out)

    def dp_index(coord) -> int:
        i = 0
        for a in dp:
            i = i * sizes[a] + coord[names.index(a)]
        return i

    def reduce(g, dt, gathered):
        """A gathered leaf's gradient summed over the dp axes into the
        param's placements (a reduce-scatter where they shard it), over
        n_dp."""
        from torch.distributed.tensor import DTensor
        src = [Partial("sum") if a in dp else p
               for a, p in zip(names, gathered)]
        out = DTensor.from_local(g, mesh, src, run_check=False,
                                 shape=dt.shape, stride=dt.stride()
                                 ).redistribute(mesh, dt.placements)
        out = out.to_local()
        return out / n_dp if n_dp > 1 else out

    def factored_mean(flat):
        """``Opt.update``'s mean over one axis of a sharded leaf: this
        shard's sum, added over the mesh dims that cut that axis of the
        leaf, over the whole leaf's width."""
        def mean(i, x, dim, axis):
            dt = flat[i]
            total = x.sum(dim)
            for d, p in enumerate(dt.placements):
                if isinstance(p, Shard) and p.dim == dt.ndim + axis:
                    dist.all_reduce(total, group=mesh.get_group(d))
            return total / dt.shape[axis]
        return mean

    def train_step(params, opt_state, batch):
        flat = leaves(params)
        paths = Sh.leaf_paths(params)
        gathered = [gathered_placements(p, dt) for p, dt in zip(paths, flat)]
        full = unflatten(params, [dt.redistribute(mesh, pl).to_local()
                                  for dt, pl in zip(flat, gathered)])
        local = {k: _dp_part(v, dp_index(Sh.coordinate(mesh)), n_dp,
                             tcfg.n_micro) for k, v in batch.items()}
        loss, grads = _loss_and_grads(model, full, local, tcfg.n_micro,
                                      adt)
        del full
        shards = [reduce(g, dt, pl)
                  for g, dt, pl in zip(leaves(grads), flat, gathered)]
        del grads
        # the whole gradient's norm: each shard's sum of squares once per
        # distinct block (divided by the processes that hold a copy)
        total = 0
        for g, dt in zip(shards, flat):
            copies = 1
            for a, p in zip(names, dt.placements):
                if isinstance(p, Replicate):
                    copies *= sizes[a]
            s = Opt.leaf_square_sum(g)
            total = total + (s if copies == 1 else s / copies)
        total = torch.as_tensor(total, dtype=torch.float32,
                                device=shards[0].device).reshape(1)
        gnorm = torch.sqrt(mesh_sum(total, mesh)[0])
        local_state = Opt.OptState(opt_state.step, *(
            None if f is None else tree_map(lambda dt: dt.to_local(), f)
            for f in opt_state[1:]))
        _, new_state, om = Opt.update(
            opt_cfg, unflatten(params, shards), local_state,
            tree_map(lambda dt: dt.to_local(), params), gnorm=gnorm,
            mean=factored_mean(flat))
        loss = mesh_sum(loss.float().reshape(1).clone(), mesh)[0] \
            / mesh.size()
        return params, opt_state._replace(step=new_state.step), {
            "loss": loss, **om}

    return train_step


def _dp_part(v: torch.Tensor, i: int, n_dp: int, n_micro: int):
    """Process ``i``'s rows of a global batch leaf: microbatch j of the
    global batch (rows j B/n_micro onwards, as the single-device step
    cuts them) split into ``n_dp`` parts, part ``i`` of each in order,
    so this process's microbatch j is its part of the global one."""
    rows = v.shape[0] // (n_micro * n_dp)
    if rows * n_micro * n_dp != v.shape[0]:
        raise ValueError(f"batch {v.shape[0]} does not split into "
                         f"{n_micro} microbatches over {n_dp} processes")
    if n_micro == 1:
        return v[i * rows:(i + 1) * rows]
    per = rows * n_dp
    return torch.cat([v[j * per + i * rows:j * per + (i + 1) * rows]
                      for j in range(n_micro)])


def mesh_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed in place over every process of ``mesh`` (one
    all-reduce per mesh dim)."""
    for dim in range(mesh.ndim):
        dist.all_reduce(t, group=mesh.get_group(dim))
    return t


@dataclasses.dataclass
class Trainer:
    """Binds a model to its device or mesh: seeded init (sharded on a
    mesh), the step, and the memory plan (``lower``)."""

    model: Model
    mesh: Any
    opt_cfg: Opt.OptConfig = Opt.OptConfig()
    tcfg: TrainConfig = TrainConfig()
    device: str = "cuda"

    def __post_init__(self):
        self.step_fn = None

    # -------- spec derivation (meta tensors, no allocation) ---------------

    def specs(self, batch_like):
        """(params on the meta device, their specs, the optimizer state's,
        the batch's), as the JAX ``Trainer.specs``."""
        from repro_torch.models.specs import params_specs
        params_meta = params_specs(self.model)
        pspec = Sh.param_specs(params_meta, self.mesh)
        ospec = Opt.opt_specs(self.opt_cfg, pspec, params_meta)
        bspec = Sh.batch_specs_tree(batch_like, self.mesh)
        return params_meta, pspec, ospec, bspec

    def lower(self, batch_like) -> dict:
        """There is no jit to lower: the meta-device plan of this step on
        the trainer's mesh instead (``launch.dryrun.plan_step``): each
        device's param, optimizer-state and batch bytes and its FLOPs."""
        from repro_torch.launch.dryrun import plan_step
        return plan_step(self.model, self.mesh, self.opt_cfg, self.tcfg,
                         batch_like)

    # ------------------------- concrete execution --------------------------

    def init_state(self, seed: int = 0):
        """Seeded params and zero moments; on a mesh every process draws
        the whole tree from ``seed`` and keeps its own shards."""
        params = self.model.init(seed, self.device)
        if self.mesh is None:
            return params, Opt.init(self.opt_cfg, params)
        return self.shard_state(params)

    def shard_state(self, params):
        """(sharded params, zero optimizer state placed as
        ``optimizer.opt_specs`` places it) from a whole params tree that
        every process of the mesh holds alike (a seeded init, converted
        JAX params): each keeps its own blocks."""
        specs = Sh.param_specs(params, self.mesh)
        ospecs = Opt.opt_specs(self.opt_cfg, specs, params)
        state = Opt.init(self.opt_cfg, params)
        return Sh.shard_tree(params, specs, self.mesh), Opt.OptState(
            state.step, *(None if f is None else
                          Sh.shard_tree(f, spec, self.mesh)
                          for f, spec in zip(state[1:], ospecs[1:])))

    def compile_step(self):
        """The step as ``jax.jit`` compiles it: without a mesh, the
        compiled program (``train/programs.py``: captured on the card at
        its first call on a state tree and batch shape, replayed after;
        eager on the CPU); on a mesh, the eager mesh step."""
        if self.mesh is not None:
            self.step_fn = make_train_step(self.model, self.opt_cfg,
                                           self.tcfg, mesh=self.mesh)
            return self.step_fn
        # imported here: train/programs.py builds on make_train_step
        from repro_torch.train.programs import train_step
        self.step_fn = functools.partial(train_step, self.model,
                                         self.opt_cfg, self.tcfg)
        return self.step_fn
