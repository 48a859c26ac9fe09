"""Multi-pod dry run on the meta device: plan every (arch x shape x mesh)
cell and count what one device holds and does, with no storage and no
card.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell for
512 placeholder devices.  PyTorch has no program to lower, so a cell
here is:
  * its plan (``plan_cell``), JAX's ``lower_cell`` decisions as a pure
    function: the optimizer (adafactor above 1.5e10 params), bf16
    gradient accumulation above 1e11, the bytes-per-param table, the
    ``fsdp_all`` test (dense archs whose ZeRO-3 state over the whole pod
    fits go without TP), the FSDP switch, ``auto_n_micro``; and
    ``configs.shapes.applicable``'s skips;
  * its per-device state bytes from the placements
    (``sharding.param_specs`` / ``optimizer.opt_specs`` /
    ``batch_specs_tree`` / ``cache_specs_tree``): params, optimizer
    state, batch and decode caches;
  * its per-device FLOPs, bytes and transcendentals
    (``launch.accounting``) from running the port's model on meta
    tensors for this device's rows of the batch: ``loss_fn`` and its
    gradient (one microbatch, times ``n_micro``), ``prefill`` or one
    ``decode_step``.

What is counted, and how:
  * the port's schedule: the model axis repeats the dense work (no
    tensor-parallel matmuls), so a ``tp``-layout cell counts n_model
    times JAX's dense FLOPs per device; the experts are split over the
    model axis (EP) wherever JAX's ``build_model`` splits them;
  * the kernels run as stand-ins that make the output shapes and add
    reckoned counts: attention (flash) 2 * pairs * (D + Dv) FLOPs in the
    forward and twice that backward, over the causal pairs of the mask
    (Sq * (Sk - Sq) + Sq (Sq + 1) / 2; all Sq * Sk when not causal), one
    exponential a pair; decode attention 2 * H * kv_len * (D + Dv) a
    row; the selective scan 9 FLOPs and one exponential per (b, l, d, n)
    forward, twice that backward; the router as its plain version (MLA
    attends through the plain functions, as on the card: all Sq * Sk
    pairs);
  * the MoE layer as the capacity-padded dispatch JAX lowers
    (``grouped_ffn``: the E_local x capacity rows of the scattered
    buffer through the three expert products, capacity from this
    device's tokens as inside JAX's ``shard_map``), not the port's
    count-exact dispatch, whose rows depend on the routing;
  * training is a forward and a backward (model FLOPs: for yi-6b at
    train_4k within a few % of 6 N T plus the causal attention term
    3 * 4 * L * H * hd * (S (S + 1) / 2) per sequence); the per-layer
    recompute of the activation checkpointing is reported apart
    (``remat_flops_per_device``, one more forward);
  * collective bytes, reckoned from the placements under
    ``hlo_accounting``'s rule (result-shape bytes per op occurrence):
    one all-gather per sharded param leaf per step (its result the
    gathered leaf), one reduce-scatter (dp-sharded leaves: the shard)
    or all-reduce (the rest: the leaf) per gradient leaf, and under EP
    one (T, d) all-reduce per MoE layer forward (twice in training,
    with the recompute) and, backward, the activations' (T, d) and the
    router's (d, E) fp32.
XLA's ``memory_analysis`` / ``cost_analysis`` and compile times have no
counterpart, so the records leave ``lower_s``, ``compile_s`` and
``xla_cost_*`` out.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out DIR
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.convert import leaves, tree_map, unflatten
from repro_torch.distributed import sharding as Sh
from repro_torch.kernels.moe_router.ref import moe_router_ref
from repro_torch.launch import accounting
from repro_torch.launch.mesh import axes as mesh_axes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import backend, lm
from repro_torch.models import moe as Moe
from repro_torch.models.config import _DTYPES
from repro_torch.models.lm import Model
from repro_torch.models.specs import cache_specs, input_specs, meta
from repro_torch.train import optimizer as Opt
from repro_torch.train.trainer import auto_n_micro

SCAN_FLOPS = 9            # per (b, l, d, n) of the selective scan, forward


def _mesh_dp(ax: dict) -> int:
    return math.prod(ax[a] for a in ("pod", "data") if a in ax)


def ep_splits(cfg, ax: dict) -> bool:
    """JAX's ``build_model``: experts split over the model axis."""
    nm = ax.get("model", 1)
    return bool(cfg.n_experts) and nm > 1 and cfg.n_experts % nm == 0


def plan_cell(cfg, shape, mesh, opt_kind: str | None = None,
              n_micro: int | None = None) -> dict:
    """The decisions of JAX ``lower_cell`` (``dryrun.py:108-161``) for one
    cell: optimizer, accumulation dtype, bytes per param, layout, FSDP,
    microbatches, the dp axes and the param layout's arguments."""
    ax = mesh_axes(mesh)
    n_model = ax.get("model", 1)
    n_dev = math.prod(ax.values())
    dp = Sh.dp_axes(mesh)
    out = dict(params=cfg.param_count(),
               active_params=cfg.active_param_count(), n_devices=n_dev,
               ep=ep_splits(cfg, ax))
    if shape.kind != "train":
        fsdp = cfg.param_count() * 2 / n_model > 12e9
        out.update(layout="tp", fsdp=fsdp, dp_axes=dp,
                   spec_kw=dict(fsdp=fsdp))
        return out
    n_params = cfg.param_count()
    okind = opt_kind or ("adafactor" if n_params > 1.5e10 else "adamw")
    accum = "bfloat16" if n_params > 1e11 else "float32"
    # bytes/param of live training state per model shard
    bpp = {"adamw": 14.0, "adafactor": 8.5}[okind]
    if accum == "bfloat16":
        bpp -= 2.0
    # activation estimate at n_micro=1: remat carries + loss-head live set
    tokens_dev = shape.global_batch * shape.seq_len / n_dev
    logits_est = tokens_dev * cfg.padded_vocab * 2
    act_est = ((cfg.n_layers + cfg.encoder_layers) * tokens_dev
               * cfg.d_model * 2 + logits_est)
    fsdp_all = (cfg.n_experts == 0
                and n_params * bpp / n_dev <= 12e9
                and act_est <= 2.7e9 and logits_est <= 1.2e9
                and shape.global_batch % n_dev == 0)
    n_layers = cfg.n_layers + cfg.encoder_layers
    if fsdp_all:
        dp = dp + ("model",)
        fsdp = True
        spec_kw = dict(fsdp=True, tp=False, fsdp_axes=("data", "model"))
        nm = n_micro or auto_n_micro(
            shape.global_batch, shape.seq_len, cfg.padded_vocab, n_dev,
            n_model=1, n_layers=n_layers, d_model=cfg.d_model)
    else:
        fsdp = n_params * bpp / n_model > 12e9  # ~12G of 16G HBM
        spec_kw = dict(fsdp=fsdp)
        nm = n_micro or auto_n_micro(
            shape.global_batch, shape.seq_len, cfg.padded_vocab,
            _mesh_dp(ax), n_model=n_model, n_layers=n_layers,
            d_model=cfg.d_model)
    out.update(optimizer=okind, accum_dtype=accum, bytes_per_param=bpp,
               n_micro=nm, fsdp=fsdp,
               layout="fsdp_all" if fsdp_all else "tp", dp_axes=dp,
               spec_kw=spec_kw)
    return out


def train_batch_specs(batch: dict, mesh, plan: dict) -> dict:
    """JAX's batch placement: over every dp axis where the whole mesh
    divides the batch (``fsdp_all``), else ``batch_specs_tree``."""
    if plan["layout"] != "fsdp_all":
        return Sh.batch_specs_tree(batch, mesh)
    n_dev = plan["n_devices"]
    return {k: ((plan["dp_axes"] if v.shape[0] % n_dev == 0 else None),
                *([None] * (v.dim() - 1))) for k, v in batch.items()}


# ------------------------------ state bytes --------------------------------


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def tree_bytes(tree, specs, ax: dict) -> int:
    """Bytes one device holds of ``tree`` placed by ``specs``."""
    return sum(Sh.shard_numel(t.shape, s, ax) * _itemsize(t.dtype)
               for t, s in zip(leaves(tree), Sh.spec_leaves(specs)))


def opt_state_bytes(ocfg: Opt.OptConfig, params, pspec, ax: dict) -> int:
    """One device's optimizer state by ``opt_specs``: AdamW's two
    moments in ``moment_dtype``; adafactor's bf16 first moment and its
    factored (or full, for vectors) fp32 second moments."""
    ospec = Opt.opt_specs(ocfg, pspec, params)
    ps = leaves(params)
    if ocfg.kind == "adamw":
        item = _itemsize(_DTYPES[ocfg.moment_dtype])
        return 2 * sum(Sh.shard_numel(p.shape, s, ax) * item
                       for p, s in zip(ps, Sh.spec_leaves(ospec.m)))
    total = 0
    for p, sm, sr, sc in zip(ps, Sh.spec_leaves(ospec.m),
                             Sh.spec_leaves(ospec.v_row),
                             Sh.spec_leaves(ospec.v_col)):
        shape = tuple(p.shape)
        fact = Opt._factored(shape)
        row = shape[:-1] if fact else (1,)
        col = shape[:-2] + shape[-1:] if fact else shape
        total += Sh.shard_numel(shape, sm, ax) * 2
        total += Sh.shard_numel(row, sr, ax) * 4
        total += Sh.shard_numel(col, sc, ax) * 4
    return total


# ------------------------------ stand-ins ----------------------------------


class _Reckoned(torch.autograd.Function):
    """A kernel's stand-in: outputs of the right shapes (empty on meta),
    its reckoned counts added to the counter, forward and backward."""

    @staticmethod
    def forward(ctx, counter, counts, shapes, *inputs):
        ctx.counter, ctx.counts = counter, counts
        ctx.meta = [(t.shape, t.dtype) for t in inputs]
        counter.add(**counts)
        outs = tuple(inputs[0].new_empty(s, dtype=d) for s, d in shapes)
        return outs if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        ctx.counter.add(**{k: 2 * v for k, v in ctx.counts.items()})
        return (None, None, None) + tuple(
            grads[0].new_empty(s, dtype=d) for s, d in ctx.meta)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _attn_pairs(sq: int, sk: int, causal: bool) -> int:
    if not causal:
        return sq * sk
    return sq * (sk - sq) + sq * (sq + 1) // 2


@contextlib.contextmanager
def stand_ins(counter: accounting.Counter, ep_split: bool):
    """The model's kernels, its MoE dispatch and its checkpointing swapped
    for the counting stand-ins above (the module docstring says what
    each counts); restored on exit."""
    saved = (backend.attention, backend.decode_attention,
             backend.mamba_scan, backend.mamba_scan_with_state,
             backend.moe_router, Moe.grouped_ffn, lm.checkpoint)

    def attention(q, k, v, *, causal=True):
        b, h, sq, d = q.shape
        pairs = _attn_pairs(sq, k.shape[2], causal)
        out = (b, h, sq, v.shape[-1])
        counts = dict(flops=2.0 * b * h * pairs * (d + v.shape[-1]),
                      transcendentals=float(b * h * pairs),
                      nbytes=float(_nbytes(q, k, v) + _nbytes(q)))
        return _Reckoned.apply(counter, counts, [(out, q.dtype)], q, k, v)

    def decode_attention(q, k, v, *, kv_len):
        b, h, d = q.shape
        kv = k[:, :, :kv_len]
        counter.add(flops=2.0 * b * h * kv_len * (d + v.shape[-1]),
                    transcendentals=float(b * h * kv_len),
                    nbytes=float(_nbytes(q, kv, kv, q)))
        return q.new_empty(b, h, v.shape[-1])

    def scan_counts(u, n):
        bld = u.shape[0] * u.shape[1] * u.shape[2]
        return dict(flops=float(SCAN_FLOPS * bld * n),
                    transcendentals=float(bld * n),
                    nbytes=float(3 * u.numel() * u.element_size()))

    def mamba_scan(u, delta, a, b, c, skip):
        return _Reckoned.apply(counter, scan_counts(u, a.shape[1]),
                               [(u.shape, u.dtype)], u, delta, a, b, c,
                               skip)

    def mamba_scan_with_state(u, delta, a, b, c, skip):
        counter.add(**scan_counts(u, a.shape[1]))
        return (u.new_empty(u.shape),
                u.new_empty((u.shape[0], u.shape[2], a.shape[1]),
                            dtype=torch.float32))

    def grouped_ffn(x, idx, w, wg, wu, wd, capacity, valid=None,
                    offsets=None):
        # JAX's dispatch: E x C slots gathered from the copies, the three
        # expert products over every slot, the weighted scatter-add back
        e, c = wg.shape[0], capacity
        slot = torch.empty(e * c, dtype=torch.long, device=x.device)
        xe = x.index_select(0, slot).view(e, c, x.shape[1])
        h = torch.nn.functional.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
        ye = torch.bmm(h, wd).reshape(e * c, x.shape[1])
        wc = w.reshape(-1).index_select(0, slot)
        if ep_split:   # the partial outputs summed over the model axis
            counter.add(all_reduce=float(_nbytes(x)))
        return torch.zeros_like(x).index_add(0, slot, ye * wc[:, None])

    def no_checkpoint(fn, *args, use_reentrant=False):
        return fn(*args)

    backend.attention = attention
    backend.decode_attention = decode_attention
    backend.mamba_scan = mamba_scan
    backend.mamba_scan_with_state = mamba_scan_with_state
    backend.moe_router = moe_router_ref
    Moe.grouped_ffn = grouped_ffn
    lm.checkpoint = no_checkpoint
    try:
        yield
    finally:
        (backend.attention, backend.decode_attention, backend.mamba_scan,
         backend.mamba_scan_with_state, backend.moe_router,
         Moe.grouped_ffn, lm.checkpoint) = saved


# ----------------------------- device work ---------------------------------


def _local(tree, specs, ax: dict):
    """Meta tensors of this device's blocks of ``tree``."""
    return unflatten(tree, [meta(Sh.shard_shape(t.shape, s, ax), t.dtype)
                            for t, s in zip(leaves(tree),
                                            Sh.spec_leaves(specs))])


def _expert_local(params, n_shards: int):
    """The params with every expert stack cut to one device's E/n slice
    (the EP layout the mesh step gathers to)."""
    paths = Sh.leaf_paths(params)
    out = []
    for p, t in zip(paths, leaves(params)):
        if Sh.is_expert_leaf(p):
            e_dim = t.dim() - 3
            t = t.narrow(e_dim, 0, t.shape[e_dim] // n_shards)
        out.append(t)
    return unflatten(params, out)


def _gather_bytes(params, pspec, ax: dict, ep: bool) -> tuple[int, int]:
    """(all-gather result bytes, the gathered tree's bytes): one gather
    per leaf that some mesh axis shards, to the whole leaf (an expert
    stack under EP to its slice)."""
    gathered = moved = 0
    n_model = ax.get("model", 1)
    for p, t, s in zip(Sh.leaf_paths(params), leaves(params),
                       Sh.spec_leaves(pspec)):
        whole = t.numel() * _itemsize(t.dtype)
        if ep and Sh.is_expert_leaf(p):
            whole //= n_model
        gathered += whole
        sharded = any(e is not None for e in s)
        if ep and Sh.is_expert_leaf(p):
            sharded = any(e is not None for i, e in enumerate(s)
                          if i != t.dim() - 3)
        if sharded:
            moved += whole
    return moved, gathered


def _reduce_bytes(params, pspec, ax: dict, dp: tuple, ep: bool,
                  grad_dtype=None) -> dict:
    """Per gradient leaf: a reduce-scatter over the dp axes where its spec
    shards it on one of them (result: its block over those axes), else
    an all-reduce of the gathered leaf."""
    out = {"reduce-scatter": 0, "all-reduce": 0}
    n_model = ax.get("model", 1)
    for p, t, s in zip(Sh.leaf_paths(params), leaves(params),
                       Sh.spec_leaves(pspec)):
        item = _itemsize(grad_dtype or t.dtype)
        shape = list(t.shape)
        if ep and Sh.is_expert_leaf(p):
            shape[t.dim() - 3] //= n_model
        on_dp = [tuple(a for a in Sh._entry_axes(e) if a in dp)
                 for e in s] + [()] * (len(shape) - len(s))
        if any(on_dp):
            block = 1
            for n, axs in zip(shape, on_dp):
                block *= -(-n // math.prod(ax[a] for a in axs))
            out["reduce-scatter"] += block * item
        else:
            out["all-reduce"] += math.prod(shape) * item
    return out


def _moe_layers(model: Model) -> int:
    n = 0
    for g in model.groups:
        if g.kind == "hybrid":
            n += g.n * (model.cfg.attn_period // model.cfg.moe_every)
        elif g.moe:
            n += g.n
    return n


def count_train(model: Model, params, pspec, batch, bspec, mesh,
                plan: dict) -> dict:
    """This device's work in one training step: ``n_micro`` times one
    microbatch's forward and backward (the stand-ins counting the
    kernels), plus the collectives reckoned from the placements."""
    cfg = model.cfg
    ax = mesh_axes(mesh)
    ep = plan["ep"]
    nm = plan["n_micro"]
    local = _local(batch, bspec, ax)
    micro = {k: meta((v.shape[0] // nm,) + tuple(v.shape[1:]), v.dtype)
             for k, v in local.items()}
    p = _expert_local(params, ax["model"]) if ep else params
    xs = tree_map(lambda t: meta(t.shape, t.dtype).requires_grad_(), p)
    c = accounting.Counter()
    with stand_ins(c, ep):
        with c:
            loss = model.loss_fn(xs, micro)
        fwd = accounting.Totals()
        fwd.add(c.totals)
        with c:
            torch.autograd.grad(loss, leaves(xs), materialize_grads=True)
    step = c.totals.scaled(nm)
    moved, gathered = _gather_bytes(params, pspec, ax, ep)
    step.collectives["all-gather"] += moved
    grad_dtype = _DTYPES[plan["accum_dtype"]] if nm > 1 else None
    for k, v in _reduce_bytes(params, pspec, ax, plan["dp_axes"], ep,
                              grad_dtype).items():
        step.collectives[k] += v
    if ep:   # the recompute's forward all-reduce; backward: x and router
        tokens = micro["tokens"].numel() + (
            cfg.frontend_tokens * micro["tokens"].shape[0]
            if cfg.family == "vlm" else 0)
        act = tokens * cfg.d_model * _itemsize(cfg.dtype)
        step.collectives["all-reduce"] += nm * _moe_layers(model) * (
            2 * act + cfg.d_model * cfg.n_experts * 4)
    return dict(totals=step, remat=fwd.scaled(nm).flops,
                gathered=gathered)


def count_serve(model: Model, params, pspec, inputs: dict, specs: dict,
                mesh, kind: str, plan: dict) -> dict:
    """This device's work in one ``prefill`` or one ``decode_step`` of its
    batch rows (the whole context: the port has no sequence-parallel
    decode), plus the param gathers."""
    ax = mesh_axes(mesh)
    ep = plan["ep"]
    p = _expert_local(params, ax["model"]) if ep else params
    c = accounting.Counter()
    with stand_ins(c, ep), torch.no_grad():
        if kind == "prefill":
            batch = _local(inputs["batch"], specs["batch"], ax)
            with c:
                model.prefill(p, batch)
        else:
            b = Sh.shard_shape(inputs["tokens"].shape, specs["tokens"],
                               ax)[0]
            seq = specs["seq"]
            caches = cache_specs(model, b, seq)
            tokens = meta((b, 1), torch.int32)
            with c:
                model.decode_step(p, caches, tokens, seq - 1)
    moved, gathered = _gather_bytes(params, pspec, ax, ep)
    c.totals.collectives["all-gather"] += moved
    return dict(totals=c.totals, remat=0.0, gathered=gathered)


# --------------------------------- cells -----------------------------------


def lower_cell(arch: str, shape_name: str, mesh, opt_kind=None,
               seq_shard_cache: bool = True, n_micro=None) -> dict:
    """One (arch, shape, mesh) cell: its plan, per-device state bytes and
    per-device counts."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ax = mesh_axes(mesh)
    plan = plan_cell(cfg, shape, mesh, opt_kind=opt_kind, n_micro=n_micro)
    model = Model(cfg)
    params = model.init(0, "meta")
    pspec = Sh.param_specs(params, mesh, **plan["spec_kw"])
    inputs = input_specs(model, shape)
    per_device = dict(param_bytes=tree_bytes(params, pspec, ax))
    if shape.kind == "train":
        ocfg = Opt.OptConfig(kind=plan["optimizer"])
        bspec = train_batch_specs(inputs["batch"], mesh, plan)
        per_device.update(
            opt_state_bytes=opt_state_bytes(ocfg, params, pspec, ax),
            batch_bytes=tree_bytes(inputs["batch"], bspec, ax))
        work = count_train(model, params, pspec, inputs["batch"], bspec,
                           mesh, plan)
    elif shape.kind == "prefill":
        bspec = Sh.batch_specs_tree(inputs["batch"], mesh)
        per_device.update(batch_bytes=tree_bytes(inputs["batch"], bspec,
                                                 ax))
        work = count_serve(model, params, pspec, inputs, {"batch": bspec},
                           mesh, "prefill", plan)
    else:
        cspec = Sh.cache_specs_tree(inputs["caches"], mesh,
                                    seq_axis_sharding=seq_shard_cache)
        tspec = (Sh._dp_if_divisible(shape.global_batch, mesh), None)
        per_device.update(
            cache_bytes=tree_bytes(inputs["caches"], cspec, ax),
            batch_bytes=Sh.shard_numel(inputs["tokens"].shape, tspec, ax)
            * 4)
        work = count_serve(model, params, pspec, inputs,
                           {"tokens": tspec, "seq": shape.seq_len}, mesh,
                           "decode", plan)
    per_device["gathered_param_bytes"] = work["gathered"]
    t = work["totals"]
    keep = {k: v for k, v in plan.items() if k != "spec_kw"}
    keep["dp_axes"] = list(plan["dp_axes"])
    return dict(
        keep, per_device=per_device,
        flops_per_device=float(t.flops),
        bytes_per_device=float(t.bytes),
        transcendentals_per_device=float(t.transcendentals),
        collective_bytes_per_device=dict(
            {k: float(v) for k, v in t.collectives.items()},
            total=float(t.collective_bytes)),
        remat_flops_per_device=float(work["remat"]),
        unknown_trip_loops=int(t.unknown_trip_loops))


def plan_step(model: Model, mesh, ocfg: Opt.OptConfig, tcfg,
              batch_like: dict) -> dict:
    """A mesh trainer's own step on the meta device (``Trainer.lower``):
    its default layout (``param_specs``), its batch over the dp axes,
    its microbatches; per-device state bytes and counts."""
    ax = mesh_axes(mesh)
    ep = model.ep is not None and model.ep.n_shards > 1
    model = Model(model.cfg)        # counted with no process group
    params = model.init(0, "meta")
    pspec = Sh.param_specs(params, mesh)
    batch = {k: meta(v.shape, v.dtype) for k, v in batch_like.items()}
    bspec = Sh.batch_specs_tree(batch, mesh)
    plan = dict(ep=ep, n_micro=tcfg.n_micro, accum_dtype=tcfg.accum_dtype,
                dp_axes=Sh.dp_axes(mesh))
    work = count_train(model, params, pspec, batch, bspec, mesh, plan)
    t = work["totals"]
    return dict(
        param_bytes=tree_bytes(params, pspec, ax),
        opt_state_bytes=opt_state_bytes(ocfg, params, pspec, ax),
        batch_bytes=tree_bytes(batch, bspec, ax),
        gathered_param_bytes=work["gathered"],
        flops_per_device=float(t.flops), bytes_per_device=float(t.bytes),
        transcendentals_per_device=float(t.transcendentals),
        collective_bytes_per_device=dict(t.collectives,
                                         total=t.collective_bytes),
        remat_flops_per_device=float(work["remat"]))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str | None = None, tag: str = "",
             **lower_kw) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    mesh_name = "multipod" if multi_pod else "pod"
    rec = dict(arch=arch, shape=shape_name, mesh=mesh_name, tag=tag)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    try:
        rec.update(lower_cell(arch, shape_name, mesh, **lower_kw))
        rec.update(status="ok", plan_s=time.perf_counter() - t0)
        pd = rec["per_device"]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}{tag}: OK "
              f"flops/dev={rec['flops_per_device']:.3e} "
              f"coll/dev={rec['collective_bytes_per_device']['total']:.3e}B "
              f"params/dev={pd['param_bytes'] / 2**30:.3f}GiB "
              f"layout={rec['layout']} n_micro={rec.get('n_micro', '-')} "
              f"optimizer={rec.get('optimizer', '-')} "
              f"({rec['plan_s']:.1f}s)", flush=True)
    except Exception as e:  # record failures as bugs to fix
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
              f"FAIL {type(e).__name__}: {e}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}_{shape_name}_{mesh_name}{tag}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list_archs(False))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="directory for one JSON record per cell "
                         "(default: print only)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--flat-cache", action="store_true",
                    help="disable seq-axis KV cache sharding")
    ap.add_argument("--n-micro", type=int, default=None)
    args = ap.parse_args(argv)
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    recs = [run_cell(arch, shape, mp, out_dir=args.out, tag=args.tag,
                     seq_shard_cache=not args.flat_cache,
                     n_micro=args.n_micro)
            for arch in archs for shape in shapes for mp in meshes]
    if argv is None:
        raise SystemExit(1 if any(r["status"] == "error" for r in recs)
                         else 0)
    return recs


if __name__ == "__main__":
    main()
