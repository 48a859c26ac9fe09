"""Ranks of a ``torch.distributed`` gloo group for the port's multi-process
tests, and the functions they run.

``spawn(target, world, tmp_path, args, timeout)`` starts ``world``
subprocesses of this file, each joining one gloo group that rendezvouses
through a ``FileStore`` under ``tmp_path`` (no TCP port, so parallel test
workers cannot collide), runs ``target(rank, world, **args)`` and pickles
its return value.  A rank that has not finished by ``timeout`` seconds
fails the test and every rank is killed, so a hung collective costs one
test, not the suite.  The ranks import torch, numpy and the port only
(no JAX): the JAX references run in the test's own process.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def spawn(target: str, world: int, tmp_path, args: dict | None = None,
          timeout: float = 120.0, backend: str = "gloo") -> list:
    """``target`` ("function" of this module) on ``world`` ranks of a
    ``backend`` group (gloo; "nccl" for the on-card tests, one rank a
    card); returns each rank's result in rank order."""
    tmp = Path(tmp_path) / f"ranks-{target}-{time.monotonic_ns()}"
    tmp.mkdir(parents=True)
    with open(tmp / "args.pkl", "wb") as f:
        pickle.dump(args or {}, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(tmp / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, target, str(r), str(world),
             str(tmp), backend], env=env, stdout=log, stderr=subprocess.STDOUT,
            cwd=ROOT), log))
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
        raise AssertionError(f"{target} on {world} ranks passed its "
                             f"{timeout} s:\n" + _logs(tmp, world))
    finally:
        for p, log in procs:
            p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode]
    assert not bad, f"{target}: ranks {bad} failed:\n" + _logs(tmp, world)
    out = []
    for r in range(world):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _logs(tmp: Path, world: int) -> str:
    return "\n".join(f"--- rank {r}\n"
                     + (tmp / f"rank{r}.log").read_text()[-3000:]
                     for r in range(world))


def _main() -> None:
    import torch
    import torch.distributed as dist
    target, rank, world, tmp, backend = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), Path(sys.argv[4]), sys.argv[5]
    torch.set_num_threads(1)
    with open(tmp / "args.pkl", "rb") as f:
        args = pickle.load(f)
    kw = dict(device_id=torch.device("cuda", rank)) \
        if backend == "nccl" else {}
    dist.init_process_group(backend, store=dist.FileStore(
        str(tmp / "store"), world), rank=rank, world_size=world, **kw)
    try:
        res = globals()[target](rank, world, **args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(tmp / f"out{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


# ------------------------------ rank functions ------------------------------


def _t(a):
    import torch
    return torch.from_numpy(np.array(a, copy=True))


def _n(t):
    return t.detach().float().cpu().numpy()


def compression(rank, world, grads, frac):
    """EF-int8 and EF-top-k over three rounds: ``grads[i][rank]`` is this
    rank's gradient tree of round i (dicts of numpy arrays)."""
    from repro_torch.distributed import compression as C
    out = {}
    for scheme in ("int8", "topk"):
        res = C.zero_residual({k: _t(v) for k, v in grads[0][rank].items()})
        rounds = []
        for g in grads:
            tree = {k: _t(v) for k, v in g[rank].items()}
            if scheme == "int8":
                red, res = C.ef_int8_reduce(tree, res)
            else:
                red, res = C.ef_topk_reduce(tree, res, frac=frac)
            rounds.append(({k: _n(v) for k, v in red.items()},
                           {k: _n(v) for k, v in res.items()}))
        out[scheme] = rounds
    return out


def expert_parallel(rank, world, cases):
    """``moe_apply`` with the experts split over the group: each case is
    (config, the layer's params, x, inference), numpy; this rank takes
    its expert slice (``p_local``)."""
    import torch.distributed as dist

    from repro_torch.models import moe as Moe
    out = []
    for cfg, p, x, inference in cases:
        e_loc = cfg.n_experts // world
        local = {}
        for k, v in p.items():
            if k in ("wg", "wu", "wd"):
                v = v[rank * e_loc:(rank + 1) * e_loc]
            local[k] = ({kk: _t(vv) for kk, vv in v.items()}
                        if isinstance(v, dict) else _t(v))
        ep = Moe.EPContext(group=dist.group.WORLD, n_shards=world,
                           rank=rank)
        y = Moe.moe_apply(local, cfg, _t(x), ep, inference=inference)
        out.append(_n(y))
    return out


def mesh_train(rank, world, shape, cases, steps=3, batch=8, seq=16):
    """The mesh trainer on a ``shape`` (data, model) mesh: per case
    (config, JAX params as numpy, n_micro, OptConfig kwargs, the dp axes
    or None), ``steps`` steps of ``SyntheticLM`` batches from the
    converted params."""
    from repro_torch import convert
    from repro_torch.distributed import sharding as Sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import Model
    from repro_torch.train import optimizer as Opt
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.trainer import (TrainConfig, Trainer, ep_setup,
                                           make_train_step)
    mesh = make_host_mesh(*shape, device_type="cpu")
    out = []
    for cfg, params, n_micro, opt_kw, dp_axes in cases:
        model = Model(cfg, ep=ep_setup(cfg, mesh))
        tr = Trainer(model, mesh, opt_cfg=Opt.OptConfig(**opt_kw),
                     tcfg=TrainConfig(n_micro=n_micro), device="cpu")
        full = convert.from_jax(params, "cpu")
        p, s = tr.shard_state(full)
        spec = Sh.param_specs(full, mesh)
        want = sum(Sh.shard_numel(t.shape, sp, mesh) for t, sp in
                   zip(convert.leaves(full), Sh.spec_leaves(spec)))
        local = sum(dt.to_local().numel() for dt in convert.leaves(p))
        moments = sum(dt.to_local().numel()
                      for dt in convert.leaves(s.m) + convert.leaves(s.v))
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                      global_batch=batch), device="cpu")
        step = make_train_step(model, tr.opt_cfg, tr.tcfg, mesh=mesh,
                               dp_axes=dp_axes)
        losses = []
        for i in range(steps):
            p, s, m = step(p, s, data.batch(i))
            losses.append(float(m["loss"]))
        whole = Sh.full_tree(p)
        plan = tr.lower(data.batch(0))
        out.append(dict(
            losses=losses, local_numel=local, shard_numel=want,
            moment_numel=moments, step=int(s.step),
            params=convert.to_numpy(whole) if rank == 0 else None,
            placements={".".join(path): str(dt.placements) for path, dt in
                        zip(Sh.leaf_paths(p), convert.leaves(p))},
            plan={k: v for k, v in plan.items()
                  if k != "collective_bytes_per_device"}))
    return out


def one_rank_mesh(rank, world, cases, steps=3, batch=8, seq=16,
                  device="cpu"):
    """A (1, 1) mesh step against the unsharded step from the same params:
    the losses and params of each, per case."""
    from repro_torch import convert
    from repro_torch.distributed import sharding as Sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import Model
    from repro_torch.train import optimizer as Opt
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.trainer import TrainConfig, Trainer, ep_setup
    mesh = make_host_mesh(1, 1, device_type=device)
    out = []
    for cfg, params, n_micro, opt_kw in cases:
        runs = []
        for m in (mesh, None):
            model = Model(cfg, ep=None if m is None else ep_setup(cfg, m))
            tr = Trainer(model, m, opt_cfg=Opt.OptConfig(**opt_kw),
                         tcfg=TrainConfig(n_micro=n_micro), device=device)
            full = convert.from_jax(params, device)
            p, s = (tr.shard_state(full) if m is not None else
                    (full, Opt.init(tr.opt_cfg, full)))
            data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                          global_batch=batch), device=device)
            step = tr.compile_step()
            losses = []
            for i in range(steps):
                p, s, met = step(p, s, data.batch(i))
                losses.append(float(met["loss"]))
            runs.append((losses, convert.to_numpy(Sh.full_tree(p))))
        out.append(runs)
    return out


def elastic(rank, world, root):
    """On a (2, 2) mesh of 4 ranks: remesh after losing rank 3 (model
    parallelism 2: a (1, 2) grid of ranks 0, 1; ranks 2 and 3 get no
    coordinate and must not hang), reshard a sharded tree onto it; save
    it from the (2, 2) mesh and restore it onto a (2, 1) mesh of ranks 0
    and 2."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import elastic as E
    from repro_torch.distributed import sharding as Sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import checkpoint as ckpt
    mesh = make_host_mesh(2, 2, device_type="cpu")
    gen = torch.Generator().manual_seed(0)
    tree = {"embed": torch.randn(64, 16, generator=gen),
            "g0": {"attn": {"wq": torch.randn(3, 16, 8, generator=gen)},
                   "ln1": {"w": torch.randn(3, 16, generator=gen)}},
            "head": torch.randn(16, 64, generator=gen).to(torch.bfloat16)}
    specs = Sh.param_specs(tree, mesh)
    sharded = Sh.shard_tree(tree, specs, mesh)
    st = E.remesh(E.ElasticState(mesh=mesh), [3], model_parallel=2)
    moved = E.reshard(sharded, mesh, st.mesh,
                      lambda t, m: Sh.param_specs(t, m))
    out = dict(generation=st.generation, failed=st.failed_devices,
               grid=st.mesh.mesh.tolist(),
               coordinate=st.mesh.get_coordinate())
    if moved is not None:
        out["reshard_equal"] = all(
            torch.equal(a.full_tensor(), b) for a, b in zip(
                _leaves(moved), _leaves(tree)))
        out["reshard_local"] = [tuple(a.to_local().shape)
                                for a in _leaves(moved)]
    ckpt.save(root, 3, sharded, write=rank == 0)
    torch.distributed.barrier()
    small = DeviceMesh("cpu", torch.tensor([[0], [2]]),
                       mesh_dim_names=("data", "model"))
    if small.get_coordinate() is not None:
        back = ckpt.restore(root, 3, tree, mesh=small,
                            specs=Sh.param_specs(tree, small))
        out["restore_equal"] = all(
            torch.equal(a.full_tensor(), b) and a.dtype == b.dtype
            for a, b in zip(_leaves(back), _leaves(tree)))
        out["restore_local"] = [tuple(a.to_local().shape)
                                for a in _leaves(back)]
    else:
        # the ranks outside the small mesh take part in its gathers only
        # through nothing: they hold no block of it
        out["restore_equal"] = None
    return out


def _leaves(tree):
    from repro_torch.convert import leaves
    return leaves(tree)


def compression_on_card(rank, world, shapes, frac, rounds=3):
    """EF-int8 and EF-top-k of seeded gradient leaves on the card (the
    nccl group) and on the CPU (a gloo group of the same ranks), rounds
    in lockstep: per scheme and round, whether each leaf's reduced value
    and residual are bit-equal and (top-k) its kept index set equal."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import compression as C
    cpu = dist.new_group(backend="gloo")
    gen = torch.Generator().manual_seed(rank)
    grads = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    # an embedding-like leaf: most rows untouched (zero), ties at zero
    grads["sparse"] = torch.zeros(64, 32)
    grads["sparse"][::7] = torch.randn(10, 32, generator=gen)
    out = {}
    for scheme in ("int8", "topk"):
        res_d = C.zero_residual({k: v.cuda() for k, v in grads.items()})
        res_h = C.zero_residual(grads)
        checks = []
        for _ in range(rounds):
            if scheme == "int8":
                red_d, res_d = C.ef_int8_reduce(
                    {k: v.cuda() for k, v in grads.items()}, res_d)
                red_h, res_h = C.ef_int8_reduce(grads, res_h, cpu)
            else:
                red_d, res_d = C.ef_topk_reduce(
                    {k: v.cuda() for k, v in grads.items()}, res_d,
                    frac=frac)
                red_h, res_h = C.ef_topk_reduce(grads, res_h, cpu, frac)
            for k in grads:
                ok = (torch.equal(red_d[k].cpu(), red_h[k])
                      and torch.equal(res_d[k].cpu(), res_h[k]))
                if scheme == "topk":
                    gf = grads[k] + 0   # the kept set of this leaf
                    _, i_d = C.topk_compress(gf.cuda(), frac)
                    _, i_h = C.topk_compress(gf, frac)
                    ok = ok and torch.equal(i_d.cpu(), i_h)
                checks.append((k, ok))
        out[scheme] = checks
    return out


def gather_loop(rank, world, trips):
    """Collective bytes of ``trips`` all-gathers of a (64, 32) fp32 block
    counted by the port's accounting."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.accounting import Counter
    x = torch.ones(64, 32)
    with Counter() as c:
        for _ in range(trips):
            outs = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(outs, x)
    return dict(c.totals.collectives)


if __name__ == "__main__":
    _main()
