"""Gradient compression for the cross-pod reduction (the scarce link):
the JAX package's ``distributed/compression.py``.

Error-feedback int8 quantization: g_q = round(g/s) with one per-tensor
scale agreed over the group, the quantization residual carried into the
next step (EF-SGD [Karimireddy et al.]), so the compressed update is
unbiased in the limit.  Also a top-k sparsifier with the same
error-feedback contract.

Where JAX reduces over a named mesh axis inside ``shard_map``, these take
a ``torch.distributed`` process group (a mesh dim's: ``mesh.get_group(
"data")``; None is the default group): ``pmax`` is an ``all_reduce(MAX)``
of the scalar, ``psum`` an ``all_reduce(SUM)``, and ``n`` the group's
size.  The int8 payload is summed as int32, as JAX's ``psum`` sums it (the
sum is exact in any order).  Rounding is half to even in both packages
(``jnp.round``, ``torch.round``).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.convert import leaves, tree_map, unflatten


def int8_compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: returns (q int8, scale f32)."""
    gf = g.float()
    scale = torch.clamp_min(gf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _ef_int8_one(g, r, group):
    gf = g.float() + r
    # agree on ONE scale across the group (scalar max), so the int32 sum
    # dequantizes exactly; per-process scales would misweight them
    local_max = gf.abs().max().reshape(1)
    dist.all_reduce(local_max, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(local_max[0] / 127.0, 1e-12)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_r = gf - q.float() * scale
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    n = dist.get_world_size(group)
    return total.float() * scale / n, new_r


def ef_int8_reduce(grads: Any, residual: Any, group=None
                   ) -> tuple[Any, Any]:
    """Error-feedback int8 all-reduce over ``group``.  Returns (reduced
    fp32 grads, new residual), trees as ``grads``."""
    out = [_ef_int8_one(g, r, group)
           for g, r in zip(leaves(grads), leaves(residual))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))


def _kth_largest(mag: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest of ``mag`` (1-d, >= 0), exactly: a lower estimate
    t0 from a strided sample of ~1 M values (its 2 k n_sample / n-th
    largest), then either t0 itself (fewer than k values above it, at
    least k at or above) or the k-th largest of the few values above
    it; ``torch.topk`` of the whole where the sample misjudged.  A whole
    ``topk`` of a 262 M-value leaf takes seconds on the CPU."""
    n = mag.numel()
    sample = mag[::max(1, n >> 20)]
    ks = min(sample.numel(), -(-2 * k * sample.numel() // n))
    t0 = torch.topk(sample, ks, sorted=False).values.min()
    above = mag > t0
    if int(above.sum()) >= k:
        return torch.topk(mag[above], k, sorted=False).values.min()
    if int((mag >= t0).sum()) >= k:
        return t0
    return torch.topk(mag, k, sorted=False).values.min()


def topk_compress(g: torch.Tensor, frac: float = 0.01
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep the top-``frac`` magnitudes; returns (values, flat indices),
    largest magnitude first and the lower index first among equal ones,
    as ``jax.lax.top_k`` orders them (``torch.topk`` leaves ties in no
    set order, and a gradient leaf has many: an embedding's untouched
    rows are all zero).  The k-th magnitude is the threshold; every
    index above it is kept, then the lowest of those equal to it."""
    flat = g.reshape(-1).float()
    k = max(1, int(flat.shape[0] * frac))
    mag = flat.abs()
    thr = _kth_largest(mag, k)
    above = torch.nonzero(mag > thr).flatten()
    above = above[torch.sort(mag[above], descending=True,
                             stable=True).indices]
    idx = torch.cat([above, _first_equal(mag, thr, k - above.numel())])
    return flat[idx], idx


def _first_equal(mag, thr, need: int, chunk: int = 1 << 24):
    """The ``need`` lowest indices where ``mag == thr``, found a chunk at a
    time (an embedding's zero rows would make one ``nonzero`` of the
    whole leaf hundreds of millions long)."""
    out = [mag.new_zeros(0, dtype=torch.long)]
    for start in range(0, mag.numel(), chunk):
        if need <= 0:
            break
        hit = torch.nonzero(mag[start:start + chunk] == thr).flatten()
        hit = hit[:need] + start
        out.append(hit)
        need -= hit.numel()
    return torch.cat(out)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, shape: tuple
                    ) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= int(s)
    out = torch.zeros(n, dtype=torch.float32, device=vals.device)
    out[idx] = vals
    return out.reshape(shape)


def _ef_topk_one(g, r, group, frac, kept):
    gf = g.float() + r
    vals, idx = topk_compress(gf, frac)
    if kept is not None:
        kept.append(idx)
    dense = topk_decompress(vals, idx, gf.shape)
    new_r = gf - dense
    dist.all_reduce(dense, group=group)
    return dense / dist.get_world_size(group), new_r


def ef_topk_reduce(grads: Any, residual: Any, group=None,
                   frac: float = 0.01, kept: list | None = None
                   ) -> tuple[Any, Any]:
    """Error-feedback top-k all-reduce (a dense sum of the sparse mask's
    dense form — on a real fabric this becomes an all-gather of (vals,
    idx); the error-feedback semantics are identical).  The residual is
    exact; the reduced value is a fp32 sum over the group, whose order
    (and so its last bits past two processes) the collective chooses.
    ``kept``, a list, gets each leaf's kept flat indices in turn."""
    out = [_ef_topk_one(g, r, group, frac, kept)
           for g, r in zip(leaves(grads), leaves(residual))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))


def zero_residual(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
