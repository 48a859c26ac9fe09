"""Plain PyTorch version of the Mamba-1 selective scan, the JAX
package's ``mamba_scan_ref``: the recurrence stepped over time in fp32,
one step per loop iteration (JAX's ``lax.scan``), the output cast to
u's dtype.  Differentiable through autograd."""
from __future__ import annotations

import torch


def mamba_scan_ref(u, delta, a, b, c, skip, h0=None):
    """u, delta: (B, L, D); a: (D, N); b, c: (B, L, N); skip: (D,);
    h0: (B, D, N) fp32 or None (zeros).  Returns y (B, L, D) in u's
    dtype:

        h_t = exp(delta_t * a) * h_{t-1} + (delta_t * u_t) * b_t
        y_t = <c_t, h_t> + skip * u_t
    """
    bsz, _, d = u.shape
    n = a.shape[1]
    uf, df, af, bf, cf = (t.float() for t in (u, delta, a, b, c))
    h = (torch.zeros(bsz, d, n, dtype=torch.float32, device=u.device)
         if h0 is None else h0)
    ys = []
    # unbind, not uf[:, t]: an index's backward would fill and add a
    # whole (B, L, D) gradient for every step
    for u_t, dt_t, b_t, c_t in zip(uf.unbind(1), df.unbind(1), bf.unbind(1),
                                   cf.unbind(1)):
        decay = torch.exp(dt_t[..., None] * af[None])        # (B, D, N)
        h = decay * h + (dt_t * u_t)[..., None] * b_t[:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c_t) + skip[None] * u_t)
    if not ys:
        return u.new_empty(bsz, 0, d)
    return torch.stack(ys, dim=1).to(u.dtype)
