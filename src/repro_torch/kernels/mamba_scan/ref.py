"""Plain PyTorch versions of the Mamba-1 selective scan and its gradient.

``mamba_scan_ref`` is the JAX package's ``mamba_scan_ref``: the
recurrence stepped over time in fp32, one step per loop iteration (JAX's
``lax.scan``), the output cast to u's dtype; differentiable through
autograd.  ``scan_states_ref`` and ``mamba_scan_bwd_ref`` are the plain
versions of what the kernels do for the gradient: the forward keeps the
state entering every chunk of ``chunk`` steps, and the backward, chunk by
chunk from the last, steps the chunk forward again from its state and
then sweeps it in reverse."""
from __future__ import annotations

import torch

CHUNK = 32          # steps between kept states (the kernels' kChunk)


def mamba_scan_ref(u, delta, a, b, c, skip, h0=None):
    """u, delta: (B, L, D); a: (D, N); b, c: (B, L, N); skip: (D,);
    h0: (B, D, N) fp32 or None (zeros).  Returns y (B, L, D) in u's
    dtype:

        h_t = exp(delta_t * a) * h_{t-1} + (delta_t * u_t) * b_t
        y_t = <c_t, h_t> + skip * u_t
    """
    return mamba_scan_with_state_ref(u, delta, a, b, c, skip, h0)[0]


def mamba_scan_with_state_ref(u, delta, a, b, c, skip, h0=None):
    """:func:`mamba_scan_ref`'s y and the state after the last step,
    (B, D, N) fp32: the JAX package's ``_scan_with_state`` (the SSM
    prefill's scan), op for op."""
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
        return u.new_empty(bsz, 0, d), h
    return torch.stack(ys, dim=1).to(u.dtype), h


def scan_states_ref(u, delta, a, b, chunk: int = CHUNK):
    """The state entering each chunk of ``chunk`` steps: (B, ceil(L /
    chunk), D, N) fp32, zeros first; the recurrence of
    :func:`mamba_scan_ref`."""
    bsz, ell, d = u.shape
    uf, df, af, bf = (t.float() for t in (u, delta, a, b))
    h = torch.zeros(bsz, d, a.shape[1], dtype=torch.float32, device=u.device)
    out = []
    for t in range(ell):
        if t % chunk == 0:
            out.append(h)
        decay = torch.exp(df[:, t, :, None] * af[None])
        h = decay * h + (df[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
    if not out:
        return h.new_empty(bsz, 0, d, a.shape[1])
    return torch.stack(out, dim=1)


def mamba_scan_bwd_ref(u, delta, a, b, c, skip, g, states=None,
                       chunk: int = CHUNK):
    """The six gradients of :func:`mamba_scan_ref` for the output
    gradient g (B, L, D), each in its input's dtype.  ``states`` is
    :func:`scan_states_ref` of the same inputs and ``chunk`` (computed
    when None).  With lam_t = dLoss/dh_t, swept in reverse,

        lam_t = g_t c_t + exp(delta_{t+1} a) lam_{t+1}
        dc_t = sum_d g_t h_t                db_t = sum_d lam_t delta_t u_t
        du_t = delta_t sum_n lam_t b_t + skip g_t
        ddelta_t = sum_n lam_t (a exp(delta_t a) h_{t-1} + u_t b_t)
        da = sum_{b,t} lam_t exp(delta_t a) h_{t-1} delta_t
        dskip = sum_{b,t} g_t u_t
    """
    bsz, ell, d = u.shape
    uf, df, af, bf, cf, gf = (t.float() for t in (u, delta, a, b, c, g))
    if states is None:
        states = scan_states_ref(u, delta, a, b, chunk)
    du, ddelta = torch.empty_like(uf), torch.empty_like(uf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros(bsz, *af.shape, dtype=torch.float32, device=u.device)
    lam = torch.zeros_like(da)
    a_next = torch.ones_like(da)
    for t0 in reversed(range(0, ell, chunk)):
        h = states[:, t0 // chunk]
        h_prev, decays = [], []
        for t in range(t0, min(t0 + chunk, ell)):
            decay = torch.exp(df[:, t, :, None] * af[None])
            h_prev.append(h)
            decays.append(decay)
            h = decay * h + (df[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        for i in reversed(range(len(decays))):
            t = t0 + i
            g_t, dt_t, u_t = gf[:, t], df[:, t], uf[:, t]
            lam = g_t[..., None] * cf[:, t, None, :] + a_next * lam
            q = lam * decays[i] * h_prev[i]
            da += q * dt_t[..., None]
            r1 = (lam * bf[:, t, None, :]).sum(-1)
            du[:, t] = dt_t * r1 + skip * g_t
            ddelta[:, t] = (q * af[None]).sum(-1) + u_t * r1
            db[:, t] = torch.einsum("bdn,bd->bn", lam, dt_t * u_t)
            dc[:, t] = torch.einsum("bdn,bd->bn", h, g_t)
            a_next, h = decays[i], h_prev[i]
    dskip = (gf * uf).sum((0, 1))
    return (du.to(u.dtype), ddelta.to(delta.dtype), da.sum(0).to(a.dtype),
            db.to(b.dtype), dc.to(c.dtype), dskip.to(skip.dtype))
