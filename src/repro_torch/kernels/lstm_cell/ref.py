"""Plain PyTorch version of the fused LSTM cell: what the CUDA kernel
computes, op for op with ``repro.core.encoder_lstm.lstm_cell_apply``."""
from __future__ import annotations

import torch


def lstm_cell_ref(x, h, c, wx, wh, b):
    """x (B, In); h, c (B, H); wx (In, 4H); wh (H, 4H); b (4H,); gates
    packed [i, f, g, o].  The math runs in fp32 and the outputs take the
    input dtype, as in the kernel (a no-op for fp32 inputs)."""
    dtype = x.dtype
    x, h, c, wx, wh, b = (t.float() for t in (x, h, c, wx, wh, b))
    z = x @ wx + h @ wh + b
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(dtype), c_new.to(dtype)
