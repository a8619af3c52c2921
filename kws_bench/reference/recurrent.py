"""The plain Keras-v1 GRU (Keras 2.1.x ``GRU`` with its defaults:
``implementation=1``, ``reset_after=False``), in functional form.

For an input [B, C, T] (NCW, the trunk's layout) and ``units`` u, with
per-gate input weights W_z, W_r, W_h [u, C], biases b_z, b_r, b_h and
recurrent weights U_z, U_r, U_h [u, u], from h_0 = 0, at each step t (the
last first where ``reverse``)::

    z = hard_sigmoid((x_t * m_z) W_z^T + b_z + (h * n_z) U_z^T)
    r = hard_sigmoid((x_t * m_r) W_r^T + b_r + (h * n_r) U_r^T)
    c = tanh((x_t * m_h) W_h^T + b_h + (r * (h * n_h)) U_h^T)
    h = z * h + (1 - z) * c

and the layer gives the last h. In train mode m_* are the input dropout
masks (Keras 2.1's variational dropout: one [B, C] mask a gate, drawn
once a call and held over every step) and n_* the recurrent ones ([B, u]
a gate), each a keep mask over 1 - rate; in eval mode both are 1.
hard_sigmoid is Keras's, clip(0.2 x + 0.5, 0, 1).

Parameters under the port's keys (torch's [out, in] layout): ``weight``
[3u, C] (W_z, W_r, W_h stacked), ``bias`` [3u], ``recurrent_weight_zr``
[2u, u] (U_z, U_r) and ``recurrent_weight_h`` [u, u]. Every product is
``@`` with ``q`` on both operands.

Departures from the Keras layer: the input products of all steps are
taken before the loop (Keras takes each inside its step; the same sums);
the masks come from the caller, in the program's draw order, not from
Keras's own random draws.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from kws_bench.reference import layers as L


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return (0.2 * x + 0.5).clamp(0.0, 1.0)


def gru_shapes(prefix: str, cin: int, units: int,
               ) -> List[Tuple[str, tuple, str]]:
    """The layer's parameters; the three weights carry the L2 penalty
    (``kernel``), the bias does not."""
    return [(f"{prefix}.weight", (3 * units, cin), "kernel"),
            (f"{prefix}.bias", (3 * units,), "bias"),
            (f"{prefix}.recurrent_weight_zr", (2 * units, units), "kernel"),
            (f"{prefix}.recurrent_weight_h", (units, units), "kernel")]


def dropout_shapes(batch: int, cin: int, units: int, rate: float,
                   ) -> List[Tuple[Tuple[int, ...], float]]:
    """The layer's masks in the order the program draws them: the three
    input masks, then the three recurrent ones."""
    return [((3, batch, 1, cin), rate), ((3, batch, units), rate)]


def gru(p, prefix: str, x: torch.Tensor, reverse: bool,
        keep: Optional[Sequence[torch.Tensor]], rate: float,
        q: L.Quant = L.identity) -> torch.Tensor:
    """The last state [B, u] of the layer over NCW ``x``; ``keep``: the
    input and the recurrent keep masks (train mode), or None (eval)."""
    w, b = p[f"{prefix}.weight"], p[f"{prefix}.bias"]
    u_zr, u_h = p[f"{prefix}.recurrent_weight_zr"], \
        p[f"{prefix}.recurrent_weight_h"]
    u = u_h.shape[0]
    x = x.transpose(1, 2)                                   # [B, T, C]
    keep_in, keep_rec = (None, None) if keep is None else keep
    xs = []
    for i in range(3):
        xi = x if keep_in is None else L.dropout(x, keep_in[i], rate)
        xs.append(q(xi) @ q(w[i * u:(i + 1) * u]).t() + b[i * u:(i + 1) * u])
    xz, xr, xh = xs
    uz, ur = u_zr[:u], u_zr[u:]
    h = x.new_zeros(x.shape[0], u)
    steps = range(x.shape[1])
    for t in (reversed(steps) if reverse else steps):
        hz, hr, hh = (h, h, h) if keep_rec is None else (
            L.dropout(h, keep_rec[i], rate) for i in range(3))
        z = hard_sigmoid(xz[:, t] + q(hz) @ q(uz).t())
        r = hard_sigmoid(xr[:, t] + q(hr) @ q(ur).t())
        c = torch.tanh(xh[:, t] + q(r * hh) @ q(u_h).t())
        h = z * h + (1.0 - z) * c
    return h
