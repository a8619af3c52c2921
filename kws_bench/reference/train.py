"""The reference's first training steps, and the numbers compared.

``steps`` follows the program's first steps from the same weights, the
same inputs and the draws worked out again (``draws.py``): plain
forward and backward in float32 with TF32 off (or under the precision
control's ``q``), the label-smoothed cross-entropy plus the L2 penalty
on every kernel, and Keras's RMSprop (rho 0.9, epsilon 1e-8 outside the
square root, a zero accumulator).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch

from kws_bench.reference import draws as D
from kws_bench.reference import layers as L
from kws_bench.reference.layers import identity

KINDS_TRAINED = ("kernel", "bias", "bn_scale", "bn_shift")


@contextlib.contextmanager
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def loss_fn(logits, labels, smoothing: float, kernels, l2: float):
    c = logits.shape[-1]
    target = torch.nn.functional.one_hot(labels.long(), c).to(logits.dtype)
    target = target * (1.0 - smoothing) + smoothing / c
    ce = -(target * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
    return ce + l2 * sum(w.square().sum() for w in kernels)


def steps(model, cfg: Dict, weights: Dict[str, torch.Tensor],
          batch_fn: Callable[[int, torch.Generator], D.Draws],
          bank_fn: Callable[[int], torch.Tensor], bg_flat: torch.Tensor,
          trainer_seed: int, n: int, q=None) -> Dict[str, object]:
    """``n`` reference steps of a trainer seeded ``trainer_seed``;
    ``batch_fn(i, g)`` gives step i's draws and ``bank_fn(i)`` the int16
    rows they index. Returns the first step's model input, the losses, each
    trained leaf's first gradient norm and its change after ``n`` steps,
    by the order of ``model.param_shapes``."""
    q = q or identity
    shapes = model.param_shapes(cfg["num_classes"])
    names = [n_ for n_, _, k in shapes if k in KINDS_TRAINED]
    kernels = [n_ for n_, _, k in shapes if k == "kernel"]
    dev = bg_flat.device
    p = L.Recorder({k: v.detach().clone().float()
                    for k, v in weights.items()})
    for k in names:
        p[k].requires_grad_(True)
    acc = {k: torch.zeros_like(p[k]) for k in names}
    rho, eps, lr = cfg["rho"], cfg["epsilon"], cfg["learning_rate"]
    g = D.trainer_generator(trainer_seed, dev)
    losses, first, bn_stats = [], None, None
    with no_tf32():
        for i in range(n):
            d = batch_fn(i, g)
            x = D.decode_augment(bank_fn(i), bg_flat, d)
            keep = D.dropout_masks(g, model.dropout_shapes(x.shape[0]), dev)
            logits = model.forward(p, x, True, keep, q)
            loss = loss_fn(logits, d.labels, cfg["label_smoothing"],
                           [p[k] for k in kernels], cfg["l2_reg"])
            grads = torch.autograd.grad(loss, [p[k] for k in names])
            if i == 0:
                inputs = x.detach().clone()
                first = [gr.detach().clone() for gr in grads]
                bn_stats = dict(p.stats)
            with torch.no_grad():
                for k, gr in zip(names, grads):
                    acc[k].mul_(rho).addcmul_(gr, gr, value=1.0 - rho)
                    p[k].addcdiv_(gr, acc[k].sqrt().add_(eps), value=-lr)
            losses.append(loss.detach())
    change = torch.stack([(p[k].detach() - weights[k].float()).norm()
                          for k in names])
    return {"names": names, "inputs": inputs,
            "losses": torch.stack(losses),
            "grads": first, "change_norms": change, "bn_stats": bn_stats}


def leaf_gap(program: torch.Tensor, reference: torch.Tensor,
             mask: torch.Tensor = None) -> float:
    """The worst leaf's gap between two vectors of per-leaf norms,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger; leaves where ``mask`` is False are left out."""
    ref = reference.double()
    floor = ref.median()
    gap = (program.double() - ref).abs() / torch.maximum(ref, floor)
    if mask is not None:
        gap = gap[mask]
    return float(gap.max())


def moved(grads) -> torch.Tensor:
    """Leaves whose first gradient in the reference is above a thousandth
    of the median leaf's: the others move under RMSprop by round-off
    alone (a conv's output that BatchNorm normalises away, say)."""
    norms = torch.stack([g.norm() for g in grads])
    return norms > 1e-3 * norms.median()


def elem_gap(prog, ref) -> float:
    """The first gradient's gap over every element of every trained leaf:
    the norm of the difference of the magnitudes (the program's are
    RMSprop's, which keeps no sign) over the norm of the reference's."""
    num = sum(float((p.double().abs() - r.double().abs()).square().sum())
              for p, r in zip(prog, ref))
    den = sum(float(r.double().square().sum()) for r in ref)
    return (num / den) ** 0.5


def grad_norm_gap(prog, ref) -> float:
    """The gap between the first gradient's norm over every trained leaf
    and the reference's, over the reference's."""
    n_p = sum(float(g.double().square().sum()) for g in prog) ** 0.5
    n_r = sum(float(g.double().square().sum()) for g in ref) ** 0.5
    return abs(n_p - n_r) / n_r


def bn_gap(prog, ref) -> float:
    """The first step's BatchNorm batch statistics against the
    reference's, over every channel of every layer: the root mean square
    of each channel's mean gap in its standard deviations and of its
    variance gap over its variance."""
    num, n = 0.0, 0
    for layer, (m_r, v_r) in ref.items():
        m_p, v_p = prog[layer]
        m_r, v_r, m_p, v_p = (t.double() for t in (m_r, v_r, m_p, v_p))
        num += float(((m_p - m_r).square() / v_r).sum()
                     + ((v_p - v_r) / v_r).square().sum())
        n += 2 * m_r.numel()
    return (num / n) ** 0.5


def input_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The first step's model input (decode+augment's output) against the
    reference's, element by element: the largest gap over the largest
    magnitude. A wrong roll, crop or volume moves it by its own size,
    where the statistics and norms that follow barely move."""
    ref = ref.double()
    return float((prog.double() - ref).abs().max() / ref.abs().max())


def compare(prog: Dict[str, object], ref: Dict[str, object],
            ) -> Dict[str, float]:
    """The numbers compared in a training cell: ``input_gap`` (the first
    step's decode+augment, ``input_gap``), ``bn_gap`` (the first
    step's forward, ``bn_gap``), ``grad_gap`` (the first gradient's
    norm, ``grad_norm_gap``) and ``change_gap`` (each leaf's change after
    the steps, by the worst leaf that moves, ``leaf_gap``); beside them,
    not compared (PERF.md: their readings do not separate the program
    from the control or the faults), the first step's relative loss gap,
    the worst leaf's first gradient norm gap and the gap over every
    element of the first gradient's magnitude."""
    lr_, lp = ref["losses"].double(), prog["losses"].double()
    norms_p = torch.stack([g.norm() for g in prog["grads"]])
    norms_r = torch.stack([g.norm() for g in ref["grads"]])
    return {
        "input_gap": input_gap(prog["inputs"], ref["inputs"]),
        "bn_gap": bn_gap(prog["bn_stats"], ref["bn_stats"]),
        "grad_gap": grad_norm_gap(prog["grads"], ref["grads"]),
        "change_gap": leaf_gap(prog["change_norms"], ref["change_norms"],
                               moved(ref["grads"])),
        "loss1_gap": float((lp[0] - lr_[0]).abs() / lr_[0].abs()),
        "leaf_grad_gap": leaf_gap(norms_p, norms_r),
        "elem_grad_gap": elem_gap(prog["grads"], ref["grads"]),
    }
