"""Plain fine-tuning step of the reference: the scale-invariant log-depth
loss on MoGe's z channel and AdamW with optax's defaults, written out.

The loss is L = m2 - m1^2 / 2 with m1, m2 the masked means of d and d^2,
d = log(pred) - log(target) over the valid pixels (a copy of the port's
`parallel/train.py::depth_sums` and `loss_from_sums`). It is not a mean of
per-row terms, so the gradient of a batch taken in micro-batches uses the
global sums as constants: a forward pass without gradients gives them,
then each micro-batch back-propagates dL/dS . S_micro.

AdamW: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
p -= lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p), with
b1 0.9, b2 0.999, eps 1e-8, wd 1e-4; a parameter the loss does not reach
gets a zero gradient and is only decayed.
"""

from __future__ import annotations

import torch

from .precision import full_f32

B1, B2, EPS, WD = 0.9, 0.999, 1e-8, 1e-4


def depth_sums(pred, target, valid) -> torch.Tensor:
    d = (torch.log(torch.clamp(pred.float(), min=1e-6))
         - torch.log(torch.clamp(target.float(), min=1e-6)))
    w = valid.float()
    return torch.stack([(d * w).sum(), (d * d * w).sum(), w.sum()])


def loss_from_sums(s: torch.Tensor) -> torch.Tensor:
    n = torch.clamp(s[2], min=1.0)
    m1, m2 = s[0] / n, s[1] / n
    return m2 - 0.5 * m1 * m1


def loss_and_grads(model, images, target, valid, micro: int) -> tuple[float, list]:
    """The loss of the whole batch and every parameter's gradient (zeros
    where the loss does not reach), in micro-batches of `micro` rows."""
    params = list(model.parameters())
    for p in params:
        p.grad = None
    parts = [slice(i, min(i + micro, images.shape[0])) for i in range(0, images.shape[0], micro)]
    with full_f32():
        with torch.no_grad():
            total = sum(depth_sums(model(images[sl])["points"][..., 2], target[sl], valid[sl])
                        for sl in parts)
        n = torch.clamp(total[2], min=1.0)
        d0, d1 = -(total[0] / n) / n, 1.0 / n
        for sl in parts:
            with torch.enable_grad():
                s = depth_sums(model(images[sl])["points"][..., 2], target[sl], valid[sl])
                (d0 * s[0] + d1 * s[1]).backward()
    grads = [p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
             for p in params]
    for p in params:
        p.grad = None
    return float(loss_from_sums(total)), grads


class AdamW:
    def __init__(self, params, lr: float):
        self.params = list(params)
        self.lr = lr
        self.t = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads) -> None:
        self.t += 1
        c1, c2 = 1 - B1 ** self.t, 1 - B2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(B1).add_(g, alpha=1 - B1)
            v.mul_(B2).addcmul_(g, g, value=1 - B2)
            upd = (m / c1) / ((v / c2).sqrt() + EPS) + WD * p
            p.sub_(self.lr * upd)


def run_steps(model, batches, lr: float, micro: int) -> dict:
    """AdamW steps over `batches` [(images, target, valid)]: each step's
    loss, the first gradient, and each parameter's change over the steps
    (float32, on the parameters' device)."""
    start = [p.detach().clone() for p in model.parameters()]
    opt = AdamW(model.parameters(), lr)
    losses, first = [], None
    for images, target, valid in batches:
        loss, grads = loss_and_grads(model, images, target, valid, micro)
        losses.append(loss)
        if first is None:
            first = grads
        opt.step(grads)
        del grads
    change = [p.detach() - s for p, s in zip(model.parameters(), start)]
    return {"losses": losses, "grad": first, "change": change}
