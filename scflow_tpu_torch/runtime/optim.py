"""Optimizer and learning-rate schedule of the shipped recipe
(configs/refine_models/scflow.py:93-106): AdamW lr 4e-4, betas (0.9, 0.999),
eps 1e-8, weight decay 1e-4; OneCycle with a linear anneal; gradient clip at
global norm 10.  Port of scflow_tpu/runtime/optim.py, which builds them from
optax: the schedule here is its optax schedule as a function of the step
(torch's OneCycleLR puts the phase boundary one step elsewhere), the clip is
optax's clip_by_global_norm (no 1e-6 in the denominator, unlike
torch.nn.utils.clip_grad_norm_), and the update is torch.optim.AdamW, whose
decoupled decay p (1 - lr wd) - lr m^ / (sqrt(v^) + eps) is optax.adamw's
p - lr (m^ / (sqrt(v^) + eps) + wd p) up to rounding."""

import math
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    def f(step: int) -> float:
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    def f(step: int) -> float:
        decay = 0.5 * (1.0 + math.cos(math.pi * min(max(step, 0), steps) / steps))
        return init * ((1.0 - alpha) * decay + alpha)
    return f


def onecycle_lr(max_lr: float, total_steps: int, pct_start: float = 0.05,
                div_factor: float = 25.0, final_div_factor: float = 1e4,
                anneal_strategy: str = "linear") -> Callable[[int], float]:
    """step -> learning rate: from max_lr / div_factor up to max_lr over
    max(int(pct_start * total) - 1, 1) steps, then down to
    max_lr / div_factor / final_div_factor over the rest, linearly or along
    a cosine ('cos')."""
    initial = max_lr / div_factor
    min_lr = initial / final_div_factor
    up_steps = max(int(pct_start * total_steps) - 1, 1)
    down_steps = max(total_steps - up_steps - 1, 1)
    if anneal_strategy == "linear":
        up, down = _linear(initial, max_lr, up_steps), _linear(max_lr, min_lr, down_steps)
    elif anneal_strategy == "cos":
        up = _cosine(initial, up_steps, max_lr / initial)
        down = _cosine(max_lr, down_steps, min_lr / max_lr)
    else:
        raise ValueError(f"unknown anneal_strategy {anneal_strategy!r}; 'linear' or 'cos'")
    return lambda step: up(step) if step < up_steps else down(step - up_steps)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over tensors of their summed squares (optax's)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


class AdamWClip:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, ...)) on
    a list of parameters.  `step(count)` reads their .grad (a missing one is
    a zero gradient, as JAX's grads are: decay still applies), clips them in
    place, sets the learning rate to schedule(count) and updates; it
    returns the global norm before the clip."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Callable[[int], float],
                 betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip: Optional[float] = None):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.adamw = torch.optim.AdamW(self.params, lr=schedule(0), betas=tuple(betas), eps=eps,
                                       weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self, count: int) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if self.grad_clip:
            keep = norm < self.grad_clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.grad_clip))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(count)
        self.adamw.step()
        return norm


def build_optimizer(params: Iterable[torch.nn.Parameter], optimizer_cfg: Dict[str, Any],
                    lr_cfg: Optional[Dict[str, Any]] = None, grad_clip: Optional[float] = None,
                    frozen_prefixes: Optional[Any] = None):
    """(AdamWClip, schedule) from reference-style config dicts, as
    scflow_tpu.runtime.optim.build_optimizer reads them: optimizer_cfg
    {'type': 'AdamW', 'lr', 'betas', 'eps', 'weight_decay'}; lr_cfg
    {'policy': 'OneCycle', 'max_lr', 'total_steps', 'pct_start',
    'anneal_strategy', ...} or None for a constant lr.  Only AdamW is
    ported: 'Adam', 'SGD' and frozen_prefixes raise NotImplementedError."""
    if frozen_prefixes:
        raise NotImplementedError("frozen_prefixes is not ported")
    opt_type = optimizer_cfg.get("type", "AdamW")
    if opt_type != "AdamW":
        raise NotImplementedError(f"optimizer {opt_type!r} is not ported; AdamW is")
    if lr_cfg and lr_cfg.get("policy") == "OneCycle":
        schedule = onecycle_lr(lr_cfg["max_lr"], lr_cfg["total_steps"],
                               lr_cfg.get("pct_start", 0.3), lr_cfg.get("div_factor", 25.0),
                               lr_cfg.get("final_div_factor", 1e4),
                               lr_cfg.get("anneal_strategy", "cos"))
    elif lr_cfg:
        raise NotImplementedError(f"lr policy {lr_cfg.get('policy')!r} is not ported")
    else:
        lr = optimizer_cfg.get("lr", 1e-4)
        schedule = lambda step: lr  # noqa: E731
    tx = AdamWClip(params, schedule, optimizer_cfg.get("betas", (0.9, 0.999)),
                   optimizer_cfg.get("eps", 1e-8), optimizer_cfg.get("weight_decay", 0.0),
                   grad_clip)
    return tx, schedule
