"""Optimizer and learning-rate schedule of the shipped recipe
(configs/refine_models/scflow.py:93-106): AdamW lr 4e-4, betas (0.9, 0.999),
eps 1e-8, weight decay 1e-4; OneCycle with a linear anneal; gradient clip at
global norm 10.  Port of scflow_tpu/runtime/optim.py, which builds them from
optax: the schedule here is its optax schedule as a function of the step
(torch's OneCycleLR puts the phase boundary one step elsewhere), the clip is
optax's clip_by_global_norm (no 1e-6 in the denominator, unlike
torch.nn.utils.clip_grad_norm_), and the update is torch.optim.AdamW, whose
decoupled decay p (1 - lr wd) - lr m^ / (sqrt(v^) + eps) is optax.adamw's
p - lr (m^ / (sqrt(v^) + eps) + wd p) up to rounding.  'Adam' and 'SGD'
(optax.adam, optax.sgd with JAX's momentum 0.9) and frozen parameter paths
(optax.masked) take torch.optim.Adam and SGD and leave frozen parameters
out of the update."""

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


class ClippedOptimizer:
    """optax.chain(clip_by_global_norm(grad_clip), tx) on a list of
    parameters, tx a torch optimizer (AdamW, Adam or SGD) over the trainable
    ones; the frozen ones (the masked set_to_zero of optax) get no update at
    all, AdamW's decay included.  `step(count)` reads the .grad of every
    parameter (a missing one is a zero gradient, as JAX's grads are: decay
    still applies), takes the global norm over all of them, frozen ones
    included (optax clips before the mask), clips them in place, sets the
    learning rate to schedule(count) and updates; it returns the global
    norm before the clip."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Callable[[int], float],
                 make_tx: Callable[[List[torch.nn.Parameter], float], torch.optim.Optimizer],
                 grad_clip: Optional[float] = None,
                 frozen: Iterable[torch.nn.Parameter] = ()):
        self.params: List[torch.nn.Parameter] = list(params)
        frozen_ids = {id(p) for p in frozen}
        self.trainable = [p for p in self.params if id(p) not in frozen_ids]
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.tx = make_tx(self.trainable, schedule(0))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

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
        for group in self.tx.param_groups:
            group["lr"] = self.schedule(count)
        self.tx.step()
        return norm


def _torch_tx(optimizer_cfg: Dict[str, Any]):
    """(params, lr) -> the torch optimizer of optimizer_cfg, with the JAX
    package's defaults (SGD's momentum 0.9, not torch's 0)."""
    opt_type = optimizer_cfg.get("type", "AdamW")
    betas = tuple(optimizer_cfg.get("betas", (0.9, 0.999)))
    eps = optimizer_cfg.get("eps", 1e-8)
    weight_decay = optimizer_cfg.get("weight_decay", 0.0)
    if opt_type == "AdamW":
        return lambda ps, lr: torch.optim.AdamW(ps, lr=lr, betas=betas, eps=eps,
                                                weight_decay=weight_decay)
    if opt_type not in ("Adam", "SGD"):
        raise KeyError(opt_type)
    if weight_decay:
        # JAX's optax.adam / optax.sgd take no decay and drop the field
        # unread; the reference's torch optimizers would apply it as L2
        raise ValueError(f"{opt_type} with weight_decay {weight_decay}: the JAX package "
                         "ignores it, the reference applies it; set it to 0 or use AdamW")
    if opt_type == "Adam":
        return lambda ps, lr: torch.optim.Adam(ps, lr=lr, betas=betas, eps=eps)
    momentum = optimizer_cfg.get("momentum", 0.9)
    return lambda ps, lr: torch.optim.SGD(ps, lr=lr, momentum=momentum)


def build_optimizer(params, optimizer_cfg: Dict[str, Any],
                    lr_cfg: Optional[Dict[str, Any]] = None, grad_clip: Optional[float] = None,
                    frozen_prefixes: Optional[Any] = None):
    """(ClippedOptimizer, schedule) from reference-style config dicts, as
    scflow_tpu.runtime.optim.build_optimizer reads them: optimizer_cfg
    {'type': 'AdamW' | 'Adam' | 'SGD', 'lr', 'betas', 'eps',
    'weight_decay', 'momentum'}; lr_cfg {'policy': 'OneCycle', 'max_lr',
    'total_steps', 'pct_start', 'anneal_strategy', ...} or None for a
    constant lr.  params: a refiner (nn.Module) or an iterable of
    parameters.  frozen_prefixes: '/'-joined flax parameter paths, as JAX's
    configs name them (convert.flax_param_names); the parameters under them
    get no update, which needs params to be a refiner.

    Raises where JAX reads a field silently otherwise: KeyError for an
    unknown optimizer type (as JAX does), ValueError for an lr policy other
    than 'OneCycle' (JAX runs any other as a constant optimizer.lr) and for
    'Adam' or 'SGD' with a nonzero weight_decay (JAX drops it)."""
    frozen = []
    if isinstance(params, torch.nn.Module):
        model, params = params, list(params.parameters())
        if frozen_prefixes:
            from scflow_tpu_torch.convert import flax_param_names

            prefixes = tuple(frozen_prefixes)
            named = dict(model.named_parameters())
            frozen = [named[name] for name, path in flax_param_names(model).items()
                      if path.startswith(prefixes)]
    elif frozen_prefixes:
        raise TypeError("frozen_prefixes name flax paths, so params must be the refiner")
    make_tx = _torch_tx(optimizer_cfg)
    if lr_cfg and lr_cfg.get("policy") == "OneCycle":
        schedule = onecycle_lr(lr_cfg["max_lr"], lr_cfg["total_steps"],
                               lr_cfg.get("pct_start", 0.3), lr_cfg.get("div_factor", 25.0),
                               lr_cfg.get("final_div_factor", 1e4),
                               lr_cfg.get("anneal_strategy", "cos"))
    elif lr_cfg:
        raise ValueError(f"lr policy {lr_cfg.get('policy')!r}: only 'OneCycle' is known (the "
                         "JAX package runs any other as a constant optimizer.lr)")
    else:
        lr = optimizer_cfg.get("lr", 1e-4)
        schedule = lambda step: lr  # noqa: E731
    return ClippedOptimizer(params, schedule, make_tx, grad_clip, frozen), schedule
