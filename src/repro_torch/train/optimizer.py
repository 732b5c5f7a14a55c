"""AdamW and learning-rate schedules (port of ``repro.train.optimizer``).

Parameters, gradients and moments are dicts keyed by parameter name
(``dict(model.named_parameters())``). The state is ``step`` (0-d int32)
and the moments ``m`` and ``v``, float32 whatever the parameters' dtype;
a bf16 parameter gets no float32 master copy, as in JAX.

The arithmetic is JAX's, op for op: the global-norm clip ``min(1, clip /
max(gnorm, 1e-9))`` (times ``extra_scale``), float32 moments, bias
correction with ``b ** step`` in float32, weight decay on every leaf
(norms and embeddings included), and the new parameter computed in
float32, then cast to the parameter's dtype. ``update`` writes the new
parameters and moments into the tensors it is given (no second copy of
the state at a time) and reads nothing back to the host.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor     # 0-d int32
    m: Params              # float32, keyed like the parameters
    v: Params


class AdamW(NamedTuple):
    init: Callable[[Params], AdamWState]
    update: Callable[..., Tuple[Params, AdamWState, torch.Tensor]]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def adamw(lr: Union[Schedule, float], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          grad_clip_norm: float = 1.0) -> AdamW:
    lr_fn = lr if callable(lr) else (lambda step: _f32(lr, step))

    def init(params: Params) -> AdamWState:
        dev = next(iter(params.values())).device
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for k, p in params.items()}
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev), m=zeros,
            v={k: torch.zeros_like(z) for k, z in zeros.items()})

    @torch.no_grad()
    def update(grads: Params, state: AdamWState, params: Params,
               extra_scale: Optional[torch.Tensor] = None
               ) -> Tuple[Params, AdamWState, torch.Tensor]:
        """One step: (params, state, gnorm), params and moments updated in
        place; ``grads`` and ``params`` share their keys."""
        step = state.step + 1
        gnorm = global_norm(grads)
        clip = torch.minimum(
            _f32(1.0, gnorm), grad_clip_norm / torch.clamp(gnorm, min=1e-9))
        if extra_scale is not None:
            clip = clip * extra_scale
        s = step.to(torch.float32)
        bc1 = 1 - torch.pow(_f32(b1, s), s)
        bc2 = 1 - torch.pow(_f32(b2, s), s)
        rate = lr_fn(step)
        for name, g in grads.items():
            p, m, v = params[name], state.m[name], state.v[name]
            g = g.to(torch.float32) * clip
            m.mul_(b1).add_(g * (1 - b1))                # b1 m + (1-b1) g
            v.mul_(b2).add_((g * (1 - b2)).mul_(g))      # b2 v + (1-b2) g g
            del g
            delta = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            p32 = p.to(torch.float32)                    # p itself if f32
            delta.add_(p32 * weight_decay)
            new_p = p32 - rate * delta
            del delta
            p.copy_(new_p)
        return params, AdamWState(step=step, m=state.m, v=state.v), gnorm

    return AdamW(init=init, update=update)


def global_norm(tree: Params) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> Schedule:
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return _f32(peak_lr, s) * torch.where(s < warmup_steps, warm, cos)
    return fn


def linear_schedule(peak_lr: float, warmup_steps: int,
                    total_steps: int) -> Schedule:
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = s / max(warmup_steps, 1)
        decay = torch.clamp(1.0 - (s - warmup_steps)
                            / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        return _f32(peak_lr, s) * torch.where(s < warmup_steps, warm, decay)
    return fn
