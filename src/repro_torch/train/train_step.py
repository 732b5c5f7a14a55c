"""Per-family losses and train / serve steps (port of
``repro.train.train_step``).

A ``TrainState`` holds the model (an ``nn.Module`` whose parameters are
the JAX tree's leaves) and its ``AdamWState``. A step is ``step(state,
batch) -> (state, metrics)``: it computes the loss and the gradients with
autograd, then updates the parameters and moments in place through
``opt.update``; ``metrics`` holds 0-d tensors (``loss``, ``grad_norm``), so
nothing is read back to the host inside the step. Parameters take
gradients only inside a step (``trainable``); serving entry points run
under ``torch.no_grad``.

The LM cross-entropy is chunked over the sequence, each chunk's loss
checkpointed: at a 150 k vocabulary the float32 logits of a whole batch
would not fit, so only one chunk's logits live at a time, and its forward
is recomputed in the backward. The head's product and softcap run in the
parameter dtype and only then go to float32, as in JAX.

``num_microbatches = m > 1`` accumulates gradients over m microbatches.
The split is strided, as JAX's ``reshape(mb, m, S).transpose(1, 0, 2)``:
microbatch j holds rows j, j + m, j + 2m, ... Each microbatch's gradients
are added into float32 buffers (JAX's float32 zeros tree), never summed
in ``.grad`` (the parameter dtype, bf16 for a bf16 model); the gradients
are the buffers / m and the loss the mean of the microbatch losses.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, NamedTuple, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models.layers import softcap
from repro_torch.models.transformer import DecoderLM, forward_hidden
from repro_torch.train.optimizer import AdamW, AdamWState

Batch = Dict[str, Any]
Metrics = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: nn.Module
    opt: AdamWState


def init_train_state(params: nn.Module, opt: AdamW) -> TrainState:
    return TrainState(params=params, opt=opt.init(named_params(params)))


def named_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    return dict(model.named_parameters())


@contextlib.contextmanager
def trainable(model: nn.Module) -> Iterator[Dict[str, torch.Tensor]]:
    """The model's parameters by name, taking gradients within the block
    (and as they were after it)."""
    params = named_params(model)
    before = {k: p.requires_grad for k, p in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            yield params
    finally:
        for k, p in params.items():
            p.requires_grad_(before[k])


def value_and_grad(loss_fn: Callable[[], torch.Tensor], model: nn.Module
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, grads by parameter name) of ``loss_fn()``; a parameter the
    loss does not reach gets a zero gradient (JAX's)."""
    with trainable(model) as params:
        loss = loss_fn()
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True)
    out = {}
    for k, g in zip(names, grads):
        out[k] = torch.zeros_like(params[k]) if g is None else g
    return loss.detach(), out


def _apply(opt: AdamW, state: TrainState, grads, loss
           ) -> Tuple[TrainState, Metrics]:
    _, new_opt, gnorm = opt.update(grads, state.opt,
                                   named_params(state.params))
    return TrainState(state.params, new_opt), {"loss": loss,
                                               "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def _chunk_loss(hc: torch.Tensor, yc: torch.Tensor, head: torch.Tensor,
                cap) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the chunk's NLL, count of its targets >= 0)."""
    logits = softcap(hc @ head, cap).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(yc, min=0)[..., None])[..., 0]
    valid = yc >= 0
    nll = torch.where(valid, logz - gold, 0.0)
    return torch.sum(nll), torch.sum(valid.to(torch.float32))


def lm_loss(params: DecoderLM, cfg: LMConfig, tokens, targets, *,
            chunk_tokens: int = 8192, remat: bool = True) -> torch.Tensor:
    """Next-token CE (targets < 0 masked), chunked over the sequence:
    chunks of ``min(S, chunk_tokens // B)`` positions, walked down to a
    divisor of S."""
    hidden = forward_hidden(params, cfg, tokens, remat=remat)  # (B, S, D)
    B, S = hidden.shape[:2]
    targets = torch.as_tensor(targets, device=hidden.device).to(torch.int64)
    chunk_s = max(1, min(S, chunk_tokens // max(B, 1)))
    while S % chunk_s != 0:
        chunk_s -= 1
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    remat = remat and torch.is_grad_enabled()
    for c in range(0, S, chunk_s):
        args = (hidden[:, c:c + chunk_s], targets[:, c:c + chunk_s],
                params.head, cfg.logit_softcap)
        if remat:
            nll, n = checkpoint(_chunk_loss, *args, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            nll, n = _chunk_loss(*args)
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def lm_grads(params: DecoderLM, cfg: LMConfig, tokens, targets, *,
             chunk_tokens: int = 8192, num_microbatches: int = 1
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, grads) of one LM batch, accumulated over strided
    microbatches in float32 when ``num_microbatches > 1``."""
    dev = params.device
    tokens = torch.as_tensor(tokens, device=dev)
    targets = torch.as_tensor(targets, device=dev)

    def loss_of(t, y):
        return lambda: lm_loss(params, cfg, t, y, chunk_tokens=chunk_tokens)

    m = num_microbatches
    if m <= 1:
        return value_and_grad(loss_of(tokens, targets), params)
    B, S = tokens.shape
    if B % m:
        raise ValueError(f"batch {B} is not a multiple of "
                         f"num_microbatches {m}")
    tk = tokens.reshape(B // m, m, S).transpose(0, 1)
    tg = targets.reshape(B // m, m, S).transpose(0, 1)
    g_acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.named_parameters()}
    l_acc = torch.zeros((), dtype=torch.float32, device=dev)
    for j in range(m):
        loss, g = value_and_grad(loss_of(tk[j], tg[j]), params)
        for k, gk in g.items():
            g_acc[k] += gk.to(torch.float32)
        del g
        l_acc = l_acc + loss
    return l_acc / m, {k: a / m for k, a in g_acc.items()}


def make_lm_train_step(cfg: LMConfig, opt: AdamW, chunk_tokens: int = 8192,
                       num_microbatches: int = 1) -> Callable:
    """step(state, {"tokens", "targets"}) -> (state, metrics). A MoE
    ``DecoderLM`` trains at its capacity factor (tokens beyond capacity
    dropped), with the load-balancing loss left out, as in JAX."""
    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        loss, grads = lm_grads(state.params, cfg, batch["tokens"],
                               batch["targets"], chunk_tokens=chunk_tokens,
                               num_microbatches=num_microbatches)
        return _apply(opt, state, grads, loss)
    return step


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------

def make_gnn_train_step(cfg: GNNConfig, opt: AdamW) -> Callable:
    def step(state: TrainState, batch: G.GraphBatch
             ) -> Tuple[TrainState, Metrics]:
        loss, grads = value_and_grad(
            lambda: G.pna_loss(state.params, cfg, batch), state.params)
        return _apply(opt, state, grads, loss)
    return step


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------

def bce_loss(logits: torch.Tensor, labels) -> torch.Tensor:
    z = logits.to(torch.float32)
    y = torch.as_tensor(labels, device=z.device).to(torch.float32)
    return torch.mean(torch.clamp(z, min=0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


def recsys_forward(params: nn.Module, cfg: RecsysConfig,
                   batch: Batch) -> torch.Tensor:
    if cfg.interaction == "fm-2way":
        return R.fm_forward(params, cfg, batch["ids"])
    if cfg.interaction == "self-attn":
        return R.autoint_forward(params, cfg, batch["ids"])
    if cfg.interaction == "target-attn":
        return R.din_forward(params, cfg, batch["hist_ids"],
                             batch["hist_mask"], batch["target_ids"])
    if cfg.interaction == "self-attn-seq":
        return R.sasrec_forward(params, cfg, batch["hist_ids"],
                                batch["hist_mask"], batch["target_ids"])
    raise ValueError(cfg.interaction)


def make_recsys_train_step(cfg: RecsysConfig, opt: AdamW) -> Callable:
    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        loss, grads = value_and_grad(
            lambda: bce_loss(recsys_forward(state.params, cfg, batch),
                             batch["labels"]), state.params)
        return _apply(opt, state, grads, loss)
    return step


@torch.no_grad()
def recsys_serve(params: nn.Module, cfg: RecsysConfig,
                 batch: Batch) -> torch.Tensor:
    """Forward scoring (serve_p99 / serve_bulk shapes)."""
    return recsys_forward(params, cfg, batch)


@torch.no_grad()
def recsys_score_candidates(params: nn.Module, cfg: RecsysConfig,
                            batch: Batch) -> torch.Tensor:
    """retrieval_cand shape: 1 query vs n_candidates items."""
    if cfg.interaction == "fm-2way":
        return R.fm_score_candidates(params, cfg, batch["context_ids"],
                                     batch["cand_ids"])
    if cfg.interaction == "self-attn":
        return R.autoint_score_candidates(params, cfg, batch["context_ids"],
                                          batch["cand_ids"])
    if cfg.interaction == "target-attn":
        return R.din_score_candidates(params, cfg, batch["hist_ids"],
                                      batch["hist_mask"], batch["cand_ids"])
    if cfg.interaction == "self-attn-seq":
        return R.sasrec_score_candidates(params, cfg, batch["hist_ids"],
                                         batch["hist_mask"],
                                         batch["cand_ids"])
    raise ValueError(cfg.interaction)
