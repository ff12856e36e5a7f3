"""Train step: loss -> grads (with microbatch accumulation) -> optimizer.

``make_train_step`` builds the step for one architecture, as the
reference's does:
  * activations in the config's dtype, float32 softmax/loss, float32
    optimizer state;
  * gradient accumulation over ``microbatches`` (the global batch dim is
    split; float32 sums, each term divided by ``microbatches``; under a
    mesh the batch is made whole first and each microbatch's rows sharded
    again over the data dims that divide them);
  * global-norm clipping;
  * the cosine schedule, read at the state's step before it advances.

The returned step has signature (state, batch) -> (state, metrics) where
state = {"params": Model, "opt", "step"} and metrics = {"loss",
"grad_norm", "lr"} (0-d tensors).  It updates the state in place (the
parameters, the optimizer's tensors) where the reference's jitted step
donates it, and returns the same dict.  A state placed on a mesh
(``dist.sharding.to_named``) runs the same code on DTensors, inside
``dist.ctx.use(mesh)``.
"""
from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.dist import ctx as shard_ctx
from repro_torch.models import ModelConfig, lm_loss
from repro_torch.train.optimizer import (
    OPTIMIZERS,
    clip_by_global_norm,
    cosine_schedule,
    pick_optimizer,
)


def make_train_step(
    cfg: ModelConfig,
    optimizer: str | None = None,
    microbatches: int = 1,
    base_lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10_000,
    max_grad_norm: float = 1.0,
) -> tuple[Callable, Callable]:
    """Returns (init_state, train_step)."""
    opt_name = optimizer or pick_optimizer(cfg)
    opt_init, opt_update = OPTIMIZERS[opt_name]

    def init_state(params):
        return {
            "params": params,
            "opt": opt_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=params.embed.table.device),
        }

    def grads_of(params, batch):
        named = dict(params.named_parameters())
        loss = lm_loss(params, cfg, batch)
        # a parameter the batch does not reach (the token table of an
        # encoder fed embeddings) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), dict(zip(named, grads))

    def accumulate(params, batch):
        if microbatches <= 1:
            return grads_of(params, {k: shard_ctx.shard_rows(v) for k, v in batch.items()})
        # under a mesh the batch is made whole on every rank before the split
        # and each microbatch is sharded again, over the data dims that
        # divide its rows: DTensor cannot split a batch axis sharded over
        # more ranks than there are microbatches
        split = {k: shard_ctx.replicate(v).reshape(
                     (microbatches, v.shape[0] // microbatches) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        acc_loss = torch.zeros((), dtype=torch.float32, device=params.embed.table.device)
        # laid out as the parameters (their shards under a mesh)
        acc_g = {n: torch.zeros_like(p, dtype=torch.float32)
                 for n, p in params.named_parameters()}
        for i in range(microbatches):
            loss, g = grads_of(params, {k: shard_ctx.shard_rows(v[i])
                                        for k, v in split.items()})
            acc_loss = acc_loss + loss / microbatches
            acc_g = {n: a + g[n].float() / microbatches for n, a in acc_g.items()}
        return acc_loss, acc_g

    def train_step(state, batch):
        params = state["params"].requires_grad_(True)
        loss, grads = accumulate(params, batch)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = cosine_schedule(state["step"], base_lr, warmup, total_steps)
        opt_update(params, grads, state["opt"], lr=lr)
        state["step"] = state["step"] + 1
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return init_state, train_step
