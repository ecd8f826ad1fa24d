"""Train and eval step builders.

Port of :mod:`repro.train.step` for every family (dense, ``moe``,
``hybrid``, RWKV-6 ``ssm``, ``encdec`` and ``vlm``).  A batch holds what the family's
``input_specs`` names: the encoder-decoder's ``frames`` beside its
target tokens, the vlm's ``image_embeds`` beside its text tokens, whose
labels cover the image positions too (:func:`_align_labels`).
:func:`make_prefill_step` and :func:`make_serve_step` are the reference's
serving steps (the engine has its own); the sharded train step over a
mesh is :func:`repro_torch.launch.shardings.make_sharded_train_step`.
``make_train_step(api, opt_cfg)`` returns ``(params, opt_state, batch)
-> (params', opt_state', metrics)``; the optimizer updates ``params`` and
``opt_state`` in place (:func:`repro_torch.optim.adamw.adamw_update`), so
the returned trees are the ones passed in.  Parameters are leaf tensors with ``requires_grad``
set (:func:`init_train_state`); gradients come from
``torch.autograd.grad`` and never accumulate in ``.grad``.

Cross-entropy: logits stay in the compute dtype; :class:`_TokenNLL` saves
only them and the float32 log-sum-exp, and its backward forms
``exp(x − lse) − onehot`` without a float32 logits-sized residual.
Label positions < 0 are masked out of the loss.

Profiler ranges: each microbatch's forward and cross-entropy runs inside
:data:`FORWARD_RANGE`, its ``torch.autograd.grad`` inside
:data:`BACKWARD_RANGE`, and the step's AdamW update (the clip included)
inside :data:`OPTIMIZER_RANGE`.  Outside a ``torch.profiler`` session a
range costs one dispatcher call on entry and one on exit.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.models.registry import ModelApi
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_adamw
from repro_torch.tree import tree_leaves, tree_unflatten

#: profiler range around ``loss_fn``: the forward and the cross-entropy
FORWARD_RANGE = "repro_torch.train.forward"
#: profiler range around the gradient's ``torch.autograd.grad`` (and,
#: with microbatches, its float32 accumulation); under remat "full" it
#: holds the forward recompute too.  The backward's CUDA work is launched
#: from autograd's device thread, so its device time lies under this
#: range by time (its launches fall inside the range), as it does for
#: ``kernels.ops.BACKWARD_RANGE``, which nests in this one
BACKWARD_RANGE = "repro_torch.train.backward"
#: profiler range around ``adamw_update``, the gradient clip included
OPTIMIZER_RANGE = "repro_torch.train.optimizer"


class _TokenNLL(torch.autograd.Function):
    """Per-token negative log likelihood, memory-lean (reference
    ``_token_nll``): saves the compute-dtype logits and the (b, s) float32
    lse."""

    @staticmethod
    def forward(ctx, logits, labels):
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
        ctx.save_for_backward(logits, labels, lse)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        # softmax·g, cast to the logits' dtype; the −onehot·g term is a
        # scatter-add at the gold indices (no (b, s, V) one-hot)
        grad = (torch.exp(logits.float() - lse[..., None])
                * g[..., None]).to(logits.dtype)
        grad.scatter_add_(-1, labels[..., None].long(),
                          -g[..., None].to(grad.dtype))
        return grad, None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean masked cross-entropy. logits (b, s, V); labels (b, s) int,
    negative = ignore."""
    mask = labels >= 0
    safe = torch.clamp(labels, min=0)
    nll = _TokenNLL.apply(logits, safe) * mask.float()
    denom = torch.clamp(mask.sum(), min=1)
    return nll.sum() / denom


def _align_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Pad/crop labels on the sequence axis to the logits length (VLM
    prepends image positions: those get ignore-labels)."""
    s_logits, s_labels = logits.shape[1], labels.shape[1]
    if s_labels == s_logits:
        return labels
    if s_labels < s_logits:
        pad = torch.full((labels.shape[0], s_logits - s_labels), -1,
                         dtype=labels.dtype, device=labels.device)
        return torch.cat([pad, labels], dim=1)
    return labels[:, -s_logits:]


def make_loss_fn(api: ModelApi) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)``: the cross-entropy,
    plus ``lb_loss_weight · lb + z_loss_weight · zl`` for a MoE config
    (the load-balance and router-z losses summed over layers, reported as
    ``moe_lb`` / ``moe_z``)."""
    cfg = api.cfg

    def loss_fn(params, batch) -> tuple:
        if cfg.moe is None:
            logits = api.forward(params, batch)
        else:
            logits, aux = api.forward(params, batch, return_aux=True)
        loss = softmax_xent(logits, _align_labels(logits, batch["labels"]))
        metrics = {"xent": loss}
        if cfg.moe is not None:
            lb, zl = aux[0], aux[1]
            loss = (loss + cfg.moe.lb_loss_weight * lb
                    + cfg.moe.z_loss_weight * zl)
            metrics["moe_lb"] = lb
            metrics["moe_z"] = zl
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def make_grad_fn(api: ModelApi, microbatches: int = 1) -> Callable:
    """``grad_fn(params, batch) -> (grads, metrics)``: the gradient half
    of :func:`make_train_step`.  ``microbatches`` > 1 splits the batch
    into N sequential micro-steps with float32 gradient accumulation; the
    gradient is their mean, and each metric the mean of its values.  The
    ``frontend_proj`` of a batch with no ``image_embeds`` (the vlm on a
    text-only batch) does not reach the loss and gets a zero gradient, as
    under ``jax.grad``; any other parameter that does not reach it
    raises."""
    loss_fn = make_loss_fn(api)

    def grad_fn(params, batch) -> Tuple[dict, dict]:
        leaves = tree_leaves(params)
        if microbatches == 1:
            with torch.profiler.record_function(FORWARD_RANGE):
                loss, metrics = loss_fn(params, batch)
            with torch.profiler.record_function(BACKWARD_RANGE):
                grads = _grads(loss, leaves, _unreached(params, batch))
            return tree_unflatten(params, grads), _detached(metrics)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        ms = []
        splits = {k: v.chunk(microbatches, dim=0) for k, v in batch.items()}
        for i in range(microbatches):
            with torch.profiler.record_function(FORWARD_RANGE):
                loss, m = loss_fn(params,
                                  {k: v[i] for k, v in splits.items()})
            with torch.profiler.record_function(BACKWARD_RANGE):
                for a, g in zip(acc, _grads(loss, leaves,
                                            _unreached(params, batch))):
                    a.add_(g.float())
            ms.append(_detached(m))
        grads = [a / microbatches for a in acc]
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        return tree_unflatten(params, grads), metrics

    return grad_fn


def _unreached(params: dict, batch: dict) -> set:
    """The ids of the leaves the batch leaves out of the loss: the
    frontend projection when the batch carries no image embeddings and
    no frames."""
    if ("image_embeds" in batch or "frames" in batch
            or "frontend_proj" not in params):
        return set()
    return {id(t) for t in tree_leaves(params["frontend_proj"])}


def _grads(loss: torch.Tensor, leaves: list, unreached: set) -> list:
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    out = []
    for p, g in zip(leaves, grads):
        if g is None and id(p) not in unreached:
            raise RuntimeError(f"a parameter of shape {tuple(p.shape)} "
                               "does not reach the loss")
        out.append(torch.zeros_like(p) if g is None else g)
    return out


def _detached(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(api: ModelApi, opt_cfg: AdamWConfig,
                    microbatches: int = 1) -> Callable:
    """Build the train step: gradients (:func:`make_grad_fn`), then one
    AdamW update, in place."""
    grad_fn = make_grad_fn(api, microbatches)

    def train_step(params, opt_state, batch):
        grads, metrics = grad_fn(params, batch)
        with torch.profiler.record_function(OPTIMIZER_RANGE):
            new_params, new_opt, opt_metrics = adamw_update(
                grads, opt_state, params, opt_cfg)
        return new_params, new_opt, {**metrics, **opt_metrics}

    return train_step


def make_eval_step(api: ModelApi) -> Callable:
    loss_fn = make_loss_fn(api)

    @torch.no_grad()
    def eval_step(params, batch):
        return loss_fn(params, batch)[1]

    return eval_step


def make_prefill_step(api: ModelApi, batch_chunks: int = 8) -> Callable:
    """Serving prefill: the LAST position's logits only (the decode
    bootstrap), the forward mapped over batch chunks (full-sequence
    logits of a 32k-token prefill batch have no consumer, and chunking
    bounds the activation peak as microbatching does in training).  The
    chunk count keeps each chunk's rows divisible by the data-parallel
    degree of :func:`~repro_torch.distributed.sharding.current_mesh`
    (pod × data), as the reference does."""
    from repro_torch.distributed.sharding import axis_sizes, current_mesh

    @torch.no_grad()
    def prefill_step(params, batch):
        b = next(iter(batch.values())).shape[0]
        mesh = current_mesh()
        dp = 1
        if mesh is not None:
            sizes = axis_sizes(mesh)
            for ax in ("pod", "data"):
                dp *= sizes.get(ax, 1)
        n = max(1, min(batch_chunks, b // dp))
        while b % n or (b // n) % dp:
            n -= 1
        if n <= 1:
            return api.forward(params, batch)[:, -1:]
        chunks = {k: v.chunk(n, dim=0) for k, v in batch.items()}
        return torch.cat([api.forward(params, {k: v[i] for k, v in
                                               chunks.items()})[:, -1:]
                          for i in range(n)], dim=0)

    return prefill_step


def make_serve_step(api: ModelApi) -> Callable:
    """One decode step: the greedy next token against the KV cache /
    recurrent state.  Returns (next tokens (b, 1) int32, logits, states')."""

    @torch.no_grad()
    def serve_step(params, tokens, states, batch=None):
        logits, new_states = api.step(params, tokens, states, batch)
        next_tokens = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return next_tokens, logits, new_states

    return serve_step


def init_train_state(api: ModelApi, opt_cfg: AdamWConfig,
                     gen: torch.Generator, *, device=None):
    """Initialize (params, opt_state): parameters from ``gen`` (a
    generator on the CPU or on ``device``) on ``device`` (default
    ``cuda``), as leaf tensors that require grad.  The reference also
    returns the logical sharding axes; here they are ``api.axes()``."""
    params = api.init(gen, device=device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params, init_adamw(params, opt_cfg)
