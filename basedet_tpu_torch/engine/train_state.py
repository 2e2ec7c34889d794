"""Train state and the train step (counterpart of
``basedet_tpu/engine/train_state.py``).

Where the JAX package compiles forward, loss, gradient, optimizer update and
EMA into one program over an immutable state, the port runs them eagerly and
updates in place: the module's parameters and BN buffers, the optimizer's
momentum, and the EMA copy of the parameters.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from basedet_tpu_torch import parallel
from basedet_tpu_torch.parallel.tp import all_reduce_model_grads, tp_context
from basedet_tpu_torch.layers.common.function import full_f32
from basedet_tpu_torch.layers.precision import policy_from_cfg, precision_policy
from basedet_tpu_torch.layers.remat import mode_from_cfg, remat_policy


def ema_momentum(cfg_ema, max_iters: int) -> float:
    """pycls-style momentum from ALPHA (90000 = the 1x COCO schedule's
    iterations), unless MOMENTUM is given."""
    if cfg_ema.get("MOMENTUM", None):
        return float(cfg_ema.MOMENTUM)
    alpha = cfg_ema.get("ALPHA", 5e-4)
    period = cfg_ema.get("UPDATE_PERIOD", 1)
    return max(0.0, 1.0 - alpha * (90000 * period / max_iters))


class TrainState:
    """``step``, the number of steps taken; the model's optimizer; and
    ``ema_params``, an EMA copy of the parameters by name (None without
    EMA). The BN buffers are the module's own and are never averaged."""

    def __init__(self, model, solver, ema: bool = False):
        self.step = 0
        self.optimizer = solver.make_optimizer(model.module)
        self.ema_params: Optional[Dict[str, torch.Tensor]] = (
            {n: p.detach().clone() for n, p in model.module.named_parameters()} if ema else None
        )

    def variables(self, module: torch.nn.Module, ema: bool = False) -> Dict[str, torch.Tensor]:
        """The module's state_dict, with the EMA parameters in place of the
        live ones when ``ema`` and the state tracks them."""
        sd = module.state_dict()
        if ema and self.ema_params is not None:
            sd.update(self.ema_params)
        return sd


def make_train_step(model, solver, cfg) -> Callable[[TrainState, Dict], Dict[str, torch.Tensor]]:
    """The (state, batch) → metrics step: forward and losses, backward,
    gradient clipping, the solver's optimizer at ``lr = schedule(state.step)``
    (times each parameter group's ``lr_ratio``), then the EMA of
    the parameters. The step runs in IEEE f32 (TF32 off), backward included,
    unless ``TRAINER.AMP.ENABLE``: then the forward and the losses of every
    model run under the bf16 policy (``layers/precision.py``), as the JAX
    package's step does, with ``TRAINER.AMP.FUSED_BN`` choosing the fused CSP
    chain; parameters, gradients, the solver and the EMA stay f32.
    ``TRAINER.REMAT`` (``True`` or ``"selective"``) recomputes the network's
    activations in the backward, segment by segment (``layers/remat.py``);
    the step's results do not change. Metrics stay on the device; ``lr`` is
    a float.

    A model that samples (``draws_per_step``: Faster R-CNN's anchors and
    RoIs, DETR's dropout) is handed ``cfg.SEED`` (42 unless set) and the step, from which it
    seeds its draw, as the JAX package folds the step into its key: a step's
    draw does not depend on what ran before it.

    Under a process group (``basedet_tpu_torch/parallel``) each rank steps its
    own rows of the global batch: the gradients are averaged over ranks
    (``parallel.all_reduce_grads``) after the backward and before the
    clipping, so every rank takes the same update; the metrics stay the
    rank's own (the trainer averages them at its log interval). The fused
    CSP chain is refused there.

    With ``TRAINER.TP_SIZE`` above 1 (``parallel.mesh.init_grid``) the step
    runs forward and backward inside ``tp_context`` of this rank's model
    group, where DETR's FFNs split their hidden width; after the backward
    the FFN gradients that each model rank holds only a slice of
    (``tp_sharded_parameters``) are summed over the model group and the
    others, computed alike on every model rank, averaged over it
    (``tp.all_reduce_model_grads``, one all-reduce); then the mean over the
    data group, then the clipping, on whole gradients."""
    dtype, fused_bn = policy_from_cfg(cfg)
    if fused_bn and parallel.is_active():
        raise NotImplementedError("TRAINER.AMP.FUSED_BN takes the BN statistics inside the fused kernels over one "
                                  "rank's rows; it is not ported to data-parallel training")
    remat = mode_from_cfg(cfg)
    ema_cfg = cfg.TRAINER.EMA
    use_ema = bool(ema_cfg.get("ENABLE", False))
    momentum = ema_momentum(ema_cfg, solver.max_iters) if use_ema else 0.0
    burnin = ema_cfg.get("BURNIN_ITER", 0) if use_ema else 0
    update_period = ema_cfg.get("UPDATE_PERIOD", 1) if use_ema else 1
    names, params = zip(*model.module.named_parameters())
    seed = cfg.get("SEED", 42)
    draws = getattr(model, "draws_per_step", False)

    sharded = [p for m in model.module.modules() if hasattr(m, "tp_sharded_parameters")
               for p in m.tp_sharded_parameters()]

    def train_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        group = parallel.model_group()
        with full_f32(), tp_context(group):
            randomness = {"seed": seed, "step": state.step} if draws else {}
            with precision_policy(dtype, fused_bn), remat_policy(remat):
                total, loss_dict = model.get_losses(batch, **randomness)
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
        all_reduce_model_grads(params, sharded, group)
        parallel.all_reduce_grads(params)
        solver.clip_grads(params)
        lr = solver.lr_schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr * group.get("lr_ratio", 1.0)
        state.optimizer.step()

        if use_ema and state.ema_params is not None:
            # params exactly until burn-in, then EMA every update_period steps
            m = 0.0 if state.step < burnin else momentum
            if not (state.step % update_period == 0 or state.step <= burnin):
                m = 1.0
            ema = [state.ema_params[n] for n in names]
            with torch.no_grad():
                torch._foreach_mul_(ema, m)
                torch._foreach_add_(ema, params, alpha=1.0 - m)
        state.step += 1
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["lr"] = lr
        return metrics

    return train_step
