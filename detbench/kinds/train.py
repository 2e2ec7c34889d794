"""A training cell: the port's ``make_train_step`` on a ``TrainState``
(with the configuration's EMA), stepped over a pool of distinct batches on
the device, as many steps as fit the window.

Set-up builds the model and state once, drives them through the window's
own call on the pool's first three batches (the steps the reference
follows), then warms up; the window continues the same state. The check
rebuilds the seed's weights, steps the plain reference through the same
three batches and compares each step's loss, the first gradient as the
optimizer holds it, the parameters' change after three steps, with an EMA
the EMA's change, where the configuration names modules of the network
(``check.outputs``) what each put out in the first step, and where it
names the modules whose outputs the losses read (``check.grads``) the
first step's gradient of the loss at their outputs, image by image."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch

from core import check, port, trace, traffic
from core.roofline import PEAK_FLOPS
from reference.common import fp8_e4m3, fp8_e5m2_grad, identity, set_quant
from reference.solver import SGD, ema_update, learning_rate

FOLLOWED = 3  # steps the reference follows
WARM = 2  # further warm-up steps before the window


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].float()) for n in names]).cpu().tolist()
    return dict(zip(names, vals))


def _flat(outputs) -> List[torch.Tensor]:
    """The tensors of a module's output (nested lists and tuples), in order."""
    if isinstance(outputs, torch.Tensor):
        return [outputs]
    return [t for o in outputs for t in _flat(o)]


@contextlib.contextmanager
def _catch_outputs(model: torch.nn.Module, paths: List[str], into: Dict[str, List[torch.Tensor]], device: str):
    """While active, the outputs of each of ``model``'s submodules ``paths``
    are kept in ``into[path]``, detached, on ``device``."""
    def keep(path):
        return lambda mod, args, out: into.setdefault(path, []).extend(
            t.detach().to(device, copy=True) for t in _flat(out))

    hooks = [model.get_submodule(p).register_forward_hook(keep(p)) for p in paths]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def _catch_image_grads(model: torch.nn.Module, paths: List[str], batch: int, into: List[torch.Tensor]):
    """While active, the gradient that the loss sends to the outputs of each
    of ``model``'s submodules ``paths`` is summed image by image into
    ``into`` (one (batch,) tensor of squared norms, made on the first
    output). Outputs are batch-first, or (batch × rows, ...) image by image;
    the hooks run before any other forward hook, so they see what the
    module itself put out."""
    def add(grad):
        g = grad.detach().unflatten(0, (batch, -1))
        sq = torch.stack([torch.linalg.vector_norm(g[i], dtype=torch.float32) ** 2 for i in range(batch)])
        if into:
            into[0] += sq
        else:
            into.append(sq)

    def keep(mod, args, out):
        for t in _flat(out):
            if t.requires_grad:
                t.register_hook(add)

    hooks = [model.get_submodule(p).register_forward_hook(keep, prepend=True) for p in paths]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def half_batch_gradient(model: torch.nn.Module, paths: List[str], batch: int):
    """A fault: while active, the loss's gradient reaches the network from
    the first half of each batch only, doubled (the mean over the other
    half), though the whole batch is forwarded and the loss reads it all,
    as a masking or normaliser fault in a loss would have it."""
    def plant(mod, args, out):
        if isinstance(out, torch.Tensor):
            s = torch.zeros(batch, device=out.device, dtype=out.dtype)
            s[:batch // 2] = 2.0
            s = s.repeat_interleave(out.shape[0] // batch).reshape(-1, *[1] * (out.dim() - 1))
            return out * s + (out * (1 - s)).detach()
        return type(out)(plant(mod, args, o) for o in out)

    hooks = [model.get_submodule(p).register_forward_hook(plant) for p in paths]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        c = cell.config
        self.t = c["train"]
        self.batch, self.image = int(self.t["batch"]), tuple(self.t["image"])
        self.outputs_modules = list(c.get("check", {}).get("outputs", []))
        self.grad_modules = list(c.get("check", {}).get("grads", []))

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prepare(self) -> None:
        """The seed's pool of batches on the device."""
        c = self.cell.config
        self.pool = traffic.train_pool(self.cell.traffic, self.batch, self.image, c["max_instances"],
                                       c["num_classes"], self.seed, self.device)

    def setup(self) -> None:
        from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
        from basedet_tpu_torch.utils.registry import registers

        c = self.cell.config
        self.prepare()
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
            self.held = torch.cuda.memory_allocated(self.device)
        cfg = port.port_config(c, self.batch, self.t["amp"], self.seed)
        self.model = port.build_port_model(c, cfg, self.seed, self.device).train()
        solver = registers.solvers.get(cfg.SOLVER.BUILDER_NAME).build(cfg, 1)
        start = int(self.t["start_step"])
        for step in (start, start + FOLLOWED - 1):  # the file's schedule is the one the port runs
            lr, want = solver.lr_schedule(step), learning_rate(c["solver"], step)
            if abs(lr - want) > 1e-6 * abs(want):
                raise ValueError(f"{self.cell.config_name}: the port's LR at step {step} is {lr}, "
                                 f"the configuration file's {want}")
        self.state = TrainState(self.model, solver, ema=bool(cfg.TRAINER.EMA.ENABLE))
        self.state.step = start
        self.step_fn = make_train_step(self.model, solver, cfg)
        self.k = 0
        params = {n: p for n, p in self.model.module.named_parameters() if p.requires_grad}
        losses, outputs, image_grad = [], {}, []
        for i in range(FOLLOWED):
            first = i == 0
            with _catch_outputs(self.model.module, self.outputs_modules if first else [], outputs, "cpu"), \
                    _catch_image_grads(self.model.module, self.grad_modules if first else [], self.batch, image_grad):
                metrics = self.step()
            losses.append(float(metrics["total_loss"]))
            if i == 0:
                opt = self.state.optimizer.state
                grad = _norms({n: opt.get(p, {}).get("momentum_buffer", torch.zeros_like(p))
                               for n, p in params.items()})
        self.followed = {"losses": losses, "grad": grad, "outputs": outputs,
                         "image_grad": image_grad[0].sqrt().cpu().tolist() if image_grad else None,
                         "p3": {n: p.detach().to("cpu", copy=True) for n, p in params.items()},
                         "ema3": ({n: self.state.ema_params[n].to("cpu", copy=True) for n in params}
                                  if self.state.ema_params is not None else None)}
        for _ in range(WARM):
            self.step()
        self.sync()

    def step(self):
        metrics = self.step_fn(self.state, self.pool[self.k % len(self.pool)])
        self.k += 1
        return metrics

    def window(self, seconds: float) -> Dict[str, float]:
        self.sync()
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            self.step()
            n += 1
        self.sync()
        dt = time.perf_counter() - t0
        self.images_per_s = n * self.batch / dt
        peak = torch.cuda.max_memory_allocated(self.device) - self.held if self.device.type == "cuda" else 0
        self.attempted = n
        return {"train_img_per_s": self.images_per_s, "train_peak_gib": peak / 2 ** 30}

    def traced(self) -> trace.Trace:
        tr = trace.traced_stretch(self.step, int(self.cell.traffic["trace_steps"]), trace.Recorder())
        flops = port.flops_per_image(self.cell.config, self.batch, self.image, train=True)
        tr.run = {"images_per_s": self.images_per_s, "flops_per_image": flops,
                  "peak_flops": PEAK_FLOPS["bfloat16" if self.t["amp"] else "float32"], "batch": self.batch}
        return tr

    def release(self) -> None:
        del self.model, self.state, self.step_fn
        port.free_device()

    def reference_side(self, weights, control: Optional[str] = None) -> Dict:
        """The reference's three steps from the seed's weights: its losses,
        first gradient, change and EMA change, per leaf under the port's
        names, its first step's outputs and the gradient at them image by
        image. ``control`` "fp8" runs every convolution and product as fp8
        training does (e4m3 operands forward, e5m2 gradients backward, a
        scale per tensor); "half" plants a fault: each step forwards its
        whole batch, and its gradient comes from the first half
        (``half_batch_gradient``)."""
        c = self.cell.config
        ref_mod, ref = port.build_reference(c, weights, self.device)
        ref.train()
        fp8 = control == "fp8"
        set_quant(ref, fp8_e4m3 if fp8 else identity, fp8_e5m2_grad if fp8 else identity)
        port.tf32_off()
        named = [(n, p) for n, p in ref.named_parameters()]
        trainable = [(n, p) for n, p in named if p.requires_grad]
        sgd = SGD(trainable, c["solver"])
        ema = {n: p.detach().clone() for n, p in named} if c["ema"]["enable"] else None
        start, losses, outputs, image_grad = int(self.t["start_step"]), [], {}, []
        fault = half_batch_gradient if control == "half" else (lambda *a: contextlib.nullcontext())
        for i in range(FOLLOWED):
            for _, p in trainable:
                p.grad = None
            first = i == 0
            with _catch_outputs(ref.module, self.outputs_modules if first else [], outputs, str(self.device)), \
                    _catch_image_grads(ref.module, self.grad_modules if first else [], self.batch, image_grad), \
                    fault(ref.module, self.grad_modules, self.batch):
                out = ref.losses(self.pool[i], self.seed, start + i)
            out["total_loss"].backward()
            sgd.step(learning_rate(c["solver"], start + i))
            if i == 0:
                grad = _norms(sgd.buf)
            if ema is not None:
                ema_update(ema, named, c["ema"], start + i, c["solver"]["total_iters"])
            losses.append(float(out["total_loss"].detach()))
        name = ref_mod.port_name
        side = {"losses": losses, "grad": {name(n): g for n, g in grad.items()},
                "update": {name(n): v for n, v in _norms({n: p.detach() - weights[n] for n, p in trainable}).items()}}
        if ema is not None:
            side["ema_move"] = {name(n): v for n, v in _norms({n: ema[n] - weights[n] for n, _ in trainable}).items()}
        if self.outputs_modules:
            side["outputs"] = outputs
        if image_grad:
            side["image_grad"] = image_grad[0].sqrt().cpu().tolist()
        del ref, sgd, ema
        port.free_device()
        return side

    def program_side(self, weights, ref_mod) -> Dict:
        f = self.followed
        inv = {ref_mod.port_name(n): n for n in weights}
        side = {"losses": f["losses"], "grad": f["grad"], "outputs": f["outputs"], "image_grad": f["image_grad"],
                "update": _norms({n: p.to(self.device) - weights[inv[n]] for n, p in f["p3"].items()})}
        if f["ema3"] is not None:
            side["ema_move"] = _norms({n: f["ema3"][n].to(self.device) - weights[inv[n]] for n in f["p3"]})
        return side

    def readings(self, control: Optional[str] = None) -> Dict[str, float]:
        """The check's numbers: the program's three steps against the
        reference's, or, with ``control``, the reference in that numerics
        put in the program's place."""
        weights = port.seeded_weights(self.cell.config, self.seed, self.device)
        ref_mod = port.manifest.reference_module(self.cell.config)
        prog = self.program_side(weights, ref_mod) if control is None else self.reference_side(weights, control)
        ref = self.reference_side(weights)
        return check.train_readings(prog, ref)
