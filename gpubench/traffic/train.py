"""Traffic kind ``train``: ``StyleGAN.train_on_batch(images, depth,
alpha, fetch=False)`` of the trainer ``cli/train.py::build_trainer``
makes from the configuration, update after update.

``pool`` host batches of full-resolution reals, uniform in [-1, 1], are
made on the device from the run seed and pinned on the host; update k
takes batch (k - 1) mod pool.  The first three updates run in set-up
through the window's own call on the same trainer; their losses, the
first update's gradients and the three updates' change are read for the
check, which the reference follows on the same inputs after the window.
The window then takes the following updates and closes with a device
synchronize.

Parameters (the traffic file): ``batch``, ``depth``, ``alpha``,
``pool``, ``trace_from`` and ``trace_units``.
"""

from __future__ import annotations

import time

import torch

from gpubench import check, controls, counts, drive, program
from gpubench import weights as wts
from gpubench.reference import draws
from gpubench.reference import train as ref_train

CHECK_STEPS = 3


class Program:
    """The port's trainer over the configuration, its weights the run's."""

    def __init__(self, config, traffic, weights: dict, seed: int, device):
        from stylegan_torch.cli.train import build_trainer
        self.gan = build_trainer(program.run_config(config, seed), device)
        s = self.gan.state
        g, d = wts.split(weights, "g"), wts.split(weights, "d")
        s.generator.load_state_dict(g, strict=True)
        s.discriminator.load_state_dict(d, strict=True)
        if s.g_shadow is not None:
            s.g_shadow.load_state_dict(g, strict=True)
        self.depth, self.alpha = traffic["depth"], traffic["alpha"]

    def step(self, images):
        """One update; returns the (d_loss, g_loss) device tensors."""
        return self.gan.train_on_batch(images, self.depth, self.alpha,
                                       fetch=False)

    def named(self, which: str) -> dict:
        s = self.gan.state
        module = {"g": s.generator, "d": s.discriminator,
                  "shadow": s.g_shadow}[which]
        return dict(module.named_parameters())

    def first_grads(self, which: str) -> dict:
        """The gradient the optimizer took on its first step, from its
        state: Adam's first moment over (1 - beta1)."""
        s = self.gan.state
        opt = s.g_optimizer if which == "g" else s.d_optimizer
        b1 = opt.param_groups[0]["betas"][0]
        return {name: opt.state[p]["exp_avg"] / (1.0 - b1)
                for name, p in self.named(which).items()}


class Load:
    family = "train"

    def __init__(self, prog_cls, cell, seed: int, device, ranks=None):
        drive.single(ranks)
        self.cell, self.seed, self.device = cell, seed, device
        self.arch = cell.config["architecture"]
        t = cell.traffic
        self.batch = t["batch"]
        self.dtype = drive.dtype(cell.config)
        self.weights = wts.make(self.arch, seed, device)
        res = self.arch["resolution"]
        g = torch.Generator(device=device).manual_seed(
            draws.stream(seed, drive.REALS_STREAM))
        pool = torch.rand((t["pool"], self.batch, res, res,
                           self.arch["num_channels"]), generator=g,
                          device=device).mul_(2).sub_(1)
        self.pool = [b.cpu().pin_memory() if torch.device(device).type ==
                     "cuda" else b.cpu() for b in pool]
        del pool
        self.prog = None if prog_cls is None else prog_cls(
            cell.config, t, self.weights, seed, device)
        o = cell.config["overlay"]
        self.interval = int(o.get("r1_interval", 1))
        self.gamma = float(o.get("r1_gamma", 10.0))
        self.updates = 0
        self.losses = []
        self.measured = None

    def _with_r1(self, k: int) -> bool:
        """Whether update k (from 1) carries R1 (lazy R1: every
        interval-th update, from the first)."""
        return (k - 1) % self.interval == 0

    def _gamma(self, k: int) -> float:
        """R1's weight on update k (lazy R1 scales it by the interval)."""
        return self.gamma * self.interval if self._with_r1(k) else 0.0

    def _flops(self, k: int):
        f = counts.train_image(self.arch, self._with_r1(k))
        return (f[0] * self.batch, f[1] * self.batch)

    def step(self):
        images = self.pool[self.updates % len(self.pool)]
        self.updates += 1
        with drive.span("gpubench.step"):
            return self.prog.step(images)

    def warm(self):
        """The first three updates, read for the check."""
        losses = [self.step()]
        grads = {n: check.norms(self.prog.first_grads(n)) for n in "gd"}
        for _ in range(CHECK_STEPS - 1):
            losses.append(self.step())
        start = {"g": wts.split(self.weights, "g"),
                 "d": wts.split(self.weights, "d")}
        start["shadow"] = start["g"]
        with torch.no_grad():
            change = {n: check.change_norms(self.prog.named(n), start[n])
                      for n in ("g", "d", "shadow")}
        self.measured = {"losses": [(float(d), float(g)) for d, g in losses],
                         "grads": grads, "change": change}

    def window(self, run, seconds: float, tracer=None):
        first = self.updates
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            if tracer:
                tracer.before(i)
            self.losses.append(self.step())
            if tracer:
                tracer.after(i)
            i += 1
        drive.sync(self.device)
        run.window_s = time.perf_counter() - t0
        run.units, run.images = i, i * self.batch
        run.unit_flops = [self._flops(first + j + 1) for j in range(i)]
        if self.losses:
            finite = torch.isfinite(torch.stack(
                [torch.stack(x) for x in self.losses]).float()).all(1)
            run.failed = int((~finite).sum())

    def release(self):
        del self.prog
        self.prog = None

    def reference(self, lower=None, half=False) -> dict:
        """The reference's first three updates on the same inputs; with
        `lower`, computed one precision below the configuration's (the
        control); with `half`, on the first half of each batch (a planted
        fault)."""
        q, tf32 = controls.lower(lower)
        o = self.cell.config["overlay"]
        opt = {"g_optim": o["model"]["g_optim"],
               "d_optim": o["model"]["d_optim"],
               "ema_decay": o["ema_decay"]}
        t = self.cell.traffic
        with drive.precise(tf32):
            ref = ref_train.Trainer(self.arch, opt, self.weights, q)
            zs = draws.ZStream(self.seed, self.device)
            losses = []
            for k in range(1, CHECK_STEPS + 1):
                reals = self.pool[k - 1].to(self.device).permute(0, 3, 1, 2)
                reals = reals.to(self.dtype).float()
                z = zs.draw(self.batch, self.arch["latent_size"], self.dtype)
                if half:
                    reals, z = reals[:self.batch // 2], z[:self.batch // 2]
                d, g, gg, dg = ref.step(reals, z, draws.step_seed(self.seed, k),
                                        t["depth"], t["alpha"], self._gamma(k),
                                        self.dtype)
                losses.append((d, g))
                if k == 1:
                    grads = {"g": check.norms(gg), "d": check.norms(dg)}
            start = {"g": wts.split(self.weights, "g"),
                     "d": wts.split(self.weights, "d")}
            change = {"g": check.change_norms(ref.g, start["g"]),
                      "d": check.change_norms(ref.d, start["d"]),
                      "shadow": check.change_norms(ref.shadow, start["g"])}
        return {"losses": losses, "grads": grads, "change": change}

    def numbers(self) -> dict:
        return check.train_numbers(self.measured, self.reference())


def readings(cell, seed, device):
    """The control and the half-batch fault against the reference."""
    load = Load(None, cell, seed, device)
    ref = load.reference()
    return {"control": check.train_numbers(
                load.reference(controls.for_config(cell.config)), ref),
            "half_batch": check.train_numbers(load.reference(half=True),
                                              ref)}
