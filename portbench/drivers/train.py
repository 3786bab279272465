"""Driver of the fine-tuning cells: MoGe trained by the port's step.

Set-up draws the weights on the device from the seed (float32 master
weights), builds the port's `MoGeModel`, `init_train_state` and
`make_train_step`, makes the traffic's pool of scenes on the device, and
drives that one step object through its first three steps, on three
batches of distinct rows: they warm every shape the window uses and are
the steps the reference follows. The window then runs whole steps over the
pool until `--seconds` have passed. Each step's time is the interval
between CUDA events recorded at consecutive step ends, read after the
window.

`correct`: the plain reference (float32, TF32 off) takes the same weights
and the same three batches through its own loss and AdamW. Compared, each
by its gap to the reference: each step's loss (`loss_gap`); the first
gradient as the optimizer holds it after one step (`grad_gap`, from
AdamW's first moment over 1 - b1), and each parameter's change over the
three steps (`change_gap`), both by the worst leaf's norm against the
larger of its reference norm and the median leaf's. Elements whose
reference gradient is under a thousandth of the median leaf's RMS
gradient are left out of the change: Adam moves them by round-off alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import torch

from common import checks, weights
from common.trace import Window
from gen import depth_scenes

COMPARED_STEPS = 3
FAULTS = ("unchanged", "half_batch", "leaf_dropped")


def reference_config(name: str):
    from reference.moge import MoGeConfig

    return as_f32(getattr(MoGeConfig, name)())


def as_f32(cfg):
    """A config with every `dtype` field, nested ones too, set to float32."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            kw[f.name] = torch.float32
        elif dataclasses.is_dataclass(v):
            kw[f.name] = as_f32(v)
    return dataclasses.replace(cfg, **kw)


def reference_model(cfg: dict, device):
    """The reference MoGe, float32, its parameters uninitialised."""
    from reference.moge import MoGeModel

    size = cfg["image_size"]
    with torch.device("meta"):
        model = MoGeModel(reference_config(cfg["moge"]), (size, size))
    return model if device == "meta" else model.to_empty(device=device)


def draw_weights(cfg: dict, seed: int, device) -> dict:
    rec = weights.recipe(reference_model(cfg, "meta"), cfg["layerscale_gamma"])
    return weights.draw(rec, seed, device)


class Program:
    """The system under test: the port's train step over a pool of scenes."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, fault: str | None = None):
        from labelany3d_tpu_torch.models.moge import MoGeConfig, MoGeModel
        from labelany3d_tpu_torch.parallel.train import init_train_state, make_train_step

        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg, self.device, self.fault = cfg, device, fault
        self.batch = cfg["batch_size"]
        size = cfg["image_size"]
        self.start = draw_weights(cfg, seed, device)
        with torch.device("meta"):
            model = MoGeModel(getattr(MoGeConfig, cfg["moge"])(), (size, size))
        model = model.to_empty(device=device)
        model.load_state_dict(self.start)
        self.model = model
        self.state, self.opt = init_train_state(model, learning_rate=cfg["learning_rate"])
        self.step_fn = make_train_step(model, self.opt)
        self.pool = depth_scenes.make(traffic, size, self.batch, seed + 1, device)
        n = self.pool[0].shape[0] // self.batch
        if n < COMPARED_STEPS:
            raise ValueError(f"a pool of {self.pool[0].shape[0]} scenes holds fewer than "
                             f"{COMPARED_STEPS} batches of {self.batch}")
        self.n_batches = n
        self.k = 0

    def batch_rows(self, k: int):
        sl = slice((k % self.n_batches) * self.batch, (k % self.n_batches + 1) * self.batch)
        return tuple(t[sl] for t in self.pool)

    def step(self):
        rows = self.batch_rows(self.k)
        if self.fault == "half_batch":
            rows = tuple(t[:self.batch // 2] for t in rows)
        params = list(self.model.parameters())
        before = params[0].detach().clone() if self.fault == "leaf_dropped" else None
        if self.fault == "unchanged":
            saved = [p.detach().clone() for p in params]
        self.state, loss = self.step_fn(self.state, *rows)
        if self.fault == "unchanged":
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
        elif before is not None:
            with torch.no_grad():
                params[0].copy_(before)
        self.k += 1
        return loss

    def first_steps(self) -> dict:
        """The compared steps: losses, the first gradient from AdamW's
        state after one step, and each parameter's change after three."""
        b1 = self.opt.param_groups[0]["betas"][0]
        losses, grad = [], None
        for _ in range(COMPARED_STEPS):
            losses.append(self.step())
            if grad is None:
                grad = [self.opt.state[p]["exp_avg"].detach() / (1 - b1)
                        for p in self.model.parameters()]
        change = [p.detach() - self.start[name]
                  for name, p in self.model.named_parameters()]
        self.start = None
        return {"losses": [float(x) for x in losses], "grad": grad, "change": change}

    def free(self) -> None:
        self.model = self.state = self.opt = self.step_fn = self.pool = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_readings(cfg: dict, traffic: dict, seed: int, device,
                       precision: str | None = None) -> dict:
    """The reference's first three steps from the same weights and batches
    (the control's with `precision`)."""
    from reference import precision as prec
    from reference.train import run_steps

    model = reference_model(cfg, device)
    model.load_state_dict(draw_weights(cfg, seed, device))
    model.requires_grad_(True)
    b = cfg["batch_size"]
    pool = depth_scenes.make(traffic, cfg["image_size"], b, seed + 1, device)
    batches = [tuple(t[i * b:(i + 1) * b] for t in pool) for i in range(COMPARED_STEPS)]
    del pool
    ctx = prec.lower(precision) if precision else contextlib.nullcontext()
    with ctx:
        out = run_steps(model, batches, cfg["learning_rate"], cfg["reference_micro_batch"])
    del model, batches
    gc.collect()
    return out


def compare(got: dict, want: dict) -> dict:
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], want["losses"])]
    return {"loss_gap": max(losses),
            "grad_gap": checks.norm_gap(got["grad"], want["grad"]),
            "change_gap": checks.norm_gap(got["change"], want["change"],
                                          checks.moving_masks(want["grad"]))}


def run(cell: dict, cfg: dict, traffic: dict, opts) -> checks.Result:
    dev = opts.device
    prog = Program(cfg, traffic, opts.seed, dev, opts.fault)
    got = prog.first_steps()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - opts.t_start
    notes = []
    cuda = dev.type == "cuda"
    ends, host_ends = [], []
    with Window(opts.trace, dev) as win:
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        steps = 0
        while True:
            with win.span("train.step"):
                prog.step()
            steps += 1
            if cuda:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                ends.append(e)
            else:
                host_ends.append(time.perf_counter())
            if win.elapsed() >= opts.seconds:
                break
        win.close()
    if cuda:
        step_ms = [a.elapsed_time(b) for a, b in zip([e0] + ends[:-1], ends)]
        peak = torch.cuda.max_memory_allocated(dev)
    else:
        starts = [win.t0 / 1e9] + host_ends[:-1]
        step_ms = [(b - a) * 1e3 for a, b in zip(starts, host_ends)]
        peak = 0
    images = steps * prog.batch
    notes.append(f"window: {steps} steps of {prog.batch} images in {win.seconds:.6f} s")
    prog.free()
    want = reference_readings(cfg, traffic, opts.seed, dev)
    readings = compare(got, want)
    del got, want
    metrics = {"setup_s": setup_s, "train_images_per_s": images / win.seconds,
               "train_step_p90_ms": checks.percentile(step_ms, 90)}
    return checks.Result(metrics=metrics, checks=checks.held(readings, cfg["limits"]),
                         attempted=steps, failed=0, memory_peak_bytes=peak, window=win,
                         counts={"steps": steps, "images": images, "batch": prog.batch},
                         notes=notes)
