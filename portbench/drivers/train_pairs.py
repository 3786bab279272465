"""Driver of the two-view fine-tuning cells: the MASt3R matcher trained on
view pairs by the port's step.

Set-up draws the weights on the device from the seed (float32 master
weights), builds the port's `TwoViewMatcher`, `init_train_state` (torch's
fused AdamW: the foreach update's host work at each step's end matched the
card's, so the card's step waited on a busy host) and `make_train_step`
with the pair objective (`parallel/pair_loss.py`), makes
the traffic's pool of pairs on the device (`gen/view_pairs.py`), and
drives that one step object through its first three steps, on three
batches of distinct pairs: they warm every shape the window uses and are
the steps the reference follows. K2's launch counters are read over the
third. The window then runs whole steps over the pool until `--seconds`
have passed. Each step's time is the interval between CUDA events
recorded at consecutive step ends, read after the window. Both views of a
pair are encoded, decoded and supervised, so a step takes 2 x pairs
images.

`correct`: the plain reference (float32, TF32 off, `reference/
train_pairs.py`) takes the same weights and the same three batches, in
micro-batches of pairs, through its own loss and AdamW, and the readings
are compared as `drivers/train.py` compares them: each step's loss
(`loss_gap`), the first gradient (`grad_gap`) and each parameter's change
over the three steps (`change_gap`).
"""

from __future__ import annotations

import contextlib
import gc
import math
import time

import torch

from common import checks, weights
from common.trace import Window
from drivers.train import FAULTS, as_f32
from gen import view_pairs

COMPARED_STEPS = 3


def reference_model(cfg: dict, device):
    """The reference matcher, float32, its parameters uninitialised."""
    from reference.matcher import MatcherConfig, TwoViewMatcher

    grid = cfg["image_size"] // cfg["published"]["patch_size"]
    with torch.device("meta"):
        model = TwoViewMatcher(as_f32(getattr(MatcherConfig, cfg["matcher"])()), (grid, grid))
    return model if device == "meta" else model.to_empty(device=device)


def draw_weights(cfg: dict, seed: int, device) -> dict:
    """`common/weights.py`'s recipe, the heads' last convolution (`head_c3`,
    points and confidence through `exp`) drawn `head_c3_scale` times as
    wide (the configuration's `assumed`)."""
    rec = [(name, shape, kind, scale * cfg["head_c3_scale"]
            if name.endswith("head_c3.weight") else scale)
           for name, shape, kind, scale in weights.recipe(reference_model(cfg, "meta"), 1.0)]
    return weights.draw(rec, seed, device)


def make_pool(cfg: dict, traffic: dict, seed: int, device) -> tuple:
    return view_pairs.make(traffic, cfg["image_size"], cfg["batch_pairs"], cfg["matches"],
                           seed + 1, device)


def k2_counts() -> tuple[int, int]:
    from labelany3d_tpu_torch.ops import attention

    return attention.FLASH_LAUNCHES.count, attention.FLASH_BACKWARD_LAUNCHES.count


class Program:
    """The system under test: the port's train step over a pool of pairs."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, fault: str | None = None):
        from labelany3d_tpu_torch.models.matcher import MatcherConfig, TwoViewMatcher
        from labelany3d_tpu_torch.parallel.pair_loss import pair_objective
        from labelany3d_tpu_torch.parallel.train import init_train_state, make_train_step

        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg, self.device, self.fault = cfg, device, fault
        self.batch = cfg["batch_pairs"]
        grid = cfg["image_size"] // cfg["published"]["patch_size"]
        self.start = draw_weights(cfg, seed, device)
        with torch.device("meta"):
            model = TwoViewMatcher(getattr(MatcherConfig, cfg["matcher"])(), (grid, grid))
        model = model.to_empty(device=device)
        model.load_state_dict(self.start)
        self.model = model
        self.state, self.opt = init_train_state(model, learning_rate=cfg["learning_rate"],
                                                fused=True)
        self.step_fn = make_train_step(model, self.opt, objective=pair_objective)
        self.pool = make_pool(cfg, traffic, seed, device)
        n = self.pool[0].shape[0] // self.batch
        if n < COMPARED_STEPS:
            raise ValueError(f"a pool of {self.pool[0].shape[0]} pairs holds fewer than "
                             f"{COMPARED_STEPS} batches of {self.batch}")
        self.n_batches = n
        self.k = 0
        self.k2_per_step = (0, 0)

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
        state after one step, and each parameter's change after three; K2's
        launches over the last."""
        b1 = self.opt.param_groups[0]["betas"][0]
        losses, grad = [], None
        for i in range(COMPARED_STEPS):
            if i == COMPARED_STEPS - 1:
                fwd, bwd = k2_counts()
            losses.append(self.step())
            if grad is None:
                grad = [self.opt.state[p]["exp_avg"].detach() / (1 - b1)
                        for p in self.model.parameters()]
        fwd1, bwd1 = k2_counts()
        self.k2_per_step = (fwd1 - fwd, bwd1 - bwd)
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
    from reference.train_pairs import run_steps

    model = reference_model(cfg, device)
    model.load_state_dict(draw_weights(cfg, seed, device))
    model.requires_grad_(True)
    b = cfg["batch_pairs"]
    pool = make_pool(cfg, traffic, seed, device)
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
    return {"loss_gap": max(losses) if all(map(math.isfinite, losses)) else math.nan,
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
    fwd, bwd = prog.k2_per_step
    notes = [f"K2 launches a warm step: {fwd} forward, {bwd} backward"]
    cuda = dev.type == "cuda"
    ends, host_ends = [], []
    with Window(opts.trace, dev) as win:
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        steps = 0
        while True:
            with win.span("train.step"):
                loss = prog.step()
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
    pairs = steps * prog.batch
    notes.append(f"window: {steps} steps of {prog.batch} pairs in {win.seconds:.6f} s; "
                 f"its last loss {float(loss):.6g}")
    prog.free()
    if opts.control:  # tools/controls.py: the reference one precision down stands in
        del got
        got = reference_readings(cfg, traffic, opts.seed, dev, precision=opts.control)
    want = reference_readings(cfg, traffic, opts.seed, dev)
    readings = compare(got, want)
    del got, want
    metrics = {"setup_s": setup_s, "train_images_per_s": 2 * pairs / win.seconds,
               "train_step_p90_ms": checks.percentile(step_ms, 90)}
    return checks.Result(metrics=metrics, checks=checks.held(readings, cfg["limits"]),
                         attempted=steps, failed=0, memory_peak_bytes=peak, window=win,
                         counts={"steps": steps, "pairs": pairs, "images": 2 * pairs,
                                 "batch_pairs": prog.batch, "k2_forward_per_step": fwd,
                                 "k2_backward_per_step": bwd},
                         notes=notes)
