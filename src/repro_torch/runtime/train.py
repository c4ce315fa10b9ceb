"""Fault-tolerant training runtime.

The port of the reference package's ``runtime/train.py`` on one device:

- **checkpoint/restart** — periodic async snapshots of the state tree
  ``{"params", "opt": {"m", "v", "step"}, "err"}`` in the reference's
  layout (``checkpoint/sharded.py``); ``Trainer.run`` resumes from the
  latest committed checkpoint after any crash, replaying the data stream
  deterministically;
- **failure injection** — ``FailureInjector`` raises ``SimulatedFailure``
  at configured steps;
- **straggler detection** — an EWMA + deviation detector on the step's
  wall time; flagged steps are logged and returned;
- **gradient compression** — optional int8 quantization with error
  feedback (``compressed_grads``); the residual buffer keeps the
  quantization error.

The step is ``launch/steps.make_train_step`` (or, with compression, its
gradient, the int8 round trip and ``adamw.apply``); parameters are drawn
from ``torch.Generator(device).manual_seed(seed)``, so they differ from
the reference's for the same seed: the parity tests start both from one
checkpoint.  The train state of granite_3_2b is 42.1 GB (parameters,
moments and gradients in float32), and ``ckpt_every = 0`` writes no
checkpoint at all.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch

from repro_torch.checkpoint.sharded import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.models import model as mdl
from repro_torch.models.blocks import init_params, tree_map
from repro_torch.optim import adamw


class SimulatedFailure(RuntimeError):
    """Injected node failure (testing the restart path)."""


@dataclasses.dataclass
class FailureInjector:
    fail_at_steps: tuple = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


class StragglerDetector:
    """EWMA step-time monitor: a step slower than mean + k*dev is a
    straggler signal."""

    def __init__(self, alpha: float = 0.2, k: float = 3.0, warmup: int = 5):
        self.alpha = alpha
        self.k = k
        self.warmup = warmup
        self.mean = 0.0
        self.dev = 0.0
        self.n = 0
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            self.mean = dt if self.n == 1 else (
                self.mean + (dt - self.mean) / self.n)
            self.dev = max(self.dev, abs(dt - self.mean))
            return False
        is_straggler = dt > self.mean + self.k * max(self.dev, 1e-9)
        self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
        self.dev = (1 - self.alpha) * self.dev + self.alpha * abs(
            dt - self.mean)
        if is_straggler:
            self.flagged.append((step, dt))
        return is_straggler


# ------------------------------------------------- gradient compression

def int8_compress(g, scale_dtype=torch.float32):
    """Per-tensor symmetric int8 quantization: ``(q, scale)``.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    amax = torch.clamp(torch.max(torch.abs(g)), min=1e-12)
    scale = (amax / 127.0).to(scale_dtype)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q, scale):
    return q.float() * scale


def compressed_grads(grads, error):
    """Error-feedback int8 round trip: ``(g_hat, new_error)``, trees like
    ``grads``.  On the wire ``q`` (1 byte a parameter) is what a
    data-parallel reduce would move; the error buffer re-injects the
    quantization noise next step."""
    def one(g, e):
        target = g + e
        g_hat = int8_decompress(*int8_compress(target))
        return g_hat, target - g_hat

    pairs = tree_map(one, grads, error)
    return (tree_map(lambda pair: pair[0], pairs),
            tree_map(lambda pair: pair[1], pairs))


# ------------------------------------------------------------- trainer

@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20                  # 0: no checkpoint at all
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 2
    accum_steps: int = 1
    grad_compression: str = "none"        # none | int8_ef
    log_every: int = 10
    seed: int = 0
    fail_at_steps: tuple = ()


def check_pipeline_inputs(cfg: ArchConfig) -> None:
    """Raise for a model that takes inputs the data pipeline does not
    carry.  ``Pipeline`` gives ``tokens``, ``targets`` and ``loss_mask``,
    as the reference's does; an encoder-decoder also needs ``frames`` and
    a VLM ``vision_embed``, so the reference's ``Trainer`` fails on them
    at its first step.  ``launch/steps.make_train_step`` trains them on a
    batch that holds those inputs (``steps.batch_structs``)."""
    need = [name for name, used in (("frames", cfg.enc_layers > 0),
                                    ("vision_embed", cfg.vision_prefix > 0))
            if used]
    if need:
        raise NotImplementedError(
            f"{cfg.name}: the Trainer's data pipeline carries only tokens, "
            f"targets and loss_mask (as the reference's does), not "
            f"{' or '.join(need)}; train it through "
            f"launch/steps.make_train_step on a batch that holds them")


class Trainer:
    """The reference's ``Trainer`` on one device (``cuda`` by default,
    which needs a card; ``device="cpu"`` runs the kernels' plain
    versions).  It trains every configuration whose inputs are tokens
    alone, and raises for the encoder-decoder and the VLM
    (``check_pipeline_inputs``)."""

    def __init__(self, cfg: ArchConfig, data_cfg: DataConfig,
                 tcfg: TrainerConfig, opt_cfg: adamw.AdamWConfig | None = None,
                 log: Callable[[str], None] = print, *, device="cuda"):
        self.device = resolve_device(device)
        check_pipeline_inputs(cfg)
        if tcfg.grad_compression not in ("none", "int8_ef"):
            raise ValueError(f"grad_compression {tcfg.grad_compression!r}")
        self.cfg = cfg
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or adamw.AdamWConfig()
        self.pipeline = Pipeline(data_cfg)
        self.log = log
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.injector = FailureInjector(tcfg.fail_at_steps)
        self.straggler = StragglerDetector()
        self.defs = mdl.model_defs(cfg)
        self._build_step()
        self.params = None
        self.opt_state = None
        self.err = {}
        self.step = 0
        self.history: list[dict] = []

    # ------------------------------------------------------------ build

    def _build_step(self):
        cfg, dev = self.cfg, self.device
        base = steps_mod.make_train_step(
            cfg, self.opt_cfg, accum_steps=self.tcfg.accum_steps, device=dev)
        if self.tcfg.grad_compression == "none":
            def step_fn(params, opt_state, err, batch):
                p, o, m = base(params, opt_state, batch)
                return p, o, err, m
        else:
            opt_cfg = self.opt_cfg

            def step_fn(params, opt_state, err, batch):
                grads = tree_map(torch.zeros_like, params)
                metrics = steps_mod.accumulate_grads(params, batch, cfg,
                                                     grads, device=dev)
                grads, err = compressed_grads(grads, err)
                params, opt_state, om = adamw.apply(
                    opt_cfg, params, opt_state, grads)
                return params, opt_state, err, {**metrics, **om}
        self.step_fn = step_fn

    # ------------------------------------------------------------ state

    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        self.params = init_params(self.defs, gen)
        self.opt_state = adamw.init(self.params)
        self.err = tree_map(torch.zeros_like, self.params) \
            if self.tcfg.grad_compression != "none" else {}
        self.step = 0

    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state,
                "err": self.err}

    def maybe_restore(self) -> bool:
        """Restore the latest committed checkpoint if one exists."""
        if self.ckpt.latest_step() is None:
            return False
        if self.params is None:
            self.init_state()
        tree, step, meta = self.ckpt.restore(self._state_tree())
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.err = tree["err"]
        self.step = step
        self.log(f"[trainer] restored step {step} "
                 f"(loss was {meta.get('loss')})")
        return True

    # ------------------------------------------------------------- run

    def run(self, *, resume: bool = True) -> dict:
        if not (resume and self.maybe_restore()):
            if self.params is None:
                self.init_state()
        t = self.tcfg
        while self.step < t.total_steps:
            self.injector.check(self.step)
            batch = self.pipeline.batch_at(self.step)
            t0 = time.time()
            self.params, self.opt_state, self.err, metrics = self.step_fn(
                self.params, self.opt_state, self.err, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            slow = self.straggler.observe(self.step, dt)
            self.history.append({"step": self.step, "loss": loss,
                                 "dt": dt, "straggler": slow})
            if self.step % t.log_every == 0:
                self.log(f"[trainer] step {self.step} loss {loss:.4f} "
                         f"({dt * 1e3:.0f} ms{' STRAGGLER' if slow else ''})")
            self.step += 1
            if t.ckpt_every and (self.step % t.ckpt_every == 0
                                 or self.step == t.total_steps):
                self.ckpt.save(self.step, self._state_tree(),
                               meta={"loss": loss})
        self.ckpt.wait()
        return {"final_loss": self.history[-1]["loss"],
                "history": self.history,
                "stragglers": self.straggler.flagged}
