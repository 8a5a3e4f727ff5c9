"""Fault-tolerant training loop.  The JAX package's
``repro.training.train_loop``, in PyTorch.

* the train step of ``launch.steps.build_train_step`` (remat-able, grad-
  accumulation-able), run eagerly on the Trainer's device;
* async double-buffered checkpoints through the snapshot substrate;
* a restart path with REAP-accelerated restore;
* a deterministic data order keyed by (step, rank), so a restart sees
  each batch exactly once;
* a preemption hook for the fault-tolerance tests.

The fresh state is ``launch.steps.init_params(cfg, seed, device)``: the
bytes ``host_initialize`` writes into a snapshot.  (The JAX Trainer
draws its fresh params from ``jax.random``, which the port cannot
reproduce; a restored run carries the checkpoint's values either way.)
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..configs.base import ModelConfig
from ..data.pipeline import PrefetchLoader, TokenDataset
from ..device import device_of
from ..launch import steps as steps_lib
from . import optimizer as opt_lib
from .checkpoint import AsyncCheckpointer, restore_checkpoint


class SimulatedPreemption(Exception):
    """Raised by the preemption hook to model a node loss."""


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 50
    checkpoint_every: int = 10
    batch_size: int = 4
    seq_len: int = 64
    remat: bool = False
    restore_mode: str = "reap"  # lazy | reap
    log_every: int = 10


class Trainer:
    def __init__(self, cfg: ModelConfig, opt: opt_lib.OptConfig,
                 loop: TrainLoopConfig, corpus_path: str, ckpt_dir: str,
                 *, preempt_at: int | None = None, device="cuda"):
        self.cfg, self.opt, self.loop = cfg, opt, loop
        self.device = device_of(device)
        self.dataset = TokenDataset(corpus_path, loop.seq_len)
        self.ckpt = AsyncCheckpointer(ckpt_dir)
        self.preempt_at = preempt_at
        self.step_fn = steps_lib.build_train_step(cfg, opt, remat=loop.remat)
        self.restore_stats: dict | None = None
        #: the losses of the last ``run``, also when a preemption cut it
        self.losses: list[float] = []

    def _fresh_state(self, seed: int = 0):
        params = steps_lib.init_params(self.cfg, seed, self.device)
        return params, opt_lib.init_state(params, self.opt)

    def _resume_or_init(self):
        base = self.ckpt.latest()
        params, opt_state = self._fresh_state()
        if base is None:
            return params, opt_state, 0
        params, opt_state, step, stats = restore_checkpoint(
            base, params, opt_state, mode=self.loop.restore_mode)
        self.restore_stats = stats
        return params, opt_state, step

    def run(self) -> dict:
        params, opt_state, start = self._resume_or_init()
        losses = self.losses = []
        loader = PrefetchLoader(self.dataset, self.loop.batch_size,
                                start_step=start)
        t0 = time.perf_counter()
        try:
            step = start
            while step < self.loop.total_steps:
                got_step, tokens = next(loader)
                if got_step != step:
                    raise RuntimeError(f"loader gave step {got_step}, want {step}")
                batch = self._make_batch(tokens)
                params, opt_state, metrics = self.step_fn(params, opt_state, batch)
                losses.append(float(metrics["loss"]))
                step += 1
                if step % self.loop.checkpoint_every == 0:
                    self.ckpt.save(params, opt_state, step)
                if self.preempt_at is not None and step >= self.preempt_at:
                    self.preempt_at = None
                    raise SimulatedPreemption(f"preempted at step {step}")
        finally:
            loader.close()
            self.ckpt.wait()
        return {
            "final_step": step,
            "losses": losses,
            "seconds": time.perf_counter() - t0,
            "restore_stats": self.restore_stats,
        }

    def _make_batch(self, tokens) -> dict:
        """The loader's tokens on the device, with the zero patch embeddings
        (a VLM) or frames (an encoder-decoder) of the JAX package."""
        batch = {"tokens": torch.as_tensor(tokens, device=self.device)}
        if self.cfg.family == "vlm":
            b = tokens.shape[0]
            batch["patch_embeds"] = torch.zeros(
                (b, self.cfg.n_patches, self.cfg.d_model), dtype=torch.bfloat16,
                device=self.device)
        elif self.cfg.family == "encdec":
            b, s = tokens.shape
            batch["frames"] = torch.zeros(
                (b, max(s // self.cfg.frame_stride, 1), self.cfg.d_model),
                dtype=torch.bfloat16, device=self.device)
        return batch
