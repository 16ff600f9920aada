"""The QAT trainer loop (port of `opt/trainer.py`, the QATTrainer analog).

A functional loop around `quant.qat.make_optax_train_step`:

 - quantize on the first step: given a bf16 model and a preset, the first
   `calib_batches` batches calibrate it before any gradient step, and then
   train like the rest;
 - the checkpoint cadence: `opt.state.save` (the replayable modelopt state
   and the weights) with `trainer_state.json` every `save_steps`, and at
   the end; `resume()` restores the latest checkpoint and its step;
 - the eval cadence: held-out perplexity (`utils.evaluate.perplexity`)
   through the fake-quant model every `eval_steps`.

Each checkpoint also holds the Adam state (`optimizer.safetensors`), so a
resumed run continues exactly where an uninterrupted one would be. JAX's
trainer saves none and re-initializes Adam on resume (a deliberate
difference: ROADMAP queue 3); a JAX-saved checkpoint resumes here as it
does there, with fresh moments, and JAX reads a port-saved one, ignoring
the extra file.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
from typing import Any, Iterable, Optional

import numpy as np
import torch

from ..models import hf_loader, llama
from ..quant import ptq
from ..quant.qat import Adam, make_optax_train_step
from ..utils import tree as tree_util
from . import state as mto

OPTIMIZER_FILE = "optimizer.safetensors"


@dataclasses.dataclass
class TrainerConfig:
    output_dir: str
    max_steps: int = 1000
    save_steps: int = 200
    eval_steps: int = 100
    learning_rate: float = 1e-4
    train_amax: bool = False  # LSQ: the learn_amax sites' amax train too
    quant_preset: Optional[str] = None  # quantize on the first step if given
    calib_batches: int = 4


class QATTrainer:
    """QAT with checkpoint / resume and an eval cadence, on `device` (the
    params' device)."""

    def __init__(self, cfg: llama.LlamaConfig, params: dict, tcfg: TrainerConfig,
                 eval_batches: Optional[list] = None, optimizer: Optional[Adam] = None, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.eval_batches = eval_batches or []
        self.model: Optional[ptq.QuantizedModel] = None
        self.params = params
        self.device = device if device is not None else params["embed_tokens"].device
        self.step = 0
        self.history: list[dict] = []
        self._optimizer = optimizer or Adam(tcfg.learning_rate)
        self._step_fn = None
        self._init_fn = None
        self._opt_state = None

    def attach_quantized(self, model: ptq.QuantizedModel):
        self.model = model
        self.params = model.params

    def _ensure_quantized(self, first_batches: list):
        if self.model is not None:
            return
        if self.tcfg.quant_preset is None:
            raise ValueError("pass quant_preset or attach a quantized model")
        self.model = ptq.quantize(self.cfg, self.params, self.tcfg.quant_preset,
                                  first_batches[: self.tcfg.calib_batches], device=self.device)

    def _tokens(self, b) -> torch.Tensor:
        t = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.asarray(b))
        return t.to(device=self.device, dtype=torch.int64)

    def train(self, batches: Iterable[Any]) -> ptq.QuantizedModel:
        batches = iter(batches)
        if self.model is None:
            head = list(itertools.islice(batches, self.tcfg.calib_batches))
            self._ensure_quantized([self._tokens(b) for b in head])
            batches = itertools.chain(head, batches)  # the calibration batches train too
        m = self.model
        if self._step_fn is None:
            self._step_fn, self._init_fn = make_optax_train_step(self.cfg, m.layout, self._optimizer,
                                                                 train_amax=self.tcfg.train_amax)
        if self._opt_state is None:
            self._opt_state = self._init_fn(m.params, m.qstate)
        p, qs = m.params, m.qstate
        for toks in batches:
            if self.step >= self.tcfg.max_steps:
                break
            p, qs, self._opt_state, loss = self._step_fn(p, qs, self._opt_state, self._tokens(toks))
            self.step += 1
            if self.tcfg.eval_steps and self.step % self.tcfg.eval_steps == 0:
                self._record_eval(p, qs, float(loss))
            if self.tcfg.save_steps and self.step % self.tcfg.save_steps == 0:
                self._save(p, qs)
        self.model = dataclasses.replace(m, params=p, qstate=qs)
        self.params = p
        self._save(p, qs)
        return self.model

    def _record_eval(self, p, qs, loss: float):
        row = {"step": self.step, "loss": loss}
        if self.eval_batches:
            from ..utils.evaluate import perplexity

            row["ppl"] = perplexity(self.cfg, p, self.eval_batches, layout=self.model.layout, qstate=qs)
        self.history.append(row)

    def _ckpt_dir(self, step: int) -> str:
        return os.path.join(self.tcfg.output_dir, f"checkpoint-{step}")

    def _save(self, p, qs):
        path = self._ckpt_dir(self.step)
        mto.save(dataclasses.replace(self.model, params=p, qstate=qs), path)
        named = {k: v.view(torch.uint16) if v.dtype == torch.bfloat16 else v
                 for k, v in tree_util.flatten_with_names(self._opt_state).items()}
        hf_loader.save_safetensors(named, os.path.join(path, OPTIMIZER_FILE))
        with open(os.path.join(path, "trainer_state.json"), "w") as f:
            json.dump({"step": self.step, "history": self.history}, f)

    def resume(self) -> bool:
        """Restore the latest checkpoint under output_dir; False where there
        is none. Its Adam state comes back where the checkpoint has one."""
        if not os.path.isdir(self.tcfg.output_dir):
            return False
        ckpts = [d for d in os.listdir(self.tcfg.output_dir) if d.startswith("checkpoint-")]
        if not ckpts:
            return False
        path = os.path.join(self.tcfg.output_dir, max(ckpts, key=lambda d: int(d.split("-")[1])))
        self.model = mto.restore(path, device=self.device)
        self.params = self.model.params
        with open(os.path.join(path, "trainer_state.json")) as f:
            st = json.load(f)
        self.step = st["step"]
        self.history = st["history"]
        self._step_fn, self._init_fn = make_optax_train_step(self.cfg, self.model.layout, self._optimizer,
                                                             train_amax=self.tcfg.train_amax)
        self._opt_state = None
        opt_path = os.path.join(path, OPTIMIZER_FILE)
        if os.path.exists(opt_path):
            template = self._init_fn(self.model.params, self.model.qstate)
            raw = hf_loader.SafetensorsDir(opt_path)
            self._opt_state = tree_util.map_pairs(
                lambda t, v: v.view(t.dtype).to(self.device) if t.dtype == torch.bfloat16 else v.to(self.device),
                template, tree_util.unflatten_like(template, {k: raw[k] for k in raw.keys()}))
        return True
