"""CTC training as a job feeds it: ``CTCTrainer.train_step`` on a pool of
host batches, back to back; each step uploads its batch.

Set-up builds one trainer and its state, loads the seed's weights, and
drives it through its first three steps on the pool's first three batches
(every row different), recording what the check compares (``_recorded``):
the frontend's output and the logits of the first step (a forward hook on
the model), each step's loss, the first gradient per leaf as the
optimizer got it (the change of Adam's first moment over the step, over
1 - b1, unclipped by the step's reported norm) and the change of every
leaf over the three steps. Further steps warm each bucket's shapes twice;
then the same state goes into the window. Once the window has closed,
``record`` drives the same state through three more steps on the pool's
next three batches and records them the same way, with a copy of the
state they start from: the check's second stage, on the warm path.
"""

from __future__ import annotations

import time
from collections import Counter

import torch

from benchmark.core import files, weights
from benchmark.loops.common import batch_meta, program_config, sync

B1 = 0.9


class Loop:
    kind = "train"

    def __init__(self, conf: dict, work: dict, seed: int, device):
        self.conf, self.work, self.seed, self.dev = conf, work, int(seed), torch.device(device)

    def setup(self) -> None:
        from uasr_torch import train

        self.cfg = program_config(self.conf, self.seed)
        gen = files.module("traffic", self.work["traffic"]["kind"])
        self.pool = gen.generate(self.work["traffic"], self.seed)
        self.metas = [batch_meta(b, self.conf) for b in self.pool]
        self.trainer = train.CTCTrainer(self.cfg, device=self.dev)
        self.state = self.trainer.init_state()
        shapes = {k: tuple(p.shape) for k, p in self.state.params.items()}
        self.w0 = weights.draw(shapes, self.seed, self.dev, self.conf["weights"])
        audio, alen = (torch.as_tensor(x, device=self.dev) for x in self.pool[0][:2])
        weights.blank_bias(self.w0, self.conf, audio, alen.long())
        weights.load_into(self.trainer.model, self.w0)
        self.out = self._recorded(0)
        del self.out["start"]  # the reference starts from the seed's weights
        # warm every bucket's shapes twice
        runs = Counter(m["L"] for m in self.metas[:3])
        i = 3
        while min(runs[m["L"]] for m in self.metas) < 2:
            self._step(i)
            runs[self.metas[i % len(self.pool)]["L"]] += 1
            i += 1
        sync(self.dev)
        self.next = i

    def _recorded(self, first: int) -> dict:
        """Three steps on the pool's batches ``first`` to ``first + 2``,
        recorded for the check, with a copy of the state they start from."""
        st = self.state
        start = {"params": {k: p.detach().clone() for k, p in st.params.items()},
                 "mu": {k: m.clone() for k, m in st.opt_state["mu"].items()},
                 "nu": {k: v.clone() for k, v in st.opt_state["nu"].items()},
                 "count": int(st.opt_state["count"]), "step": int(st.step), "first": first}
        seen = []
        hook = self.trainer.model.register_forward_hook(
            lambda m, inp, out: seen.append((inp[0], inp[1], out[0].detach(), out[1])))
        out = {"loss": [], "start": start}
        for i in range(3):
            self.state, aux = self.trainer.train_step(self.state,
                                                      self.pool[(first + i) % len(self.pool)])
            out["loss"].append(float(aux["loss"]))
            if i == 0:
                hook.remove()
                out["feats"], out["feat_len"], out["logits"], out["enc_len"] = seen[0]
                # the gradient the optimizer got: its clipped image in the
                # step's change of Adam's first moment, scaled back by the
                # norm the step reports
                mu, mu0 = self.state.opt_state["mu"], start["mu"]
                scale = max(float(aux["grad_norm"]) / self.cfg.train.grad_clip, 1.0)
                out["grad"] = {k: float((mu[k] - B1 * mu0[k]).norm()) / (1 - B1) * scale
                               for k in mu}
        out["change"] = {k: float((p.detach() - start["params"][k]).norm())
                         for k, p in self.state.params.items()}
        return out

    def record(self) -> None:
        """The check's second stage: three steps after the window."""
        self.warm = self._recorded(self.next)
        self.next += 3

    def _step(self, i: int):
        self.state, aux = self.trainer.train_step(self.state, self.pool[i % len(self.pool)])
        return aux["loss"]

    def run(self, seconds: float | None = None, calls: int | None = None) -> dict:
        """Steps back to back for ``seconds`` (or ``calls`` steps); the
        window ends when the device has finished the last one."""
        losses, done = [], []
        sync(self.dev)
        t0 = time.perf_counter()
        while True:
            losses.append(self._step(self.next))
            done.append(self.metas[self.next % len(self.pool)])
            self.next += 1
            if calls is not None and len(done) >= calls:
                break
            if calls is None and time.perf_counter() - t0 >= seconds:
                break
        sync(self.dev)
        wall = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        audio = sum(m["audio_s"] for m in done)
        return {"wall_s": wall, "calls": done, "attempted": len(done), "failed": failed,
                "e2e": {"train_audio_s_per_s": audio / wall},
                "notes": f"{len(done)} steps, {audio:.1f} audio-s in {wall:.3f} s"}

    def release(self) -> None:
        for k in ("trainer", "state"):
            setattr(self, k, None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
