"""WGAN-GP and bce objectives of adversarial phone-sequence training
(counterpart of ``uasr.ops.wgan``).

The critic D consumes distributions over phones (softmax posteriors from
the generator, one-hot vectors for real text), so the generator stays
differentiable end to end. The gradient penalty differentiates through
D's input gradient: ``torch.autograd.grad(create_graph=True)`` keeps that
gradient in the graph, and the critic's parameter gradients come from a
second backward through it.

``disc`` is any callable ``(probs [B, T, V], lengths [B]) -> scores [B]``
(a ``PhoneDiscriminator`` or ``functional_call`` over one). The
interpolation weights ε [B, 1, 1] are drawn from ``generator`` (a
``torch.Generator``; the draw is made on the CPU and moved, so a seed
gives the same ε on every device), or passed in as ``eps``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def draw_eps(batch: int, generator: torch.Generator | None, device) -> torch.Tensor:
    """ε ~ U[0, 1) of shape [batch, 1, 1] on ``device``."""
    return torch.rand((batch, 1, 1), generator=generator).to(device)


def gradient_penalty(disc: Callable, real: torch.Tensor, fake: torch.Tensor,
                     lengths: torch.Tensor, generator: torch.Generator | None = None,
                     eps: torch.Tensor | None = None) -> torch.Tensor:
    """E[(||grad_x D(x_interp)|| - 1)^2] over per-sample interpolates of
    real and fake [B, T, V] (same shapes); the norm is taken over each
    sample's whole (T, V) slab (padding frames have zero gradient: D masks
    them)."""
    if eps is None:
        eps = draw_eps(real.shape[0], generator, real.device)
    eps = eps.to(device=real.device, dtype=real.dtype)
    interp = eps * real + (1.0 - eps) * fake
    if not interp.requires_grad:
        interp = interp.detach().requires_grad_()
    (grads,) = torch.autograd.grad(disc(interp, lengths).sum(), interp, create_graph=True)
    norms = torch.sqrt(torch.sum(torch.square(grads), dim=(1, 2)) + 1e-12)
    return torch.mean(torch.square(norms - 1.0))


def _scores_and_gp(disc, real, real_lengths, fake, fake_lengths, generator, eps):
    score_real = disc(real, real_lengths)
    score_fake = disc(fake, fake_lengths)
    # interpolate on a common length: the shorter side is right-padded with
    # zeros (both are masked by length inside D)
    T = max(real.shape[1], fake.shape[1])
    pad_r = F.pad(real, (0, 0, 0, T - real.shape[1]))
    pad_f = F.pad(fake, (0, 0, 0, T - fake.shape[1]))
    gp_len = torch.minimum(real_lengths, fake_lengths)
    gp = gradient_penalty(disc, pad_r, pad_f, gp_len, generator, eps)
    return score_real, score_fake, gp


def d_loss_fn(disc: Callable, real: torch.Tensor, real_lengths: torch.Tensor,
              fake: torch.Tensor, fake_lengths: torch.Tensor, lambda_gp: float,
              generator: torch.Generator | None = None, eps: torch.Tensor | None = None):
    """Critic loss E[D(fake)] - E[D(real)] + lambda * GP. real and fake may
    differ in T. Returns (loss, {"d_loss", "wasserstein", "gp"})."""
    score_real, score_fake, gp = _scores_and_gp(disc, real, real_lengths, fake, fake_lengths,
                                                generator, eps)
    wdist = torch.mean(score_real) - torch.mean(score_fake)
    loss = -wdist + lambda_gp * gp
    return loss, {"d_loss": loss, "wasserstein": wdist, "gp": gp}


def g_loss_fn(score_fake: torch.Tensor) -> torch.Tensor:
    """Generator loss -E[D(G(x))]."""
    return -torch.mean(score_fake)


def bce_d_loss_fn(disc: Callable, real: torch.Tensor, real_lengths: torch.Tensor,
                  fake: torch.Tensor, fake_lengths: torch.Tensor, lambda_gp: float,
                  generator: torch.Generator | None = None, eps: torch.Tensor | None = None):
    """Non-saturating critic loss (wav2vec-U's objective):
    softplus(-D(real)) + softplus(D(fake)) + lambda * GP, with the same
    Wasserstein diagnostic as ``d_loss_fn``."""
    score_real, score_fake, gp = _scores_and_gp(disc, real, real_lengths, fake, fake_lengths,
                                                generator, eps)
    loss = (torch.mean(F.softplus(-score_real)) + torch.mean(F.softplus(score_fake))
            + lambda_gp * gp)
    wdist = torch.mean(score_real) - torch.mean(score_fake)
    return loss, {"d_loss": loss, "wasserstein": wdist, "gp": gp}


def bce_g_loss_fn(score_fake: torch.Tensor) -> torch.Tensor:
    """Non-saturating generator loss softplus(-D(G(x)))."""
    return torch.mean(F.softplus(-score_fake))
