"""Time ``ClipAdam``'s update on the card at the librispeech BiGRU's leaves:
K-norm + K-adam against the per-leaf plain version and two library forms.

  python -m uasr_torch.tools.time_adam [--reps 20]

The leaves: the 22 of the benchmark's librispeech BiGRU (conv2d front,
three BiGRU layers of 512, 32 symbols; 15,031,264 f32 parameters), random
parameters, gradients scaled to a global norm of 20 (above the clip of 5)
and of 2.5 (below it), mid-training moments. Prints one JSON line per
case: the ms of each form (CUDA events, the mean of ``--reps`` updates
after one, the gradients the same every update), the launches of each
(K-norm and K-adam counted by ``cuda_adam.LAUNCHES``; every form's
kernels by the profiler), the bound (K-adam's 28 bytes an f32 element and
K-norm's 4, over 3.35 TB/s) and, from the same state, whether one update
of the fused pair and of the foreach form give the plain version's bits.

The forms: ``fused`` (K-norm, K-adam), ``plain`` (the per-leaf version),
``foreach`` (PyTorch's multi-tensor ``torch._foreach_*`` ops in optax's
order, each operation rounded as the plain version rounds it, the host
scalars as Python floats) and ``fused_library`` (``torch._foreach_norm``
and a clip by ``torch._foreach_mul``, then ``torch._fused_adam_``, whose
update rounds differently). It calls only ``cuda_adam``'s functions, so
the file runs from any checkout that has them.
"""

from __future__ import annotations

import argparse
import json

SIZES = [576, 64, 64, 64, 36864, 64, 64, 64, 3932160, 1572864, 3072, 3072, 3145728, 1572864,
         3072, 3072, 3145728, 1572864, 3072, 3072, 32768, 32]
HBM_BYTES_PER_S = 3.35e12
ADAM = dict(max_norm=5.0, b1=0.9, b2=0.999, eps=1e-8)
COUNT, LR = 100, 6e-4  # the update timed: its step and learning rate


def bound_ms(n: int) -> float:
    """K-adam's 28 bytes and K-norm's 4 an f32 element, over HBM."""
    return 32 * n / HBM_BYTES_PER_S * 1e3


def problem(torch, dev, norm: float, seed: int = 0):
    """(params, grads, mu, nu) at ``SIZES``: random f32 parameters,
    gradients of global norm ``norm``, mid-training moments."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = [torch.randn(k, device=dev, generator=gen) for k in SIZES]
    total = float(torch.sqrt(sum(torch.sum(x * x) for x in g)))
    g = [x * (norm / total) for x in g]
    p = [torch.randn(k, device=dev, generator=gen) for k in SIZES]
    m = [0.01 * torch.randn(k, device=dev, generator=gen) for k in SIZES]
    v = [(0.01 * torch.randn(k, device=dev, generator=gen)) ** 2 for k in SIZES]
    return p, g, m, v


def scalars(count: int = COUNT, lr: float = LR) -> dict:
    from uasr_torch.ops import cuda_adam

    return dict(zip(("bc1", "bc2", "step_size"),
                    cuda_adam.host_scalars(count, ADAM["b1"], ADAM["b2"], lr)))


def fused(p, g, m, v):
    from uasr_torch.ops import cuda_adam

    norm = cuda_adam.sq_norms_cuda(g, [False] * len(g))[2]
    cuda_adam.clip_adam_cuda(p, g, m, v, norm, **ADAM, **scalars())


def plain(p, g, m, v):
    from uasr_torch.ops import cuda_adam

    norm = cuda_adam.sq_norms_reference(g)[2]
    cuda_adam.clip_adam_reference(p, g, m, v, norm, **ADAM, **scalars())


def foreach_norm(g):
    """The global norm by ``torch._foreach_norm``."""
    import torch

    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))


def foreach_update(p, g, m, v, g_norm, max_norm: float, b1: float, b2: float, eps: float,
                   bc1: float, bc2: float, step_size: float) -> None:
    """``cuda_adam.clip_adam_reference``'s update in ``torch._foreach_*``
    ops, in its order and rounding (same arguments)."""
    import torch

    clipped = torch._foreach_mul(torch._foreach_div(g, g_norm), max_norm)
    keep = (g_norm < max_norm).float()  # x * 1 + y * 0 is x exactly: torch.where's pick
    g = torch._foreach_add(torch._foreach_mul(g, keep), torch._foreach_mul(clipped, 1 - keep))
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
    den = torch._foreach_sqrt(torch._foreach_div(v, bc2))
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(torch._foreach_div(m, bc1), den)
    torch._foreach_add_(p, torch._foreach_mul(upd, step_size))


def foreach(p, g, m, v):
    foreach_update(p, g, m, v, foreach_norm(g), **ADAM, **scalars())


def fused_library(p, g, m, v, steps):
    """A foreach clip, then ``torch._fused_adam_`` (``steps``: its step
    tensors, one a leaf, at COUNT - 1)."""
    import torch

    a = ADAM
    norm = foreach_norm(g)
    scale = torch.where(norm < a["max_norm"], torch.ones_like(norm), a["max_norm"] / norm)
    g = torch._foreach_mul(g, scale)
    torch._foreach_add_(steps, 1)
    torch._fused_adam_(p, g, m, v, [], steps, lr=LR, beta1=a["b1"], beta2=a["b2"],
                       weight_decay=0.0, eps=a["eps"], amsgrad=False, maximize=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from uasr_torch.ops import cuda_adam

    dev = torch.device("cuda")
    n = sum(SIZES)

    def ms(fn, state):
        fn(*state)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.reps):
            fn(*state)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / args.reps

    def kernels(fn, state):
        fn(*state)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*state)
            torch.cuda.synchronize()
        return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)

    for norm in (20.0, 2.5):
        start = problem(torch, dev, norm)

        def state(library=False):
            p, g, m, v = start
            out = [[x.clone() for x in p], g, [x.clone() for x in m], [x.clone() for x in v]]
            if library:
                out.append([torch.full((), float(COUNT - 1), device=dev) for _ in SIZES])
            return out

        once = {}
        for name, fn in (("fused", fused), ("plain", plain), ("foreach", foreach)):
            once[name] = state()
            fn(*once[name])

        def same(name):
            return all(torch.equal(x, y) for a, b in zip(once[name], once["plain"])
                       for x, y in zip(a, b))

        before = cuda_adam.LAUNCHES
        fused(*state())
        launches = cuda_adam.LAUNCHES - before
        forms = {"fused": (fused, False), "plain": (plain, False), "foreach": (foreach, False),
                 "fused_library": (fused_library, True)}
        print(json.dumps({
            "case": f"bigru_22_norm_{norm:g}", "leaves": len(SIZES), "params": n,
            **{f"{k}_ms": round(ms(fn, state(lib)), 4) for k, (fn, lib) in forms.items()},
            "bound_ms": round(bound_ms(n), 4), "fused_launches": launches,
            **{f"{k}_kernels_profiled": kernels(fn, state(lib)) for k, (fn, lib) in forms.items()},
            "fused_bit_equal": same("fused"), "foreach_bit_equal": same("foreach"),
            "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
